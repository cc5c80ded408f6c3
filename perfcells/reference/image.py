"""A whole trace with a focal-plane image, in plain torch: the loop of
`trace.trace` (the same nearest hit, materials, Snell refraction and
Fresnel split, cutoff, top-k fit into the capacity and stop; see that
module) that also bins the power of each measured hit onto an image
plane of `image_bins` x `image_bins` pixels.

A hit point h is binned as the program's `step.image_flat_indices` bins
it: with (u, v) the first two rows of the port's `sources._frame` for
`image_normal` (`sampling.frame`, its frozen copy), x = (h - c) . u and
y = (h - c) . v, elementwise, c the `image_center`; then ix =
floor((x + hw) / (2 hw) nb), iy the same for y, pixel ix * nb + iy, and a
hit outside the nb x nb grid is dropped. No test of the hit's distance
from the plane is made: the program makes none.

The image and the detector totals are summed in float64 on the host with
`np.add.at`, in the rays' order, so the same rays read the same bits every
time. The (azimuth x polar) histogram of `trace.trace` is not made: the
image takes its place in the check.
"""

from __future__ import annotations

import numpy as np
import torch

from perfcells.reference.nearest_hit import nearest_hit
from perfcells.reference.sampling import frame
from perfcells.reference.trace import (MEASURE, MIRROR, REFRACTIVE,
                                       TERMINATOR, dielectric)


def image_pixels(points, center, normal, nb, halfwidth):
    """Flat pixel ix * nb + iy of each point on the image plane, -1 where
    it falls outside the grid; computed in the points' dtype."""
    F = torch.as_tensor(frame(normal), dtype=points.dtype,
                        device=points.device)
    rel = points - torch.as_tensor(center, dtype=points.dtype,
                                   device=points.device)
    x = (rel * F[0]).sum(1)
    y = (rel * F[1]).sum(1)
    ix = torch.floor((x + halfwidth) / (2 * halfwidth) * nb).long()
    iy = torch.floor((y + halfwidth) / (2 * halfwidth) * nb).long()
    inside = (ix >= 0) & (ix < nb) & (iy >= 0) & (iy < nb)
    return torch.where(inside, ix * nb + iy, -1)


def trace(o, d, p, scene, opts, dtype=torch.float64, capacity=None):
    """Trace rays (o, d, p) through `scene` (`trace.scene_arrays`). `opts`:
    those of `trace.trace` and image_bins, image_center, image_normal,
    image_halfwidth. `capacity`: the slots a bounce's children are fitted
    into, or None for every child. Returns float64 numbers: ledger
    (emitted, measured, absorbed, escaped, culled), live, per_detector
    (D,), image (nb, nb), bounces, live_rays."""
    dev = o.device
    nb, hw = int(opts["image_bins"]), float(opts["image_halfwidth"])
    ior_env, cutoff = float(opts["ior_env"]), float(opts["power_cutoff"])
    geo = {k: scene[k].to(dtype) for k in ("v0", "e1", "e2")}
    nrm = torch.linalg.cross(geo["e1"], geo["e2"])
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
    refl, ior = scene["refl"].to(dtype), scene["ior"].to(dtype)
    o, d, p = o.to(dtype), d.to(dtype), p.to(dtype)
    med = torch.full_like(p, ior_env)  # the index each ray travels in
    zero = torch.zeros((), dtype=dtype, device=dev)
    emitted = p.sum()
    measured = absorbed = escaped = culled = zero
    per_det = np.zeros(scene["n_det"])
    image = np.zeros(nb * nb)
    bounces = 0
    while bounces < opts["iterations"] and bool(
            (measured + absorbed + escaped + culled).double()
            < opts["dissipation_target"] * emitted.double()):
        bounces += 1
        if o.shape[0] == 0:
            continue
        t, tri = nearest_hit(o, d, geo["v0"], geo["e1"], geo["e2"],
                             opts["eps"], opts["eps_bary"],
                             opts["max_ray_len"], dtype=dtype)
        hit = tri >= 0
        safe = torch.clamp_min(tri, 0)
        kind = torch.where(hit, scene["kind"][safe], -1)
        escaped = escaped + torch.where(~hit, p, zero).sum()
        t = torch.where(hit, t, 0.0).to(dtype)
        h = o + t[:, None] * d
        meas = kind == MEASURE
        measured = measured + torch.where(meas, p, zero).sum()
        pm = p[meas].double().cpu().numpy()
        np.add.at(per_det, scene["det"][safe][meas].cpu().numpy(), pm)
        pix = image_pixels(h[meas], opts["image_center"],
                           opts["image_normal"], nb, hw).cpu().numpy()
        np.add.at(image, pix[pix >= 0], pm[pix >= 0])
        absorbed = absorbed + torch.where(kind == TERMINATOR, p, zero).sum()
        mir, refr = kind == MIRROR, kind == REFRACTIVE
        n = nrm[safe]
        entering = (d * n).sum(1) < 0
        n = torch.where(entering[:, None], n, -n)
        r = d - 2.0 * (d * n).sum(1)[:, None] * n
        pr = p * refl[safe]
        absorbed = absorbed + torch.where(mir, p - pr, zero).sum()
        R, tdir, n2, tir = dielectric(d, n, entering, med, ior[safe],
                                      ior_env)
        push = 1e-6 * (torch.linalg.vector_norm(o, dim=1) + t)
        # the children, reflected (or mirrored) then transmitted: (is a
        # child, direction, power, index)
        kids = [(mir | refr, r, torch.where(mir, pr, R * p), med),
                (refr & ~tir, tdir, (1.0 - R) * p, n2)]
        is_kid, cd, cp, cm = (torch.cat(c) for c in zip(*kids))
        keep = is_kid & (cp > cutoff)
        if capacity is not None and int(keep.sum()) > capacity:
            top = torch.sort(torch.where(keep, cp, -1.0), descending=True,
                             stable=True).indices[:capacity]
            keep = keep & torch.zeros_like(keep).index_fill(0, top, True)
        culled = culled + torch.where(is_kid & ~keep, cp, zero).sum()
        h, push = h.repeat(2, 1), push.repeat(2)
        o = (h + push[:, None] * cd)[keep]
        d, p, med = cd[keep], cp[keep], cm[keep]
    f = lambda x: float(x.double())  # noqa: E731
    return {"emitted": f(emitted), "measured": f(measured),
            "absorbed": f(absorbed), "escaped": f(escaped),
            "culled": f(culled), "live": f(p.sum()), "bounces": bounces,
            "live_rays": int(p.shape[0]), "per_detector": per_det,
            "image": image.reshape(nb, nb)}
