"""A whole trace of a scene of mirrors, measuring surfaces and
terminators, with power weighting, in plain torch.

Per bounce, every live ray finds its nearest hit (`nearest_hit`):
* a miss escapes with its power;
* a measuring surface takes the ray's power into its detector's total and
  into the (azimuth x polar) histogram of the hit point's direction seen
  from `hist_center` (azimuth in [0, 2 pi), polar in [0, pi], bins of equal
  width, indices clamped into range);
* a terminator absorbs it;
* a mirror of reflectivity R absorbs (1 - R) P and reflects the ray
  specularly about the triangle's normal (turned to face the ray), with
  power R P, from the hit point moved 1e-6 (|o| + t) along the new
  direction.
The loop runs at most `iterations` bounces and stops once the accounted
power (measured + absorbed + escaped) reaches `dissipation_target` of the
emitted power; the power still live at the end is returned apart.
"""

from __future__ import annotations

import math

import torch

from perfcells.reference.nearest_hit import nearest_hit

MIRROR, TERMINATOR, MEASURE = "mirror", "terminator", "measure"


def scene_arrays(elements, device):
    """Flat float64 triangle columns and per-triangle attributes of a list
    of elements (dicts with vertices, triangles, material, reflectivity,
    name), in the elements' order. Detector ids number the measuring
    elements in order."""
    cols = {k: [] for k in ("v0", "e1", "e2", "kind", "refl", "det")}
    n_det = 0
    for el in elements:
        tv = torch.as_tensor(el["vertices"], dtype=torch.float64)[
            torch.as_tensor(el["triangles"], dtype=torch.int64)]
        n = tv.shape[0]
        kind = {MIRROR: 0, TERMINATOR: 1, MEASURE: 2}[el["material"]]
        cols["v0"].append(tv[:, 0])
        cols["e1"].append(tv[:, 1] - tv[:, 0])
        cols["e2"].append(tv[:, 2] - tv[:, 0])
        cols["kind"].append(torch.full((n,), kind, dtype=torch.int64))
        cols["refl"].append(torch.full((n,), float(el.get("reflectivity",
                                                          1.0)),
                                       dtype=torch.float64))
        cols["det"].append(torch.full((n,), n_det if kind == 2 else -1,
                                      dtype=torch.int64))
        n_det += kind == 2
    out = {k: torch.cat(v).to(device) for k, v in cols.items()}
    out["n_det"] = max(n_det, 1)
    return out


def hist_bins(points, center, n_az, n_pol):
    """Flat (azimuth, polar) bin of each point's direction from center."""
    v = points - torch.as_tensor(center, dtype=points.dtype,
                                 device=points.device)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    az = torch.atan2(v[:, 1], v[:, 0])
    az = torch.where(az < 0, az + 2.0 * math.pi, az)
    pol = torch.arccos(torch.clamp(v[:, 2], -1.0, 1.0))
    ia = torch.clamp((az / (2.0 * math.pi) * n_az).floor().long(), 0,
                     n_az - 1)
    ip = torch.clamp((pol / math.pi * n_pol).floor().long(), 0, n_pol - 1)
    return ia * n_pol + ip


def trace(o, d, p, scene, opts, dtype=torch.float64):
    """Trace rays (o, d, p) through `scene` (from `scene_arrays`). `opts`:
    eps, eps_bary, max_ray_len, iterations, dissipation_target,
    hist_azimuth_bins, hist_polar_bins, hist_center. Returns float64
    numbers: ledger (emitted, measured, absorbed, escaped), live,
    per_detector (D,), hist (n_az, n_pol), bounces."""
    dev = o.device
    n_az, n_pol = opts["hist_azimuth_bins"], opts["hist_polar_bins"]
    geo = {k: scene[k].to(dtype) for k in ("v0", "e1", "e2")}
    nrm = torch.linalg.cross(geo["e1"], geo["e2"])
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
    refl = scene["refl"].to(dtype)
    o, d, p = o.to(dtype), d.to(dtype), p.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    emitted = p.sum()
    measured = absorbed = escaped = zero
    per_det = torch.zeros(scene["n_det"], dtype=dtype, device=dev)
    hist = torch.zeros(n_az * n_pol, dtype=dtype, device=dev)
    bounces = 0
    while bounces < opts["iterations"] and bool(
            (measured + absorbed + escaped).double()
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
        meas = kind == 2
        measured = measured + torch.where(meas, p, zero).sum()
        det = torch.where(meas, scene["det"][safe], 0)
        per_det = per_det.index_add(0, det, torch.where(meas, p, zero))
        hb = hist_bins(h, opts["hist_center"], n_az, n_pol)
        hist = hist.index_add(0, hb, torch.where(meas, p, zero))
        absorbed = absorbed + torch.where(kind == 1, p, zero).sum()
        mir = kind == 0
        n = nrm[safe]
        n = torch.where(((d * n).sum(1) < 0)[:, None], n, -n)
        r = d - 2.0 * (d * n).sum(1)[:, None] * n
        pr = p * refl[safe]
        absorbed = absorbed + torch.where(mir, p - pr, zero).sum()
        push = 1e-6 * (torch.linalg.vector_norm(o, dim=1) + t)
        keep = mir & (pr > 0)
        o = (h + push[:, None] * r)[keep]
        d, p = r[keep], pr[keep]
    f = lambda x: float(x.double())  # noqa: E731
    return {"emitted": f(emitted), "measured": f(measured),
            "absorbed": f(absorbed), "escaped": f(escaped),
            "live": f(p.sum()), "bounces": bounces,
            "per_detector": per_det.double().cpu().numpy(),
            "hist": hist.double().reshape(n_az, n_pol).cpu().numpy()}
