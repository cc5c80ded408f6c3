"""A whole trace of a scene of mirrors, dielectrics, measuring surfaces
and terminators, with power weighting and ray splitting, in plain torch.

Every ray carries a power and the index of the medium it travels in,
`ior_env` at the source. Per bounce, every live ray finds its nearest hit
(`nearest_hit`):
* a miss escapes with its power;
* a measuring surface takes the ray's power into its detector's total and
  into the (azimuth x polar) histogram of the hit point's direction seen
  from `hist_center` (azimuth in [0, 2 pi), polar in [0, pi], bins of equal
  width, indices clamped into range);
* a terminator absorbs it;
* a mirror of reflectivity R absorbs (1 - R) P and reflects the ray
  specularly about the triangle's normal (turned to face the ray), with
  power R P;
* a dielectric (`refractive`) of index n splits the ray (`dielectric`). A
  ray that meets the triangle's outward normal (e1 x e2, counter-clockwise
  winding, as the program's `GeoObject` documents) head on enters, from
  its current index to n; any other leaves, from its current index to
  `ior_env`. Snell's law gives the transmitted direction; the unpolarized
  Fresnel reflectance R = (Rs + Rp) / 2 gives the reflected child R P and
  the transmitted child (1 - R) P, which travels in the new index. Under
  total internal reflection R = 1 and there is no transmitted child.
Each child starts from the hit point moved 1e-6 (|o| + t) along its own
direction. A child of power at most `power_cutoff` is booked as culled.
With a `capacity`, the children of a bounce are then fitted into that many
slots as the program's top-k fits them: the `capacity` of highest power
stay (ties to the lower slot, the reflected or mirror children of the rays
in order before their transmitted ones, as the program lays them out at
(i, C + i)) and the rest are booked as culled. The loop runs at most
`iterations` bounces and stops once the accounted power (measured +
absorbed + escaped + culled) reaches `dissipation_target` of the emitted
power; the power still live at the end is returned apart.

The program's top-k spans the slots of one call, or one batch: the
reference models it where it traces those rays together, at their
capacity. Where it traces a sample of them, the sample's share of the
slots keeps the children above about the same power as the whole batch's
slots do, up to the sample's spread. Powers that the program rounds to
float32 can order two children of nearly equal power the other way, so
the kept children may differ by such near-ties, with that child's power.
"""

from __future__ import annotations

import math

import torch

from perfcells.reference.nearest_hit import nearest_hit

# the materials the reference follows, by their code in `kind`
MIRROR, TERMINATOR, MEASURE, REFRACTIVE = 0, 1, 2, 3
KINDS = {"mirror": MIRROR, "terminator": TERMINATOR, "measure": MEASURE,
         "refractive": REFRACTIVE}


def scene_arrays(elements, device):
    """Flat float64 triangle columns and per-triangle attributes (kind,
    reflectivity, index of refraction, detector id) of a list of elements
    (dicts with vertices, triangles, material, reflectivity, name, and
    optionally ior, default 1), in the elements' order. Detector ids number
    the measuring elements in order."""
    cols = {k: [] for k in ("v0", "e1", "e2", "kind", "refl", "ior", "det")}
    n_det = 0
    for el in elements:
        if el["material"] not in KINDS:
            raise ValueError(
                f"element {el.get('name')!r}: the reference follows "
                f"{sorted(KINDS)}, not {el['material']!r}")
        tv = torch.as_tensor(el["vertices"], dtype=torch.float64)[
            torch.as_tensor(el["triangles"], dtype=torch.int64)]
        n = tv.shape[0]
        kind = KINDS[el["material"]]
        cols["v0"].append(tv[:, 0])
        cols["e1"].append(tv[:, 1] - tv[:, 0])
        cols["e2"].append(tv[:, 2] - tv[:, 0])
        cols["kind"].append(torch.full((n,), kind, dtype=torch.int64))
        for col, key in (("refl", "reflectivity"), ("ior", "ior")):
            cols[col].append(torch.full((n,), float(el.get(key, 1.0)),
                                        dtype=torch.float64))
        cols["det"].append(torch.full((n,), n_det if kind == MEASURE else -1,
                                      dtype=torch.int64))
        n_det += kind == MEASURE
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


def dielectric(d, n, entering, n1, n_element, ior_env):
    """Snell refraction and the unpolarized Fresnel split of rays `d` at a
    dielectric surface whose normal `n` faces them: `entering` rays go from
    index n1 to `n_element`, the others to `ior_env`. Returns (R,
    transmitted direction, the transmitted child's index, tir); under total
    internal reflection R = 1 and the direction is not a ray's."""
    n2 = torch.where(entering, n_element, torch.full_like(n_element,
                                                          ior_env))
    eta = n1 / n2
    cos_i = -(d * n).sum(1)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    rs = ((n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)) ** 2
    rp = ((n1 * cos_t - n2 * cos_i) / (n1 * cos_t + n2 * cos_i)) ** 2
    R = torch.where(tir, torch.ones_like(rs), 0.5 * (rs + rp))
    t = eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * n
    t = t / torch.linalg.vector_norm(t, dim=1, keepdim=True)
    return R, t, n2, tir


def trace(o, d, p, scene, opts, dtype=torch.float64, capacity=None):
    """Trace rays (o, d, p) through `scene` (from `scene_arrays`). `opts`:
    eps, eps_bary, max_ray_len, iterations, dissipation_target,
    hist_azimuth_bins, hist_polar_bins, hist_center, ior_env and
    power_cutoff. `capacity`: the slots a bounce's children are fitted
    into, or None for every child. Returns float64 numbers: ledger
    (emitted, measured, absorbed, escaped, culled), live, per_detector
    (D,), hist (n_az, n_pol), bounces, live_rays."""
    dev = o.device
    n_az, n_pol = opts["hist_azimuth_bins"], opts["hist_polar_bins"]
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
    per_det = torch.zeros(scene["n_det"], dtype=dtype, device=dev)
    hist = torch.zeros(n_az * n_pol, dtype=dtype, device=dev)
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
        det = torch.where(meas, scene["det"][safe], 0)
        per_det = per_det.index_add(0, det, torch.where(meas, p, zero))
        hb = hist_bins(h, opts["hist_center"], n_az, n_pol)
        hist = hist.index_add(0, hb, torch.where(meas, p, zero))
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
            "live_rays": int(p.shape[0]),
            "per_detector": per_det.double().cpu().numpy(),
            "hist": hist.double().reshape(n_az, n_pol).cpu().numpy()}
