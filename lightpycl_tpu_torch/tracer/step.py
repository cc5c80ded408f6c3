"""The trace step: (reorder,) intersect -> shade/split -> measure -> compact.

Port counterpart of lightpycl_tpu/tracer/step.py, core model only. Shapes
are static as in the reference: C = ray capacity, children land in 2C slots
(reflected child of ray i at slot i, refracted at C + i), compaction keeps C
of them and books the rest as 'culled' so the conservation ledger stays
exact.

What is ported: `morton_order` / `reorder_rays`, `gather_hit_attrs` /
`default_hit_attrs` (base columns), `_relaunch_push`, every line of `shade`
that no TraceConfig flag gates (Beer-Lambert attenuation, Cauchy B and C
dispersion, mirror / refractive / terminator / measure / beamsplitter
materials, polarizer and waveplate absorbed in the unpolarized model, the
split and no-split child layouts, the absorbed / escaped / measured sums),
`accumulate_detector(_arrays)` with `image_flat_indices` and the optional
maps (coherent field, time-of-flight histogram, per-facet flux), Russian
`roulette`, `compact` (no-split, 'topk', 'stream'), `trace_step` with the
measured-ray front compaction, and the device loop. Every branch a flag
gates that is still unported (polarization, coatings, metals, gratings,
diffuse, volume scattering, fluorescence, roughness, GRIN, analytic
surfaces, path tracking) raises NotImplementedError here and waits for a
later port.

Determinism: the detector scatter-adds are a sort-based segmented sum with
a fixed association (`bincount_sorted`, no float atomics), so the same
inputs give the same bits; top-k is a stable descending sort, so ties keep
the lower slot first as jax.lax.top_k does. Random draws (roulette) come
from a torch.Generator per bounce, seeded from (cfg.seed, bounce) as the
reference folds the bounce index into its key (`make_generator`); torch's
streams are not JAX's, so the tests feed `roulette` JAX's own uniforms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lightpycl_tpu_torch import physics
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.ops.intersect import intersect
from lightpycl_tpu_torch.sources import _frame
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import (DetectorState, Ledger, RayBatch,
                                             norm3)
from lightpycl_tpu_torch.tracer.scene import Scene

_F32 = torch.float32

# cfg switches whose branches are not ported yet, with the feature each names
_GATED_FLAGS = (
    ("polarization", "polarization (Stokes-Mueller model)"),
    ("has_gratings", "gratings (has_gratings)"),
    ("has_coatings", "thin-film coatings (has_coatings)"),
    ("has_metals", "metal mirrors (has_metals)"),
    ("has_diffuse", "diffuse scatterers (has_diffuse)"),
    ("has_scattering", "volume scattering (has_scattering)"),
    ("has_fluorescence", "fluorescence (has_fluorescence)"),
    ("has_roughness", "rough mirrors (has_roughness)"),
    ("has_grin", "gradient-index media (has_grin)"),
    ("has_analytic", "analytic quadric surfaces (has_analytic)"),
    ("track_paths", "path tracking (track_paths)"),
)


def require_core(cfg: TraceConfig) -> None:
    """Raise NotImplementedError naming the first cfg feature outside the
    ported core model."""
    for flag, feature in _GATED_FLAGS:
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{feature} is not ported to lightpycl_tpu_torch yet")


def make_generator(device, *words: int) -> torch.Generator:
    """A torch.Generator on `device` whose stream depends only on the
    integers `words` (e.g. (seed, bounce) or (seed, batch, bounce)): the
    port's counterpart of folding indices into a JAX key."""
    seed = np.random.SeedSequence(
        [int(w) & 0xFFFFFFFFFFFFFFFF for w in words]).generate_state(
            1, np.uint64)[0]
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return g


# --------------------------------------------------------------------------
# Ray reordering (coherence for the cull mask)
# --------------------------------------------------------------------------

def _spread3(x):
    """Spread 10 bits to every 3rd bit (Morton encoding helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(o, alive, lo, hi):
    """Stable permutation sorting rays by the Morton code of their origins
    (10 bits/axis over [lo, hi]); dead rays sort to the end. Codes are held
    in int64 (the reference's uint32 values, exactly)."""
    span = torch.clamp_min(hi - lo, 1e-20)
    q = torch.clamp((o - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))
    code = torch.where(alive, code, 0xFFFFFFFF)
    return torch.argsort(code, stable=True)


def morton_permutation(scene: Scene, rays: RayBatch) -> torch.Tensor:
    """The slot permutation `reorder_rays` applies: Morton order of the
    origins over the box of the scene's valid triangles (padding rows
    would stretch the box to include the origin)."""
    valid = torch.any(scene.ww != 0.0, dim=1)[:, None]
    lo = torch.where(valid, scene.v0, 3.4e38).amin(dim=0)
    hi = torch.where(valid, scene.v0, -3.4e38).amax(dim=0)
    return morton_order(rays.o, rays.alive, lo, hi)


def reorder_rays(scene: Scene, rays: RayBatch) -> RayBatch:
    """Morton-sort the batch (ray order is semantically free: every
    downstream quantity is per-ray or a sum)."""
    return rays.permuted(morton_permutation(scene, rays))


# --------------------------------------------------------------------------
# Shade: material dispatch, Snell/Fresnel split, measurement
# --------------------------------------------------------------------------

class ShadeOut(NamedTuple):
    child_o: torch.Tensor        # (2C, 3) or (C, 3) without splitting
    child_d: torch.Tensor
    child_power: torch.Tensor
    child_ior: torch.Tensor
    child_wavelength: torch.Tensor
    child_absorb: torch.Tensor
    policy_dropped: torch.Tensor  # () power dropped by allow_splitting=False
    child_s1: torch.Tensor
    child_s2: torch.Tensor
    child_s3: torch.Tensor
    child_basis: torch.Tensor
    child_opl: torch.Tensor
    child_alive: torch.Tensor
    hit_point: torch.Tensor      # (C, 3) parent hit / termination point
    measured: torch.Tensor       # (C,) bool parent measured this step
    measured_power: torch.Tensor  # (C,)
    det_id: torch.Tensor         # (C,) i32
    absorbed: torch.Tensor       # () power absorbed this step
    escaped: torch.Tensor        # () power escaped (miss) this step
    escaped_power: torch.Tensor  # (C,)
    dropped_power: torch.Tensor  # (C,)
    child_path: torch.Tensor
    child_scat: torch.Tensor
    child_scat_g: torch.Tensor
    child_medium: torch.Tensor
    atten: torch.Tensor          # (C,) Beer-Lambert transmission


def gather_hit_attrs(scene: Scene, safe_tri):
    """Per-hit triangle attributes, base columns (plus the Cauchy C column
    when the scene carries it)."""
    out = {
        "mat": scene.mat[safe_tri],
        "normal": scene.normal[safe_tri],
        "ior": scene.ior[safe_tri],
        "ior_b": scene.ior_b[safe_tri],
        "reflectivity": scene.reflectivity[safe_tri],
        "detector_id": scene.detector_id[safe_tri],
        "absorb": scene.absorb[safe_tri],
        "metal_n": scene.metal_n[safe_tri],
        "metal_k": scene.metal_k[safe_tri],
    }
    if scene.ior_c is not None:
        out["ior_c"] = scene.ior_c[safe_tri]
    return out


def default_hit_attrs(scene: Scene, safe_tri, cfg: TraceConfig):
    """The gather shade performs when no attrs override is given."""
    require_core(cfg)
    return gather_hit_attrs(scene, safe_tri.long())


def _relaunch_push(rays: RayBatch, t_draw):
    """Scale-proportional nudge (C, 1) moving a child's origin off its
    parent's facet along the outgoing direction: 1e-6 * (|o| + t), ~8x the
    worst-case f32 rounding of the hit point (see the reference)."""
    return (1e-6 * (norm3(rays.o) + t_draw))[:, None]


def shade(scene: Scene, rays: RayBatch, t, tri, cfg: TraceConfig,
          attrs=None) -> ShadeOut:
    """Surface interaction at the nearest hit, branchless: every ray
    computes all material outcomes; masks select."""
    require_core(cfg)
    hit_valid = (tri >= 0) & rays.alive
    safe_tri = torch.clamp_min(tri, 0)
    live_p = torch.where(rays.alive, rays.power, 0.0)

    t_draw = torch.where(hit_valid, t, cfg.max_ray_len)
    hit_point = rays.o + t_draw[:, None] * rays.d
    # optical path length through the segment just traveled
    opl_new = rays.opl + rays.ior * t_draw

    # Beer-Lambert bulk attenuation over the segment just traveled
    atten = torch.exp(-rays.absorb * t_draw)
    bulk_absorbed = torch.sum(live_p * (1.0 - atten))
    live_p = live_p * atten

    if attrs is None:
        attrs = default_hit_attrs(scene, safe_tri, cfg)
    mat = attrs["mat"]
    # dispersive glass: Cauchy n(lambda) = A + B / lambda^2 (+ C / lambda^4)
    wl2 = torch.square(rays.wavelength)
    tri_ior = attrs["ior"] + attrs["ior_b"] / wl2
    if "ior_c" in attrs:
        tri_ior = tri_ior + attrs["ior_c"] / torch.square(wl2)
    refl = attrs["reflectivity"]
    det_id = attrs["detector_id"]
    tri_absorb = attrs["absorb"]
    sn = physics.snell_interaction(rays.d, attrs["normal"], rays.ior,
                                   tri_ior, cfg.ior_env)
    R_diel = sn["R"]

    is_mirror = hit_valid & (mat == int(Material.MIRROR))
    is_refr = hit_valid & (mat == int(Material.REFRACTIVE))
    is_term = hit_valid & (mat == int(Material.TERMINATOR))
    is_meas = hit_valid & (mat == int(Material.MEASURE))
    is_bs = hit_valid & (mat == int(Material.BEAMSPLITTER))
    is_pol = hit_valid & (mat == int(Material.POLARIZER))
    is_wp = hit_valid & (mat == int(Material.WAVEPLATE))
    is_optic = is_pol | is_wp  # straight-through Stokes elements
    is_miss = rays.alive & ~hit_valid

    # child A: the reflected branch (mirror / dielectric / beamsplitter) at
    # slot i; polarizer/waveplate children continue straight through with
    # zero power in the unpolarized model
    refl_like = is_mirror | is_bs
    pa = torch.where(refl_like, live_p * refl,
                torch.where(is_refr, live_p * R_diel, 0.0))
    da = torch.where(is_optic[:, None], rays.d, sn["refl_dir"])
    a_ior = rays.ior
    a_absorb = rays.absorb
    push = _relaunch_push(rays, t_draw)
    # transmitted power of dielectrics (Fresnel) and beamsplitters
    pb = torch.where(is_refr, live_p * (1.0 - R_diel),
                torch.where(is_bs, live_p * (1.0 - refl), 0.0))
    dropped_power = torch.zeros_like(live_p)
    if cfg.allow_splitting:
        # child B at slot C + i: refracted branch (dielectric) or the
        # straight-through transmitted branch (beamsplitter)
        db = torch.where(is_bs[:, None], rays.d, sn["refr_dir"])
        b_ior = torch.where(is_bs, rays.ior, sn["new_ior"])
        # refracted child changes medium: entering -> element's bulk
        # absorption, exiting -> ambient (0); beamsplitter stays in medium
        refr_absorb = torch.where(is_bs, rays.absorb,
                             torch.where(sn["entering"], tri_absorb, 0.0))

        def two(a, b):
            return torch.cat([a, b], dim=0)

        child_o = two(hit_point + push * da, hit_point + push * db)
        child_d = two(da, db)
        child_power = two(pa, pb)
        child_ior = two(a_ior, b_ior)
        child_wl = two(rays.wavelength, rays.wavelength)
        child_ab = two(a_absorb, refr_absorb)
        # the relaunch push is traveled path: fold it into the child's OPL
        child_opl = two(opl_new + push[:, 0] * a_ior,
                        opl_new + push[:, 0] * b_ior)
        child_path = two(rays.path, rays.path)
        child_scat = two(rays.scat, rays.scat)
        child_scat_g = two(rays.scat_g, rays.scat_g)
        child_medium = two(rays.medium, rays.medium)
        child_s1 = two(rays.s1, rays.s1)
        child_s2 = two(rays.s2, rays.s2)
        child_s3 = two(rays.s3, rays.s3)
        child_basis = two(rays.basis, rays.basis)
    else:
        # no refractive elements (engine-verified): children stay in their
        # parent slots; transmitted power has no slot and is booked as
        # dropped so the ledger still balances for direct step users
        child_o = hit_point + push * da
        child_d, child_power, child_ior = da, pa, a_ior
        child_wl = rays.wavelength
        child_ab = a_absorb
        child_opl = opl_new + push[:, 0] * a_ior
        child_path = rays.path
        child_scat, child_scat_g = rays.scat, rays.scat_g
        child_medium = rays.medium
        dropped_power = pb
        child_s1, child_s2, child_s3 = rays.s1, rays.s2, rays.s3
        child_basis = rays.basis
    child_alive = child_power > 0.0

    # mirror absorption is the reflectivity deficit; polarizer / waveplate /
    # birefringent hits act on Stokes state the unpolarized model does not
    # carry (the engine refuses such scenes): absorbed so the ledger closes
    absorbed = (bulk_absorbed
                + torch.sum(torch.where(is_term, live_p, 0.0))
                + torch.sum(torch.where(is_mirror, live_p - pa, 0.0)))
    absorbed = absorbed + torch.sum(torch.where(is_optic, live_p, 0.0))
    absorbed = absorbed + torch.sum(torch.where(
        hit_valid & (mat == int(Material.BIREFRINGENT)), live_p, 0.0))
    escaped_power = torch.where(is_miss, live_p, 0.0)
    measured_power = torch.where(is_meas, live_p, 0.0)

    return ShadeOut(
        child_o, child_d, child_power, child_ior, child_wl, child_ab,
        torch.sum(dropped_power),
        child_s1, child_s2, child_s3, child_basis, child_opl,
        child_alive,
        hit_point, is_meas, measured_power, det_id,
        absorbed, torch.sum(escaped_power),
        escaped_power, dropped_power, child_path,
        child_scat, child_scat_g, child_medium,
        atten,
    )


# --------------------------------------------------------------------------
# Detector accumulation
# --------------------------------------------------------------------------

def bincount_sorted(idx: torch.Tensor, vals: torch.Tensor, n_bins: int):
    """Weighted bincount (n_bins,) of vals at idx in [0, n_bins),
    deterministic on CPU and CUDA: a stable sort by bin, then a segmented
    inclusive scan with a fixed (Hillis-Steele) association, so every run
    adds the same numbers in the same order, with no atomics; log2(C)
    elementwise passes. (PyTorch's deterministic index_put_ accumulates each
    bin serially in one warp: 23 ms for 524,288 rays into one detector bin
    on an H100.)"""
    out = torch.zeros(n_bins, dtype=vals.dtype, device=vals.device)
    n = idx.shape[0]
    if n == 0:
        return out
    order = torch.argsort(idx, stable=True)
    k, x = idx[order], vals[order]
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = k[1:] != k[:-1]
    f, s = head, 1
    while s < n:
        # (x, f)[i] <- (x, f)[i - s] (+) (x, f)[i]: a segment head keeps
        # its own partial sum; otherwise the earlier partial is added first
        x = torch.cat([x[:s], torch.where(f[s:], x[s:], x[:-s] + x[s:])])
        f = torch.cat([f[:s], f[s:] | f[:-s]])
        s *= 2
    last = torch.ones(n, dtype=torch.bool, device=idx.device)
    last[:-1] = head[1:]
    out[k[last].long()] = x[last]  # one write per bin
    return out


def image_flat_indices(hit_point, cfg: TraceConfig):
    """(C,) flat pixel index of each hit on the cfg image plane; points
    outside the grid map to the drop slot nb * nb."""
    F = torch.as_tensor(np.asarray(_frame(cfg.image_normal), np.float32),
                        device=hit_point.device)
    rel = hit_point - torch.as_tensor(
        np.asarray(cfg.image_center, np.float32), device=hit_point.device)
    # elementwise dot, as the reference
    x = torch.sum(rel * F[0], dim=1)
    y = torch.sum(rel * F[1], dim=1)
    nb = cfg.image_bins
    hw = cfg.image_halfwidth
    # floor, not int-cast: truncation would alias points just outside the
    # left/bottom edge into row/column 0
    ix = torch.floor((x + hw) / (2 * hw) * nb).to(torch.int32)
    iy = torch.floor((y + hw) / (2 * hw) * nb).to(torch.int32)
    inside = (ix >= 0) & (ix < nb) & (iy >= 0) & (iy < nb)
    return torch.where(inside, ix * nb + iy, nb * nb)


def accumulate_detector_arrays(det: DetectorState, hit_point, dirs,
                               measured_power, det_id, cfg: TraceConfig,
                               opl=None, wavelength=None, tri=None,
                               incident_power=None) -> DetectorState:
    """Scatter-add measured power into the (azimuth x polar) histogram,
    per-detector totals and the optional planar image, from bare arrays
    (measured_power is zero on unmeasured slots). With cfg.coherent (and
    opl, wavelength given) also the complex field sqrt(P) e^{i 2 pi
    OPL/lambda} into image_amp; with cfg.time_bins (and opl) the measured
    power by arrival OPL into time_hist; with cfg.flux_map (and tri,
    incident_power) the arriving power at each hit triangle into tri_flux.
    Every map is a `bincount_sorted` with one extra bin for what falls
    outside it."""
    n_az, n_pol = det.hist.shape
    if cfg.hist_mode == "direction":
        v = dirs
    else:  # 'position': direction of the hit point seen from hist_center
        v = physics.normalize(hit_point - torch.as_tensor(
            np.asarray(cfg.hist_center, np.float32), device=hit_point.device))
    az = torch.atan2(v[:, 1], v[:, 0])  # [-pi, pi)
    az = torch.where(az < 0, az + 2.0 * math.pi, az)
    pol = torch.arccos(torch.clamp(v[:, 2], -1.0, 1.0))
    ia = torch.clamp((az / (2.0 * math.pi) * n_az).to(torch.int32),
                     0, n_az - 1)
    ip = torch.clamp((pol / math.pi * n_pol).to(torch.int32), 0, n_pol - 1)
    flat = ia * n_pol + ip
    did = torch.clamp(det_id, 0, det.per_detector.shape[0] - 1)
    hist = det.hist + bincount_sorted(flat, measured_power,
                                      n_az * n_pol).reshape(n_az, n_pol)
    per_det = det.per_detector + bincount_sorted(
        did, measured_power, det.per_detector.shape[0])

    image, image_amp = det.image, det.image_amp
    if cfg.image_bins > 0:
        nb = cfg.image_bins
        # the extra bin nb * nb takes every hit outside the grid
        flat_img = image_flat_indices(hit_point, cfg)
        image = image + bincount_sorted(
            flat_img, measured_power, nb * nb + 1)[:-1].reshape(nb, nb)
        if cfg.coherent and opl is not None and wavelength is not None:
            re, im = coherent_amplitudes(measured_power, opl, wavelength)
            image_amp = image_amp + torch.stack([
                bincount_sorted(flat_img, a, nb * nb + 1)[:-1]
                for a in (re, im)]).reshape(image_amp.shape)

    time_hist = det.time_hist
    if cfg.time_bins > 0 and opl is not None:
        # out-of-range arrivals clamp into the edge bins, so the histogram
        # total stays exactly the measured power
        nt = time_hist.shape[1]
        span = max(cfg.opl_max - cfg.opl_min, 1e-30)
        it = torch.clamp(((opl - cfg.opl_min) / span * nt).to(torch.int32),
                         0, nt - 1)
        time_hist = time_hist + bincount_sorted(
            did * nt + it, measured_power,
            time_hist.numel()).reshape(time_hist.shape)

    tri_flux = det.tri_flux
    if cfg.flux_map and tri is not None and incident_power is not None:
        # misses (tri == -1) go to the extra bin T, which is dropped
        T = tri_flux.shape[0]
        idx = torch.where(tri >= 0, tri, T)
        tri_flux = tri_flux + bincount_sorted(idx, incident_power,
                                              T + 1)[:-1]
    return DetectorState(hist, per_det, image, image_amp, tri_flux,
                         time_hist)


def coherent_amplitudes(measured_power, opl, wavelength):
    """(re, im) of sqrt(P) e^{i 2 pi OPL / lambda} per ray, the phase from
    the fractional part of OPL / lambda (whole waves drop out)."""
    amp = torch.sqrt(torch.clamp_min(measured_power, 0.0))
    turns = opl / wavelength
    phase = 2.0 * math.pi * (turns - torch.floor(turns))
    return amp * torch.cos(phase), amp * torch.sin(phase)


def accumulate_detector(det: DetectorState, sh: ShadeOut, rays: RayBatch,
                        cfg: TraceConfig, tri=None) -> DetectorState:
    """Detector update of one bounce (arrival directions = parent rays').
    `tri` (the intersect result) feeds only the flux map, with the arriving
    power: the parent's power times the segment's Beer-Lambert
    transmission."""
    C = sh.hit_point.shape[0]
    inc = None
    if cfg.flux_map and tri is not None:
        inc = torch.where((tri >= 0) & rays.alive, rays.power * sh.atten,
                          0.0)
    return accumulate_detector_arrays(det, sh.hit_point, rays.d,
                                      sh.measured_power, sh.det_id, cfg,
                                      opl=sh.child_opl[:C],
                                      wavelength=rays.wavelength,
                                      tri=tri, incident_power=inc)


# --------------------------------------------------------------------------
# Compaction
# --------------------------------------------------------------------------

def _child_batch(sh: ShadeOut, power, alive, pick) -> RayBatch:
    """The children's columns as a RayBatch, each through pick(column,
    fill); `fill` is the value of a slot no child lands in (stream mode)."""
    return RayBatch(
        o=pick(sh.child_o, 0.0), d=pick(sh.child_d, 1.0), power=power,
        ior=pick(sh.child_ior, 1.0), alive=alive,
        wavelength=pick(sh.child_wavelength, 1.0),
        absorb=pick(sh.child_absorb, 0.0), s1=pick(sh.child_s1, 0.0),
        s2=pick(sh.child_s2, 0.0), s3=pick(sh.child_s3, 0.0),
        basis=pick(sh.child_basis, 0.0), opl=pick(sh.child_opl, 0.0),
        path=pick(sh.child_path, 0.0), scat=pick(sh.child_scat, 0.0),
        scat_g=pick(sh.child_scat_g, 0.0),
        medium=pick(sh.child_medium, -1.0))


def roulette(sh: ShadeOut, cfg: TraceConfig, u: torch.Tensor):
    """Russian-roulette termination (cfg.roulette_threshold > 0), given the
    unit uniforms `u`: children with 0 < power < threshold survive with
    probability power / threshold and are boosted to exactly the threshold
    (unbiased). The power delta (kills minus boosts) is returned for the
    ledger's 'culled' (it can be negative), so conservation stays exact."""
    thr = cfg.roulette_threshold
    weak = sh.child_alive & (sh.child_power < thr)
    p_survive = torch.clamp(sh.child_power / thr, 0.0, 1.0)
    survive = u < p_survive
    new_power = torch.where(weak, torch.where(survive, thr, 0.0),
                            sh.child_power)
    delta = torch.sum(torch.where(weak, sh.child_power - new_power, 0.0))
    return sh._replace(child_power=new_power,
                       child_alive=sh.child_alive & (new_power > 0.0)), delta


def compact(sh: ShadeOut, capacity: int, cfg: TraceConfig):
    """Fit the live children back into `capacity` slots. Returns
    (RayBatch, culled_power); dropped / below-cutoff power is accounted so
    the ledger stays exact.
      * no-split scenes: children sit in their parent slots
      * 'topk':   keep the `capacity` highest-power live children
      * 'stream': cumsum scatter, O(C); drops by slot order on overflow
    """
    live = sh.child_alive & (sh.child_power > cfg.power_cutoff)
    below = torch.sum(torch.where(sh.child_alive & ~live, sh.child_power,
                                  0.0))

    if not cfg.allow_splitting:
        power = torch.where(live, sh.child_power, 0.0)
        return _child_batch(sh, power, live, lambda a, fill: a), below

    total_live = torch.sum(torch.where(live, sh.child_power, 0.0))
    if cfg.compaction == "stream":
        pos = torch.cumsum(live.to(torch.int32), dim=0) - 1
        slot = torch.where(live & (pos < capacity), pos, capacity).long()

        def scat(a, fill):
            buf = torch.full((capacity + 1,) + tuple(a.shape[1:]), fill,
                             dtype=a.dtype, device=a.device)
            buf[slot] = a  # the extra row takes every dropped child
            return buf[:capacity]

        power = scat(sh.child_power, 0.0)
        culled = total_live - torch.sum(power) + below
        return _child_batch(sh, power, scat(live, False), scat), culled
    if cfg.compaction != "topk":
        raise ValueError(f"unknown compaction {cfg.compaction!r}")

    key = torch.where(live, sh.child_power, -1.0)
    # stable descending sort == jax.lax.top_k's order (ties: lower slot)
    idx = torch.sort(key, descending=True, stable=True).indices[:capacity]
    sel_live = live[idx]
    sel_power = torch.where(sel_live, sh.child_power[idx], 0.0)
    culled = total_live - torch.sum(sel_power) + below
    return (_child_batch(sh, sel_power, sel_live, lambda a, fill: a[idx]),
            culled)


# --------------------------------------------------------------------------
# Full step + the device loop
# --------------------------------------------------------------------------

class StepAux(NamedTuple):
    """Per-iteration observables for host mode; measured rays compacted
    into the FRONT of the m_* arrays (first `measured_count` entries)."""

    hit_point: torch.Tensor       # (C, 3) segment endpoints
    start_point: torch.Tensor     # (C, 3) segment starts (post-reorder)
    parent_alive: torch.Tensor    # (C,) bool parents that were traced
    m_pos: torch.Tensor           # (C, 3)
    m_dir: torch.Tensor           # (C, 3)
    m_power: torch.Tensor         # (C,)
    m_det: torch.Tensor           # (C,) i32
    m_wl: torch.Tensor            # (C,)
    m_stokes: torch.Tensor        # (C, 3)
    m_opl: torch.Tensor           # (C,)
    m_path: torch.Tensor          # (C,)
    measured_count: torch.Tensor  # () i32
    live_count: torch.Tensor      # () i32 live rays AFTER the step


def _measured_aux(sh: ShadeOut, rays: RayBatch, new_rays: RayBatch):
    """Stream-compact the measured rays to the array front with one fused
    (C, 14) scatter (the reference's layout; det_id rides as f32)."""
    C = rays.capacity
    dev = rays.device
    m_count = torch.sum(sh.measured.to(torch.int32))
    midx = torch.cumsum(sh.measured.to(torch.int32), dim=0) - 1
    slot = torch.where(sh.measured, midx, C).long()  # C = the dropped row
    stacked = torch.cat(
        [sh.hit_point, rays.d, sh.measured_power[:, None],
         rays.wavelength[:, None], rays.s1[:, None], rays.s2[:, None],
         rays.s3[:, None], sh.det_id.to(_F32)[:, None],
         sh.child_opl[:C, None], rays.path[:, None]], dim=1)
    m = torch.zeros((C + 1, 14), dtype=_F32, device=dev)
    m[slot] = stacked
    m = m[:C]
    m_det = torch.where(torch.arange(C, device=dev) < m_count,
                   m[:, 11].to(torch.int32), -1)
    return StepAux(
        hit_point=sh.hit_point, start_point=rays.o,
        parent_alive=rays.alive, m_pos=m[:, 0:3], m_dir=m[:, 3:6],
        m_power=m[:, 6], m_det=m_det, m_wl=m[:, 7], m_stokes=m[:, 8:11],
        m_opl=m[:, 12], m_path=m[:, 13], measured_count=m_count,
        live_count=torch.sum(new_rays.alive.to(torch.int32)))


def trace_step(scene: Scene, rays: RayBatch, det: DetectorState, led: Ledger,
               cfg: TraceConfig, with_aux: bool = True,
               gen: torch.Generator | None = None):
    """One bounce: (reorder,) intersect, shade, measure, (roulette,)
    compact, ledger. `gen` draws the roulette uniforms and is needed only
    when cfg.needs_rng. Returns (rays, det, led, aux); aux is None when
    with_aux is False (the device loop, where the reference's compiler
    drops it as dead code)."""
    require_core(cfg)
    if cfg.cull:
        rays = reorder_rays(scene, rays)
    t, tri = intersect(scene, rays.o, rays.d, cfg, alive=rays.alive)
    sh = shade(scene, rays, t, tri, cfg)
    det = accumulate_detector(det, sh, rays, cfg, tri=tri)
    rr_delta = 0.0
    if cfg.roulette_threshold > 0.0:
        if gen is None:
            raise ValueError("roulette_threshold > 0 requires a generator")
        u = torch.rand(sh.child_power.shape, generator=gen, dtype=_F32,
                       device=sh.child_power.device)
        sh, rr_delta = roulette(sh, cfg, u)
    new_rays, culled = compact(sh, rays.capacity, cfg)
    culled = culled + rr_delta + sh.policy_dropped
    led = Ledger(
        emitted=led.emitted,
        measured=led.measured + torch.sum(sh.measured_power),
        absorbed=led.absorbed + sh.absorbed,
        escaped=led.escaped + sh.escaped,
        culled=led.culled + culled,
    )
    aux = _measured_aux(sh, rays, new_rays) if with_aux else None
    return new_rays, det, led, aux


def trace_loop(scene: Scene, rays: RayBatch, det: DetectorState, led: Ledger,
               cfg: TraceConfig, iterations: int, rng_words=None):
    """The whole fixed-depth trace, one host sync per bounce for the early
    exit: stop once accounted power reaches cfg.dissipation_target of the
    emitted power, compared in float32 as the reference's while_loop does,
    so the bounce count matches. Bounce i draws from
    make_generator(*rng_words, i) (rng_words defaults to (cfg.seed,)).
    Returns (rays, det, led, iterations_run)."""
    words = (cfg.seed,) if rng_words is None else tuple(rng_words)
    target = torch.tensor(cfg.dissipation_target, dtype=_F32,
                          device=led.emitted.device)
    i = 0
    while i < iterations and bool(led.accounted() < target * led.emitted):
        gen = (make_generator(rays.device, *words, i) if cfg.needs_rng
               else None)
        rays, det, led, _ = trace_step(scene, rays, det, led, cfg,
                                       with_aux=False, gen=gen)
        i += 1
    return rays, det, led, i
