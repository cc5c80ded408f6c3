"""Wavelength-resolved tracing: W spectral samples in one trace.

Port counterpart of lightpycl_tpu/spectral.py, in two methods:

  * shared geometry (`trace_spectral`): when the scene's geometry is
    achromatic (no dispersive glass, gratings, polarization optics or
    random scatter), directions do not depend on the wavelength and only
    the power bookkeeping is spectral. One geometry pass carries a (C, W)
    power matrix: intersection and Snell directions once a bounce, the
    thin-film reflectance per wavelength column, the ledger per column
    (`SpectralRays`, `SpectralLedger`, `spectral_step`,
    `trace_spectral_loop`).
  * wavelength-batched (`trace_spectral_dispersive`): every wavelength gets
    a stamped copy of the rays (`spread_rays_over_wavelengths`) and one
    trace of W x C rays runs the full scalar physics (`_dispersive_loop`),
    with a (D, W) spectrum, a per-wavelength ledger and, under
    cfg.coherent, one complex field plane a wavelength.

Every function here is plain torch on the rays' device; the nearest hit of
every bounce is the port's kernel (`ops.intersect`). Where the reference
scatter-adds (`.at[].add`: the per-detector spectra, the wavelength bins,
the white-light planes), the port sums through `step.bincount_sorted`, so a
repeat run gives the same bits on the card. The shared path's top-k is a
stable descending sort, so ties keep the lower slot as jax.lax.top_k does.
The batched path's random draws come from one generator a bounce,
`step.make_generator(device, cfg.seed, bounce)` (shade's uniforms, then
the roulette uniforms), as `step.trace_loop` draws them;
make_generator(device, cfg.seed, ray_rank, bounce) under a mesh.

Both methods shard over the "rays" axis of a torch DeviceMesh
(`trace_spectral_dispersive(mesh=)`, `trace_spectral_multichip`): the
batch is padded to a multiple of the ranks, round-robin interleaved, and
each rank traces its share (parallel/sharding.py); the detector state, the
spectra and the ledger are summed over the axis, and the final rays stay
this rank's shard.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from lightpycl_tpu_torch import physics
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.ops.film_stack import film_stack_reflectance
from lightpycl_tpu_torch.ops.intersect import CullFrame, cull_frame
from lightpycl_tpu_torch.parallel import sharding
from lightpycl_tpu_torch.parallel.distributed import all_reduce_packed, axis
from lightpycl_tpu_torch.tracer import step as step_mod
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene, build_scene

_F32 = torch.float32


class SpectralRays(NamedTuple):
    """Ray geometry shared across wavelengths; power per (ray, wavelength)."""

    o: torch.Tensor        # (C, 3) f32
    d: torch.Tensor        # (C, 3) f32 unit directions
    P: torch.Tensor        # (C, W) f32 power per spectral sample
    ior: torch.Tensor      # (C,) f32 current-medium IOR (achromatic)
    absorb: torch.Tensor   # (C,) f32 current-medium absorption [1/len]
    alive: torch.Tensor    # (C,) bool
    opl: torch.Tensor      # (C,) f32 optical path length, shared by the
    #                        columns (every sample rides the same path)

    @property
    def capacity(self) -> int:
        return self.o.shape[0]

    @staticmethod
    def from_batch(rays: RayBatch, weights) -> "SpectralRays":
        """Spread a RayBatch over W spectral samples: each ray's power is
        split as power * weights (weights (W,), summing to 1 for a straight
        split)."""
        w = torch.as_tensor(weights, dtype=_F32, device=rays.device)
        return SpectralRays(o=rays.o, d=rays.d,
                            P=rays.power[:, None] * w[None, :],
                            ior=rays.ior, absorb=rays.absorb,
                            alive=rays.alive, opl=rays.opl)


class SpectralLedger(NamedTuple):
    """Per-wavelength power ledger (each field (W,)): emitted == measured +
    absorbed + escaped + culled + live, column by column."""

    emitted: torch.Tensor
    measured: torch.Tensor
    absorbed: torch.Tensor
    escaped: torch.Tensor
    culled: torch.Tensor

    def accounted(self):
        return self.measured + self.absorbed + self.escaped + self.culled


def validate_spectral_scene(elements) -> None:
    """Reject scenes whose geometry or physics is wavelength-coupled in a
    way the shared-geometry model cannot represent."""
    for el in elements:
        if (float(getattr(el, "dispersion_b", 0.0)) != 0.0
                or float(getattr(el, "dispersion_c", 0.0)) != 0.0):
            raise ValueError(
                f"spectral tracing needs achromatic geometry; element "
                f"{el.name or el.material} has dispersion_b/_c != 0 "
                "(refraction angles would differ per wavelength — use "
                "per-wavelength scalar traces for dispersive systems)")
        if el.material in (Material.GRATING, Material.POLARIZER,
                           Material.WAVEPLATE, Material.DIFFUSE,
                           Material.BIREFRINGENT):
            raise ValueError(
                f"spectral tracing does not support material "
                f"{Material(el.material).name} (wavelength-dependent "
                "directions / polarization / RNG)")
        if float(getattr(el, "scattering", 0.0)) > 0.0:
            raise ValueError(
                f"shared-geometry spectral tracing cannot draw per-ray "
                f"scatter paths; element {el.name or el.material} has "
                "scattering > 0 (use method='batched' — the dispersive "
                "wavelength-batched path supports turbid media)")
        if float(getattr(el, "grin_a", 0.0)) != 0.0:
            raise ValueError(
                f"shared-geometry spectral tracing cannot advance curved "
                f"GRIN steps; element {el.name or el.material} has a "
                "gradient profile (use method='batched')")
        if float(getattr(el, "fluorescence", 0.0)) > 0.0:
            raise ValueError(
                f"spectral tracing assumes wavelengths are conserved, but "
                f"element {el.name or el.material} fluoresces (conversion "
                "changes the carried wavelength mid-trace, so per-lambda "
                "ledger columns cannot close). Trace scalar: the measured-"
                "ray harvest carries per-ray wavelengths, and "
                "analysis.spectral_power / cie_xyz bin the output spectrum")


def _detector_zeros(scene: Scene, cfg: TraceConfig, n_detectors: int,
                    device) -> DetectorState:
    return DetectorState.zeros(
        cfg.hist_azimuth_bins, cfg.hist_polar_bins, n_detectors,
        cfg.image_bins, n_tris=scene.mat.shape[0] if cfg.flux_map else 0,
        time_bins=cfg.time_bins, device=device)


def spectral_step(scene: Scene, sr: SpectralRays, det: DetectorState,
                  per_det, led: SpectralLedger, wavelengths,
                  cfg: TraceConfig, frame: Optional[CullFrame] = None):
    """One bounce of the wavelength-parallel trace: geometry as `shade`'s
    (the same physics helpers), power (C, W). `det` takes the row-total
    measured power through the scalar binning
    (`accumulate_detector_arrays`); `per_det` (D, W) keeps the full
    per-detector spectra. Rays stay in slot order (the slot order decides
    the top-k ties); only the culled launch runs in octant, then Morton
    order (`step.intersect_bounce` over `frame`)."""
    C, W = sr.P.shape
    _, t, tri = step_mod.intersect_bounce(scene, sr, cfg, frame,
                                          slot_order=True)
    # exact quadric surfaces are deterministic and achromatic: they merge
    # here as in the scalar step
    t, tri, quad_hit = step_mod.merge_analytic(scene, sr.o, sr.d, t, tri,
                                               cfg)
    hit_valid = (tri >= 0) & sr.alive
    safe_tri = torch.clamp_min(tri, 0).long()

    t_draw = torch.where(hit_valid, t, cfg.max_ray_len)
    hit_point = sr.o + t_draw[:, None] * sr.d

    live_P = torch.where(sr.alive[:, None], sr.P, 0.0)
    atten = torch.exp(-sr.absorb * t_draw)[:, None]
    bulk_absorbed = torch.sum(live_P * (1.0 - atten), dim=0)
    live_P = live_P * atten

    attrs = step_mod.gather_hit_attrs(scene, safe_tri, with_optics=False,
                                      with_coatings=cfg.has_coatings)
    if quad_hit is not None:
        # the exact quadric gradient replaces the placeholder facet normal
        use_q, nq = quad_hit
        attrs["normal"] = torch.where(use_q[:, None], nq, attrs["normal"])
    mat = attrs["mat"]
    refl = attrs["reflectivity"]
    sn = physics.snell_interaction(sr.d, attrs["normal"], sr.ior,
                                   attrs["ior"], cfg.ior_env)
    if cfg.has_metals:
        # metal n, k are wavelength-constant per element: R(theta) is
        # shared by the columns
        refl = torch.where(attrs["metal_n"] > 0.0,
                           refl * physics.metal_reflectance(
                               sn["cos_i"], sn["n1"], attrs["metal_n"],
                               attrs["metal_k"]),
                           refl)

    R = sn["R"][:, None].expand(C, W)
    if cfg.has_coatings:
        cn, ch = attrs["coat_ior"], attrs["coat_thickness"]   # (C, L)
        ent = sn["entering"][:, None]
        cn = torch.where(ent, cn, cn.flip(1))
        ch = torch.where(ent, ch, ch.flip(1))
        wl_row = torch.as_tensor(wavelengths, dtype=_F32,
                                 device=sr.o.device)[None, :]  # (1, W)
        # per-ray layer stacks (C, L) against the wavelength row (1, W):
        # one (C, W) reflectance surface, 1 under substrate TIR, the bare
        # Fresnel R where the triangle is uncoated
        R = film_stack_reflectance(sn["cos_i"], sn["n1"], sn["n2"], cn, ch,
                                   wl_row, tir=sn["tir"],
                                   coated=ch.amax(dim=1) > 0.0,
                                   r_fresnel=sn["R"], backend=cfg.backend)

    is_mirror = hit_valid & (mat == int(Material.MIRROR))
    is_refr = hit_valid & (mat == int(Material.REFRACTIVE))
    is_term = hit_valid & (mat == int(Material.TERMINATOR))
    is_meas = hit_valid & (mat == int(Material.MEASURE))
    is_bs = hit_valid & (mat == int(Material.BEAMSPLITTER))
    is_miss = sr.alive & ~hit_valid
    refl_like = is_mirror | is_bs

    pa = torch.where(refl_like[:, None], live_P * refl[:, None],
                     torch.where(is_refr[:, None], live_P * R, 0.0))
    pb = torch.where(is_refr[:, None], live_P * (1.0 - R),
                     torch.where(is_bs[:, None],
                                 live_P * (1.0 - refl[:, None]), 0.0))
    da = sn["refl_dir"]
    db = torch.where(is_bs[:, None], sr.d, sn["refr_dir"])
    b_ior = torch.where(is_bs, sr.ior, sn["new_ior"])
    refr_absorb = torch.where(is_bs, sr.absorb,
                              torch.where(sn["entering"], attrs["absorb"],
                                          0.0))

    measured_P = torch.where(is_meas[:, None], live_P, 0.0)
    did = torch.clamp(attrs["detector_id"], 0, per_det.shape[0] - 1)
    per_det = per_det + step_mod.bincount_sorted(did, measured_P,
                                                 per_det.shape[0])
    # OPL shared by the columns; the row-total power feeds the
    # wavelength-integrated maps (time-of-flight, flux) as in the scalar
    # step
    opl_new = sr.opl + sr.ior * t_draw
    inc = (torch.where(hit_valid, torch.sum(live_P, dim=1), 0.0)
           if cfg.flux_map else None)
    det = step_mod.accumulate_detector_arrays(
        det, hit_point, sr.d, torch.sum(measured_P, dim=1),
        attrs["detector_id"], cfg, opl=opl_new,
        tri=tri if cfg.flux_map else None, incident_power=inc)

    absorbed = (bulk_absorbed
                + torch.sum(torch.where(is_term[:, None], live_P, 0.0), dim=0)
                + torch.sum(torch.where(is_mirror[:, None],
                                        live_P * (1.0 - refl[:, None]), 0.0),
                            dim=0))
    escaped = torch.sum(torch.where(is_miss[:, None], live_P, 0.0), dim=0)

    # children at slots (i, C + i), compacted back to C by row-total power,
    # with the scalar shade's relaunch push (its length folded into the
    # child OPL below)
    push = step_mod._relaunch_push(sr, t_draw)
    child_o = torch.cat([hit_point + push * da, hit_point + push * db])
    child_d = torch.cat([da, db])
    child_P = torch.cat([pa, pb])
    child_ior = torch.cat([sr.ior, b_ior])
    child_ab = torch.cat([sr.absorb, refr_absorb])
    row = torch.sum(child_P, dim=1)
    child_live = row > cfg.power_cutoff
    key = torch.where(child_live, row, -1.0)
    # stable descending sort == jax.lax.top_k's order (ties: lower slot)
    idx = torch.sort(key, descending=True, stable=True).indices[:C]
    sel_live = child_live[idx]
    sel_P = torch.where(sel_live[:, None], child_P[idx], 0.0)
    # per-wavelength culled power: whatever of the 2C children's columns
    # did not survive selection (cutoff rows and top-k overflow)
    culled_cols = torch.sum(child_P, dim=0) - torch.sum(sel_P, dim=0)

    child_opl = torch.cat([opl_new + push[:, 0] * sr.ior,
                           opl_new + push[:, 0] * b_ior])
    new_sr = SpectralRays(o=child_o[idx], d=child_d[idx], P=sel_P,
                          ior=child_ior[idx], absorb=child_ab[idx],
                          alive=sel_live, opl=child_opl[idx])
    led = SpectralLedger(
        emitted=led.emitted,
        measured=led.measured + torch.sum(measured_P, dim=0),
        absorbed=led.absorbed + absorbed,
        escaped=led.escaped + escaped,
        culled=led.culled + culled_cols)
    return new_sr, det, per_det, led


def trace_spectral_loop(scene: Scene, sr: SpectralRays, wavelengths,
                        cfg: TraceConfig, iterations: int, n_detectors: int):
    """`iterations` spectral steps (no early exit, as the reference's
    fixed-depth loop; nothing is read back). Returns (sr, det, per_det
    (D, W), SpectralLedger)."""
    dev = sr.o.device
    W = sr.P.shape[1]
    det = _detector_zeros(scene, cfg, n_detectors, dev)
    per_det = torch.zeros((max(n_detectors, 1), W), dtype=_F32, device=dev)
    z = torch.zeros((W,), dtype=_F32, device=dev)
    led = SpectralLedger(
        emitted=torch.sum(torch.where(sr.alive[:, None], sr.P, 0.0), dim=0),
        measured=z, absorbed=z, escaped=z, culled=z)
    frame = cull_frame(scene) if cfg.cull else None
    for _ in range(iterations):
        sr, det, per_det, led = spectral_step(scene, sr, det, per_det, led,
                                              wavelengths, cfg, frame)
    return sr, det, per_det, led


def spread_rays_over_wavelengths(rays: RayBatch, wavelengths,
                                 weights) -> RayBatch:
    """Flatten the wavelength axis into the ray axis: a (W * C)-slot batch
    whose lane k (slots [k C, (k + 1) C)) is a copy of `rays` stamped with
    wavelengths[k] and carrying weights[k] of each ray's power. The
    dispersive counterpart of SpectralRays.from_batch: refraction angles
    and grating orders resolve per wavelength, at W geometry passes' worth
    of intersection work in one trace."""
    dev = rays.device
    wl = torch.as_tensor(wavelengths, dtype=_F32, device=dev)
    w = torch.as_tensor(weights, dtype=_F32, device=dev)
    W = wl.shape[0]
    C = rays.capacity
    big = RayBatch(*(torch.cat([a] * W) for a in rays))
    return big._replace(power=big.power * torch.repeat_interleave(w, C),
                        wavelength=torch.repeat_interleave(wl, C))


def _wavelength_bins(wl, wl_grid):
    """Index of the nearest grid wavelength of each entry (first on ties,
    as jnp.argmin): exact, since children copy their parent's wavelength."""
    return torch.argmin(torch.abs(wl[:, None] - wl_grid[None, :]), dim=1)


def _dispersive_loop(scene: Scene, rays: RayBatch, wl_grid, cfg: TraceConfig,
                     iterations: int, n_detectors: int,
                     uniforms: Optional[Callable] = None, rng_words=None):
    """Fixed-depth scalar trace of a wavelength-flattened batch with a
    (D, W) per-(detector, wavelength) accumulator. The full scalar physics
    (dispersion, gratings, metals, coatings, polarization); each measured
    ray's column is the nearest grid point to its carried wavelength.

    The loop calls shade / roulette / compact itself instead of
    `trace_step`: the measured-ray harvest there would dominate at W x C
    slots. Bounce i draws from make_generator(device, *rng_words, i)
    (rng_words defaults to (cfg.seed,)), as `step.trace_loop` does:
    shade's uniforms, then the roulette uniforms; `uniforms(i)` ->
    (ShadeUniforms, roulette uniforms) injects them instead (tests feeding
    the reference's own draws).

    Returns (rays, det, per_dw, led_w, amp_w): led_w is a PER-WAVELENGTH
    Ledger of (W,) columns, conserving emitted[w] == measured[w] +
    absorbed[w] + escaped[w] + culled[w] + live_final[w]. measured /
    escaped / dropped bin by the parent's carried wavelength; absorbed[w]
    is the per-column residual of shade's power flow (live_in - measured -
    escaped - dropped - children); culled[w] = children[w] -
    live_after_compaction[w] + dropped[w]. amp_w is the (W, 2, nb, nb)
    per-wavelength field planes under cfg.coherent (each wavelength
    interferes only with itself), else a (1,) zero."""
    dev = rays.device
    D = max(n_detectors, 1)
    W = wl_grid.shape[0]
    C = rays.capacity
    det = _detector_zeros(scene, cfg, D, dev)
    per_dw = torch.zeros((D, W), dtype=_F32, device=dev)
    spectral_coherent = cfg.coherent and cfg.image_bins > 0
    nb = cfg.image_bins
    n_pix = nb * nb + 1  # the last slot takes off-grid hits
    amp_w = (torch.zeros((W, 2, n_pix), dtype=_F32, device=dev)
             if spectral_coherent else torch.zeros((1,), dtype=_F32,
                                                   device=dev))
    # different wavelengths do not interfere: the scalar accumulator's
    # coherent plane is off, the per-wavelength planes are the output
    cfg_det = cfg.replace(coherent=False) if spectral_coherent else cfg
    shade_rng = (cfg.has_diffuse or cfg.has_scattering
                 or cfg.has_fluorescence or cfg.has_roughness)

    def live_power(r):
        return torch.where(r.alive, r.power, 0.0)

    def bin_by(wl, power):
        return step_mod.bincount_sorted(_wavelength_bins(wl, wl_grid), power,
                                        W)

    words = (cfg.seed,) if rng_words is None else tuple(rng_words)
    z = torch.zeros((W,), dtype=_F32, device=dev)
    led_w = Ledger(emitted=bin_by(rays.wavelength, live_power(rays)),
                   measured=z, absorbed=z, escaped=z, culled=z)
    frame = cull_frame(scene) if cfg.cull else None
    for i in range(iterations):
        gen = None
        if uniforms is not None:
            un, rr_u = uniforms(i)
        else:
            if cfg.needs_rng:
                gen = step_mod.make_generator(dev, *words, i)
            un = (step_mod.draw_shade_uniforms(cfg, C, gen, dev)
                  if shade_rng else None)
            rr_u = None
        rays, t, tri = step_mod.intersect_bounce(scene, rays, cfg, frame)
        t, tri, attrs = step_mod.merge_analytic_attrs(scene, rays, t, tri,
                                                      cfg)
        sh = step_mod.shade(scene, rays, t, tri, cfg, attrs=attrs,
                            uniforms=un)
        det = step_mod.accumulate_detector(det, sh, rays, cfg_det, tri=tri)
        # the parent's carried wavelength picks the column; one sort bins
        # the four parent columns together
        wl_idx = _wavelength_bins(rays.wavelength, wl_grid)
        before, m_w, e_w, d_w = step_mod.bincount_sorted(
            wl_idx, torch.stack([live_power(rays), sh.measured_power,
                                 sh.escaped_power, sh.dropped_power], dim=1),
            W).unbind(1)
        did = torch.clamp(sh.det_id, 0, D - 1).long()
        per_dw = per_dw + step_mod.bincount_sorted(
            did * W + wl_idx, sh.measured_power, D * W).reshape(D, W)
        if spectral_coherent:
            flat = step_mod.image_flat_indices(sh.hit_point, cfg)
            re, im = step_mod.coherent_amplitudes(
                sh.measured_power, sh.child_opl[:C], rays.wavelength)
            amp_w = amp_w + step_mod.bincount_sorted(
                wl_idx * n_pix + flat, torch.stack([re, im], dim=1),
                W * n_pix).reshape(W, n_pix, 2).transpose(1, 2)
        # children binned BEFORE roulette / compaction, so the cull column
        # takes everything dropped after shade
        c_w = bin_by(sh.child_wavelength,
                     torch.where(sh.child_alive, sh.child_power, 0.0))
        if cfg.roulette_threshold > 0.0:
            if rr_u is None:
                if gen is None:
                    raise ValueError("roulette_threshold > 0 with injected "
                                     "uniforms needs their roulette draws")
                rr_u = torch.rand(sh.child_power.shape, generator=gen,
                                  dtype=_F32, device=dev)
            sh, _ = step_mod.roulette(sh, cfg, rr_u)
        # one global top-k over all 2 W C children (under adequate headroom
        # nothing is culled and a per-wavelength top-k would be the same)
        rays, _ = step_mod.compact(sh, C, cfg)
        after = bin_by(rays.wavelength, live_power(rays))
        led_w = Ledger(
            emitted=led_w.emitted,
            measured=led_w.measured + m_w,
            absorbed=led_w.absorbed + (before - m_w - e_w - d_w - c_w),
            escaped=led_w.escaped + e_w,
            culled=led_w.culled + (c_w - after) + d_w)
    if spectral_coherent:
        # drop the off-grid slot: (W, 2, nb, nb)
        amp_w = amp_w[:, :, :nb * nb].reshape(W, 2, nb, nb)
    return rays, det, per_dw, led_w, amp_w


def _element_flags(elements):
    """The material flags both methods set from the elements alone."""
    return dict(
        has_coatings=any(e.coating_layers() for e in elements
                         if hasattr(e, "coating_layers")),
        has_metals=any(getattr(e, "metal_n", 0.0) > 0.0 for e in elements),
        has_analytic=any(getattr(e, "quad_abgd", None) is not None
                         for e in elements))


def _default_weights(wl):
    return torch.full((wl.shape[0],), 1.0 / wl.shape[0], dtype=_F32,
                      device=wl.device)


def trace_spectral_dispersive(elements, rays: RayBatch, wavelengths,
                              weights=None, cfg: TraceConfig | None = None,
                              iterations: int = 8, mesh=None,
                              uniforms: Optional[Callable] = None):
    """Wavelength-BATCHED trace for dispersive scenes (Cauchy glass,
    gratings: everything the shared-geometry model rejects). The W
    wavelengths each get a stamped copy of the batch and one trace of
    W x C rays runs them together on the rays' device.

    Returns (per_det (D, W), Ledger (total power), detector_names, final
    RayBatch, DetectorState, per-wavelength Ledger of (W,) columns whose
    column sums are the total Ledger, and the (W, 2, nb, nb)
    per-wavelength coherent field planes when cfg.coherent). `uniforms`:
    see `_dispersive_loop`.

    `mesh` (a 1-D torch DeviceMesh) shards the flattened batch over its
    "rays" axis, round-robin interleaved like every sharded path; the
    DetectorState, spectra, field planes and ledger are summed over the
    axis, and the final RayBatch is this rank's shard."""
    cfg = (cfg or TraceConfig()).replace(
        has_gratings=any(e.material == Material.GRATING for e in elements),
        has_diffuse=any(e.material == Material.DIFFUSE for e in elements),
        **_element_flags(elements))
    if any(e.material in (Material.POLARIZER, Material.WAVEPLATE)
           for e in elements) and not cfg.polarization:
        raise ValueError("polarizer/waveplate elements need "
                         "TraceConfig(polarization=True)")
    scene, det_names = build_scene(elements, spatial_sort=cfg.cull,
                                   device=rays.device)
    wl = torch.as_tensor(wavelengths, dtype=_F32, device=rays.device)
    if weights is None:
        weights = _default_weights(wl)
    big = spread_rays_over_wavelengths(rays, wl, weights)
    rng_words = None
    if mesh is not None:
        n, r, group = axis(mesh, sharding.RAY_AXIS)
        big = sharding.shard_rays(sharding.padded_for(big, n), mesh)
        rng_words = (cfg.seed, r)
    rays_out, det, per_dw, led_w, amp_w = _dispersive_loop(
        scene, big, wl, cfg, iterations, len(det_names), uniforms=uniforms,
        rng_words=rng_words)
    if mesh is not None:
        det, led_w = sharding.reduce_state(det, led_w, group)
        per_dw, amp_w = all_reduce_packed([per_dw, amp_w], group)
    led = Ledger(*(torch.sum(x) for x in led_w))
    return per_dw, led, det_names, rays_out, det, led_w, amp_w


def _resolve_spectral(elements, cfg, wavelengths, weights, device):
    """The shared path's set-up: validate the scene, set every material
    flag from the elements, build the scene on `device`, default the
    weights."""
    validate_spectral_scene(elements)
    cfg = (cfg or TraceConfig()).replace(
        has_gratings=False, polarization=False, has_diffuse=False,
        **_element_flags(elements))
    scene, det_names = build_scene(elements, spatial_sort=cfg.cull,
                                   device=device)
    wl = torch.as_tensor(wavelengths, dtype=_F32, device=device)
    if weights is None:
        weights = _default_weights(wl)
    return cfg, scene, det_names, wl, weights


def trace_spectral(elements, rays: RayBatch, wavelengths, weights=None,
                   cfg: TraceConfig | None = None, iterations: int = 8):
    """Trace one geometry pass carrying W spectral samples per ray, on the
    rays' device.

    elements: GeoObjects (validated achromatic); rays: a RayBatch whose
    per-ray power is split over `wavelengths` (um) by `weights` (default
    uniform). Returns (per_detector (D, W), SpectralLedger, detector_names,
    final SpectralRays, DetectorState); the DetectorState holds the angular
    histogram, per-detector row totals and planar image of the row-total
    measured power, binned as the scalar engine bins it."""
    cfg, scene, det_names, wl, weights = _resolve_spectral(
        elements, cfg, wavelengths, weights, rays.device)
    sr = SpectralRays.from_batch(rays, weights)
    sr, det, per_det, led = trace_spectral_loop(scene, sr, wl, cfg,
                                                iterations, len(det_names))
    return per_det, led, det_names, sr, det


def trace_spectral_multichip(elements, rays: RayBatch, wavelengths,
                             weights=None, cfg: TraceConfig | None = None,
                             iterations: int = 8, mesh=None):
    """Spectral trace SPMD over a 1-D "rays" mesh (default every rank of
    the process group): every rank passes the same rays, keeps its
    round-robin share (capacity padded to a multiple of the ranks) and
    runs the wavelength-parallel loop on it; the (D, W) per-detector
    spectra, the DetectorState and the per-wavelength ledger are summed
    over the axis. The sharded twin of trace_spectral with the same return
    contract; the final SpectralRays are this rank's shard."""
    cfg, scene, det_names, wl, weights = _resolve_spectral(
        elements, cfg, wavelengths, weights, rays.device)
    if mesh is None:
        mesh = sharding.make_ray_mesh(device=rays.device)
    n, _, group = axis(mesh, sharding.RAY_AXIS)
    rays = sharding.shard_rays(sharding.padded_for(rays, n), mesh)
    sr = SpectralRays.from_batch(rays, weights)
    sr, det, per_det, led = trace_spectral_loop(scene, sr, wl, cfg,
                                                iterations, len(det_names))
    det, led = sharding.reduce_state(det, led, group)
    per_det, = all_reduce_packed([per_det], group)
    return per_det, led, det_names, sr, det
