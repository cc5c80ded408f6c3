"""The trace step: (reorder,) intersect -> shade/split -> measure -> compact.

Port counterpart of lightpycl_tpu/tracer/step.py. Shapes are static as in
the reference: C = ray capacity, children land in 2C slots (reflected child
of ray i at slot i, refracted at C + i), compaction keeps C of them and
books the rest as 'culled' so the conservation ledger stays exact.

What is here: `morton_order` / `reorder_rays`, `gather_hit_attrs` /
`default_hit_attrs` (base and optional columns), `nearest_t_rows`,
`_relaunch_push`, `_shade_birefringent` and the whole of `shade`
(Beer-Lambert attenuation, Cauchy dispersion, mirror / refractive /
terminator / measure / beamsplitter materials, complex-index metals,
thin-film coatings, reflection gratings, the Stokes-Mueller path with
polarizers, waveplates and uniaxial crystals, Lambertian and rough-mirror
scatter, volume scattering and fluorescence, gradient-index propagation
with its sub-step loop, path signatures, the split and no-split child
layouts), `merge_analytic` (exact quadric hits, ops/quadric.py),
`accumulate_detector(_arrays)` with `image_flat_indices` and the optional
maps (coherent field, time-of-flight histogram, per-facet flux), Russian
`roulette`, `compact` (no-split, 'topk', 'stream'), `trace_step` (its
second half, from shade on, is `finish_step`, which the triangle-sharded
trace calls after its own sharded intersect) with the measured-ray front
compaction, and the device loop.

Determinism: the detector scatter-adds are a sort-based segmented sum with
a fixed association (`bincount_sorted`, no float atomics), so the same
inputs give the same bits; top-k is a stable descending sort, so ties keep
the lower slot first as jax.lax.top_k does. Random draws come from one
torch.Generator per bounce, seeded from (cfg.seed[, batch], bounce) as the
reference folds the bounce index into its key (`make_generator`), and are
drawn in a fixed order: the streams of `draw_shade_uniforms` (free path,
event kind, emission quantile, scatter direction, Lambertian direction,
rough lobe; only those the cfg turns on), then the roulette uniforms. So a
repeat, and a batched run resumed from a checkpoint, see the same numbers.
`shade` and `roulette` take their uniforms as arguments; torch's streams
are not JAX's, so the tests feed them JAX's own draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from lightpycl_tpu_torch import physics
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.ops.film_stack import film_stack_reflectance
from lightpycl_tpu_torch.ops.intersect import intersect, nearest_hit
from lightpycl_tpu_torch.ops.quadric import intersect_quadrics
from lightpycl_tpu_torch.sources import _frame
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import (DetectorState, Ledger, RayBatch,
                                             norm3)
from lightpycl_tpu_torch.tracer.scene import Scene
from lightpycl_tpu_torch.utils.profiling import count, enabled, span

_F32 = torch.float32


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

_MORTON_MAX = (1 << 20) - 1  # 20 bits a axis: see morton_order
_MORTON_DEAD = 1 << 62  # above every live code (< 2**60)


def _spread3(x):
    """Spread 20 bits to every 3rd bit of an int64 (Morton encoding
    helper). 20, not the reference's 10: a batch much denser than the
    scene box's 10-bit cells would leave each ray block scattered over a
    cell (morton_order)."""
    x = (x | (x << 32)) & 0x001F00000000FFFF
    x = (x | (x << 16)) & 0x001F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def morton_order(o, alive, lo, hi):
    """Stable permutation sorting rays by the Morton code of their origins
    (20 bits/axis over [lo, hi], a 60-bit code in int64); dead rays sort to
    the end, live ties keep their slot order.

    The reference quantises to 10 bits a axis. Over a scene box much wider
    than the beam (a 3.5-wide beam under a radius-100 dome: cells 0.2
    across) thousands of rays share a 10-bit code, the stable sort leaves
    them in sampling order, and every 256-ray block spans a whole cell, so
    the cull mask keeps every tile such a block could reach. At 20 bits a
    cell holds far fewer rays than a block, and a block is a tight patch:
    on config 4's 4M-ray batches the mask keeps 2.1% and 5.3% of the
    (block, tile) pairs at the two bounces, against 3.8% and 7.9% at 10
    bits. The code's top 30 bits order cells as the 10-bit code does (up
    to the rounding of the two quantisations), so this order refines the
    reference's."""
    span = torch.clamp_min(hi - lo, 1e-20)
    top = float(_MORTON_MAX)
    q = torch.clamp((o - lo) / span * top, 0.0, top).to(torch.int64)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))
    code = torch.where(alive, code, _MORTON_DEAD)
    return torch.argsort(code, stable=True)


def morton_permutation(scene: Scene, rays) -> torch.Tensor:
    """The slot permutation `reorder_rays` applies: Morton order of the
    origins over the box of the scene's valid triangles (padding rows
    would stretch the box to include the origin). `rays`: anything with
    `o` and `alive` (a RayBatch, spectral.SpectralRays)."""
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


class ShadeUniforms(NamedTuple):
    """The unit uniforms one `shade` call consumes, one field per stream of
    the reference (the constant it folds into the bounce key in brackets).
    A field is None when the cfg never reads it."""

    free_path: Optional[torch.Tensor] = None    # (C,) in [1e-7, 1) [0x5CA7]
    event_kind: Optional[torch.Tensor] = None   # (C,)   [0x5CA9]
    emission: Optional[torch.Tensor] = None     # (C,)   [0x5CAA]
    scatter_dir: Optional[torch.Tensor] = None  # (C, 2) [0x5CA8]
    lambertian: Optional[torch.Tensor] = None   # (C, 2) [0x5D1F]
    rough_lobe: Optional[torch.Tensor] = None   # (C, 2) [0x70F5]


def draw_shade_uniforms(cfg: TraceConfig, capacity: int,
                        gen: torch.Generator, device) -> ShadeUniforms:
    """Draw the streams cfg turns on from `gen`, in the fixed order of the
    ShadeUniforms fields (a stream that is off draws nothing). Pure device
    work: no host sync."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=_F32, device=device)

    C = capacity
    u = {}
    if cfg.has_scattering or cfg.has_fluorescence:
        # free paths take -log(u): keep u off zero, as the reference's
        # uniform(minval=1e-7) does
        u["free_path"] = torch.clamp_min(
            rand(C) * (1.0 - 1e-7) + 1e-7, 1e-7)
        if cfg.has_fluorescence:
            u["event_kind"] = rand(C)
            u["emission"] = rand(C)
        u["scatter_dir"] = rand(C, 2)
    if cfg.has_diffuse:
        u["lambertian"] = rand(C, 2)
    if cfg.has_roughness:
        u["rough_lobe"] = rand(C, 2)
    return ShadeUniforms(**u)


def gather_hit_attrs(scene: Scene, safe_tri, with_optics: bool = True,
                     with_coatings: bool = True, with_bire=None,
                     with_scatter=None, with_rough=None):
    """Per-hit triangle attributes (the gathers shade needs): the base
    columns, then the optional ones. `with_optics` adds the polarizer /
    waveplate / grating columns (axis, retardance, m / period, order-0
    fraction), `with_coatings` the film stacks; `with_bire`, `with_scatter`
    and `with_rough` (None = the scene carries the column) add the
    extraordinary index, the bulk (scat_mu, scat_g) pair and the
    (rough_sigma, rough_g) pair. The Cauchy C column rides along whenever
    the scene has it."""
    if with_bire is None:
        with_bire = scene.bire_ne is not None
    if with_scatter is None:
        with_scatter = scene.scat_mu is not None
    if with_rough is None:
        with_rough = scene.rough_sigma is not None
    idx = safe_tri.long()
    out = {
        "mat": scene.mat[idx],
        "normal": scene.normal[idx],
        "ior": scene.ior[idx],
        "ior_b": scene.ior_b[idx],
        "reflectivity": scene.reflectivity[idx],
        "detector_id": scene.detector_id[idx],
        "absorb": scene.absorb[idx],
        "metal_n": scene.metal_n[idx],
        "metal_k": scene.metal_k[idx],
    }
    if with_optics:
        out["axis"] = scene.axis[idx]
        out["retardance"] = scene.retardance[idx]
        out["grating_mlp"] = scene.grating_mlp[idx]
        out["grating_g0"] = scene.grating_g0[idx]
    if with_bire:
        out["bire_ne"] = scene.bire_ne[idx]
    if with_scatter:
        out["scat_mu"] = scene.scat_mu[idx]
        out["scat_g"] = scene.scat_g[idx]
    if with_rough:
        out["rough_sigma"] = scene.rough_sigma[idx]
        out["rough_g"] = scene.rough_g[idx]
    if scene.ior_c is not None:
        out["ior_c"] = scene.ior_c[idx]
    if with_coatings:
        out["coat_ior"] = scene.coat_ior[idx]              # (C, L)
        out["coat_thickness"] = scene.coat_thickness[idx]  # (C, L)
    return out


def default_hit_attrs(scene: Scene, safe_tri, cfg: TraceConfig):
    """The cfg-gated gather shade performs when no attrs override is
    given; trace_step's analytic-surface merge builds the identical
    attribute set through it."""
    return gather_hit_attrs(
        scene, safe_tri,
        with_optics=cfg.polarization or cfg.has_gratings,
        with_coatings=cfg.has_coatings,
        with_bire=(cfg.has_birefringence and cfg.polarization
                   and scene.bire_ne is not None),
        with_scatter=cfg.has_scattering and scene.scat_mu is not None,
        with_rough=cfg.has_roughness and scene.rough_sigma is not None)


def nearest_t_rows(o, d, wu, wv, ww, cfg: TraceConfig):
    """Nearest-hit distance of C rays against a compact set of
    unit-transform rows (no triangle ids): the GRIN sub-step path's
    own-surface check (TraceConfig.grin_substeps). The nearest hit of
    `ops.intersect` on cfg.backend (the kernel on the card, the plain
    version on the CPU or under backend='torch'), with the full
    intersect's predicate and eps, so step decisions match it exactly; no
    cull mask (the rows are few, so the plain version's ray blocks are
    wide)."""
    block = max(4096, (1 << 23) // max(int(wu.shape[0]), 1))
    return nearest_hit(o.contiguous(), d.contiguous(), wu, wv, ww, cfg.eps,
                       cfg.eps_bary, cfg.max_ray_len, backend=cfg.backend,
                       ray_block=block)[0]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _unit_rows(v):
    """v (C, 3) over its length, the length clamped at 1e-20."""
    return v / torch.clamp_min(norm3(v)[:, None], 1e-20)


def _shade_birefringent(scene, rays, sn, attrs, live_p, s_dir, hit_valid,
                        cfg):
    """Per-lane quantities for BIREFRINGENT (uniaxial crystal) hits, as the
    reference models them:

      * entry (outside -> crystal): the incident Stokes state projects onto
        the crystal's two eigenmodes (Malus decomposition); slot A carries
        the ordinary child (Snell refraction with n_o: `sn` already holds
        it, the element's `ior` being n_o), slot B the extraordinary child
        (tangential matching on the e normal surface plus Poynting
        walk-off). Each child pays the Fresnel transmittance of its
        eigenmode; the externally reflected share is booked as absorbed.
      * exit (crystal -> ambient): slot A is the transmitted child (o:
        Snell via sn; e: Snell applied to the recovered wave normal), slot
        B the internally reflected same-mode child, so TIR falls out with
        R = 1.

    The e-ray's carried `ior` is its OPL-effective ray index n(theta_k)
    cos(rho); exit lanes re-identify the mode by |ior - n_o|. Children are
    fully polarized (s1 = 1) in their eigenframe basis."""
    d = rays.d
    n = sn["n"]                      # oriented against the ray
    entering = sn["entering"]
    n1 = sn["n1"]
    cos_i = sn["cos_i"]
    n_o = attrs["ior"]
    n_e = attrs["bire_ne"]
    c_axis = attrs["axis"]
    mat = attrs["mat"]
    is_bire = hit_valid & (mat == int(Material.BIREFRINGENT))
    safe_ne = torch.where(n_e > 0.0, n_e, 1.0)   # non-bire lanes: inert math
    safe_no = torch.clamp_min(n_o, 1e-6)

    def _perp(v, ref):
        """Component of v perpendicular to unit ref, normalized; falls
        back to an orthonormal tangent of ref when degenerate."""
        p = v - physics.dot(v, ref)[:, None] * ref
        p2 = torch.sum(p * p, dim=1, keepdim=True)
        fb, _ = physics.orthonormal_basis(ref)
        return torch.where(p2 > 1e-12,
                           p / torch.sqrt(torch.clamp_min(p2, 1e-20)), fb)

    def _eigen_T(cos_t, n_in, n_out, w_s, tir):
        """Fresnel power transmittance of an eigenmode whose polarization
        has fraction w_s along the incidence s-direction."""
        rs, rp, _, _ = physics.fresnel_amplitudes(cos_i, cos_t, n_in, n_out)
        T = w_s * (1.0 - rs * rs) + (1.0 - w_s) * (1.0 - rp * rp)
        return torch.where(tir, 0.0, torch.clamp(T, 0.0, 1.0))

    # ---- entry ------------------------------------------------------------
    into = -n
    kt = n1[:, None] * (d - physics.dot(d, n)[:, None] * n)
    # ordinary wave: sn's dielectric quantities are the o-wave
    k_o = sn["refr_dir"]
    cxk = _cross(c_axis, k_o)
    o_hat = physics.normalize(cxk)
    o_ok = torch.sum(cxk ** 2, dim=1) > 1e-12
    o_hat = torch.where(o_ok[:, None], o_hat, s_dir)
    # Malus projection of the incident Stokes state onto the o eigenmode
    o_perp = _perp(o_hat, d)
    cos_b = physics.dot(rays.basis, o_perp)
    sin_b = physics.dot(_cross(rays.basis, o_perp), d)
    b1, _ = physics.rotate_stokes(rays.s1, rays.s2, cos_b, sin_b)
    f_o = 0.5 * (1.0 + b1)
    w_s_o = physics.dot(o_perp, s_dir) ** 2
    T_o = _eigen_T(sn["cos_t"], n1, safe_no, w_s_o, sn["tir"])
    # extraordinary wave: tangential matching on the e normal surface
    K_e, e_prop = physics.uniaxial_refract_wave(kt, into, c_axis,
                                                safe_no, safe_ne)
    s_e, n_ray_e = physics.uniaxial_ray_direction(K_e, c_axis,
                                                  safe_no, safe_ne)
    n_wave_e = torch.sqrt(torch.clamp_min(physics.dot(K_e, K_e), 1e-12))
    cos_t_e = torch.clamp(physics.dot(K_e, into) / n_wave_e, 0.0, 1.0)
    e_in_perp = _perp(c_axis, d)     # e-pol: principal-plane component
    w_s_e = physics.dot(e_in_perp, s_dir) ** 2
    T_e = _eigen_T(cos_t_e, n1, n_wave_e, w_s_e, ~e_prop)
    pa_in = live_p * f_o * T_o
    pb_in = live_p * (1.0 - f_o) * T_e
    basis_a_in = _perp(o_hat, k_o)
    basis_b_in = _perp(c_axis, s_e)

    # ---- exit -------------------------------------------------------------
    is_e = torch.abs(rays.ior - n_o) > 1e-4
    # e-mode: recover the wave normal from the ray direction
    k_in_hat, n_wave_x = physics.uniaxial_wave_from_ray(d, c_axis,
                                                        safe_no, safe_ne)
    K_in = n_wave_x[:, None] * k_in_hat
    kt_x = K_in - physics.dot(K_in, n)[:, None] * n
    n_out = sn["n2"]                 # ambient on exit lanes
    kt2_x = physics.dot(kt_x, kt_x)
    tir_e = kt2_x > n_out * n_out
    qpos = n_out * n_out - kt2_x
    q_out = torch.where(qpos > 0.0,
                        torch.sqrt(torch.where(qpos > 0.0, qpos, 1.0)), 0.0)
    d_out_e = ((kt_x + q_out[:, None] * (-n))
               / torch.clamp_min(n_out, 1e-6)[:, None])
    d_out_e = physics.normalize(d_out_e)
    cos_iw = torch.clamp(-physics.dot(k_in_hat, n), 1e-6, 1.0)
    cos_tw = torch.clamp(q_out / torch.clamp_min(n_out, 1e-6), 0.0, 1.0)
    e_x_perp = _perp(c_axis, d)
    w_s_xe = physics.dot(e_x_perp, s_dir) ** 2
    rs_e, rp_e, _, _ = physics.fresnel_amplitudes(cos_iw, cos_tw,
                                                  n_wave_x, n_out)
    T_xe = torch.where(tir_e, 0.0, torch.clamp(
        w_s_xe * (1.0 - rs_e * rs_e) + (1.0 - w_s_xe) * (1.0 - rp_e * rp_e),
        0.0, 1.0))
    # o-mode exit: sn quantities are exact (n1 = rays.ior = n_o)
    cxd = _cross(c_axis, d)
    o_x_hat = physics.normalize(cxd)
    o_x_ok = torch.sum(cxd ** 2, dim=1) > 1e-12
    o_x_hat = torch.where(o_x_ok[:, None], o_x_hat, s_dir)
    w_s_xo = physics.dot(_perp(o_x_hat, d), s_dir) ** 2
    T_xo = _eigen_T(sn["cos_t"], n1, n_out, w_s_xo, sn["tir"])
    T_x = torch.where(is_e, T_xe, T_xo)
    d_out = torch.where(is_e[:, None], d_out_e, sn["refr_dir"])
    # internally reflected same-mode child (slot B): o mirrors exactly; e
    # re-solves the dispersion relation going back into the crystal
    K_r, _ = physics.uniaxial_refract_wave(kt_x, n, c_axis, safe_no, safe_ne)
    s_r, n_ray_r = physics.uniaxial_ray_direction(K_r, c_axis,
                                                  safe_no, safe_ne)
    d_refl = torch.where(is_e[:, None], s_r, sn["refl_dir"])
    b_ior_x = torch.where(is_e, n_ray_r, rays.ior)
    pa_x = live_p * T_x
    pb_x = live_p * (1.0 - T_x)
    eig_x = torch.where(is_e[:, None], _perp(c_axis, d), o_x_hat)
    basis_a_x = _perp(eig_x, d_out)
    basis_b_x = _perp(eig_x, d_refl)

    # ---- merge entry / exit -----------------------------------------------
    ent = entering
    entc = ent[:, None]
    return {
        "is_bire": is_bire,
        "pa": torch.where(ent, pa_in, pa_x),
        "da": torch.where(entc, k_o, d_out),
        "a_ior": torch.where(ent, safe_no, n_out),
        "a_absorb": torch.where(ent, attrs["absorb"], 0.0),
        "a_basis": torch.where(entc, basis_a_in, basis_a_x),
        "pb": torch.where(ent, pb_in, pb_x),
        "db": torch.where(entc, s_e, d_refl),
        "b_ior": torch.where(ent, n_ray_e, b_ior_x),
        "b_absorb": torch.where(ent, attrs["absorb"], rays.absorb),
        "b_basis": torch.where(entc, basis_b_in, basis_b_x),
        # entry: the externally reflected share is absorbed; exit:
        # pa + pb == live_p exactly
        "absorbed": torch.sum(torch.where(
            is_bire & ent, live_p - (pa_in + pb_in), 0.0)),
    }


def _relaunch_push(rays: RayBatch, t_draw):
    """Scale-proportional nudge (C, 1) moving a child's origin off its
    parent's facet along the outgoing direction: 1e-6 * (|o| + t), ~8x the
    worst-case f32 rounding of the hit point (see the reference)."""
    return (1e-6 * (norm3(rays.o) + t_draw))[:, None]


def _need(u, what: str):
    if u is None:
        raise ValueError(f"{what} requires unit uniforms "
                         "(trace_step gen=... / shade uniforms=...)")
    return u


def shade(scene: Scene, rays: RayBatch, t, tri, cfg: TraceConfig,
          attrs=None, uniforms: Optional[ShadeUniforms] = None) -> ShadeOut:
    """Surface (and volume) interaction at the nearest hit, branchless:
    every ray computes all material outcomes; masks select. `attrs`
    overrides the per-hit triangle gathers (exact quadric normals).
    `uniforms` holds the unit uniforms of the random branches
    (`draw_shade_uniforms`); required iff cfg turns one of them on."""
    un = uniforms if uniforms is not None else ShadeUniforms()
    hit_valid = (tri >= 0) & rays.alive
    safe_tri = torch.clamp_min(tri, 0).long()
    live_p = torch.where(rays.alive, rays.power, 0.0)

    t_draw = torch.where(hit_valid, t, cfg.max_ray_len)
    has_volume = cfg.has_scattering or cfg.has_fluorescence
    if has_volume:
        # volume events: rays inside a turbid and/or fluorescent medium
        # draw a free path ~ Exp(mu), mu = mu_s (elastic, rays.scat) + mu_f
        # (conversion, from the table of the ray's current medium, active
        # only below the band edge); a path shorter than the surface
        # distance means the ray interacts mid-flight: clamp the segment to
        # the event point and drop the lane from every surface mask
        u_free = _need(un.free_path,
                       "cfg.has_scattering/has_fluorescence")
        if cfg.has_fluorescence and scene.fluor_mu is not None:
            mid = torch.clamp(rays.medium.to(torch.int32), 0,
                              scene.fluor_mu.shape[0] - 1).long()
            f_mu = torch.where(
                (rays.medium >= 0.0)
                & (rays.wavelength < scene.fluor_edge[mid]),
                scene.fluor_mu[mid], 0.0)
        else:
            f_mu = None
        mu_evt = rays.scat if f_mu is None else rays.scat + f_mu
        s_free = -torch.log(u_free) / torch.clamp_min(mu_evt, 1e-20)
        is_scat = rays.alive & (mu_evt > 0.0) & (s_free < t_draw)
        t_draw = torch.where(is_scat, s_free, t_draw)
        hit_valid = hit_valid & ~is_scat
        if f_mu is not None:
            # event kind: conversion with prob mu_f / mu_evt, else elastic
            u_kind = _need(un.event_kind, "cfg.has_fluorescence")
            is_fluor = is_scat & (u_kind * mu_evt < f_mu)
            # emission wavelength: linear interpolation of the medium's
            # inverse-CDF knots at a uniform quantile
            K_em = scene.fluor_icdf.shape[1]
            x_em = _need(un.emission, "cfg.has_fluorescence") * (K_em - 1)
            i_em = torch.clamp(x_em.to(torch.int32), 0, K_em - 2)
            fr_em = x_em - i_em.to(_F32)
            row = scene.fluor_icdf[mid]
            i_em = i_em.long()
            lam_lo = torch.gather(row, 1, i_em[:, None])[:, 0]
            lam_hi = torch.gather(row, 1, (i_em + 1)[:, None])[:, 0]
            lam_em = torch.clamp_min(
                lam_lo * (1.0 - fr_em) + lam_hi * fr_em, 1e-6)
            # power factor: quantum yield x Stokes-shift photon-energy
            # ratio (capped at 1: anti-Stokes tails cannot create power)
            f_factor = scene.fluor_qy[mid] * torch.clamp_max(
                rays.wavelength / lam_em, 1.0)
            g_draw = torch.where(is_fluor, 0.0, rays.scat_g)  # isotropic
        else:
            is_fluor = None
            g_draw = rays.scat_g
        d_scat = physics.sample_henyey_greenstein(
            _need(un.scatter_dir, "cfg.has_scattering/has_fluorescence"),
            rays.d, g_draw)
    else:
        is_scat = is_fluor = None
        d_scat = rays.d
    if cfg.has_grin and scene.grin_a is not None:
        # gradient-index propagation: rays inside a GRIN medium advance by
        # curved steps of cfg.grin_step arc length through the closed-form
        # SELFOC propagator. Farther than one step from the surface: clamp
        # the segment and drop the lane from every surface mask (the
        # continuation rides slot A, deterministically). The last sub-step
        # segment reaches the surface on the straight chord the intersect
        # found, with direction and OPL still curve-integrated over it, so
        # exit Snell sees the curved direction and the local index
        E_g = scene.grin_a.shape[0]
        gmid = torch.clamp(rays.medium.to(torch.int32), 0, E_g - 1).long()
        g_a = torch.where(rays.medium >= 0.0, scene.grin_a[gmid], 0.0)
        in_grin = rays.alive & (g_a != 0.0)
        is_gstep = in_grin & (t_draw > cfg.grin_step)
        t_draw = torch.where(is_gstep, cfg.grin_step, t_draw)
        hit_valid = hit_valid & ~is_gstep
        gc_l = scene.grin_center[gmid]
        gx_l = scene.grin_axis[gmid]
        gn0_l = scene.grin_n0[gmid]
        r_g, d_g, n_g, opl_g = physics.grin_selfoc_step(
            rays.o, rays.d, t_draw, gc_l, gx_l, gn0_l, g_a)

        def transported(bas, d0, d1):
            # Levi-Civita transport of the polarization frame along the
            # curved step, re-orthogonalized against the new direction;
            # Stokes fractions are untouched
            b = physics.parallel_transport(bas, d0, d1)
            b = b - physics.dot(b, d1)[:, None] * d1
            return _unit_rows(b)

        basis_g = (transported(rays.basis, rays.d, d_g)
                   if cfg.polarization else None)
        seg_len = t_draw
        if cfg.grin_substeps > 1 and scene.grin_wu is not None:
            # up to grin_substeps - 1 more curved steps this bounce,
            # re-checking the surface distance against only the GRIN
            # elements' own triangles between steps, with the full
            # intersect's hit predicate and eps
            h_g = cfg.grin_step
            act, s_tot = is_gstep, t_draw
            for _ in range(cfg.grin_substeps - 1):
                t_s = nearest_t_rows(r_g, d_g, scene.grin_wu, scene.grin_wv,
                                     scene.grin_ww, cfg)
                # t_s == inf: no GRIN surface ahead (the previous curved
                # step overshot the element); stop and let the next
                # full-scene intersect interact
                go = act & (t_s > h_g) & torch.isfinite(t_s)
                r2, d2, n2, dopl = physics.grin_selfoc_step(
                    r_g, d_g, h_g, gc_l, gx_l, gn0_l, g_a)
                if basis_g is not None:
                    basis_g = torch.where(go[:, None],
                                          transported(basis_g, d_g, d2),
                                          basis_g)
                r_g = torch.where(go[:, None], r2, r_g)
                d_g = torch.where(go[:, None], d2, d_g)
                n_g = torch.where(go, n2, n_g)
                opl_g = opl_g + torch.where(go, dopl, 0.0)
                s_tot = s_tot + torch.where(go, h_g, 0.0)
                act = go
            # Beer-Lambert below must see the total arc traveled
            seg_len = torch.where(is_gstep, s_tot, t_draw)
    else:
        in_grin = is_gstep = basis_g = None
        seg_len = t_draw
    hit_point = rays.o + t_draw[:, None] * rays.d
    # optical path length through the segment just traveled (n * length);
    # both children inherit it (same hit point)
    opl_new = rays.opl + rays.ior * t_draw
    if in_grin is not None:
        # mid-medium steps end at the curved endpoint; OPL integrates n ds
        # along the curve for stepped and final segments
        hit_point = torch.where(is_gstep[:, None], r_g, hit_point)
        opl_new = torch.where(in_grin, rays.opl + opl_g, opl_new)

    # Beer-Lambert bulk attenuation over the segment just traveled
    atten = torch.exp(-rays.absorb * seg_len)
    bulk_absorbed = torch.sum(live_p * (1.0 - atten))
    live_p = live_p * atten

    if attrs is None:
        attrs = default_hit_attrs(scene, safe_tri, cfg)
    # birefringence is polarized-model-only (the o/e split is a Stokes
    # projection); unpolarized traces absorb such hits (ledger-exact)
    has_bire = (cfg.has_birefringence and cfg.polarization
                and "bire_ne" in attrs)
    mat = attrs["mat"]
    n_geom = attrs["normal"]
    # dispersive glass: Cauchy n(lambda) = A + B / lambda^2 (+ C / lambda^4)
    wl2 = torch.square(rays.wavelength)
    tri_ior = attrs["ior"] + attrs["ior_b"] / wl2
    if "ior_c" in attrs:
        tri_ior = tri_ior + attrs["ior_c"] / torch.square(wl2)
    refl = attrs["reflectivity"]
    det_id = attrs["detector_id"]
    tri_absorb = attrs["absorb"]
    d_inc, n_inc = rays.d, rays.ior
    if in_grin is not None and scene.element_id is not None:
        # entering a GRIN element: Snell against the local index at the hit
        # point, not the constant on-axis n0
        eh = torch.clamp(scene.element_id[safe_tri], 0, E_g - 1).long()
        a_hit = scene.grin_a[eh]
        n_hit = physics.grin_index(hit_point, scene.grin_center[eh],
                                   scene.grin_axis[eh], scene.grin_n0[eh],
                                   a_hit)
        tri_ior = torch.where(hit_valid & (a_hit != 0.0), n_hit, tri_ior)
        # exiting (or internally reflecting): the incident direction and
        # index are the curve-propagated values at the surface
        d_inc = torch.where(in_grin[:, None], d_g, rays.d)
        n_inc = torch.where(in_grin, n_g, rays.ior)
    sn = physics.snell_interaction(d_inc, n_geom, n_inc, tri_ior, cfg.ior_env)

    # complex-index metal mirrors: the fixed `reflectivity` becomes
    # reflectivity * R_metal(theta) on lanes with metal_n > 0; elsewhere
    # refl_eff == refl exactly. The polarized branch below replaces this
    # unpolarized R with the complex (rs, rp) Mueller block on those lanes
    refl_eff = refl
    if cfg.has_metals:
        is_metal = attrs["metal_n"] > 0.0
        # one complex-Fresnel evaluation serves both models
        mrs, mrp = physics.metal_rs_rp(
            sn["cos_i"], sn["n1"], attrs["metal_n"], attrs["metal_k"])
        R_metal = torch.clamp(
            0.5 * (physics._abs2(mrs) + physics._abs2(mrp)), 0.0, 1.0
        ).to(_F32)
        refl_eff = torch.where(is_metal, refl * R_metal, refl)

    def oriented_stack():
        # stacks are stored outermost-layer-first as seen from outside the
        # element; a ray exiting the glass sees the layers in reverse order
        # (h = 0 padding is inert in any position, so flipping the whole
        # padded row is exact)
        ent = sn["entering"][:, None]
        cn, ch = attrs["coat_ior"], attrs["coat_thickness"]  # (C, L)
        cn = torch.where(ent, cn, cn.flip(1))
        ch = torch.where(ent, ch, ch.flip(1))
        # max over layers: reversal can move the live layer off column 0
        return cn, ch, ch.amax(dim=1) > 0.0

    # dielectric reflectance: bare Fresnel, or the multilayer thin-film
    # R(lambda, theta) where the triangle is coated. Skipped under
    # polarization, where coated lanes take the characteristic-matrix
    # Mueller split below
    R_diel = sn["R"]
    if cfg.has_coatings and not cfg.polarization:
        cn, ch, coated = oriented_stack()
        # under substrate TIR the stack analysis gives |r| = 1; the kernel
        # forces it exactly so complex64 roundoff can't leak power into the
        # (garbage-direction) refracted slot, and keeps the bare Fresnel R
        # on uncoated lanes
        R_diel = film_stack_reflectance(
            sn["cos_i"], sn["n1"], sn["n2"], cn, ch, rays.wavelength,
            tir=sn["tir"], coated=coated, r_fresnel=R_diel,
            backend=cfg.backend)

    is_mirror = hit_valid & (mat == int(Material.MIRROR))
    is_refr = hit_valid & (mat == int(Material.REFRACTIVE))
    is_term = hit_valid & (mat == int(Material.TERMINATOR))
    is_meas = hit_valid & (mat == int(Material.MEASURE))
    is_bs = hit_valid & (mat == int(Material.BEAMSPLITTER))
    is_pol = hit_valid & (mat == int(Material.POLARIZER))
    is_wp = hit_valid & (mat == int(Material.WAVEPLATE))
    is_optic = is_pol | is_wp  # straight-through Stokes elements
    is_miss = rays.alive & ~hit_valid
    if has_volume:
        # volume-event lanes left hit_valid but did not escape: they
        # continue as slot-A children with a redrawn direction
        is_miss = is_miss & ~is_scat
    if in_grin is not None:
        # mid-medium GRIN steps likewise continue in slot A
        is_miss = is_miss & ~is_gstep

    if cfg.has_diffuse:
        # Lambertian scatterer: one child, cosine-weighted direction about
        # the oriented normal, power scaled by the albedo (`reflectivity`);
        # remainder absorbed. Scattering fully depolarizes
        is_diff = hit_valid & (mat == int(Material.DIFFUSE))
        d_diff = physics.sample_lambertian(
            _need(un.lambertian, "cfg.has_diffuse"), sn["n"])
    else:
        is_diff = None
        d_diff = rays.d

    if cfg.has_gratings:
        is_gr = hit_valid & (mat == int(Material.GRATING))
        # reflection grating: tangential wavevector shift by m * lambda0 /
        # (n_medium * period) along the groove-perpendicular (element
        # `axis` projected into the surface); m = 0 reduces to the mirror
        # direction. Evanescent orders (|t_out| > 1) are absorbed
        nvec = sn["n"]
        g_t = attrs["axis"] - physics.dot(attrs["axis"], nvec)[:, None] * nvec
        g_t = _unit_rows(g_t)
        t_in = rays.d - physics.dot(rays.d, nvec)[:, None] * nvec
        shift = rays.wavelength / rays.ior * attrs["grating_mlp"]
        t_out = t_in + shift[:, None] * g_t
        s2_gr = torch.sum(t_out * t_out, dim=1)
        gr_prop = s2_gr <= 1.0
        d_gr = (t_out + torch.sqrt(torch.clamp_min(1.0 - s2_gr, 0.0))[:, None]
                * nvec)
        d_gr = _unit_rows(d_gr)
    else:
        is_gr = gr_prop = None
        d_gr = rays.d

    # child A: the reflected branch (mirror / dielectric / beamsplitter) at
    # slot i. Polarizer / waveplate children also live in slot A,
    # continuing straight through (their power is set in the polarized
    # branch below), as does the grating's diffracted child (`reflectivity`
    # = efficiency; its order-m share is (1 - order0_fraction), applied
    # below; the specular 0th-order leak rides slot B)
    refl_like = is_mirror | is_bs
    if cfg.has_gratings:
        refl_like = refl_like | (is_gr & gr_prop)
    if cfg.has_diffuse:
        refl_like = refl_like | is_diff
    pa = torch.where(refl_like, live_p * refl_eff,
                     torch.where(is_refr, live_p * R_diel, 0.0))
    da = torch.where(is_optic[:, None], rays.d, sn["refl_dir"])
    if cfg.has_gratings:
        da = torch.where(is_gr[:, None], d_gr, da)
    if cfg.has_diffuse:
        da = torch.where(is_diff[:, None], d_diff, da)

    pol_absorbed = 0.0
    a_ior = rays.ior
    a_absorb = rays.absorb
    bo = None
    if cfg.polarization:
        # Stokes-Mueller path: rotate the frame into the incidence plane,
        # apply the polarized Fresnel / TIR Mueller split, re-derive the
        # children's powers and Stokes fractions. Lanes arriving through a
        # GRIN medium use the curve-propagated incident direction and the
        # parallel-transported frame
        b_pol = rays.basis
        if in_grin is not None and basis_g is not None:
            b_pol = torch.where(in_grin[:, None], basis_g, rays.basis)
        s_dir = physics.incidence_s_direction(d_inc, sn["n"], b_pol)
        cos_phi = physics.dot(b_pol, s_dir)
        sin_phi = physics.dot(_cross(b_pol, s_dir), d_inc)
        s1f, s2f = physics.rotate_stokes(rays.s1, rays.s2, cos_phi, sin_phi)
        S = (live_p, s1f * live_p, s2f * live_p, rays.s3 * live_p)
        (r0, r1, r2, r3), (t0, t1, t2, t3) = physics.polarized_split(
            *S, sn["cos_i"], sn["cos_t"], sn["n1"], sn["n2"], sn["tir"])
        if cfg.has_coatings:
            # coated dielectric lanes: the stack's characteristic-matrix
            # split replaces the bare Fresnel Mueller split (complex rs/rp
            # cross terms carry film and TIR retardation)
            cn, ch, coated = oriented_stack()
            cn_l, ch_l = list(cn.unbind(1)), list(ch.unbind(1))
            film_r, film_t = physics.polarized_film_split(
                *S, sn["cos_i"], sn["n1"], cn_l, ch_l, sn["n2"],
                rays.wavelength)
            r0, r1, r2, r3 = (torch.where(coated, f, r) for f, r in
                              zip(film_r, (r0, r1, r2, r3)))
            t0, t1, t2, t3 = (torch.where(coated, g, x) for g, x in
                              zip(film_t, (t0, t1, t2, t3)))

        def frac(num, den):
            return num / torch.clamp_min(den, 1e-30)

        # polarizer / waveplate: rotate the Stokes frame onto the element's
        # transmission / fast axis projected perpendicular to the ray
        ax = attrs["axis"]
        ax_perp = ax - physics.dot(ax, d_inc)[:, None] * d_inc
        ax_len = norm3(ax_perp)[:, None]
        ax_ok = ax_len[:, 0] > 1e-6
        ax_perp = torch.where(ax_ok[:, None],
                              ax_perp / torch.clamp_min(ax_len, 1e-20), b_pol)
        cos_e = physics.dot(b_pol, ax_perp)
        sin_e = physics.dot(_cross(b_pol, ax_perp), d_inc)
        e1f, e2f = physics.rotate_stokes(rays.s1, rays.s2, cos_e, sin_e)
        f_pol = 0.5 * (1.0 + e1f)          # Malus: ideal linear polarizer
        delta = attrs["retardance"]        # linear retarder about fast axis
        w2 = e2f * torch.cos(delta) + rays.s3 * torch.sin(delta)
        w3 = -e2f * torch.sin(delta) + rays.s3 * torch.cos(delta)
        pol_absorbed = torch.sum(
            torch.where(is_pol, live_p * (1.0 - f_pol), 0.0))

        pa = torch.where(
            refl_like, live_p * refl_eff,
            torch.where(is_refr, r0,
                        torch.where(is_pol, live_p * f_pol,
                                    torch.where(is_wp, live_p, 0.0))))
        pb_pol = torch.where(is_refr, t0,
                             torch.where(is_bs, live_p * (1.0 - refl), 0.0))
        # reflected-child fractions: an ideal mirror (and the beamsplitter's
        # reflected arm) imposes rs = 1, rp = -1 (Mueller diag(1, 1, -1,
        # -1)): S2 and S3 flip sign. Grating: the same non-polarizing
        # reflection; the child frame is rebuilt perpendicular to the
        # diffracted direction
        flip = (is_mirror | is_bs) if not cfg.has_gratings else (
            is_mirror | is_bs | is_gr)
        a_s1 = torch.where(is_refr, frac(r1, r0), s1f)
        a_s2 = torch.where(is_refr, frac(r2, r0),
                           torch.where(flip, -s2f, s2f))
        a_s3 = torch.where(is_refr, frac(r3, r0),
                           torch.where(flip, -rays.s3, rays.s3))
        # polarizer output is fully polarized along its axis; the waveplate
        # applies the retarder Mueller in its fast-axis frame
        a_s1 = torch.where(is_pol, 1.0, torch.where(is_wp, e1f, a_s1))
        a_s2 = torch.where(is_pol, 0.0, torch.where(is_wp, w2, a_s2))
        a_s3 = torch.where(is_pol, 0.0, torch.where(is_wp, w3, a_s3))
        if cfg.has_metals:
            # metal mirror lanes: the complex (rs, rp) Mueller block in the
            # rotated frame replaces the ideal-mirror flip (power,
            # diattenuation and metallic retardation); the scalar `refl`
            # factor still applies uniformly
            m0, m1, m2, m3 = physics.mueller_reflect(*S, mrs, mrp)
            is_mm = is_mirror & is_metal
            pa = torch.where(is_mm, refl * m0, pa)
            a_s1 = torch.where(is_mm, frac(m1, m0), a_s1)
            a_s2 = torch.where(is_mm, frac(m2, m0), a_s2)
            a_s3 = torch.where(is_mm, frac(m3, m0), a_s3)
        # transmitted fractions: the beamsplitter passes the rotated state;
        # the grating's slot-B child is the specular 0th order (mirror
        # Mueller: s2 / s3 flip)
        b_s1 = torch.where(is_bs, s1f, frac(t1, t0))
        b_s2 = torch.where(is_bs, s2f, frac(t2, t0))
        b_s3 = torch.where(is_bs, rays.s3, frac(t3, t0))
        if cfg.has_gratings:
            b_s1 = torch.where(is_gr, s1f, b_s1)
            b_s2 = torch.where(is_gr, -s2f, b_s2)
            b_s3 = torch.where(is_gr, -rays.s3, b_s3)
        new_basis = torch.where(is_optic[:, None], ax_perp,
                                torch.where(hit_valid[:, None], s_dir,
                                            rays.basis))
        if cfg.has_gratings:
            gr_basis = _cross(nvec, d_gr)
            gr_len = norm3(gr_basis)[:, None]
            gr_basis = torch.where(
                gr_len > 1e-6, gr_basis / torch.clamp_min(gr_len, 1e-20),
                s_dir)
            new_basis = torch.where(is_gr[:, None], gr_basis, new_basis)
        if cfg.has_diffuse:
            # scattering depolarizes: Stokes fractions reset, frame rebuilt
            # perpendicular to the scattered direction
            a_s1 = torch.where(is_diff, 0.0, a_s1)
            a_s2 = torch.where(is_diff, 0.0, a_s2)
            a_s3 = torch.where(is_diff, 0.0, a_s3)
            diff_basis = physics.incidence_s_direction(
                d_diff, sn["n"], rays.basis)
            new_basis = torch.where(is_diff[:, None], diff_basis, new_basis)
        if has_bire:
            # uniaxial crystal double refraction: slot A = ordinary (or
            # exit-transmitted), slot B = extraordinary (or internal
            # reflection); both children fully polarized in their
            # eigenframe
            bo = _shade_birefringent(scene, rays, sn, attrs, live_p,
                                     s_dir, hit_valid, cfg)
            ib = bo["is_bire"]
            ibc = ib[:, None]
            pa = torch.where(ib, bo["pa"], pa)
            da = torch.where(ibc, bo["da"], da)
            a_ior = torch.where(ib, bo["a_ior"], a_ior)
            a_absorb = torch.where(ib, bo["a_absorb"], a_absorb)
            a_s1 = torch.where(ib, 1.0, a_s1)
            a_s2 = torch.where(ib, 0.0, a_s2)
            a_s3 = torch.where(ib, 0.0, a_s3)
            new_basis = torch.where(ibc, bo["a_basis"], new_basis)
            pb_pol = torch.where(ib, bo["pb"], pb_pol)
            b_s1 = torch.where(ib, 1.0, b_s1)
            b_s2 = torch.where(ib, 0.0, b_s2)
            b_s3 = torch.where(ib, 0.0, b_s3)
    else:
        pb_pol = None
        a_s1 = a_s2 = a_s3 = None
    fluor_absorbed = 0.0
    a_wl = rays.wavelength
    if has_volume:
        # the post-event continuation rides slot A: elastic scatter keeps
        # full power (extinction is the Beer-Lambert term over the clamped
        # segment); a conversion keeps QY x Stokes shift of it, re-emits at
        # lam_em, and books the remainder as absorbed. Medium unchanged
        p_evt = live_p
        if is_fluor is not None:
            p_evt = live_p * torch.where(is_fluor, f_factor, 1.0)
            fluor_absorbed = torch.sum(
                torch.where(is_fluor, live_p - p_evt, 0.0))
            a_wl = torch.where(is_fluor, lam_em, rays.wavelength)
        pa = torch.where(is_scat, p_evt, pa)
        da = torch.where(is_scat[:, None], d_scat, da)
        if cfg.polarization:
            # volume scattering depolarizes (like the Lambertian surface)
            a_s1 = torch.where(is_scat, 0.0, a_s1)
            a_s2 = torch.where(is_scat, 0.0, a_s2)
            a_s3 = torch.where(is_scat, 0.0, a_s3)
            scat_basis = physics.incidence_s_direction(
                d_scat, rays.d, rays.basis)
            new_basis = torch.where(is_scat[:, None], scat_basis, new_basis)
    if in_grin is not None:
        # the mid-medium GRIN continuation: full power, curved endpoint
        # direction, local index carried in the generic ior lane (what OPL
        # accumulation and the eventual exit Snell read)
        pa = torch.where(is_gstep, live_p, pa)
        da = torch.where(is_gstep[:, None], d_g, da)
        a_ior = torch.where(is_gstep, n_g, a_ior)
        if cfg.polarization and basis_g is not None:
            # the continuation carries the transported frame, and the
            # Stokes components stay unrotated relative to it
            new_basis = torch.where(is_gstep[:, None], basis_g, new_basis)
            a_s1 = torch.where(is_gstep, rays.s1, a_s1)
            a_s2 = torch.where(is_gstep, rays.s2, a_s2)
            a_s3 = torch.where(is_gstep, rays.s3, a_s3)
    if cfg.has_gratings:
        # order m keeps (1 - g0) of the diffracted-side power (slot A); the
        # specular 0th-order leak g0 goes to slot B. Evanescent order m:
        # slot A is already zero (refl_like excludes it)
        g0 = attrs["grating_g0"]
        pa = torch.where(is_gr, pa * (1.0 - g0), pa)
        if cfg.polarization:
            pb_pol = torch.where(is_gr, live_p * refl * g0, pb_pol)
    if cfg.has_roughness and "rough_sigma" in attrs:
        # rough-mirror surface scatter: the reflected power pa splits
        # deterministically by the Rayleigh-Rice total integrated scatter
        # into a specular child x (1 - TIS) at slot A and a scattered child
        # x TIS at slot B, whose direction is an HG lobe about the specular
        # direction folded above the surface. The wavelength in the medium
        # (lambda0 / n) sets the roughness scale
        is_rough = is_mirror & (attrs["rough_sigma"] > 0.0)
        arg = (4.0 * math.pi * attrs["rough_sigma"] * sn["cos_i"]
               * rays.ior / rays.wavelength)
        tis = 1.0 - torch.exp(-arg * arg)
        d_lobe = physics.sample_henyey_greenstein(
            _need(un.rough_lobe, "cfg.has_roughness"), sn["refl_dir"],
            torch.where(is_rough, attrs["rough_g"], 0.0))
        # fold below-horizon draws back above the surface (energy
        # preserving; sn["n"] is the normal oriented against the ray)
        d_dot = physics.dot(d_lobe, sn["n"])
        d_lobe = d_lobe - 2.0 * torch.clamp_max(d_dot, 0.0)[:, None] * sn["n"]
        rough_b = torch.where(is_rough, pa * tis, 0.0)  # (C,) slot-B power
        pa = torch.where(is_rough, pa * (1.0 - tis), pa)
        if cfg.polarization:
            pb_pol = torch.where(is_rough, rough_b, pb_pol)
    else:
        is_rough = None
        rough_b = torch.zeros_like(live_p)
        d_lobe = rays.d
    dropped_power = torch.zeros_like(live_p)
    if cfg.track_paths:
        # ghost / stray-light signatures: slot-A children (reflected /
        # continuing branch) append digit 1 + 2 e, slot-B children
        # (transmitted branch) 2 + 2 e, in base cfg.path_base = 2 E + 1
        # (f32-exact while path_base^bounces < 2^24)
        elem = torch.clamp_min(scene.element_id[safe_tri], 0).to(_F32)
        path_a = rays.path * float(cfg.path_base) + (1.0 + 2.0 * elem)
        path_b = rays.path * float(cfg.path_base) + (2.0 + 2.0 * elem)
        if has_volume:
            # a volume event is not a surface interaction: the
            # continuation keeps its parent's signature unchanged
            path_a = torch.where(is_scat, rays.path, path_a)
        if in_grin is not None:
            path_a = torch.where(is_gstep, rays.path, path_a)
    else:
        path_a = path_b = rays.path
    push = _relaunch_push(rays, t_draw)
    if cfg.allow_splitting:
        # child B at slot C + i: refracted branch (dielectric) or the
        # straight-through transmitted branch (beamsplitter: direction and
        # medium unchanged)
        if cfg.polarization:
            pb = pb_pol
        else:
            pb = torch.where(is_refr, live_p * (1.0 - R_diel),
                             torch.where(is_bs, live_p * (1.0 - refl), 0.0))
            if cfg.has_gratings:
                pb = torch.where(is_gr, live_p * refl * attrs["grating_g0"],
                                 pb)
        db = torch.where(is_bs[:, None], rays.d, sn["refr_dir"])
        b_ior = torch.where(is_bs, rays.ior, sn["new_ior"])
        # refracted child changes medium: entering -> element's bulk
        # absorption, exiting -> ambient (0); beamsplitter stays in medium
        refr_absorb = torch.where(
            is_bs, rays.absorb, torch.where(sn["entering"], tri_absorb, 0.0))
        if cfg.has_gratings:
            # grating slot B: mirror direction, medium unchanged
            db = torch.where(is_gr[:, None], sn["refl_dir"], db)
            b_ior = torch.where(is_gr, rays.ior, b_ior)
            refr_absorb = torch.where(is_gr, rays.absorb, refr_absorb)
        if bo is not None:
            # birefringent slot B: extraordinary child on entry, internal
            # same-mode reflection on exit
            ib = bo["is_bire"]
            db = torch.where(ib[:, None], bo["db"], db)
            b_ior = torch.where(ib, bo["b_ior"], b_ior)
            refr_absorb = torch.where(ib, bo["b_absorb"], refr_absorb)
        if is_rough is not None:
            # rough-mirror slot B: the TIS-scattered child, HG lobe
            # direction, same medium as the parent
            if not cfg.polarization:
                pb = torch.where(is_rough, rough_b, pb)
            db = torch.where(is_rough[:, None], d_lobe, db)
            b_ior = torch.where(is_rough, rays.ior, b_ior)
            refr_absorb = torch.where(is_rough, rays.absorb, refr_absorb)

        def slot_b_medium(parent, entered, left, crystal):
            """A medium column of the slot-B children: the beamsplitter,
            grating and rough-mirror children keep the parent's; the
            refracted child takes `entered` going in and `left` coming
            out; both crystal children get `crystal`. The reference's
            order of overrides: grating, crystal, rough mirror."""
            col = torch.where(is_bs, parent,
                              torch.where(sn["entering"], entered, left))
            if cfg.has_gratings:
                col = torch.where(is_gr, parent, col)
            if bo is not None:
                col = torch.where(bo["is_bire"], crystal, col)
            if is_rough is not None:
                col = torch.where(is_rough, parent, col)
            return col

        # medium scattering columns travel exactly like `absorb`: slot A
        # stays in the parent's medium; the refracted child picks up the
        # element's bulk (scat_mu, scat_g) on entry and the clear ambient
        # on exit (crystals cannot be turbid). Inert zeros when off
        if cfg.has_scattering and "scat_mu" in attrs:
            refr_scat = slot_b_medium(rays.scat, attrs["scat_mu"], 0.0, 0.0)
            refr_scat_g = slot_b_medium(rays.scat_g, attrs["scat_g"], 0.0,
                                        0.0)
        else:
            refr_scat, refr_scat_g = rays.scat, rays.scat_g
        # the current-medium element id travels the same way (-1 on exit
        # to ambient); maintained only when fluorescence or GRIN reads it
        if ((cfg.has_fluorescence or cfg.has_grin)
                and scene.element_id is not None):
            elem_f = scene.element_id[safe_tri].to(_F32)
            refr_med = slot_b_medium(rays.medium, elem_f, -1.0, -1.0)
        else:
            refr_med = rays.medium

        def two(a, b):
            return torch.cat([a, b], dim=0)

        child_o = two(hit_point + push * da, hit_point + push * db)
        child_d = two(da, db)
        child_power = two(pa, pb)
        child_ior = two(a_ior, b_ior)
        # slot A carries the (possibly fluorescence-converted) wavelength;
        # slot B is a surface child and keeps the parent's
        child_wl = two(a_wl, rays.wavelength)
        child_ab = two(a_absorb, refr_absorb)
        # the relaunch push is traveled path: fold it into the child's OPL
        # (in the child's medium) so ToF / coherence stay exact
        child_opl = two(opl_new + push[:, 0] * a_ior,
                        opl_new + push[:, 0] * b_ior)
        child_path = two(path_a, path_b)
        child_scat = two(rays.scat, refr_scat)
        child_scat_g = two(rays.scat_g, refr_scat_g)
        child_medium = two(rays.medium, refr_med)
        if cfg.polarization:
            # slot B frame: the grating's specular child lives in the
            # incidence frame (s_dir, perpendicular to the mirror
            # direction), not the diffracted child's rebuilt frame
            b_basis = new_basis
            if cfg.has_gratings:
                b_basis = torch.where(is_gr[:, None], s_dir, b_basis)
            if bo is not None:
                b_basis = torch.where(bo["is_bire"][:, None], bo["b_basis"],
                                      b_basis)
            if is_rough is not None:
                # the rough mirror's scattered child is depolarized, frame
                # rebuilt perpendicular to the lobe direction
                b_s1 = torch.where(is_rough, 0.0, b_s1)
                b_s2 = torch.where(is_rough, 0.0, b_s2)
                b_s3 = torch.where(is_rough, 0.0, b_s3)
                rough_basis = physics.incidence_s_direction(
                    d_lobe, sn["n"], rays.basis)
                b_basis = torch.where(is_rough[:, None], rough_basis,
                                      b_basis)
            child_s1 = two(a_s1, b_s1)
            child_s2 = two(a_s2, b_s2)
            child_s3 = two(a_s3, b_s3)
            child_basis = two(new_basis, b_basis)
        else:
            child_s1 = two(rays.s1, rays.s1)
            child_s2 = two(rays.s2, rays.s2)
            child_s3 = two(rays.s3, rays.s3)
            child_basis = two(rays.basis, rays.basis)
    else:
        # no refractive elements in the scene (engine-verified): only the
        # reflected branch exists and children stay in their parent slots
        child_o = hit_point + push * da
        child_d, child_power, child_ior = da, pa, a_ior
        child_wl = a_wl
        child_ab = a_absorb
        child_opl = opl_new + push[:, 0] * a_ior
        child_path = path_a
        child_scat, child_scat_g = rays.scat, rays.scat_g
        child_medium = rays.medium
        # direct step-level users can reach this path with refractive or
        # beamsplitter triangles present (the engine forbids it); account
        # the dropped transmitted power so the ledger still balances. The
        # polarized path must use the polarized transmitted power, or
        # conservation breaks by (R_pol - R_unpol) per ray
        if cfg.polarization:
            dropped_power = pb_pol
        else:
            dropped_power = torch.where(
                is_refr, live_p * (1.0 - R_diel),
                torch.where(is_bs, live_p * (1.0 - refl), 0.0))
            if cfg.has_gratings:
                dropped_power = dropped_power + torch.where(
                    is_gr, live_p * refl * attrs["grating_g0"], 0.0)
            # rough mirrors' scattered share has no slot either
            dropped_power = dropped_power + rough_b
        if cfg.polarization:
            child_s1, child_s2, child_s3 = a_s1, a_s2, a_s3
            child_basis = new_basis
        else:
            child_s1, child_s2, child_s3 = rays.s1, rays.s2, rays.s3
            child_basis = rays.basis
    child_alive = child_power > 0.0

    # mirror absorption is the reflectivity deficit: live - specular - any
    # rough-scattered share (rough_b is zero when roughness is off)
    absorbed = (bulk_absorbed + fluor_absorbed
                + torch.sum(torch.where(is_term, live_p, 0.0))
                + torch.sum(torch.where(is_mirror, live_p - pa - rough_b,
                                        0.0)))
    if cfg.has_diffuse:
        absorbed = absorbed + torch.sum(
            torch.where(is_diff, live_p * (1.0 - refl), 0.0))
    if cfg.has_gratings:
        # (1 - refl) always lost; an evanescent order m additionally loses
        # its (1 - g0) share of the reflected power (the 0th-order leak
        # propagates regardless)
        absorbed = absorbed + torch.sum(torch.where(
            is_gr,
            live_p * (1.0 - refl)
            + torch.where(gr_prop, 0.0,
                          live_p * refl * (1.0 - attrs["grating_g0"])),
            0.0))
    if cfg.polarization:
        absorbed = absorbed + pol_absorbed
        if bo is not None:
            # birefringent entry: the externally reflected share (no third
            # child slot) is accounted as absorbed
            absorbed = absorbed + bo["absorbed"]
    else:
        # polarizer / waveplate act on Stokes state, which the unpolarized
        # model does not carry: the engine refuses such scenes; direct step
        # users get full absorption so the ledger still balances
        absorbed = absorbed + torch.sum(torch.where(is_optic, live_p, 0.0))
    if bo is None:
        # birefringent hits with the branch disabled (unpolarized model, or
        # has_birefringence=False): no child carries power; absorb so the
        # ledger still balances
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
    """Weighted bincount (n_bins, ...) of the rows of vals (n, ...) at idx
    in [0, n_bins), deterministic on CPU and CUDA: a stable sort by bin,
    then a segmented inclusive scan with a fixed (Hillis-Steele)
    association, so every run adds the same numbers in the same order, with
    no atomics; log2(n) elementwise passes. Each column of a 2-D vals sums
    exactly as it would alone. (PyTorch's deterministic index_put_
    accumulates each bin serially in one warp: 23 ms for 524,288 rays into
    one detector bin on an H100.)"""
    out = torch.zeros((n_bins,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    n = idx.shape[0]
    if n == 0:
        return out
    order = torch.argsort(idx, stable=True)
    k, x = idx[order], vals[order]
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = k[1:] != k[:-1]
    f, s = head, 1
    row = (-1,) + (1,) * (vals.dim() - 1)
    while s < n:
        # (x, f)[i] <- (x, f)[i - s] (+) (x, f)[i]: a segment head keeps
        # its own partial sum; otherwise the earlier partial is added first
        x = torch.cat([x[:s], torch.where(f[s:].view(row), x[s:],
                                          x[:-s] + x[s:])])
        f = torch.cat([f[:s], f[s:] | f[:-s]])
        s *= 2
    last = torch.ones(n, dtype=torch.bool, device=idx.device)
    last[:-1] = head[1:]
    with span("step.sync"):  # the bins' count: a host read
        at = last.nonzero().squeeze(1)
    out[k[at].long()] = x[at]  # one write per bin
    return out


def _upload(values, device):
    """A small float32 constant on `device`. On a card torch's copy from
    pageable memory waits for the stream's queued work: a host wait, the
    span `step.sync`."""
    with span("step.sync"):
        return torch.as_tensor(np.asarray(values, np.float32), device=device)


def image_flat_indices(hit_point, cfg: TraceConfig):
    """(C,) flat pixel index of each hit on the cfg image plane; points
    outside the grid map to the drop slot nb * nb."""
    F = _upload(_frame(cfg.image_normal), hit_point.device)
    rel = hit_point - _upload(cfg.image_center, hit_point.device)
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
        v = physics.normalize(hit_point - _upload(cfg.hist_center,
                                                  hit_point.device))
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

    with span("compact.topk"):
        key = torch.where(live, sh.child_power, -1.0)
        # stable descending sort == jax.lax.top_k's order (ties: lower slot)
        idx = torch.sort(key, descending=True, stable=True).indices[:capacity]
        sel_live = live[idx]
        sel_power = torch.where(sel_live, sh.child_power[idx], 0.0)
        culled = total_live - torch.sum(sel_power) + below
        new_rays = _child_batch(sh, sel_power, sel_live,
                                lambda a, fill: a[idx])
    if enabled():
        count("compact.children", live.sum())
        count("compact.kept", sel_live.sum())
    return new_rays, culled


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


def merge_analytic(scene: Scene, o, d, t, tri, cfg: TraceConfig):
    """Merge the exact quadric nearest hits (geometry/analytic.py,
    ops/quadric.py) into a triangle-intersect result. The winning surface's
    attribute row is its placeholder triangle's, so the material model
    downstream is untouched; only the geometric normal must be overridden
    with the exact quadric gradient.

    Returns (t, tri, quad_hit): quad_hit is None when the scene has no
    analytic surfaces (or the branch is gated off), else (use_q (C,) bool,
    nq (C, 3) exact normals) for the caller to apply:
    attrs["normal"] = where(use_q, nq, attrs["normal"])."""
    if not (cfg.has_analytic and scene.quad_abgd is not None):
        return t, tri, None
    tq, qtri, nq = intersect_quadrics(scene, o, d, cfg)
    use_q = tq < t
    return (torch.where(use_q, tq, t), torch.where(use_q, qtri, tri),
            (use_q, nq))


def trace_step(scene: Scene, rays: RayBatch, det: DetectorState, led: Ledger,
               cfg: TraceConfig, with_aux: bool = True,
               gen: torch.Generator | None = None,
               uniforms: Optional[ShadeUniforms] = None,
               roulette_u: Optional[torch.Tensor] = None):
    """One bounce: (reorder,) intersect, merge the exact quadric hits,
    shade, measure, (roulette,) compact, ledger. `gen` is needed only when
    cfg.needs_rng: it draws shade's uniforms (`draw_shade_uniforms`), then
    the roulette uniforms. `uniforms` / `roulette_u` inject them instead
    (tests feeding the reference's own draws). Returns (rays, det, led,
    aux); aux is None when with_aux is False (the device loop, where the
    reference's compiler drops it as dead code)."""
    with span("step.bounce"):
        if cfg.cull:
            with span("step.reorder"):
                rays = reorder_rays(scene, rays)
        if enabled():
            count("step.live_rays", rays.alive.sum())
            count("step.slots", rays.capacity)
        t, tri = intersect(scene, rays.o, rays.d, cfg, alive=rays.alive)
        t, tri, quad_hit = merge_analytic(scene, rays.o, rays.d, t, tri, cfg)
        attrs = None
        if quad_hit is not None:
            use_q, nq = quad_hit
            attrs = default_hit_attrs(scene, torch.clamp_min(tri, 0), cfg)
            attrs["normal"] = torch.where(use_q[:, None], nq,
                                          attrs["normal"])
        return finish_step(scene, rays, t, tri, attrs, det, led, cfg,
                           with_aux=with_aux, gen=gen, uniforms=uniforms,
                           roulette_u=roulette_u)


def finish_step(scene: Scene, rays: RayBatch, t, tri, attrs,
                det: DetectorState, led: Ledger, cfg: TraceConfig,
                with_aux: bool = True, gen: torch.Generator | None = None,
                uniforms: Optional[ShadeUniforms] = None,
                roulette_u: Optional[torch.Tensor] = None,
                book: bool = True):
    """The bounce after its nearest hit (t, tri) and hit attributes (None:
    shade gathers them): shade, measure, (roulette,) compact, ledger, as
    `trace_step` describes. With book=False the detector state and the
    ledger come back unchanged (a triangle-sharded trace books them on one
    rank of the triangle axis only)."""
    shade_rng = (cfg.has_diffuse or cfg.has_scattering
                 or cfg.has_fluorescence or cfg.has_roughness)
    if uniforms is None and shade_rng:
        if gen is None:
            raise ValueError("cfg.has_diffuse / has_scattering / "
                             "has_fluorescence / has_roughness require a "
                             "generator")
        uniforms = draw_shade_uniforms(cfg, rays.capacity, gen, rays.device)
    with span("step.shade"):
        sh = shade(scene, rays, t, tri, cfg, attrs=attrs, uniforms=uniforms)
    if book:
        with span("step.accumulate"):
            det = accumulate_detector(det, sh, rays, cfg, tri=tri)
    rr_delta = 0.0
    if cfg.roulette_threshold > 0.0:
        if roulette_u is None:
            if gen is None:
                raise ValueError(
                    "roulette_threshold > 0 requires a generator")
            roulette_u = torch.rand(sh.child_power.shape, generator=gen,
                                    dtype=_F32,
                                    device=sh.child_power.device)
        sh, rr_delta = roulette(sh, cfg, roulette_u)
    with span("step.compact"):
        new_rays, culled = compact(sh, rays.capacity, cfg)
    if book:
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


def _short_of_target(led: Ledger, target) -> bool:
    """The device loop's early-exit read, one host sync a bounce: is the
    accounted power still below target x emitted?"""
    with span("step.sync"):
        return bool(led.accounted() < target * led.emitted)


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
    while i < iterations and _short_of_target(led, target):
        gen = (make_generator(rays.device, *words, i) if cfg.needs_rng
               else None)
        rays, det, led, _ = trace_step(scene, rays, det, led, cfg,
                                       with_aux=False, gen=gen)
        i += 1
    return rays, det, led, i
