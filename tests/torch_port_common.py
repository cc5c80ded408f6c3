"""Shared helpers of the tests that hold the port's surface and volume
physics (tests/test_torch_shade_*.py, test_torch_quadric.py,
test_torch_trace_physics.py) against the JAX package: one cfg resolved by
the reference engine for both sides, the reference's own random draws as
the port's uniforms, and the field-by-field compare of two ShadeOuts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.tracer import step as R
from lightpycl_tpu.tracer.engine import Tracer as RefTracer
from lightpycl_tpu_torch.tracer import step as S
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene

CPU = torch.device("cpu")

ref_shade = jax.jit(R.shade, static_argnames=("cfg",))

# what each ShadeOut field is held to, absolute. Positions and path lengths
# are o + t d: their rounding scales with the operands (a ray that left the
# scene starts 1e3 away and is drawn out by max_ray_len, and the sum can
# cancel), so they get 3e-6 plus 1e-6 (8 units of f32 roundoff) of the
# parent's reach |o| + |hit - o|
POWER = 1e-6        # of unit emitted power
DIRECTION = 3e-6
STOKES = 2e-5
LENGTH = 3e-6
LENGTH_REL = 1e-6
FIELD_KIND = {
    "child_d": "direction", "child_basis": "direction",
    "child_s1": "stokes", "child_s2": "stokes", "child_s3": "stokes",
    "child_o": "length", "hit_point": "length", "child_opl": "length",
}


def both_cfg(els, _no_split=False, _unpolarized=False, **kw):
    """(reference cfg, port cfg) as the reference engine resolves them for
    the scene `els` (splitting, the has_* flags, grin_step, path_base).
    `_no_split` / `_unpolarized` build what only a direct caller of the
    step can: no split buffer on a scene that splits, and Stokes elements
    in the unpolarized model."""
    tr = RefTracer()
    tr.set_elements(els)
    cfg = L.TraceConfig(cull=False, **kw)
    if cfg.track_paths and cfg.path_base == 0:
        cfg = cfg.replace(path_base=2 * len(els) + 1)
    if not _no_split:
        cfg = tr._tune_splitting(cfg)
    if _unpolarized:
        tr.elements = [e for e in els if e.material not in (
            L.Material.POLARIZER, L.Material.WAVEPLATE,
            L.Material.BIREFRINGENT)]
    cfg = tr._check_polarization(cfg)
    if _no_split:
        cfg = cfg.replace(allow_splitting=False)
    return cfg, P.TraceConfig(**dataclasses.asdict(cfg))


def reference_uniforms(key, cfg, C):
    """The reference's draws for one bounce key as the port's uniforms:
    each stream with the constant the reference folds in, None where the
    cfg never draws it. Returns (ShadeUniforms, roulette uniforms)."""
    def draw(const, shape, **kw):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, const), shape, **kw)))

    u = {}
    if cfg.has_scattering or cfg.has_fluorescence:
        u["free_path"] = draw(0x5CA7, (C,), minval=1e-7, maxval=1.0)
        if cfg.has_fluorescence:
            u["event_kind"] = draw(0x5CA9, (C,))
            u["emission"] = draw(0x5CAA, (C,))
        u["scatter_dir"] = draw(0x5CA8, (C, 2))
    if cfg.has_diffuse:
        u["lambertian"] = draw(0x5D1F, (C, 2))
    if cfg.has_roughness:
        u["rough_lobe"] = draw(0x70F5, (C, 2))
    rr = None
    if cfg.roulette_threshold > 0.0:
        n = 2 * C if cfg.allow_splitting else C
        rr = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    return S.ShadeUniforms(**u), rr


def bounce_key(seed, i):
    """The reference engine's key of bounce i."""
    return jax.random.fold_in(jax.random.key(seed), i)


def port_batch(src, cfg, capacity=None):
    """The source's rays as a port batch on the CPU (numpy host sampling,
    the same bits either package would trace)."""
    o, d, p = src.sample()
    wls = (src.sample_wavelengths() if hasattr(src, "sample_wavelengths")
           else None)
    return RayBatch.from_arrays(o, d, p, ior_env=cfg.ior_env,
                                capacity=capacity, wavelengths=wls,
                                stokes=getattr(src, "stokes", None),
                                device=CPU)


def ref_batch(rays: RayBatch):
    """A reference RayBatch holding the port batch's bits."""
    return L.RayBatch(*(jnp.asarray(a.numpy()) for a in rays))


def advance(scene, rays, pcfg, bounces, seed=0, n_det=4):
    """`bounces` trace steps of the port with the reference's draws."""
    det = DetectorState.zeros(36, 18, n_det, device=CPU)
    led = Ledger.start(1.0, CPU)
    for i in range(bounces):
        un, rr = reference_uniforms(bounce_key(seed, i), pcfg, rays.capacity)
        rays, det, led, _ = S.trace_step(scene, rays, det, led, pcfg,
                                         uniforms=un, roulette_u=rr)
    return rays


def shade_pair(els, src, bounces=0, capacity=2048, seed=0, **kw):
    """(reference ShadeOut, port ShadeOut, parent rays, port cfg) of one
    `shade` call on the state after `bounces` steps: both sides get the
    same scene, rays, hit (t, tri), and random numbers."""
    rcfg, pcfg = both_cfg(els, **kw)
    rs, _ = L.build_scene(els)
    scene = Scene.from_reference(rs, CPU)
    rays = advance(scene, port_batch(src, pcfg, capacity), pcfg, bounces,
                   seed)
    from lightpycl_tpu_torch.ops.intersect import intersect
    t, tri = intersect(scene, rays.o, rays.d, pcfg)
    key = bounce_key(seed, bounces)
    un, _ = reference_uniforms(key, pcfg, rays.capacity)
    port = S.shade(scene, rays, t, tri, pcfg, uniforms=un)
    ref = ref_shade(rs, ref_batch(rays), jnp.asarray(t.numpy()),
                    jnp.asarray(tri.numpy()), rcfg,
                    key=key if rcfg.needs_rng else None)
    return ref, port, rays, pcfg


# A Henyey-Greenstein direction is cos(t) d + sin(t) (...) with sin(t) =
# sqrt(1 - cos(t)^2), and a frame built on it divides a cross product by the
# sine of its angle to the normal: one unit of roundoff in the cosine becomes
# 1e-7 / sin in the direction. Cases with such lanes hold 99% of the lanes to
# DIRECTION and the small-angle rest to this.
LOBE_DIRECTION = 5e-5


def assert_shade_close(ref, port, rays, lobes=False):
    """Every ShadeOut field: masks and integers equal, floats at the
    tolerance of their kind. `rays` are the parents (for the reach);
    `lobes` says the case draws Henyey-Greenstein directions."""
    o = rays.o.numpy()
    reach = (np.linalg.norm(o, axis=1)
             + np.linalg.norm(np.asarray(ref.hit_point) - o, axis=1))
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), (f, int((a != b).sum()))
            continue
        assert np.all(np.isfinite(b)), f
        kind = FIELD_KIND.get(f, "power")
        tol = {"power": POWER, "direction": DIRECTION, "stokes": STOKES,
               "length": LENGTH}[kind]
        if kind == "length":
            scale = np.tile(reach, a.shape[0] // reach.shape[0])
            tol = LENGTH + LENGTH_REL * scale.reshape(
                (-1,) + (1,) * (a.ndim - 1))
        err = np.abs(a.astype(np.float64) - b)
        if lobes and kind == "direction":
            assert np.mean(err <= DIRECTION) > 0.99, f
            tol = LOBE_DIRECTION
        ok = (err <= tol) | (np.isnan(a) & np.isnan(b))
        assert np.all(ok), (f, float(np.nanmax(err)))


def assert_conserves(sh, rays, tol=1e-5):
    """absorbed + escaped + measured + children + dropped == live power,
    to `tol` of the unit emitted power."""
    live = float(torch.sum(torch.where(rays.alive, rays.power, 0.0)))
    out = float(sh.absorbed + sh.escaped + sh.measured_power.sum()
                + sh.child_power.sum() + sh.policy_dropped)
    assert abs(out - live) < tol, (out, live)
    return live
