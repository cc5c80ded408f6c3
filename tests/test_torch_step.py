"""The port's trace step (lightpycl_tpu_torch/tracer/step.py) against the
JAX package's, stage by stage, on identical inputs: the same scene and
rays (copied bit for bit with from_reference) and the same intersect
result (t, tri) fed to both sides."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.sources import CollimatedSource, light_source
from lightpycl_tpu.tracer import step as R
from lightpycl_tpu.tracer.engine import Tracer as RefTracer
from lightpycl_tpu.tracer.rays import DetectorState as RefDet
from lightpycl_tpu.tracer.rays import Ledger as RefLedger
from lightpycl_tpu_torch.tracer import step as S
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene

torch.set_num_threads(1)
CPU = torch.device("cpu")
# 1e-6 absolute for unit-scale quantities; positions of missed rays are
# drawn out to max_ray_len, where one f32 ulp exceeds 1e-6, hence the
# relative term (about 8 ulps)
ATOL = 1e-6
RTOL = 1e-6

# the reference stages, jitted as its engine runs them
ref_intersect = jax.jit(R.intersect_jnp, static_argnames=("cfg",))
ref_shade = jax.jit(R.shade, static_argnames=("cfg",))
ref_accumulate = jax.jit(R.accumulate_detector, static_argnames=("cfg",))
ref_compact = jax.jit(R.compact, static_argnames=("capacity", "cfg"))
ref_step = functools.partial(R.trace_step_jit)

oe = L.optical_elements(n_segments=32, n_radial=12)


def config_scene(name):
    """Configs 1-3 of tests/test_parity_oracle.py, plus every material of
    the core model in one bench."""
    if name == "config1":
        els = [oe.parabolic_mirror(focus=0.5, diameter=2.0, reflectivity=0.92),
               oe.hemisphere(radius=15.0, name="dome")]
        src = light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                           power=1.0, ray_count=3000, seed=21)
        return els, src, None
    if name == "config2":
        els = [oe.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1,
                                    ior=1.5),
               oe.disc(radius=1.0, center=(0, 0, 1.1), material="measure"),
               oe.sphere(radius=8.0, material="terminator", name="enclosure")]
        src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                               diameter=0.3, ray_count=2000, power=1.0,
                               seed=22)
        return els, src, 4096
    if name == "config3":
        els = [oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
               oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5)),
               oe.sphere(radius=6.0, material="measure", name="enclosure")]
        src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                               diameter=0.5, ray_count=1000, power=1.0,
                               seed=23)
        return els, src, 2048
    # materials: beamsplitter, absorbing dispersive glass (Cauchy B and C),
    # mirror, terminator, polarizer (absorbed in the unpolarized model)
    small = L.optical_elements(16, 6)
    glass = small.biconvex_lens(1.0, 0.8, 0.3, ior=1.5, center=(0, 0, 1.0))
    glass.dispersion_b, glass.dispersion_c, glass.absorption = 0.004, 1e-4, 0.7
    bs = small.rectangle(1.0, 1.0, center=(0.8, 0, 0.6),
                         material="beamsplitter", reflectivity=0.3)
    pol = small.disc(0.3, center=(-0.8, 0, 0.8), material="polarizer",
                     axis=(1.0, 0.0, 0.0))
    els = [glass, bs, pol,
           small.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
           small.cube(0.3, center=(0, 0.8, 0.8), material="terminator"),
           small.hemisphere(5.0, name="dome")]
    src = light_source(center=(0, 0, 0.3), direction=(0, 0, 1), power=1.0,
                       ray_count=1500, seed=4, wavelength=0.48)
    return els, src, 2048


def core_cfg(els, **kw):
    """The reference engine's cfg resolution, as both sides will run it."""
    tr = RefTracer()
    tr.set_elements(els)
    cfg = tr._tune_splitting(L.TraceConfig(cull=False, **kw))
    if any(e.material == L.Material.POLARIZER for e in els):
        # direct step use of an unpolarized trace (the engine refuses it)
        cfg = cfg.replace(has_gratings=False, has_coatings=False,
                          has_metals=False)
    else:
        cfg = tr._check_polarization(cfg)
    return cfg, P.TraceConfig(**dataclasses.asdict(cfg))


def port_tuple(cls, ref):
    """A port NamedTuple holding private copies of a reference one."""
    return cls(*(None if a is None else torch.from_numpy(np.array(a))
                 for a in ref))


def setup(name, bounces=0, **kw):
    els, src, cap = config_scene(name)
    rcfg, pcfg = core_cfg(els, **kw)
    rs, names = L.build_scene(els)
    o, d, p = src.sample()
    rays = L.RayBatch.from_arrays(o, d, p, capacity=cap,
                                  wavelengths=src.sample_wavelengths())
    det = RefDet.zeros(36, 18, max(len(names), 1),
                       image_bins=kw.get("image_bins", 0))
    led = RefLedger.start(1.0)
    for _ in range(bounces):
        rays, det, led, _ = ref_step(rs, rays, det, led, rcfg)
    return rs, rays, rcfg, pcfg


def assert_close_tuple(ref, port, atol=ATOL, rtol=RTOL):
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, f
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), f
        else:
            assert np.allclose(a, b, rtol=rtol, atol=atol,
                               equal_nan=True), f


@pytest.mark.parametrize("name,bounces", [
    ("config1", 0), ("config2", 0), ("config3", 0), ("config3", 1),
    ("materials", 0), ("materials", 1)])
def test_shade_matches_reference(name, bounces):
    rs, rays, rcfg, pcfg = setup(name, bounces)
    t, tri = ref_intersect(rs, rays.o, rays.d, rcfg)
    ref = ref_shade(rs, rays, t, tri, rcfg)
    port = S.shade(Scene.from_reference(rs, CPU),
                   RayBatch.from_reference(rays, CPU),
                   torch.from_numpy(np.array(t)),
                   torch.from_numpy(np.array(tri)), pcfg)
    assert_close_tuple(ref, port)
    assert bool(port.child_alive.any() | port.measured.any())


@pytest.mark.parametrize("name,hist_mode", [("config1", "position"),
                                            ("config3", "direction")])
def test_accumulate_detector_matches_reference(name, hist_mode):
    rs, rays, rcfg, pcfg = setup(name, 1, hist_mode=hist_mode, image_bins=8,
                                 image_center=(0.0, 0.0, 0.3),
                                 image_halfwidth=4.0)
    t, tri = ref_intersect(rs, rays.o, rays.d, rcfg)
    sh = ref_shade(rs, rays, t, tri, rcfg)
    det0 = RefDet.zeros(36, 18, 1, image_bins=8)
    ref = ref_accumulate(det0, sh, rays, rcfg)
    port = S.accumulate_detector(
        DetectorState.zeros(36, 18, 1, image_bins=8, device=CPU),
        port_tuple(S.ShadeOut, sh), RayBatch.from_reference(rays, CPU), pcfg)
    for f in ("hist", "per_detector", "image"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert np.allclose(a, b, rtol=1e-5, atol=ATOL), f
    assert float(port.hist.sum()) > 0


def compact_case(name, bounces):
    rs, rays, rcfg, pcfg = setup(name, bounces)
    t, tri = ref_intersect(rs, rays.o, rays.d, rcfg)
    return ref_shade(rs, rays, t, tri, rcfg), rays.capacity, rcfg, pcfg


def assert_same_live_children(ref_rays, port_rays):
    ra = np.asarray(ref_rays.alive)
    pa = port_rays.alive.numpy()
    assert ra.sum() == pa.sum()

    def rows(b, alive, lib):
        cols = [np.asarray(getattr(b, f)).reshape(len(alive), -1)
                if lib == "ref" else getattr(b, f).numpy().reshape(
                    len(alive), -1)
                for f in ("o", "d", "power", "ior", "absorb", "opl")]
        m = np.concatenate(cols, axis=1)[alive]
        return m[np.lexsort(m.T[::-1])]

    assert np.array_equal(rows(ref_rays, ra, "ref"),
                          rows(port_rays, pa, "port"))


@pytest.mark.parametrize("mode,capacity", [
    ("topk", None), ("topk", 700), ("stream", None), ("stream", 700)])
def test_compact_matches_reference(mode, capacity):
    sh, C, rcfg, pcfg = compact_case("config3", 2)
    capacity = capacity or C
    rcfg = rcfg.replace(compaction=mode, power_cutoff=1e-5)
    pcfg = pcfg.replace(compaction=mode, power_cutoff=1e-5)
    ref_rays, ref_culled = ref_compact(sh, capacity, rcfg)
    port_rays, port_culled = S.compact(port_tuple(S.ShadeOut, sh), capacity,
                                       pcfg)
    assert float(port_culled) == pytest.approx(float(ref_culled), rel=1e-5,
                                               abs=1e-7)
    assert_same_live_children(ref_rays, port_rays)
    # same slots, too: top-k keeps jax.lax.top_k's order (stable sort)
    assert_close_tuple(ref_rays, port_rays, atol=0.0, rtol=0.0)


def test_compact_no_split_matches_reference():
    sh, C, rcfg, pcfg = compact_case("config1", 1)
    assert not rcfg.allow_splitting
    ref_rays, ref_culled = ref_compact(sh, C, rcfg.replace(power_cutoff=0.05))
    port_rays, port_culled = S.compact(port_tuple(S.ShadeOut, sh), C,
                                       pcfg.replace(power_cutoff=0.05))
    assert float(port_culled) == float(ref_culled)
    assert_close_tuple(ref_rays, port_rays, atol=0.0, rtol=0.0)


def test_topk_ties_keep_lower_slot():
    # equal-power children overflowing the buffer: the same slots survive
    # as in jax.lax.top_k (lower index first)
    sh, C, rcfg, pcfg = compact_case("config3", 0)
    n = sh.child_power.shape[0]
    power = np.where(np.arange(n) % 3 == 0, 0.25, 0.5).astype(np.float32)
    sh = sh._replace(child_power=jnp.asarray(power),
                     child_alive=jnp.ones(n, bool))
    ref_rays, ref_culled = ref_compact(sh, 500, rcfg)
    port_rays, port_culled = S.compact(port_tuple(S.ShadeOut, sh), 500, pcfg)
    assert_close_tuple(ref_rays, port_rays, atol=0.0, rtol=0.0)
    assert float(port_culled) == pytest.approx(float(ref_culled), rel=1e-6)


def morton_order_np(o, alive, lo, hi, bits=20):
    """The port's Morton order, defined plainly: `bits` a axis over
    [lo, hi] (quantised in float32, as the port does), bit b of axis k at
    bit 3b + k of the code, dead rays keyed 2**62, a stable sort. At
    bits=10 it is the reference's order."""
    span = np.maximum(hi - lo, np.float32(1e-20)).astype(np.float32)
    top = np.float32(2 ** bits - 1)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        f = (o - lo) / span * top
    q = np.clip(f, np.float32(0), top).astype(np.int64)
    code = np.zeros(len(o), np.int64)
    for b in range(bits):
        for k in range(3):
            code |= ((q[:, k] >> b) & 1) << (3 * b + k)
    code = np.where(alive, code, np.int64(1) << 62)
    return np.argsort(code, kind="stable")


def morton_case(case, rng):
    n = 3000
    o = rng.uniform(-2.0, 3.0, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    lo = np.array([-2.0, -2.0, -2.0], np.float32)
    hi = np.array([3.0, 3.0, 3.0], np.float32)
    if case == "dead_rays":
        alive = rng.uniform(size=n) < 0.6
    elif case == "equal_origins":
        # runs of identical origins (ties) and neighbours one code apart
        o[::3] = o[0]
        o[1::7] = o[1]
        o[2::11] = o[2] + np.float32(5.0 / 2 ** 20)
        alive[5::13] = False
    elif case == "flat_box":
        # a flat scene box (z span 0): rays on, above and below its plane
        lo[2] = hi[2] = np.float32(0.5)
        o[: n // 3, 2] = 0.5
        alive[::17] = False
    return o, alive, lo, hi


@pytest.mark.parametrize("case", ["random", "dead_rays", "equal_origins",
                                  "flat_box"])
def test_morton_order_matches_definition(rng, case):
    o, alive, lo, hi = morton_case(case, rng)
    want = morton_order_np(o, alive, lo, hi)
    got = S.morton_order(torch.from_numpy(o), torch.from_numpy(alive),
                         torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    assert np.array_equal(got, want)
    # dead rays last, and every run of equal keys in slot order
    n_live = int(alive.sum())
    assert alive[got[:n_live]].all() and not alive[got[n_live:]].any()
    assert np.all(np.diff(got[n_live:]) > 0)
    if case == "equal_origins":
        same = np.flatnonzero(alive & np.all(o == o[0], axis=1))
        pos = np.argsort(got)[same]
        assert np.all(np.diff(pos) > 0) and len(same) > 500


def test_morton_reorder_matches_reference():
    # the port sorts at 20 bits a axis, the reference at 10: the two
    # batches hold the same rays, each ray bit for bit, in their own orders
    rs, rays, _, _ = setup("config3", 1)
    ref = R.reorder_rays(rs, rays)
    ps, pr = Scene.from_reference(rs, CPU), RayBatch.from_reference(rays, CPU)
    port = S.reorder_rays(ps, pr)
    perm = S.morton_permutation(ps, pr)
    valid = np.any(np.asarray(rs.ww) != 0.0, axis=1)[:, None]
    v0 = np.asarray(rs.v0)
    lo = np.where(valid, v0, np.float32(3.4e38)).min(axis=0)
    hi = np.where(valid, v0, np.float32(-3.4e38)).max(axis=0)
    ref_perm = np.asarray(R.morton_order(rays.o, rays.alive, jnp.asarray(lo),
                                         jnp.asarray(hi)))
    assert np.array_equal(np.asarray(ref.o), np.asarray(rays.o)[ref_perm])
    undo, ref_undo = torch.argsort(perm), np.argsort(ref_perm)
    for f in ref._fields:
        a = getattr(ref, f)
        if a is None:
            continue
        a, b = np.asarray(a)[ref_undo], getattr(port, f)[undo].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f
    assert not torch.equal(perm, torch.arange(len(perm)))
    assert np.array_equal(perm.numpy(), morton_order_np(
        np.asarray(rays.o), np.asarray(rays.alive), lo, hi))
    assert np.array_equal(ref_perm, morton_order_np(
        np.asarray(rays.o), np.asarray(rays.alive), lo, hi, bits=10))


def test_20bit_order_keeps_fewer_pairs_and_the_same_hits():
    """What the 20-bit order buys the cull mask. A config-4-like scene (a
    paraboloid bowl under a radius-100 dome, the port's meshers at reduced
    segments) and 262,144 collimated rays in a 3.5-wide beam: over the
    dome's box a 10-bit code cell is ~0.2 across and holds about a
    thousand of the beam's origins, so 10-bit ray blocks are scattered
    over a cell. In `morton_permutation`'s order each block is a tight
    patch: the mask keeps clearly fewer (block, tile) pairs, and the
    culled first bounce stays equal to brute, per ray and bit for bit,
    once the order is undone."""
    from lightpycl_tpu_torch.ops import intersect as PI

    n = 262_144
    els = [P.optical_elements(180, 90).parabolic_mirror(
               focus=1.0, diameter=4.0, reflectivity=0.95),
           P.optical_elements(64, 16).hemisphere(radius=100.0, name="dome")]
    scene, _ = P.build_scene(els, spatial_sort=True, device=CPU)
    src = P.CollimatedSource(center=(0, 0, 5.0), direction=(0, 0, -1),
                             diameter=3.5, ray_count=n, power=1.0, seed=11)
    rays = RayBatch.from_arrays(*src.sample(), device=CPU)
    valid = torch.any(scene.ww != 0.0, dim=1)[:, None]
    lo = torch.where(valid, scene.v0, 3.4e38).amin(dim=0)
    hi = torch.where(valid, scene.v0, -3.4e38).amax(dim=0)

    def kept(order):
        words = PI.block_tile_mask(scene, rays.o[order], rays.d[order], 1e3,
                                   alive=rays.alive[order])
        return int(np.unpackbits(words.numpy().view(np.uint8)).sum())

    perm = S.morton_permutation(scene, rays)
    k20 = kept(perm)
    k10 = kept(torch.from_numpy(morton_order_np(
        rays.o.numpy(), rays.alive.numpy(), lo.numpy(), hi.numpy(),
        bits=10)))
    # the CPU reads ~0.79 (8.3% of the pairs against 10.5%)
    assert 0 < k20 < 0.9 * k10, (k20, k10)

    # the culled launch in that order, undone, == brute on the slots (a
    # strided sample of them: brute over every ray would take minutes)
    cfg = P.TraceConfig(cull=True)
    t_m, tri_m = PI.intersect(scene, rays.o[perm], rays.d[perm], cfg,
                              alive=rays.alive[perm])
    undo = torch.argsort(perm)
    t, tri = t_m[undo], tri_m[undo]
    sample = torch.arange(0, n, 61)
    t_b, tri_b = PI.intersect(scene, rays.o[sample], rays.d[sample],
                              cfg.replace(cull=False))
    assert torch.equal(tri[sample], tri_b)
    assert torch.equal(t[sample].view(torch.int32), t_b.view(torch.int32))
    # the beam lands on the bowl (all but a handful of its rays)
    assert float((tri >= 0).float().mean()) > 0.999


@pytest.mark.parametrize("name", ["config2", "materials"])
def test_trace_step_matches_reference(name):
    rs, rays, rcfg, pcfg = setup(name, 1)
    p_rays, p_det, p_led, p_aux = S.trace_step(
        Scene.from_reference(rs, CPU), RayBatch.from_reference(rays, CPU),
        DetectorState.zeros(36, 18, 2, device=CPU), Ledger.start(1.0, CPU),
        pcfg)
    det = RefDet.zeros(36, 18, 2)
    led = RefLedger.start(1.0)
    # (the jitted reference step consumes its input batch)
    r_rays, r_det, r_led, r_aux = ref_step(rs, rays, det, led, rcfg)
    for f in RefLedger._fields:
        assert float(getattr(p_led, f)) == pytest.approx(
            float(getattr(r_led, f)), rel=1e-5, abs=1e-6), f
    m = int(r_aux.measured_count)
    assert m == int(p_aux.measured_count) and int(r_aux.live_count) == \
        int(p_aux.live_count)
    for f in ("m_pos", "m_dir", "m_power", "m_det", "m_wl", "m_opl"):
        a, b = np.asarray(getattr(r_aux, f))[:m], getattr(p_aux, f).numpy()[:m]
        assert np.allclose(a, b, rtol=0, atol=1e-5), f
    assert np.allclose(np.asarray(r_det.per_detector), p_det.per_detector,
                       rtol=1e-5, atol=ATOL)


def test_unported_branches_raise():
    """These switches once raised NotImplementedError; the branches are
    ported, so each now shades the config-1 batch to a closed power balance
    (the random ones given uniforms, and refusing to run without them)."""
    rs, rays, rcfg, pcfg = setup("config1")
    ps, pr = Scene.from_reference(rs, CPU), RayBatch.from_reference(rays, CPU)
    t, tri = S.intersect(ps, pr.o, pr.d, pcfg)
    live = float(pr.power[pr.alive].sum())
    base = S.shade(ps, pr, t, tri, pcfg)
    for kw in (dict(polarization=True), dict(has_gratings=True),
               dict(has_coatings=True), dict(has_metals=True),
               dict(has_diffuse=True), dict(has_roughness=True)):
        cfg = pcfg.replace(**kw)
        random = cfg.has_diffuse or cfg.has_roughness
        if random:
            with pytest.raises(ValueError, match="uniforms"):
                S.shade(ps, pr, t, tri, cfg)
        un = S.draw_shade_uniforms(cfg, pr.capacity,
                                   S.make_generator(CPU, 0), CPU)
        sh = S.shade(ps, pr, t, tri, cfg, uniforms=un)
        out = float(sh.absorbed + sh.escaped + sh.measured_power.sum()
                    + sh.child_power.sum() + sh.policy_dropped)
        assert out == pytest.approx(live, abs=1e-5), kw
        # no element of config 1 uses the feature: the powers stay put
        assert torch.equal(sh.child_power, base.child_power), kw


@pytest.mark.parametrize("n_bins", [1, 7, 648])
def test_bincount_sorted_matches_float64(rng, n_bins):
    idx = rng.integers(0, n_bins, 5000)
    idx[:50] = n_bins - 1  # one long run
    vals = rng.uniform(0, 1e-3, 5000).astype(np.float32)
    out = S.bincount_sorted(torch.from_numpy(idx), torch.from_numpy(vals),
                            n_bins)
    ref = np.bincount(idx, weights=vals.astype(np.float64),
                      minlength=n_bins)
    assert out.dtype == torch.float32 and out.shape == (n_bins,)
    assert np.allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    # the same inputs in another slot order give the same per-bin sums
    # (up to association), and an empty input gives zeros
    perm = torch.from_numpy(rng.permutation(5000))
    again = S.bincount_sorted(torch.from_numpy(idx)[perm],
                              torch.from_numpy(vals)[perm], n_bins)
    assert np.allclose(again.numpy(), ref, rtol=1e-6, atol=0)
    assert not S.bincount_sorted(torch.zeros(0, dtype=torch.int64),
                                 torch.zeros(0), n_bins).any()
