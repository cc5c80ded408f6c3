"""The port's exact quadric path (lightpycl_tpu_torch/ops/quadric.py,
step.merge_analytic and the normal override in trace_step) against the JAX
package's on identical scenes and rays: hit distance abs 1e-5 (plus 2e-6 of
it, 32 units of float32 roundoff, for rays that start hundreds of units away
and may graze), identical
attribute rows, normals abs 3e-6; then whole traces of analytic optics
through both Tracers, ledger terms abs 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu import sources as ref_sources
from lightpycl_tpu.ops import quadric as RQ
from lightpycl_tpu.tracer import step as R
from lightpycl_tpu.tracer.rays import DetectorState as RefDet
from lightpycl_tpu.tracer.rays import Ledger as RefLedger
from lightpycl_tpu_torch import sources as port_sources
from lightpycl_tpu_torch.ops import quadric as PQ
from lightpycl_tpu_torch.tracer import step as S
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene
from torch_port_common import (CPU, assert_shade_close, both_cfg,
                               ref_batch)

torch.set_num_threads(1)
C = 2048
# normals abs 3e-6; from 900 units away the hit distance is only good to
# 2e-6 of itself (see assert_same_hits), and a surface of unit radius turns
# that much of its hit point into as much of its normal
NORMAL = {"near": 3e-6, "rim": 3e-6, "axial": 3e-6, "far": 2e-3}


def bench(M, world=True):
    """A conic lens with its cylinder wall, a hyperbolic mirror, an
    annulus and a disc beside one mesh lens, inside an enclosing sphere.
    For rays that start hundreds of units outside (`world=False`) the
    sphere goes, and so do the two planes: a plane's axial bound is 1e-6
    wide, the hit point's float32 roundoff at that distance 6e-5, so
    whether either package accepts such a hit is chance."""
    oe = M.optical_elements(16, 6)
    els = [*M.analytic_lens(1.0, -1.5, 0.8, 0.25, ior=1.6, k1=-0.5),
           M.analytic_mirror(2.0, 1.2, k=-1.3, center=(1.5, 0, 0.5)),
           oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, center=(0, 1.5, 0.5))]
    if not world:
        return els
    return els + [
        M.analytic_annulus(0.2, 0.7, vertex=(0, 0, 1.2)),
        M.analytic_disc(0.6, vertex=(-1.5, 0.2, 0.8), axis=(1, 0, 1)),
        *M.analytic_sphere(6.0, name="world")]


def rays_for(kind, rng):
    """(o, d) float32 (C, 3) of a ray family."""
    def unit(v):
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    if kind == "near":
        o = rng.uniform(-2.5, 2.5, (C, 3))
        d = unit(rng.normal(size=(C, 3)))
    elif kind == "far":
        # origins 300 .. 900 away, aimed at the optics: the recentring case
        d = unit(rng.normal(size=(C, 3)))
        # at the lens (aperture 0.8 at the origin) or the mirror beside it
        target = rng.uniform(-1.0, 1.0, (C, 3)) * [0.3, 0.3, 0.1] \
            + np.where(rng.uniform(size=(C, 1)) < 0.5, [0.0, 0, 0.1],
                       [1.5, 0, 0.55])
        o = target - rng.uniform(300.0, 900.0, (C, 1)) * d
    elif kind == "rim":
        # aimed at the lens's rim radius 0.4 and the annulus's edges, a few
        # 1e-7 to either side, along z
        ang = rng.uniform(0, 2 * np.pi, C)
        r = rng.choice([0.4, 0.2, 0.7], C) + rng.choice(
            [-3e-7, -1e-7, 0.0, 1e-7, 3e-7], C)
        o = np.stack([r * np.cos(ang), r * np.sin(ang), np.full(C, -2.0)], 1)
        d = np.tile([0.0, 0.0, 1.0], (C, 1))
    else:  # "axial": parallel to the lens axis, inside and on its wall
        ang = rng.uniform(0, 2 * np.pi, C)
        r = np.where(rng.uniform(size=C) < 0.5, 0.4,
                     rng.uniform(0.0, 0.45, C))
        o = np.stack([r * np.cos(ang), r * np.sin(ang),
                      rng.uniform(-1.0, 0.1, C)], 1)
        d = np.tile([0.0, 0.0, 1.0], (C, 1)) * rng.choice([-1.0, 1.0],
                                                          (C, 1))
    return np.asarray(o, np.float32), np.asarray(d, np.float32)


def both_scenes(world):
    rs, _ = L.build_scene(bench(L, world))
    rcfg, pcfg = both_cfg(bench(L, world))
    assert rcfg.has_analytic
    return rs, Scene.from_reference(rs, CPU), rcfg, pcfg


@pytest.fixture(scope="module")
def scenes():
    return both_scenes(True)


@pytest.fixture(scope="module")
def open_scenes():
    return both_scenes(False)


def on_aperture_edge(ps, o, d, t, tri):
    """(C,) bool: the hit point o + t d lies within 1e-4 of a radial or
    axial bound of the surface that owns attribute row tri. There one unit
    of roundoff decides whether the bound accepts the hit, so two float32
    evaluations may answer with different roots."""
    q = (tri[:, None] == ps.quad_tri[None, :]).to(torch.int32).argmax(1)
    p = PQ._to_local(o + t[:, None] * d - ps.quad_vertex[q],
                     ps.quad_frame[q])
    r = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
    near_r = ((r[:, None] - ps.quad_rlim[q]).abs() < 1e-4).any(1)
    near_z = ((p[:, 2:3] - ps.quad_zlim[q]).abs() < 1e-4).any(1)
    return near_r | near_z


def assert_same_hits(ps, o, d, rt, rtri, pt, ptri):
    """Identical attribute rows and t within 1e-5 (+ 2e-6 t), except on
    the few lanes (under 0.2%) where either side's hit sits on an aperture
    edge."""
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    rt, rtri = torch.from_numpy(np.array(rt)), torch.from_numpy(
        np.array(rtri))
    hit = (rtri >= 0) | (ptri >= 0)
    same = (rtri == ptri) & (torch.isinf(rt) == torch.isinf(pt)) & (
        ~hit | ((rt - pt).abs() <= 1e-5 + 2e-6 * rt))
    differ = ~same
    assert int(differ.sum()) <= 0.002 * len(rt), int(differ.sum())
    edge = torch.zeros_like(differ)
    for t, tri in ((rt, rtri), (pt, ptri)):
        ok = differ & (tri >= 0)
        edge |= ok & on_aperture_edge(
            ps, o, d, torch.where(ok, t, 0.0), tri.clamp_min(0))
    assert bool((edge | same).all())
    return (same & hit).numpy()


ref_quadrics = jax.jit(RQ.intersect_quadrics, static_argnames=("cfg",))
ref_merge = jax.jit(R.merge_analytic, static_argnames=("cfg",))
ref_intersect = jax.jit(R.intersect_jnp, static_argnames=("cfg",))


@pytest.mark.parametrize("kind", ["near", "far", "rim", "axial"])
def test_intersect_quadrics_matches_reference(scenes, open_scenes, kind, rng):
    rs, ps, rcfg, pcfg = open_scenes if kind == "far" else scenes
    o, d = rays_for(kind, rng)
    rt, rtri, rn = ref_quadrics(rs, jnp.asarray(o), jnp.asarray(d), rcfg)
    pt, ptri, pn = PQ.intersect_quadrics(ps, torch.from_numpy(o),
                                         torch.from_numpy(d), pcfg)
    rt, rtri, rn = np.asarray(rt), np.asarray(rtri), np.asarray(rn)
    assert ptri.dtype == torch.int32 and pt.dtype == torch.float32
    hit = assert_same_hits(ps, o, d, rt, rtri, pt, ptri)
    assert hit.sum() > C // 8, "the family must hit the optics"
    assert np.allclose(rn[hit], pn.numpy()[hit], rtol=0, atol=NORMAL[kind])
    assert np.all(np.isfinite(pn.numpy()))
    # more than one surface answers
    assert len(np.unique(rtri[hit])) >= (2 if kind == "rim" else 3)


def test_far_origins_keep_scene_scale_accuracy(scenes, rng):
    """From 300 .. 900 units away the hit point still lands on the quadric
    to 2e-4 (f32 at that distance), which is what the recentring buys."""
    _, ps, _, pcfg = scenes
    o, d = rays_for("far", rng)
    t, tri, _ = PQ.intersect_quadrics(ps, torch.from_numpy(o),
                                      torch.from_numpy(d), pcfg)
    world = tri >= int(ps.quad_tri[-2])   # the two sphere caps
    p = torch.from_numpy(o) + t[:, None] * torch.from_numpy(d)
    assert int(world.sum()) > 100
    assert float((p[world].norm(dim=1) - 6.0).abs().max()) < 2e-4


@pytest.mark.parametrize("kind", ["near", "far"])
def test_merge_analytic_matches_reference(scenes, open_scenes, kind, rng):
    rs, ps, rcfg, pcfg = open_scenes if kind == "far" else scenes
    o, d = rays_for(kind, rng)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t0, tri0 = ref_intersect(rs, jo, jd, rcfg)
    rt, rtri, (ruse, rnq) = ref_merge(rs, jo, jd, t0, tri0, rcfg)
    pt, ptri, (puse, pnq) = S.merge_analytic(
        ps, to, td, torch.from_numpy(np.array(t0)),
        torch.from_numpy(np.array(tri0)), pcfg)
    rt = np.asarray(rt)
    fin = np.isfinite(rt)
    # the triangle hit was fed in: where it wins, it passes through
    mesh = fin & ~np.asarray(ruse) & ~puse.numpy()
    assert np.array_equal(np.asarray(rtri)[mesh], ptri.numpy()[mesh])
    assert np.array_equal(rt[mesh], pt.numpy()[mesh])
    use = np.asarray(ruse) & assert_same_hits(
        ps, o, d, np.where(np.asarray(ruse), rt, np.inf),
        np.where(np.asarray(ruse), np.asarray(rtri), -1),
        torch.where(puse, pt, float("inf")), torch.where(puse, ptri, -1))
    assert np.allclose(np.asarray(rnq)[use], pnq.numpy()[use], rtol=0,
                       atol=NORMAL[kind])
    # the mesh lens still wins where it is nearer
    assert (np.asarray(rtri)[fin] >= 0).all() and mesh.any()
    # gated off: untouched
    off = S.merge_analytic(ps, to, td, pt, ptri,
                           pcfg.replace(has_analytic=False))
    assert off[2] is None and off[0] is pt


def test_trace_step_overrides_normals(scenes):
    """One bounce through both packages on the analytic bench: the exact
    normals reach shade (the children leave in the same directions), and
    the step books the same ledger."""
    rs, ps, rcfg, pcfg = scenes
    src = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                             diameter=0.7, ray_count=1500, seed=7)
    o, d, p = src.sample()
    rays = RayBatch.from_arrays(o, d, p, capacity=C, device=CPU)
    jr = ref_batch(rays)

    @jax.jit
    def ref_children(rays):
        t, tri = R.intersect_jnp(rs, rays.o, rays.d, rcfg)
        t, tri, (use_q, nq) = R.merge_analytic(rs, rays.o, rays.d, t, tri,
                                               rcfg)
        attrs = R.default_hit_attrs(rs, jnp.maximum(tri, 0), rcfg)
        attrs["normal"] = jnp.where(use_q[:, None], nq, attrs["normal"])
        return R.shade(rs, rays, t, tri, rcfg, attrs=attrs), use_q

    ref, use_q = ref_children(jr)
    t, tri = S.intersect(ps, rays.o, rays.d, pcfg)
    t, tri, (puse, nq) = S.merge_analytic(ps, rays.o, rays.d, t, tri, pcfg)
    attrs = S.default_hit_attrs(ps, tri.clamp_min(0), pcfg)
    attrs["normal"] = torch.where(puse[:, None], nq, attrs["normal"])
    port = S.shade(ps, rays, t, tri, pcfg, attrs=attrs)
    assert int(puse.sum()) >= 1500 and np.array_equal(np.asarray(use_q),
                                                      puse.numpy())
    assert_shade_close(ref, port, rays)
    # the facet normal of the placeholder triangle would send them elsewhere
    flat = S.shade(ps, rays, t, tri, pcfg)
    assert float((flat.child_d - port.child_d).abs().max()) > 1e-2

    _, _, rled, _ = R.trace_step_jit(rs, jr, RefDet.zeros(36, 18, 2),
                                     RefLedger.start(1.0), rcfg)
    _, _, pled, _ = S.trace_step(
        ps, rays, DetectorState.zeros(36, 18, 2, device=CPU),
        Ledger.start(1.0, CPU), pcfg)
    for f in RefLedger._fields:
        assert float(getattr(pled, f)) == pytest.approx(
            float(getattr(rled, f)), abs=1e-6), f


TRACES = {
    # name: (elements(M), source kwargs, iterations, capacity)
    "plano_convex": (
        lambda M: [*M.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5),
                   M.analytic_disc(3.0, vertex=(0, 0, 2.5), name="det")],
        dict(center=(0, 0, -0.5), direction=(0, 0, 1), diameter=0.08,
             ray_count=512, seed=3, sampling="hexapolar"), 8, 4096),
    "biconvex_mesh_detector": (
        lambda M: [*M.analytic_biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
                   M.optical_elements(16, 6).disc(
                       radius=5.0, center=(0, 0, 4.0), material="measure",
                       name="det")],
        dict(center=(0, 0, -1.0), direction=(0, 0, 1), diameter=0.6,
             ray_count=1000, seed=7), 6, 8192),
    "paraboloid": (
        lambda M: [M.analytic_mirror(1.0, 2.0, k=-1.0, reflectivity=0.9),
                   M.optical_elements(16, 6).hemisphere(20.0, name="dome")],
        None, 4, None),
}


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_analytic_trace_matches_reference(name, mode):
    make, src_kw, iters, cap = TRACES[name]

    def run(M, srcs, tracer):
        src = (srcs.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                                 power=1.0, ray_count=2000, seed=5)
               if src_kw is None
               else srcs.CollimatedSource(power=1.0, **src_kw))
        return tracer.trace(src, make(M), trace_iterations=iters,
                            capacity=cap, mode=mode)

    ref = run(L, ref_sources, L.Tracer())
    port = run(P, port_sources, P.Tracer(device=CPU))
    assert port.iterations_run == ref.iterations_run
    # the collimated traces run culled, each package's bounces in its own
    # Morton order (the port's at 20 bits a axis, the reference's at 10),
    # so every float32 sum below adds its terms in another order: the
    # ledger to abs 1e-6, per detector to abs 1e-5
    for k in ref.ledger:
        assert port.ledger[k] == pytest.approx(ref.ledger[k], abs=1e-6), k
    assert port.power_conservation_error() < 1e-5
    # per detector against the reference's ledger: its one-bin scatter-add
    # of 2,000 float32 terms is itself 5e-6 off its own ledger
    assert float(port.per_detector.sum()) == pytest.approx(
        ref.ledger["measured"], abs=1e-6)
    assert np.allclose(port.per_detector, ref.per_detector, rtol=0,
                       atol=1e-5)
    if mode == "host":
        # the measured rays, ray by ray: the lists follow each package's
        # order, so each port ray is paired with a reference ray first
        assert len(port.measured_power) == len(ref.measured_power) > 0
        j = match_rays(port.measured_pos, port.measured_dir,
                       ref.measured_pos, ref.measured_dir)
        assert np.allclose(port.measured_pos, ref.measured_pos[j], rtol=0,
                           atol=2e-5)
        assert np.allclose(port.measured_dir, ref.measured_dir[j], rtol=0,
                           atol=3e-6)


def match_rays(pos, dirs, ref_pos, ref_dir):
    """The one-to-one pairing of rays (pos, dirs) with (ref_pos, ref_dir)
    that least moves them, as an index into the reference's rows (the cost
    of a pair: the largest gap of its six coordinates)."""
    from scipy.optimize import linear_sum_assignment

    a = np.concatenate([pos, dirs], axis=1).astype(np.float64)
    b = np.concatenate([ref_pos, ref_dir], axis=1).astype(np.float64)
    cost = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    rows, cols = linear_sum_assignment(cost)
    return cols[np.argsort(rows)]


def test_analytic_focus_beats_the_mesh():
    """The same plano-convex lens, exact and tessellated, in the port: the
    analytic spot at the paraxial focus is the smaller one."""
    def spot(lens):
        det = P.analytic_disc(3.0, vertex=(0, 0, 1.05), name="det")
        src = P.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                                 diameter=0.08, ray_count=512, seed=3,
                                 sampling="hexapolar")
        res = P.Tracer(device=CPU).trace(src, [*lens, det],
                                         trace_iterations=4, capacity=2048)
        main = res.measured_power > 0.5 * res.measured_power.max()
        xy = res.measured_pos[main][:, :2]
        return float(np.sqrt((xy ** 2).sum(1).mean()))

    exact = spot(P.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5))
    mesh = spot([P.optical_elements(32, 12).plano_convex_lens(
        r=0.5, aperture=0.4, thickness=0.05, ior=1.5)])
    assert exact < mesh
