"""The port's differentiable meshed design (lightpycl_tpu_torch/diff.py)
against the JAX package's lightpycl_tpu/diff.py, on the CPU.

Parity on the same seeded numpy inputs: every Scene column of
`scene_from_triangles` within 1e-6 of its row's scale (from the port's own
mesh and from the reference's vertices), `intersect_diff` with identical
triangle indices and t within 1e-5 relative, `trace_diff`'s escaped
(o, d, power) within 1e-5, and `make_spot_loss` with its gradient in
(c1, c2, z_plane) (torch.autograd.grad against jax.grad) within 1e-5
relative. A faceted loss is ill-conditioned where a ray meets a facet edge
(one ulp picks the other facet), and the reference's jitted run fuses its
arithmetic otherwise than its own op-by-op run, so the trace and the loss
are held to the op-by-op reference. Then the reference's own contracts of
tests/test_diff.py on the port: the numpy build's transform rows, zero
degenerate rows with exactly zero (and finite) gradients, power
conservation, a converging beam, AD against central finite differences
within 2e-2. The lensmaker descent and the meshed stigmatic-conic descent
(~90 s and minutes on one CPU core) run on the card in chip_smoke.py's
phase 25.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightpycl_tpu import diff as RD
from lightpycl_tpu.tracer.rays import RayBatch as RefRayBatch
from lightpycl_tpu_torch import diff as PD
from lightpycl_tpu_torch.geometry.mesh import GeoObject
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.tracer.rays import RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene, build_scene
from torch_port_common import (CPU, leaves, port_default_cpu,  # noqa: F401
                               same_rows)

torch.set_num_threads(1)

N_GLASS = 1.5
T_C = 0.3
APERTURE = 1.0
RCFG = RD.TraceConfig(backend="jnp", has_gratings=False, has_coatings=False,
                      has_metals=False)
PCFG = PD.TraceConfig(backend="jnp", has_gratings=False, has_coatings=False,
                      has_metals=False)
LOSS_SIZE = dict(ior=N_GLASS, thickness=T_C, aperture_radius=APERTURE,
                 n_rays=150, beam_fill=0.6, n_seg=32, n_rad=8)

def row_scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    scale = np.maximum(np.abs(a).max(axis=1, keepdims=True), 1.0)
    return np.max(np.abs(a - b) / scale)


@pytest.fixture(scope="module")
def scenes():
    """(reference scene, the port's own scene, the port's scene of the
    reference's vertices) of one singlet."""
    args = (0.55, -0.1, T_C, APERTURE, N_GLASS)
    kw = dict(n_seg=LOSS_SIZE["n_seg"], n_rad=LOSS_SIZE["n_rad"])
    ref = RD.singlet_scene(*args, **kw)
    own = PD.singlet_scene(*args, **kw)
    tv = np.array(RD.singlet_triangles(*args[:4], **kw))
    same = PD.scene_from_triangles(torch.from_numpy(tv),
                                   mat=int(Material.REFRACTIVE), ior=N_GLASS)
    return ref, own, same


@pytest.fixture(scope="module")
def rays():
    """Seeded rays into and around the lens: a collimated sheet, rays aimed
    at random points of the lens, and rays in random directions from
    inside it."""
    rng = np.random.default_rng(11)
    n = 512
    o = np.concatenate([
        np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                  np.full(n, -1.0)], 1),
        rng.uniform(-2.0, 2.0, (n, 3)),
        np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                  rng.uniform(0.05, 0.25, n)], 1)])
    aim = np.stack([rng.uniform(-0.9, 0.9, 3 * n),
                    rng.uniform(-0.9, 0.9, 3 * n),
                    rng.uniform(0.0, T_C, 3 * n)], 1)
    d = aim - o
    d[:n] = (0.0, 0.0, 1.0)
    d[2 * n:] = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = np.full(3 * n, 1.0 / (3 * n))
    ref = RefRayBatch.from_arrays(jnp.asarray(o, jnp.float32),
                                  jnp.asarray(d, jnp.float32),
                                  jnp.asarray(p, jnp.float32),
                                  capacity=4 * 3 * n)
    return ref, RayBatch.from_reference(ref, CPU)


class TestApi:
    def test_exports_every_public_name_with_the_same_signature(self):
        names = [n for n in dir(RD) if not n.startswith("_")
                 and not inspect.ismodule(getattr(RD, n))
                 and n != "annotations"]
        assert "trace_diff" in names and "TraceConfig" in names
        for n in names:
            assert hasattr(PD, n), n
            r = getattr(RD, n)
            if inspect.isfunction(r) and r.__module__ == RD.__name__:
                rs = inspect.signature(r).parameters
                ps = inspect.signature(getattr(PD, n)).parameters
                assert [(k, v.kind, v.default) for k, v in rs.items()] == [
                    (k, v.kind, v.default) for k, v in ps.items()], n


class TestSceneParity:
    def test_columns_match_reference(self, scenes):
        ref, own, same = scenes
        for f in Scene._fields:
            a = getattr(ref, f, None)
            if a is None:
                assert getattr(own, f) is None and getattr(same, f) is None
                continue
            for port in (own, same):
                b = getattr(port, f).detach().numpy()
                assert b.shape == a.shape and b.dtype == a.dtype, f
                if b.dtype == np.int32:
                    np.testing.assert_array_equal(b, np.asarray(a), f)
                else:
                    # 1e-6 of a row's scale: a few float32 roundings (the
                    # cross products' and cos / sin's own)
                    assert row_scaled_err(a, b) <= 1e-6, f

    def test_unit_transform_rows_match_numpy_build(self):
        tv = PD.singlet_triangles(0.5, -0.2, T_C, APERTURE, n_seg=16,
                                  n_rad=4).numpy()
        verts = tv.reshape(-1, 3)
        tris = np.arange(len(verts)).reshape(-1, 3)
        obj = GeoObject(verts, tris, material="refractive", ior=N_GLASS)
        scene_np, _ = build_scene([obj], pad_to=1, device=CPU)
        scene_t = PD.scene_from_triangles(torch.from_numpy(tv), mat=2,
                                          ior=N_GLASS, pad_to=1)
        for f in ("wu", "wv", "ww", "normal"):
            assert row_scaled_err(getattr(scene_np, f),
                                  getattr(scene_t, f)) < 1e-4, f


class TestDegenerateRows:
    def _rows(self, tv):
        return PD.unit_transform_rows(tv[:, 0], tv[:, 1] - tv[:, 0],
                                      tv[:, 2] - tv[:, 0])

    def test_zero_rows_and_exactly_zero_finite_gradients(self):
        tv = PD.singlet_triangles(0.5, 0.0, T_C, APERTURE, n_seg=8,
                                  n_rad=2).detach().requires_grad_(True)
        wu, wv, ww = self._rows(tv)
        e1, e2 = tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
        area2 = torch.sum(torch.linalg.cross(e1, e2) ** 2, dim=1).detach()
        degen = (area2 < 1e-16).numpy()
        assert degen.any() and not degen.all()
        for w in (wu, wv, ww):
            assert np.all(w.detach().numpy()[degen] == 0.0)
        g, = torch.autograd.grad(torch.sum(wu) + torch.sum(wv)
                                 + torch.sum(ww), tv)
        g = g.numpy()
        assert np.isfinite(g).all()
        assert np.all(g[degen] == 0.0)
        # and the same cotangents as jax.grad on the same vertices
        def f(v):
            a, b, c = RD.unit_transform_rows(v[:, 0], v[:, 1] - v[:, 0],
                                             v[:, 2] - v[:, 0])
            return jnp.sum(a) + jnp.sum(b) + jnp.sum(c)

        gr = np.asarray(jax.grad(f)(jnp.asarray(tv.detach().numpy())))
        assert np.all(gr[degen] == 0.0)
        np.testing.assert_allclose(g, gr, rtol=1e-5,
                                   atol=1e-5 * np.abs(gr).max())

    def test_gradient_in_curvature_matches_jax(self):
        def port(c1):
            tv = PD.singlet_triangles(c1, 0.0, T_C, APERTURE, n_seg=8,
                                      n_rad=2)
            return sum(torch.sum(w) for w in self._rows(tv))

        def ref(c1):
            tv = RD.singlet_triangles(c1, 0.0, T_C, APERTURE, n_seg=8,
                                      n_rad=2)
            w = RD.unit_transform_rows(tv[:, 0], tv[:, 1] - tv[:, 0],
                                       tv[:, 2] - tv[:, 0])
            return sum(jnp.sum(x) for x in w)

        c1, = leaves(0.5)
        g, = torch.autograd.grad(port(c1), c1)
        gr = float(jax.jit(jax.grad(ref))(jnp.float32(0.5)))
        assert np.isfinite(float(g))
        assert float(g) == pytest.approx(gr, rel=1e-4)


class TestIntersectAndTraceParity:
    def test_intersect_diff_matches_reference(self, scenes, rays):
        ref, _, _ = scenes
        rr, pr = rays
        port = Scene.from_reference(ref, CPU)
        t_r, i_r = RD.intersect_diff(ref, rr.o, rr.d, RCFG)
        t_p, i_p = PD.intersect_diff(port, pr.o, pr.d, PCFG)
        i_r = np.asarray(i_r)
        assert i_p.dtype == torch.int32
        np.testing.assert_array_equal(i_p.numpy(), i_r)
        assert (i_r >= 0).any() and (i_r < 0).any()
        np.testing.assert_allclose(t_p.numpy(), np.asarray(t_r), rtol=1e-5,
                                   atol=1e-6)

    def test_trace_diff_escaped_matches_reference(self, scenes):
        # op by op on both sides; the escaped rays as sets: children of
        # equal power tie in the compaction, and one ulp of a power (the
        # reference's fused multiply-adds on some hosts) moves a ray to
        # another slot
        ref, _, _ = scenes
        rr = RD.collimated_bundle(LOSS_SIZE["n_rays"], 0.6)
        out_r, (eo, ed, ep) = RD.trace_diff(ref, rr, RCFG, 4,
                                            collect_escaped=True)
        out_p, (po, pd_, pp) = PD.trace_diff(
            Scene.from_reference(ref, CPU), RayBatch.from_reference(rr, CPU),
            PCFG, 4, collect_escaped=True)
        ep, pp = np.asarray(ep), pp.numpy()
        assert pp.shape == ep.shape
        # the escaped rays; other slots carry no power
        live_r, live_p = ep > 0.0, pp > 0.0
        assert live_r.sum() == live_p.sum() > 150
        rows = lambda o, d, p, m: np.concatenate(  # noqa: E731
            [np.asarray(o), np.asarray(d), np.asarray(p)[:, None]],
            axis=1)[m].astype(np.float64)
        same_rows(rows(eo, ed, ep, live_r), rows(po, pd_, pp, live_p),
                  np.array([1e-5] * 6 + [1e-5 * ep.max()]))
        np.testing.assert_array_equal(out_p.alive.numpy(),
                                      np.asarray(out_r.alive))

    def test_collimated_bundle_matches_reference(self):
        ref = RD.collimated_bundle(150, 0.6)
        port = PD.collimated_bundle(150, 0.6)
        assert port.capacity == ref.capacity == 600
        assert port.device == CPU
        for f in ("power", "alive"):
            np.testing.assert_array_equal(getattr(port, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        np.testing.assert_allclose(port.o.numpy(), np.asarray(ref.o),
                                   atol=1e-7)


class TestSpotLossParity:
    @pytest.fixture(scope="class")
    def losses(self):
        return RD.make_spot_loss(**LOSS_SIZE), PD.make_spot_loss(**LOSS_SIZE)

    @pytest.mark.parametrize("args", [(0.55, -0.1, 4.0), (0.62, 0.0, 3.6)])
    def test_loss_and_gradient_match_jax_grad(self, losses, args):
        rl, pl = losses
        # the reference's loss op by op (`__wrapped__` of its jax.jit): its
        # jitted run fuses the arithmetic otherwise, and one ulp of a hit
        # on a facet edge moves this faceted loss far more than 1e-5
        v, g = jax.value_and_grad(rl.__wrapped__, argnums=(0, 1, 2))(*args)
        ts = leaves(*args)
        pv = pl(*ts)
        pg = torch.autograd.grad(pv, ts)
        assert pv.item() == pytest.approx(float(v), rel=1e-5)
        for a, b in zip(pg, g):
            assert np.isfinite(float(a))
            assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-7)

    def test_spot_rms_at_plane_matches_reference(self, rays):
        rr, pr = rays
        args = (3.5, 0.5, 0.2 * float(rr.power.max()))
        r = RD.spot_rms_at_plane(rr.o, rr.d, rr.power, *args)
        zs, = leaves(args[0])
        p = PD.spot_rms_at_plane(pr.o, pr.d, pr.power, zs, *args[1:])
        assert p.item() == pytest.approx(float(r), rel=1e-6)
        g, = torch.autograd.grad(p, zs)
        gr = jax.grad(lambda z: RD.spot_rms_at_plane(
            rr.o, rr.d, rr.power, z, *args[1:]))(jnp.float32(args[0]))
        assert float(g) == pytest.approx(float(gr), rel=1e-5)


class TestDiffTrace:
    def test_power_conserved_through_diff_path(self):
        scene = PD.singlet_scene(0.5, -0.3, T_C, APERTURE, N_GLASS,
                                 n_seg=24, n_rad=6)
        rays0 = PD.collimated_bundle(200, 0.6)
        out, (eo, ed, ep) = PD.trace_diff(scene, rays0, PCFG, 5,
                                          collect_escaped=True)
        emitted = float(torch.sum(rays0.power))
        escaped = float(torch.sum(ep))
        live = float(torch.sum(torch.where(out.alive, out.power, 0.0)))
        assert emitted == pytest.approx(escaped + live, abs=2e-5)
        assert escaped > 0.95 * emitted

    def test_transmitted_beam_converges_toward_focus(self):
        scene = PD.singlet_scene(0.5, 0.0, T_C, APERTURE, N_GLASS,
                                 n_seg=32, n_rad=8)
        rays0 = PD.collimated_bundle(100, 0.5)
        _, (eo, ed, ep) = PD.trace_diff(scene, rays0, PCFG, 4,
                                        collect_escaped=True)
        eo, ed, ep = eo.numpy(), ed.numpy(), ep.numpy()
        fwd = (ed[:, 2] > 0.5) & (ep > 1e-6)
        r = np.hypot(eo[fwd, 0], eo[fwd, 1])
        vr = eo[fwd, 0] * ed[fwd, 0] + eo[fwd, 1] * ed[fwd, 1]
        off_axis = r > 0.05
        assert off_axis.sum() > 50
        assert np.all(vr[off_axis] < 0.0)


class TestGradients:
    def test_ad_matches_finite_differences(self):
        # The meshed loss is smooth only piecewise: as an argument moves, a
        # ray that meets a facet edge picks the other facet and the loss
        # steps (along c1 here by up to ~3e-4 against a slope of ~0.9), so
        # one central difference at h = 2e-3 lands a few percent off, by
        # where the steps fall. The port's AD is held to jax.grad of the
        # reference's loss (op by op) at the same point, and to a
        # difference quotient that averages the steps: the least-squares
        # slope of the loss over 2 K points x +- h_k, h_k = w k / K (the
        # mean of the central differences at h_k weighted by h_k^2),
        # itself converged: equal at w and 2 w.
        loss = PD.make_spot_loss(**LOSS_SIZE)
        args = (0.55, -0.1, 4.0)
        ts = leaves(*args)
        g = torch.autograd.grad(loss(*ts), ts)
        _, gr = jax.value_and_grad(RD.make_spot_loss(**LOSS_SIZE).__wrapped__,
                                   argnums=(0, 1, 2))(*args)
        for a, b in zip(g, gr):
            assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-7)
        K, w = 10, 5e-3
        with torch.no_grad():
            for i in range(3):
                cd = {}

                def slope(width):
                    hs = width * np.arange(1, K + 1) / K
                    for h in hs:
                        if h not in cd:
                            hi, lo = list(args), list(args)
                            hi[i] += h
                            lo[i] -= h
                            cd[h] = (float(loss(*hi))
                                     - float(loss(*lo))) / (2 * h)
                    return (sum(h * h * cd[h] for h in hs)
                            / float(np.sum(hs * hs)))

                s1, s2 = slope(w), slope(2 * w)
                assert s1 == pytest.approx(s2, rel=1e-2, abs=1e-4), i
                for fd in (s1, s2):
                    assert float(g[i]) == pytest.approx(fd, rel=2e-2,
                                                        abs=1e-4), i
