"""The port's differentiable exact-surface design (diff.py's
quadric_intersect_diff, analytic_singlet_scene, trace_diff_analytic,
make_analytic_spot_loss) against the JAX package's, on the CPU.

Parity on the same inputs: the analytic scene's quadric columns within 2
units of float32 roundoff, `quadric_intersect_diff` with identical
attribute rows, t within 1e-5 relative and normals within 1e-5, and
`make_analytic_spot_loss` with its gradient in all five arguments
(torch.autograd.grad against jax.grad of the jitted reference) within 1e-5
relative: exact surfaces carry no facet noise, so the jitted reference and
the port agree to ~1e-6. Then the reference's own contracts of
tests/test_diff_analytic.py on the port: the forward engine's paraxial
crossings, AD against finite differences within 5e-2, the stigmatic
singlet's landscape minimum at k = -n^2, and the Coddington best-form
basin. Adam's descent to k = -n^2 (60 value-and-grad steps, ~10 s on one
CPU core) runs on the card in chip_smoke.py's phase 25c.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightpycl_tpu import diff as RD
from lightpycl_tpu_torch import diff as PD
from lightpycl_tpu_torch.tracer.rays import RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene
from torch_port_common import CPU, leaves, port_default_cpu  # noqa: F401

torch.set_num_threads(1)

N_GLASS = 1.5
PCFG = PD.TraceConfig(backend="jnp")
RCFG = RD.TraceConfig(backend="jnp")
# the loss factories' own cfg
LOSS_CFG = PD.TraceConfig(backend="jnp", has_gratings=False,
                          has_coatings=False, has_metals=False)
QUAD_FIELDS = ("quad_abgd", "quad_rlim", "quad_zlim", "quad_vertex",
               "quad_frame", "quad_tri")
SCENE_ARGS = (1.0, -1.2, 0.2, 0.4, N_GLASS)
SCENE_KW = dict(k1=-0.5, k2=0.3)


@pytest.fixture(scope="module")
def scenes():
    return (RD.analytic_singlet_scene(*SCENE_ARGS, **SCENE_KW),
            PD.analytic_singlet_scene(*SCENE_ARGS, **SCENE_KW))


class TestParity:
    def test_scene_columns_match_reference(self, scenes):
        ref, port = scenes
        for f in ("v0", "normal", "wu", "ww", "mat", "ior") + QUAD_FIELDS:
            a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_allclose(b, a, rtol=2.4e-7, atol=0, err_msg=f)

    def test_quadric_intersect_diff_matches_reference(self, scenes):
        ref, _ = scenes
        rng = np.random.default_rng(5)
        n = 2048
        o = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(-1.0, 0.6, n)], 1)
        aim = np.stack([rng.uniform(-0.45, 0.45, n),
                        rng.uniform(-0.45, 0.45, n),
                        rng.uniform(-0.2, 0.4, n)], 1)
        d = aim - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o32, d32 = o.astype(np.float32), d.astype(np.float32)
        t_r, i_r, n_r = jax.jit(RD.quadric_intersect_diff,
                                static_argnums=3)(
            ref, jnp.asarray(o32), jnp.asarray(d32), RCFG)
        t_p, i_p, n_p = PD.quadric_intersect_diff(
            Scene.from_reference(ref, CPU), torch.from_numpy(o32),
            torch.from_numpy(d32), PCFG)
        i_r = np.asarray(i_r)
        np.testing.assert_array_equal(i_p.numpy(), i_r)
        assert len(np.unique(i_r)) == 4       # three surfaces and misses
        np.testing.assert_allclose(t_p.numpy(), np.asarray(t_r), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(n_p.numpy(), np.asarray(n_r), rtol=0,
                                   atol=1e-5)

    def test_trace_diff_analytic_matches_reference(self, scenes):
        ref, _ = scenes
        rr = RD.collimated_bundle(200, 0.3)
        _, (eo, ed, ep) = jax.jit(RD.trace_diff_analytic,
                                  static_argnums=(2, 3, 4))(
            ref, rr, RCFG, 5, True)
        _, (po, pd_, pp) = PD.trace_diff_analytic(
            Scene.from_reference(ref, CPU), RayBatch.from_reference(rr, CPU),
            PCFG, 5, collect_escaped=True)
        ep = np.asarray(ep)
        np.testing.assert_allclose(pp.numpy(), ep, rtol=0,
                                   atol=1e-5 * ep.max())
        # the main beam: one ray a slot, no equal-power ties to reorder
        main = ep > 0.25 * ep.max()
        assert main.sum() == 200
        np.testing.assert_allclose(po.numpy()[main], np.asarray(eo)[main],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(pd_.numpy()[main], np.asarray(ed)[main],
                                   rtol=0, atol=1e-5)

    @pytest.fixture(scope="class")
    def losses(self):
        kw = dict(ior=N_GLASS, thickness=0.2, aperture_radius=0.4,
                  n_rays=120)
        return (jax.value_and_grad(RD.make_analytic_spot_loss(**kw),
                                   argnums=tuple(range(5))),
                PD.make_analytic_spot_loss(**kw))

    @pytest.mark.parametrize("args", [(1.0, -1.0, 0.1, -0.2, 1.1),
                                      (0.0, -2.0 / 3.0, 0.0, -2.0, 3.15)])
    def test_loss_and_gradient_match_jax_grad(self, losses, args):
        ref_vg, port_loss = losses
        v, g = ref_vg(*args)
        ts = leaves(*args)
        pv = port_loss(*ts)
        pg = torch.autograd.grad(pv, ts)
        assert pv.item() == pytest.approx(float(v), rel=1e-5)
        for a, b in zip(pg, g):
            assert np.isfinite(float(a))
            assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-7)


class TestQuadricDiffCore:
    def test_matches_forward_analytic_path(self):
        scene = PD.analytic_singlet_scene(0.0, -2.0, 0.05, 0.2, 1.5)
        hs = np.array([0.005, 0.01, 0.02, 0.04])
        o = np.stack([hs, 0 * hs, np.full_like(hs, -0.5)], axis=1)
        d = np.tile([[0.0, 0.0, 1.0]], (4, 1))
        rays = RayBatch.from_arrays(o, d, np.full(4, 0.25), capacity=32,
                                    device=CPU)
        _, (eo, ed, ep) = PD.trace_diff_analytic(scene, rays, PCFG, 5,
                                                 collect_escaped=True)
        eo, ed, ep = eo.numpy(), ed.numpy(), ep.numpy()
        m = (ep > 0.2) & (ed[:, 2] > 0.5)
        assert m.sum() == 4
        z_cross = eo[m, 2] - eo[m, 0] / ed[m, 0] * ed[m, 2]
        expect = [1.0498874, 1.0495499, 1.0481987, 1.0427797]
        np.testing.assert_allclose(sorted(z_cross, reverse=True), expect,
                                   atol=2e-5)

    def test_ad_matches_finite_difference(self):
        loss = PD.make_analytic_spot_loss(ior=1.5, thickness=0.2,
                                          aperture_radius=0.4, n_rays=120)
        base = (1.0, -1.0, 0.0, 0.0, 1.1)
        ts = leaves(*base)
        g = torch.autograd.grad(loss(*ts), ts)
        eps = 1e-3
        with torch.no_grad():
            for i in (0, 1, 4):
                hi, lo = list(base), list(base)
                hi[i] += eps
                lo[i] -= eps
                fd = (float(loss(*hi)) - float(loss(*lo))) / (2 * eps)
                assert float(g[i]) == pytest.approx(fd, rel=5e-2), i


class TestStigmaticSinglet:
    """Flat-front singlet at f/3.3; the exact stigmatic exit surface is
    the Descartes hyperbola k = -n^2."""

    @pytest.fixture(scope="class")
    def loss(self):
        n, f, t_c = N_GLASS, 3.0, 0.15
        c2 = -1.0 / ((n - 1.0) * f)
        lf = PD.make_analytic_spot_loss(ior=n, thickness=t_c,
                                        aperture_radius=0.6, n_rays=300,
                                        beam_fill=0.75)
        return lambda k2: lf(0.0, c2, 0.0, k2, t_c + f)

    def test_landscape_minimum_is_exact(self, loss):
        with torch.no_grad():
            v_star = float(loss(-N_GLASS * N_GLASS))
            assert v_star < 1e-6
            assert float(loss(0.0)) > 1e-2
            assert float(loss(-2.1)) > 100 * v_star
            assert float(loss(-2.4)) > 100 * v_star


class TestBestForm:
    def test_coddington_basin(self):
        """Best-form scan at f/5: the spot RMS over the shape factor
        q = (c1+c2)/(c1-c2) has an interior minimum bracketing the thin-lens
        optimum q* ~ 0.714. make_analytic_spot_loss's figure of merit at 61
        focus planes (the reference vmaps the loss over them): the planes
        share one trace, so each q is traced once."""
        X = 2.0
        rays0 = PD.collimated_bundle(300, 0.33 * 0.3)
        min_power = 0.25 * float(rays0.power.max())
        zs = np.linspace(0.9, 1.2, 61, dtype=np.float32)

        def best(q):
            scene = PD.analytic_singlet_scene(X * (q + 1) / 2,
                                              X * (q - 1) / 2, 0.05, 0.3,
                                              N_GLASS)
            with torch.no_grad():
                _, esc = PD.trace_diff_analytic(scene, rays0, LOSS_CFG, 4,
                                                collect_escaped=True)
                return min(float(PD.spot_rms_at_plane(
                    *esc, float(z), min_power=min_power)) for z in zs)

        v_lo, v_star, v_hi = best(0.0), best(0.7), best(1.4)
        assert v_star < v_lo * 0.85
        assert v_star < v_hi * 0.85
