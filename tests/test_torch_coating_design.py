"""The port's differentiable thin-film coating design (diff.py's
band_reflectance and design_coating) against the JAX package's, on the CPU.

Parity: band_reflectance's value within 1e-6 relative and its gradient in
every layer index and thickness (torch.autograd.grad against jax.grad)
within 1e-5 relative, over wavelength bands, incidence-angle grids and
spectral weights; a 200-step design_coating run (torch.optim.Adam against
optax.adam, the same update rounded differently) with (n, h) within 1e-3
of the reference's. Then the reference's own contracts of
tests/test_coating_design.py on the port: bare Fresnel at h = 0, the
quarter-wave formula, the band mean over its grid, delta weights, AD
against finite differences, the analytic single-layer optimum, the
broadband 4-layer stack beating a quarter-wave MgF2 film, and the V-coat
null (R < 1e-8) traced through the port's Tracer (transmission > 0.999).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightpycl_tpu import diff as RD
from lightpycl_tpu_torch import diff as PD
from lightpycl_tpu_torch import geometry
from lightpycl_tpu_torch.sources import CollimatedSource
from lightpycl_tpu_torch.tracer.engine import Tracer
from torch_port_common import port_default_cpu  # noqa: F401

torch.set_num_threads(1)

N_SUB = 1.52
WL = 0.55
R_BARE = ((1.0 - N_SUB) / (1.0 + N_SUB)) ** 2
WLS = np.linspace(0.42, 0.68, 14)


def band(layers_n, layers_h, **kw):
    return float(PD.band_reflectance(layers_n, layers_h, n_sub=N_SUB, **kw))


class TestParity:
    @pytest.mark.parametrize("case", [
        dict(n=[1.38], h=[0.1], wavelengths=[WL]),
        dict(n=[1.38, 2.1], h=[0.09, 0.055], wavelengths=WLS),
        dict(n=[1.38, 2.1, 1.6], h=[0.1, 0.06, 0.12],
             wavelengths=np.linspace(0.45, 0.65, 5),
             cos_i=np.cos(np.radians([0.0, 20.0, 40.0]))),
        dict(n=[1.38, 2.1], h=[0.12, 0.02], wavelengths=WLS,
             weights=np.hanning(len(WLS)) + 0.1, n_inc=1.33),
    ], ids=["one_layer", "band", "angles", "weights"])
    def test_value_and_gradient_match_jax_grad(self, case):
        kw = {k: v for k, v in case.items() if k not in ("n", "h")}
        n0 = np.asarray(case["n"], np.float32)
        h0 = np.asarray(case["h"], np.float32)

        def ref(n, h):
            return RD.band_reflectance(list(n), list(h), n_sub=N_SUB, **kw)

        # op by op: jit's fusion moves the smallest gradient components
        # of the complex64 recursion by more than 1e-5
        v, (gn, gh) = jax.value_and_grad(ref, argnums=(0, 1))(
            jnp.asarray(n0), jnp.asarray(h0))
        tn = torch.tensor(n0, requires_grad=True)
        th = torch.tensor(h0, requires_grad=True)
        pv = PD.band_reflectance(list(tn), list(th), n_sub=N_SUB, **kw)
        pn, ph = torch.autograd.grad(pv, (tn, th))
        assert pv.item() == pytest.approx(float(v), rel=1e-6)
        for a, b in ((pn, gn), (ph, gh)):
            b = np.asarray(b)
            assert np.isfinite(a.numpy()).all()
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())

    @pytest.mark.parametrize("kw", [
        dict(n_layers=2, fixed_n=[1.38, 2.10]),
        dict(n_layers=1),
    ], ids=["vcoat", "free_index"])
    def test_design_coating_matches_optax(self, kw):
        args = dict(n_sub=N_SUB, wavelengths=[WL], steps=200, lr=0.02, **kw)
        n_r, h_r, r_r = RD.design_coating(**args)
        n_p, h_p, r_p = PD.design_coating(**args)
        for a in (n_p, h_p):
            assert isinstance(a, np.ndarray) and a.dtype == np.float64
        np.testing.assert_allclose(n_p, n_r, rtol=0, atol=1e-3)
        np.testing.assert_allclose(h_p, h_r, rtol=0, atol=1e-3)
        assert isinstance(r_p, float)
        assert r_p == pytest.approx(r_r, rel=0.5, abs=1e-6)


class TestBandReflectance:
    def test_zero_thickness_reduces_to_bare_fresnel(self):
        assert band([1.38], [0.0], wavelengths=[WL]) == pytest.approx(
            R_BARE, abs=1e-6)

    def test_quarter_wave_analytic(self):
        nf = 1.38
        r_qw = ((N_SUB - nf * nf) / (N_SUB + nf * nf)) ** 2
        assert band([nf], [WL / (4 * nf)], wavelengths=[WL]) == (
            pytest.approx(r_qw, abs=1e-6))

    def test_band_average_is_mean_over_grid(self):
        wls = np.linspace(0.45, 0.65, 5)
        cosines = np.cos(np.radians([0.0, 20.0, 40.0]))
        r_grid = band([1.38, 2.1], [0.1, 0.06], wavelengths=wls,
                      cos_i=cosines)
        singles = [band([1.38, 2.1], [0.1, 0.06], wavelengths=[w],
                        cos_i=float(c)) for c in cosines for w in wls]
        assert r_grid == pytest.approx(np.mean(singles), abs=1e-6)

    def test_delta_weights_select_one_wavelength(self):
        wls = np.array([0.45, 0.55, 0.65])
        r = band([1.38], [0.1], wavelengths=wls, weights=[0.0, 1.0, 0.0])
        assert r == pytest.approx(band([1.38], [0.1], wavelengths=[0.55]),
                                  abs=1e-6)

    def test_gradient_matches_finite_difference(self):
        wls = np.linspace(0.45, 0.65, 7)
        h0 = np.array([0.09, 0.055], np.float64)
        th = torch.tensor(h0.astype(np.float32), requires_grad=True)
        g, = torch.autograd.grad(PD.band_reflectance(
            [1.38, 2.1], list(th), n_sub=N_SUB, wavelengths=wls), th)
        eps = 1e-3
        for k in range(2):
            hp, hm = h0.copy(), h0.copy()
            hp[k] += eps
            hm[k] -= eps
            fd = (band([1.38, 2.1], list(hp.astype(np.float32)),
                       wavelengths=wls)
                  - band([1.38, 2.1], list(hm.astype(np.float32)),
                         wavelengths=wls)) / (2 * eps)
            assert float(g[k]) == pytest.approx(fd, rel=2e-2, abs=1e-4)


@pytest.fixture(scope="module")
def vcoat():
    return PD.design_coating(2, n_sub=N_SUB, wavelengths=[WL],
                             fixed_n=[1.38, 2.10], steps=1500, lr=0.02)


class TestDesign:
    def test_single_layer_recovers_analytic_ar(self):
        n, h, r = PD.design_coating(1, n_sub=N_SUB, wavelengths=[WL],
                                    steps=1200, lr=0.02)
        n_star = np.sqrt(N_SUB)
        assert n[0] == pytest.approx(n_star, abs=2e-3)
        assert h[0] == pytest.approx(WL / (4 * n_star), abs=2e-3)
        assert r < 1e-8

    def test_vcoat_fixed_catalog_indices_nulls(self, vcoat):
        n, h, r = vcoat
        assert np.allclose(n, [1.38, 2.10])
        assert (h > 0).all()
        assert r < 1e-8

    def test_broadband_beats_single_layer_quarter_wave(self):
        r_single = band([1.38], [WL / (4 * 1.38)], wavelengths=WLS)
        _, h, r4 = PD.design_coating(4, n_sub=N_SUB, wavelengths=WLS,
                                     fixed_n=[1.38, 2.10, 1.38, 2.10],
                                     steps=1200, lr=0.02)
        assert r4 < 0.6 * r_single
        assert (h > 0).all()

    def test_designed_vcoat_survives_the_tracer(self, vcoat):
        _, h, _ = vcoat
        stack = [(1.38, float(h[0])), (2.10, float(h[1]))]
        oe = geometry.optical_elements(n_segments=24, n_radial=8)

        def scene(coating):
            kw = dict(coating=coating) if coating else {}
            win = oe.cube(size=(0.8, 0.8, 0.2), material="refractive",
                          ior=N_SUB, name="window", **kw)
            fwd = oe.disc(radius=1.2, center=(0, 0, 2.0),
                          material="measure", name="fwd")
            shell = oe.sphere(radius=6.0, material="terminator")
            return [win, fwd, shell]

        src = CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                               diameter=0.3, ray_count=256, power=1.0,
                               seed=3, wavelength=WL)
        tr = Tracer(device="cpu")
        t_coat = tr.trace(src, scene(stack), trace_iterations=10,
                          capacity=1024).detector_power("fwd")
        t_bare = tr.trace(src, scene(None), trace_iterations=10,
                          capacity=1024).detector_power("fwd")
        assert t_coat > 0.999
        t_pred_bare = (1 - R_BARE) ** 2 / (1 - R_BARE ** 2)
        assert t_bare == pytest.approx(t_pred_bare, abs=2e-4)
        assert t_coat > t_bare + 0.07
