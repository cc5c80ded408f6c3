"""The port's optional detector maps (coherent field, time-of-flight
histogram, per-facet flux) and Russian roulette against the JAX package's:
the accumulation on the same arrays, roulette on JAX's own uniforms, and
whole traces in both modes fed the same RayBatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer import step as R
from lightpycl_tpu.tracer.rays import DetectorState as RefDet
from lightpycl_tpu_torch.tracer import step as S
from lightpycl_tpu_torch.tracer.rays import DetectorState
from test_torch_batched import field_tol

torch.set_num_threads(1)
CPU = torch.device("cpu")

MAPS = dict(image_bins=16, image_center=(0.0, 0.0, 1.1),
            image_halfwidth=1.0, coherent=True, time_bins=16, opl_min=1.61,
            opl_max=2.41, flux_map=True)


def arrays(seed, C=4096, T=512, D=3):
    """Measured-ray columns made from a numpy seed: hit points on and off
    the image plane, arrival directions, powers (zero on unmeasured
    slots), detector ids, OPLs inside and outside the window, wavelengths,
    hit triangles (-1 on misses) and arriving powers."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d = rng.normal(size=(C, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    measured = rng.uniform(size=C) < 0.7
    return dict(
        hit_point=rng.uniform(-1.2, 1.2, (C, 3)).astype(f32),
        dirs=d.astype(f32),
        measured_power=np.where(measured, rng.uniform(0, 1e-3, C), 0.0)
        .astype(f32),
        det_id=np.where(measured, rng.integers(0, D, C), -1).astype(np.int32),
        opl=rng.uniform(1.5, 1.8, C).astype(f32),
        wavelength=rng.choice([0.48, 0.5876, 0.65], C).astype(f32),
        tri=np.where(rng.uniform(size=C) < 0.8, rng.integers(0, T, C), -1)
        .astype(np.int32),
        incident_power=rng.uniform(0, 1e-3, C).astype(f32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("hist_mode", ["direction", "position"])
def test_accumulate_maps_match_reference(seed, hist_mode):
    T, D = 512, 3
    a = arrays(seed, T=T, D=D)
    rcfg = L.TraceConfig(hist_mode=hist_mode, **MAPS)
    pcfg = P.TraceConfig(hist_mode=hist_mode, **MAPS)
    ref = jax.jit(R.accumulate_detector_arrays, static_argnames=("cfg",))(
        RefDet.zeros(36, 18, D, 16, coherent=True, n_tris=T, time_bins=16),
        *(jnp.asarray(a[k]) for k in ("hit_point", "dirs", "measured_power",
                                       "det_id")), rcfg,
        **{k: jnp.asarray(a[k]) for k in ("opl", "wavelength", "tri",
                                           "incident_power")})
    port = S.accumulate_detector_arrays(
        DetectorState.zeros(36, 18, D, 16, coherent=True, n_tris=T,
                            time_bins=16, device=CPU),
        *(torch.from_numpy(a[k]) for k in ("hit_point", "dirs",
                                            "measured_power", "det_id")),
        pcfg, **{k: torch.from_numpy(a[k]) for k in (
            "opl", "wavelength", "tri", "incident_power")})
    for f in RefDet._fields:
        r, p = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert r.shape == p.shape, f
        # f32 sums in another association (the reference adds ray by ray)
        assert np.allclose(p, r, rtol=1e-5, atol=1e-7), f
    # the time histogram holds every measured ray (edge bins clamp), the
    # flux map every hit, the coherent field is not the incoherent image
    assert port.time_hist.sum() == pytest.approx(a["measured_power"].sum(),
                                                 rel=1e-5)
    hits = a["tri"] >= 0
    assert port.tri_flux.sum() == pytest.approx(
        a["incident_power"][hits].sum(), rel=1e-5)
    assert float(port.image_amp.abs().sum()) > 0


def test_maps_stay_off_by_default():
    a = arrays(2)
    cfg = P.TraceConfig()
    det = S.accumulate_detector_arrays(
        DetectorState.zeros(36, 18, 3, device=CPU),
        *(torch.from_numpy(a[k]) for k in ("hit_point", "dirs",
                                            "measured_power", "det_id")),
        cfg, **{k: torch.from_numpy(a[k]) for k in (
            "opl", "wavelength", "tri", "incident_power")})
    assert det.image_amp.shape == (2, 1, 1) and not det.image_amp.any()
    assert det.tri_flux.shape == (1,) and not det.tri_flux.any()
    assert det.time_hist.shape == (1, 1) and not det.time_hist.any()


def shade_out(module, power, alive):
    """A ShadeOut of `module` whose children have the given powers (every
    other column zero: roulette reads only child_power / child_alive)."""
    C = power.shape[0]
    cols = {f: np.zeros((C,), np.float32) for f in module.ShadeOut._fields}
    cols.update(child_power=power, child_alive=alive)
    conv = jnp.asarray if module is R else torch.from_numpy
    return module.ShadeOut(**{k: conv(v) for k, v in cols.items()})


@pytest.mark.parametrize("thr", [1e-3, 0.3])
def test_roulette_matches_reference_on_its_uniforms(thr):
    rng = np.random.default_rng(7)
    C = 8192
    power = rng.uniform(0, 2e-3, C).astype(np.float32)
    power[:100] = 0.0
    alive = power > 0
    alive[100:200] = False  # dead slots keep their power out of roulette
    key = jax.random.key(11)
    rcfg, pcfg = L.TraceConfig(roulette_threshold=thr), \
        P.TraceConfig(roulette_threshold=thr)
    ref_sh, ref_delta = R.roulette(shade_out(R, power, alive), rcfg, key)
    u = np.array(jax.random.uniform(key, (C,)))
    port_sh, port_delta = S.roulette(shade_out(S, power, alive), pcfg,
                                     torch.from_numpy(u))
    assert np.array_equal(np.asarray(ref_sh.child_power),
                          port_sh.child_power.numpy())
    assert np.array_equal(np.asarray(ref_sh.child_alive),
                          port_sh.child_alive.numpy())
    assert float(port_delta) == pytest.approx(float(ref_delta), rel=1e-5,
                                              abs=1e-7)
    boosted = port_sh.child_power.numpy()
    weak = alive & (power < thr)
    assert set(np.unique(boosted[weak])) <= {0.0, np.float32(thr)}


def test_roulette_needs_a_generator():
    oe = P.optical_elements(8, 4)
    tr = P.Tracer(device=CPU)
    tr.set_elements([oe.hemisphere(2.0, name="dome")])
    rays = P.RayBatch.from_arrays(np.zeros((4, 3)), np.eye(3)[[2] * 4],
                                  np.full(4, 0.25), device=CPU)
    det = DetectorState.zeros(36, 18, 1, device=CPU)
    led = P.tracer.Ledger.start(1.0, device=CPU)
    with pytest.raises(ValueError, match="generator"):
        S.trace_step(tr.scene, rays, det, led, tr._check_polarization(
            P.TraceConfig(roulette_threshold=0.5)))
    # the generator's stream depends only on its words
    g1, g2 = S.make_generator(CPU, 3, 1), S.make_generator(CPU, 3, 1)
    assert torch.equal(torch.rand(8, generator=g1),
                       torch.rand(8, generator=g2))
    assert not torch.equal(torch.rand(8, generator=S.make_generator(CPU, 3, 2)),
                           torch.rand(8, generator=S.make_generator(CPU, 3, 1)))


def lens_bench(M):
    """Config 2 of the parity tests: a lens (splitting), a measuring disc
    the image plane sits on, a terminating enclosure."""
    oe = M.optical_elements(n_segments=32, n_radial=12)
    return [oe.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1,
                                 ior=1.5),
            oe.disc(radius=1.0, center=(0, 0, 1.1), material="measure",
                    name="disc"),
            oe.sphere(radius=8.0, material="terminator", name="enclosure")]


_TRACES = {}


def traced(mode):
    if mode not in _TRACES:
        src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                               diameter=0.3, ray_count=2000, power=1.0,
                               seed=22)
        rays = L.RayBatch.from_arrays(*src.sample(), capacity=4096)
        port_rays = P.RayBatch.from_reference(rays, CPU)
        ref = L.Tracer().trace(None, lens_bench(L), trace_iterations=5,
                               rays=rays, mode=mode, **MAPS)
        tr = P.Tracer(device=CPU)
        port = tr.trace(None, lens_bench(P), trace_iterations=5,
                        rays=port_rays, mode=mode, **MAPS)
        _TRACES[mode] = (ref, port, tr)
    return _TRACES[mode]


@pytest.mark.parametrize("mode", ["device", "host"])
def test_trace_maps_match_reference(mode):
    ref, port, tr = traced(mode)
    assert port.iterations_run == ref.iterations_run
    for k, v in ref.ledger.items():
        assert port.ledger[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    assert np.allclose(port.image, ref.image, rtol=1e-5, atol=1e-7)
    assert np.allclose(port.tri_flux, ref.tri_flux, rtol=1e-5, atol=1e-7)
    assert np.allclose(port.time_hist, ref.time_hist, rtol=1e-5, atol=1e-7)
    assert np.array_equal(port.opl_edges, ref.opl_edges)
    # the coherent field: its phase turns with OPL / lambda, so it is held
    # to 4 f32 ulps of OPL as phase on its scale (test_torch_batched.py)
    tol = field_tol(MAPS["opl_max"], ref.image_amp)
    assert np.allclose(port.image_amp, ref.image_amp, rtol=0, atol=tol)
    assert np.allclose(port.image_coherent, ref.image_coherent, rtol=0,
                       atol=2 * tol * np.abs(ref.image_amp).max())
    assert port.time_hist.shape == (1, 16)
    edges, hist = port.detector_time_histogram("disc")
    assert hist.sum() == pytest.approx(port.detector_power("disc"), rel=1e-5)
    assert len(edges) == 17
    flux = tr.get_surface_flux()
    assert flux["per_element"]["disc"] == pytest.approx(
        port.detector_power("disc"), rel=1e-5)
    assert np.isfinite(flux["irradiance"]).all()


def test_map_checks_raise_as_the_reference():
    oe = P.optical_elements(8, 4)
    els = [oe.hemisphere(2.0, material="measure", name="dome")]
    src = P.light_source(ray_count=16)
    with pytest.raises(ValueError, match="image_bins"):
        P.Tracer(device=CPU).trace(src, els, coherent=True)
    with pytest.raises(ValueError, match="OPL window"):
        P.Tracer(device=CPU).trace(src, els, time_bins=4)
    scatterer = oe.disc(0.5, center=(0, 0, 1), material="refractive",
                        scattering=0.5)
    with pytest.raises(ValueError, match="volume events"):
        P.Tracer(device=CPU).trace(src, els + [scatterer], flux_map=True)
    res = P.Tracer(device=CPU).trace(src, els, trace_iterations=1)
    for name in ("image_complex", "image_coherent"):
        with pytest.raises(ValueError, match="coherent"):
            getattr(res, name)
    with pytest.raises(ValueError, match="time-resolved"):
        res.detector_time_histogram("dome")
    with pytest.raises(ValueError, match="per-batch"):
        res.detector_stderr("dome")
