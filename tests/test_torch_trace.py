"""Whole traces of the port (lightpycl_tpu_torch.Tracer on the CPU) against
the JAX package's Tracer and its float64 oracle, on the parity configs of
tests/test_parity_oracle.py, in both trace modes."""

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu import sources as ref_sources
from lightpycl_tpu.tracer.oracle import trace_oracle
from lightpycl_tpu_torch import sources as port_sources
from lightpycl_tpu_torch.compat import CL_Tracer
from lightpycl_tpu_torch.ops import intersect as PI

torch.set_num_threads(1)
CPU = torch.device("cpu")


def config(name, M, S):
    """(elements, source, iterations, capacity) of a parity config, built
    with package M's primitives and source module S. Capacities are cut
    from the oracle test's 16,384 / 32,768 to the smallest powers of two
    that hold every bounce's live rays (4,000 in config 2; 5,925 after
    bounce 4 of config 3, whose last bounce overflows 8,192 with 8,690
    children and so also exercises the top-k cut)."""
    oe = M.optical_elements(n_segments=32, n_radial=12)
    if name == "config1":
        return ([oe.parabolic_mirror(focus=0.5, diameter=2.0,
                                     reflectivity=0.92),
                 oe.hemisphere(radius=15.0, name="dome")],
                S.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                               power=1.0, ray_count=3000, seed=21), 4, None)
    if name == "config2":
        return ([oe.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1,
                                      ior=1.5),
                 oe.disc(radius=1.0, center=(0, 0, 1.1), material="measure"),
                 oe.sphere(radius=8.0, material="terminator",
                           name="enclosure")],
                S.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                                   diameter=0.3, ray_count=2000, power=1.0,
                                   seed=22), 5, 4096)
    return ([oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
             oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5)),
             oe.sphere(radius=6.0, material="measure", name="enclosure")],
            S.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                               diameter=0.5, ray_count=1000, power=1.0,
                               seed=23), 5, 8192)


_RESULTS = {}


def traced(name, mode):
    """(reference result, port result), each traced once per session."""
    key = (name, mode)
    if key not in _RESULTS:
        els, src, it, cap = config(name, L, ref_sources)
        ref = L.Tracer().trace(src, els, trace_iterations=it, capacity=cap,
                               mode=mode)
        els, src, it, cap = config(name, P, port_sources)
        port = P.Tracer(device=CPU).trace(src, els, trace_iterations=it,
                                          capacity=cap, mode=mode)
        _RESULTS[key] = (ref, port)
    return _RESULTS[key]


def assert_same_set(a, b, atol):
    """Rows of a and b equal as sets: every row of b within atol of a
    distinct row of a."""
    assert a.shape == b.shape
    dist = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    nearest = dist.argmin(axis=0)
    assert dist[nearest, np.arange(len(b))].max() <= atol
    assert len(np.unique(nearest)) == len(b)


CONFIGS = ["config1", "config2", "config3"]


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("name", CONFIGS)
def test_trace_matches_reference(name, mode):
    ref, port = traced(name, mode)
    assert port.iterations_run == ref.iterations_run
    # ledger terms: rel 1e-5; 'culled' is the rounding residue of two f32
    # sums of the emitted power (exactly 0 in f64), a few f32 ulps of 1.0
    # on either side, hence the 1e-6 absolute floor
    for k, v in ref.ledger.items():
        assert port.ledger[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    assert np.allclose(port.hist, ref.hist, rtol=0, atol=1e-6)
    # per-detector totals against the reference's pairwise-summed ledger:
    # its own per_detector adds each ray in turn in f32 (.at[].add on the
    # CPU), which drifts ~2e-5 on config 2, while the port sums by tree
    assert port.per_detector.sum() == pytest.approx(ref.ledger["measured"],
                                                    rel=1e-5)
    assert port.power_conservation_error() < 1e-5
    assert port.device == "cpu"
    if mode == "host":
        assert len(port.measured_power) == len(ref.measured_power) > 0
        a = np.concatenate([ref.measured_pos, ref.measured_dir,
                            ref.measured_power[:, None]], axis=1)
        b = np.concatenate([port.measured_pos, port.measured_dir,
                            port.measured_power[:, None]], axis=1)
        assert_same_set(a, b, atol=1e-5)
        assert np.array_equal(np.sort(ref.measured_det),
                              np.sort(port.measured_det))


@pytest.mark.parametrize("name", CONFIGS)
def test_detected_power_matches_oracle(name):
    _, port = traced(name, "device")
    els, src, it, _ = config(name, L, ref_sources)
    o, d, p = src.sample()
    ora = trace_oracle(els, o, d, p, trace_iterations=it)
    assert port.ledger["measured"] == pytest.approx(ora["measured"], rel=1e-3)


def test_repeat_runs_bit_identical():
    # the tests/test_tracer.py determinism scene
    oe = P.optical_elements(24, 8)
    els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
           oe.hemisphere(10.0, name="dome"),
           oe.biconvex_lens(1.0, 0.6, 0.1, ior=1.5, center=(0, 0, 1.0))]
    src = P.CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                             diameter=1.5, ray_count=1024, power=1.0, seed=3)

    def run():
        return P.Tracer(device=CPU).trace(src, els, trace_iterations=5,
                                          mode="device", image_bins=16,
                                          image_halfwidth=2.0)

    a, b = run(), run()
    assert np.array_equal(a.hist, b.hist)
    assert np.array_equal(a.image, b.image)
    assert a.ledger == b.ledger
    assert a.image.sum() > 0


def test_cull_matches_brute():
    # a coherent bowl (auto-cull turns on): cull on and off agree per ray
    # on the first bounce and in the ledger
    oe = P.optical_elements(48, 24)
    els = [oe.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95),
           P.optical_elements(24, 8).hemisphere(radius=100.0, name="dome")]
    src = P.CollimatedSource(center=(0, 0, 3.0), direction=(0, 0, -1),
                             diameter=3.5, ray_count=1024, power=1.0, seed=3)
    res = {}
    for cull in (None, False):
        tr = P.Tracer(device=CPU)
        res[cull] = tr.trace(src, els, trace_iterations=3, mode="device",
                             cull=cull)
        if cull is None:
            assert tr._scene_sorted  # auto resolved to on
    for k, v in res[False].ledger.items():
        assert res[None].ledger[k] == pytest.approx(v, rel=1e-6, abs=1e-7)
    assert np.allclose(res[None].hist, res[False].hist, rtol=1e-5, atol=1e-7)

    # first bounce, per ray: brute vs culled after undoing the Morton sort
    from lightpycl_tpu_torch.tracer import step as S

    scene, _ = P.build_scene(els, spatial_sort=True, device=CPU)
    rays = P.RayBatch.from_arrays(*src.sample(), device=CPU)
    cfg = P.TraceConfig(cull=True)
    sorted_rays, t1, i1 = S.intersect_bounce(scene, rays, cfg)
    frame = PI.cull_frame(scene)
    order = S.morton_order(rays.o, rays.d, rays.alive, frame.lo, frame.hi)
    assert torch.equal(sorted_rays.o, rays.o[order])
    assert torch.equal(S.reorder_rays(scene, rays).o, sorted_rays.o)
    assert not torch.equal(order, torch.arange(len(order)))
    t0, i0 = PI.intersect(scene, rays.o, rays.d, cfg.replace(cull=False))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order))
    assert torch.equal(i1[inv], i0) and torch.equal(t1[inv], t0)
    assert (i0 >= 0).all()


def test_cl_tracer_quick_start():
    # the README quick start at 2,000 rays
    from lightpycl_tpu_torch.compat import light_source, optical_elements

    oe = optical_elements()
    mirror = oe.parabolic_mirror(focus=0.5, diameter=2.0, reflectivity=0.98)
    dome = oe.hemisphere(radius=50.0)
    ls = light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                      directivity=lambda az, pol: np.cos(pol),
                      power=1.0, ray_count=2000)
    tracer = CL_Tracer(platform_name="", device_type="GPU", device=CPU)
    tracer.iterative_tracer(ls, [mirror, dome], trace_iterations=8,
                            max_ray_len=1e3, ior_env=1.0)
    pos, dirs, powers = tracer.get_measured_rays()
    assert len(powers) == 2000
    assert powers.sum() == pytest.approx(0.98, abs=5e-3)
    assert np.allclose(np.linalg.norm(pos, axis=1), 50.0, rtol=1e-2)
    assert tracer.get_detector_histogram().sum() == pytest.approx(
        powers.sum(), rel=1e-5)
    led = tracer.get_power_ledger()
    assert led["measured"] == pytest.approx(0.98, abs=5e-3)
    perf = tracer.get_trace_performance()
    assert perf["iterations"] == 2 and perf["device"] == "cpu"
    assert len(tracer.last_result.segments) == 2


UNPORTED = {
    "polarization": dict(polarization=True),
    "track_paths": dict(track_paths=True),
    "multichip": dict(mode="multichip"),
    "mesh2d": dict(mode="mesh2d"),
}


@pytest.mark.parametrize("feature", sorted(UNPORTED))
def test_unported_feature_raises(feature):
    """Every feature this test once expected to raise is ported and gives
    the reference's result: polarization and track_paths in host mode,
    mode='multichip' on the port's one-rank group (started in this
    process) against the reference's 8 virtual devices, and mode='mesh2d'
    without a mesh the reference's own refusal, word for word."""
    oe = P.optical_elements(8, 4)
    src = P.light_source(ray_count=16)
    kw = UNPORTED[feature]

    def ref_trace():
        return L.Tracer().trace(L.sources.light_source(ray_count=16),
                                [L.optical_elements(8, 4).hemisphere(2.0)],
                                trace_iterations=1, **kw)

    if feature == "mesh2d":
        with pytest.raises(ValueError) as port_err:
            P.Tracer(device=CPU).trace(src, [oe.hemisphere(2.0)],
                                       trace_iterations=1, **kw)
        with pytest.raises(ValueError) as ref_err:
            ref_trace()
        assert str(port_err.value) == str(ref_err.value)
        assert "mesh=make_mesh2d" in str(port_err.value)
        return
    port = P.Tracer(device=CPU).trace(src, [oe.hemisphere(2.0)],
                                      trace_iterations=1, **kw)
    ref = ref_trace()
    assert port.ledger["measured"] == pytest.approx(1.0, abs=1e-6)
    assert port.ledger == pytest.approx(ref.ledger, abs=1e-6)
    np.testing.assert_allclose(port.hist, ref.hist, atol=1e-6)
    assert port.final_live_power == pytest.approx(ref.final_live_power,
                                                  abs=1e-6)
    assert np.array_equal(port.measured_path, ref.measured_path)
    assert np.allclose(port.measured_stokes, ref.measured_stokes, atol=2e-5)


SCENE_FEATURES = {
    "grating": dict(material="grating", axis=(1.0, 0.0, 0.0),
                    grating_period=1.0),
    "coating": dict(material="refractive", coating=[(1.38, 0.1)]),
    "metal": dict(material="mirror", metal_n=0.96, metal_k=6.69),
    "diffuse": dict(material="diffuse"),
    "roughness": dict(material="mirror", roughness=0.01),
    "scattering": dict(material="refractive", scattering=0.5),
}


@pytest.mark.parametrize("feature", sorted(SCENE_FEATURES))
def test_unported_scene_feature_raises(feature):
    """Scenes with these elements once raised; the features are ported, so
    each now traces in both modes with a closed ledger, and the ones that
    draw no random numbers give the reference's ledger."""
    def scene(M):
        oe = M.optical_elements(8, 4)
        return [oe.disc(0.5, center=(0, 0, 1), **SCENE_FEATURES[feature]),
                oe.hemisphere(2.0)]

    for mode in ("host", "device"):
        port = P.Tracer(device=CPU).trace(P.light_source(ray_count=64),
                                          scene(P), trace_iterations=3,
                                          mode=mode)
        assert port.power_conservation_error() < 1e-5
        assert port.ledger["measured"] > 0.5
    if feature in ("grating", "coating", "metal"):
        ref = L.Tracer().trace(L.sources.light_source(ray_count=64),
                               scene(L), trace_iterations=3, mode="device")
        assert port.ledger == pytest.approx(ref.ledger, abs=1e-6)


def test_unported_entry_points_raise():
    """The multi-device entry points are ported: called without a scene
    they refuse as the reference does, word for word."""
    def message(call):
        with pytest.raises(ValueError) as e:
            call()
        return str(e.value)

    calls = {
        "trace_batched": lambda M, tr: tr.trace_batched(None, 10, 5,
                                                        mode="multichip"),
        "trace_spectral": lambda M, tr: tr.trace_spectral(None, [0.5],
                                                          mode="multichip"),
        "iterative_tracer": lambda M, tr: tr.iterative_tracer(
            M.light_source(ray_count=4), [], wavelengths=[0.5],
            mode="multichip"),
    }
    for name, call in calls.items():
        port = message(lambda: call(P, CL_Tracer(device=CPU)))
        ref = message(lambda: call(L, L.CL_Tracer()))
        assert port == ref, name


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        P.Tracer()
    with pytest.raises(RuntimeError, match="cuda"):
        P.Tracer(device="cuda:0")
