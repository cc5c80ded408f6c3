"""Tracer.trace_batched of the port against the JAX package's, on the same
rays: a fixed-ray source per package hands both the same numpy rays in
every batch, through a bowl, a refracting slab (splitting) and a
measuring dome with every detector map on, cull on and off. Then the port's
own guarantees: a resumed run and a repeat run equal the first bit for bit
(roulette on), and the refusals."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu_torch.tracer.rays import Ledger

torch.set_num_threads(1)
CPU = torch.device("cpu")

BATCH = 512
N_BATCHES = 3
MAPS = dict(trace_iterations=5, image_bins=16, image_halfwidth=100.0,
            coherent=True, time_bins=8, opl_min=96.0, opl_max=112.0,
            flux_map=True)
FIELDS = ("hist", "per_detector", "image", "tri_flux", "time_hist",
          "per_batch_detector")


def field_tol(opl_max, amp, wavelength=0.5876):
    """Tolerance of a coherent field `amp` whose rays' OPLs (below opl_max)
    may differ by 4 f32 ulps between the packages: that phase, in radians,
    times the field's scale max |A|."""
    ulp = float(np.spacing(np.float32(opl_max)))
    return 2.0 * np.pi * 4 * ulp / wavelength * np.abs(amp).max()


def fixed_rays(n=BATCH, seed=0):
    """A collimated bundle (diameter 3.5 at z = 5, pointing down), from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    r = 1.75 * np.sqrt(rng.uniform(size=n))
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    o = np.stack([r * np.cos(phi), r * np.sin(phi), np.full(n, 5.0)], 1)
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    return (o.astype(np.float32), d.astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


class RefFixedSource:
    """The same rays in every batch, for the reference's trace_batched."""

    center = (0.0, 0.0, 5.0)

    def rays_on_device(self, key, n):
        return tuple(jnp.asarray(a[:n]) for a in fixed_rays())


class PortFixedSource:
    """The same rays in every batch, for the port's trace_batched."""

    center = (0.0, 0.0, 5.0)

    def rays_on_device(self, gen, n):
        return tuple(torch.from_numpy(a[:n]).to(gen.device)
                     for a in fixed_rays())


def bench(M):
    oe = M.optical_elements(24, 12)
    return [oe.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95),
            oe.cube(size=(2.0, 2.0, 0.2), center=(0.6, 0.0, 3.0),
                    material="refractive", ior=1.5),
            M.optical_elements(32, 8).hemisphere(radius=100.0, name="dome")]


_RUNS = {}


def runs(cull):
    """(reference, port, port tracer) trace_batched results, once per
    process and cull setting; capacity 4x the batch, so top-k never
    drops a child and the two packages' tie orders cannot differ."""
    if cull not in _RUNS:
        kw = dict(total_rays=N_BATCHES * BATCH, batch_size=BATCH,
                  capacity=4 * BATCH, seed=3, cull=cull, **MAPS)
        ref = L.Tracer().trace_batched(RefFixedSource(), elements=bench(L),
                                       **kw)
        tr = P.Tracer(device=CPU)
        port = tr.trace_batched(PortFixedSource(), elements=bench(P), **kw)
        _RUNS[cull] = (ref, port, tr)
    return _RUNS[cull]


@pytest.mark.parametrize("cull", [None, False])
def test_trace_batched_matches_reference(cull):
    ref, port, tr = runs(cull)
    assert tr._scene_sorted == (cull is None)  # auto resolves on
    assert port.iterations_run == ref.iterations_run
    assert port.rays_traced == ref.rays_traced
    assert port.intersection_tests == ref.intersection_tests
    assert port.per_batch_detector.shape == (N_BATCHES, 1)
    for k, v in ref.ledger.items():
        assert port.ledger[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.shape == b.shape, f
        assert np.allclose(b, a, rtol=1e-5, atol=1e-7), f
    # the coherent field: its phase turns with OPL / lambda, so a few f32
    # ulps of an OPL near 100 move it by ~1e-4 of its scale
    assert np.allclose(port.image_amp, ref.image_amp, rtol=0,
                       atol=field_tol(MAPS["opl_max"], ref.image_amp))
    assert np.array_equal(port.opl_edges, ref.opl_edges)
    # the maps are on and hold what the ledger says
    assert port.ledger["measured"] > 0.5
    assert port.hist.sum() == pytest.approx(port.ledger["measured"],
                                            rel=1e-5)
    assert port.time_hist.sum() == pytest.approx(port.ledger["measured"],
                                                 rel=1e-5)
    assert np.isfinite(port.detector_stderr("dome"))
    assert port.power_conservation_error() < 1e-5


def test_flux_map_follows_the_scene_order():
    # with cull on the scene is spatially sorted and tri_flux follows it,
    # as the reference's: per-element totals agree either way
    (_, on, tr_on), (_, off, tr_off) = runs(None), runs(False)
    a = tr_on.get_surface_flux()["per_element"]
    b = tr_off.get_surface_flux()["per_element"]
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
    assert not np.allclose(on.tri_flux, off.tri_flux)


def port_run(**kw):
    args = dict(total_rays=4 * 2048, batch_size=2048, seed=5,
                trace_iterations=4, roulette_threshold=2e-4, time_bins=8,
                opl_min=96.0, opl_max=112.0, flux_map=True, image_bins=8,
                image_halfwidth=100.0, coherent=True)
    args.update(kw)
    src = P.CollimatedSource(center=(0, 0, 5), direction=(0, 0, -1),
                             diameter=3.5)
    return P.Tracer(device=CPU).trace_batched(src, elements=bench(P)[::2],
                                              **args)


def assert_bit_identical(a, b):
    for f in FIELDS + ("image_amp",):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.ledger == b.ledger


def test_resume_and_repeat_are_bit_identical(tmp_path):
    full = port_run()
    # roulette acted: the batches differ, and the ledger books its delta
    assert not np.array_equal(full.per_batch_detector[0],
                              full.per_batch_detector[1])
    assert_bit_identical(full, port_run())
    ck = str(tmp_path / "run")
    first = port_run(checkpoint_path=ck, max_batches=2)
    assert first.per_batch_detector.shape == (2, 1)
    resumed = port_run(checkpoint_path=ck)
    assert_bit_identical(full, resumed)
    assert (tmp_path / "run.npz").exists()


def test_resume_from_a_reference_checkpoint(tmp_path):
    # the JAX package traces batch 0 and checkpoints; the port resumes and
    # traces batches 1 and 2 of the same rays
    ck = str(tmp_path / "ref_run")
    kw = dict(total_rays=N_BATCHES * BATCH, batch_size=BATCH,
              capacity=4 * BATCH, seed=3, cull=False, **MAPS)
    L.Tracer().trace_batched(RefFixedSource(), elements=bench(L),
                             checkpoint_path=ck, max_batches=1, **kw)
    resumed = P.Tracer(device=CPU).trace_batched(
        PortFixedSource(), elements=bench(P), checkpoint_path=ck, **kw)
    ref = runs(False)[0]
    for k, v in ref.ledger.items():
        assert resumed.ledger[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    # the reference's checkpoint holds no ledger rows for its batch
    assert resumed.per_batch_ledger is None
    for f in FIELDS:
        assert np.allclose(getattr(resumed, f), getattr(ref, f), rtol=1e-5,
                           atol=1e-7), f


def test_partial_batch_warns(caplog):
    src = P.CollimatedSource(center=(0, 0, 5), direction=(0, 0, -1),
                             diameter=3.5)
    with caplog.at_level(logging.WARNING, logger="lightpycl_tpu_torch"):
        res = P.Tracer(device=CPU).trace_batched(
            src, total_rays=1000, batch_size=300, elements=bench(P)[::2],
            trace_iterations=3)
    assert "not the requested 1000" in caplog.text
    assert res.per_batch_detector.shape == (3, 1)
    assert res.ledger["emitted"] == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("kw", [dict(mode="multichip"), dict(mode="mesh2d"),
                                dict(mesh=object())])
def test_multi_device_modes_raise(kw):
    """The multi-device modes are ported. mode='multichip' runs on the
    port's one-rank group (started in this process) and agrees with the
    reference's 8 virtual devices to f32 summation order (rel 1e-5);
    mode='mesh2d' without a mesh is the reference's refusal, word for
    word; a mesh= that is no mesh is not read in device mode, in either
    package, so the run equals the plain device run (the port's bit for
    bit)."""
    args = dict(total_rays=1024, batch_size=512, capacity=4 * BATCH,
                seed=3, cull=False, **MAPS)

    def port_run(**extra):
        return P.Tracer(device=CPU).trace_batched(
            PortFixedSource(), elements=bench(P), **args, **extra)

    def ref_run():
        return L.Tracer().trace_batched(RefFixedSource(), elements=bench(L),
                                        **args, **kw)

    if kw.get("mode") == "mesh2d":
        with pytest.raises(ValueError) as port_err:
            port_run(**kw)
        with pytest.raises(ValueError) as ref_err:
            ref_run()
        assert str(port_err.value) == str(ref_err.value)
        return
    port, ref = port_run(**kw), ref_run()
    for k, v in ref.ledger.items():
        assert port.ledger[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for f in FIELDS:
        assert np.allclose(getattr(port, f), getattr(ref, f), rtol=1e-5,
                           atol=1e-7), f
    assert port.power_conservation_error() < 1e-5
    if "mesh" in kw:
        assert_bit_identical(port, port_run())


def split_run(**kw):
    """A job of four 1,024-ray batches through the bowl, the refracting
    slab (splitting) and the dome, at 2x capacity."""
    src = P.CollimatedSource(center=(0, 0, 5), direction=(0, 0, -1),
                             diameter=3.5, power=2.0)
    args = dict(total_rays=4 * 1024, batch_size=1024, capacity=2 * 1024,
                seed=9, trace_iterations=4)
    args.update(kw)
    return P.Tracer(device=CPU).trace_batched(src, elements=bench(P), **args)


@pytest.mark.parametrize("run,power", [(port_run, 1.0), (split_run, 2.0)],
                         ids=["mirror_roulette", "splitting"])
def test_per_batch_ledger_rows_sum_to_the_ledger(run, power):
    res = run()
    rows = res.per_batch_ledger
    assert rows.shape == (4, 5) and rows.dtype == np.float64
    total = np.array([res.ledger[k] for k in Ledger._fields])
    np.testing.assert_allclose(rows.sum(axis=0), total, rtol=1e-12,
                               atol=1e-12 * total[0])
    # each batch emits its share of the source's power (float32 sums)
    np.testing.assert_allclose(rows[:, 0], power / 4, rtol=1e-6)
    # the batches differ, and each closes its own ledger
    assert not np.array_equal(rows[0], rows[1])
    np.testing.assert_allclose(rows[:, 1:].sum(axis=1), rows[:, 0],
                               rtol=1e-5)
    np.testing.assert_allclose(rows[:, 1], res.per_batch_detector.sum(axis=1),
                               rtol=1e-5)


def test_per_batch_ledger_resumes_bit_for_bit(tmp_path):
    full = split_run()
    ck = str(tmp_path / "run")
    first = split_run(checkpoint_path=ck, max_batches=3)
    assert np.array_equal(first.per_batch_ledger, full.per_batch_ledger[:3])
    resumed = split_run(checkpoint_path=ck)
    assert np.array_equal(resumed.per_batch_ledger, full.per_batch_ledger)
    assert np.array_equal(resumed.per_batch_detector,
                          full.per_batch_detector)
    assert resumed.ledger == full.ledger
