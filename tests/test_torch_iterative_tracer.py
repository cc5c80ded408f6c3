"""Tracer.iterative_tracer (the reference's alias of trace) and
Tracer.trace(profile_logdir=...) in the port.

  * The port's Tracer.iterative_tracer traces the same scene and the same
    numpy rays to the reference's ledger, to float32 tolerance, with the
    reference's defaults (16 iterations, max_ray_len 1e3, host mode).
  * CL_Tracer keeps its own override (path record, spectral upgrade).
  * profile_logdir writes a torch.profiler Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu_torch.compat import CL_Tracer
from lightpycl_tpu_torch.utils import Timer, trace_profile

torch.set_num_threads(1)

POWER = 1e-6  # of unit emitted power: float32 sums of ~1e3 rays


def scene(pkg):
    oe = pkg.optical_elements(n_segments=24, n_radial=8)
    return [oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, center=(0, 0, 0.5)),
            oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9).translate(
                (0, 0, -1.0)),
            oe.sphere(radius=6.0, material="measure", name="dome")]


def rays_of(pkg, o, d, p, **kw):
    return pkg.RayBatch.from_arrays(o, d, p, capacity=4 * len(p), **kw)


def test_reference_signature():
    assert hasattr(P.Tracer, "iterative_tracer")
    import inspect

    import lightpycl_tpu.tracer.engine as RE
    import lightpycl_tpu_torch.tracer.engine as PE

    assert (inspect.signature(PE.Tracer.iterative_tracer)
            == inspect.signature(RE.Tracer.iterative_tracer))
    # CL_Tracer overrides it with its own (record_paths, wavelengths)
    assert CL_Tracer.iterative_tracer is not P.Tracer.iterative_tracer


@pytest.mark.parametrize("mode", ["host", "device"])
def test_iterative_tracer_matches_reference(mode):
    src = L.light_source(center=(0, 0, 0.0), direction=(0, 0, 1),
                         power=1.0, ray_count=512, seed=5)
    o, d, p = src.sample()
    ref = L.Tracer().iterative_tracer(None, scene(L), rays=rays_of(L, o, d, p),
                                      mode=mode)
    port = P.Tracer(device="cpu").iterative_tracer(
        None, scene(P), rays=rays_of(P, o, d, p, device="cpu"), mode=mode)
    assert port.iterations_run == ref.iterations_run
    for k, v in ref.ledger.items():
        assert port.ledger[k] == pytest.approx(v, abs=POWER), k
    assert port.ledger["measured"] > 0.5
    np.testing.assert_allclose(port.per_detector, ref.per_detector,
                               atol=POWER)
    if mode == "host":
        assert len(port.measured_power) == len(ref.measured_power)
    # the defaults are the reference's: 16 iterations, max_ray_len 1e3
    again = P.Tracer(device="cpu").iterative_tracer(
        None, scene(P), rays=rays_of(P, o, d, p, device="cpu"),
        trace_iterations=16, max_ray_len=1e3, ior_env=1.0, mode=mode)
    assert again.ledger == port.ledger


def test_cl_tracer_override_still_records_paths():
    src = P.light_source(center=(0, 0, 0.0), direction=(0, 0, 1),
                         power=1.0, ray_count=128, seed=2)
    tr = CL_Tracer(device="cpu")
    res = tr.iterative_tracer(src, scene(P), trace_iterations=3)
    assert len(res.segments) == res.iterations_run  # host-mode path record
    plain = P.Tracer(device="cpu").iterative_tracer(src, scene(P),
                                                    trace_iterations=3)
    assert plain.segments == []  # the alias is trace(): no record
    assert plain.ledger == res.ledger


def test_profile_logdir_writes_trace(tmp_path):
    src = P.light_source(center=(0, 0, 0.0), direction=(0, 0, 1),
                         power=1.0, ray_count=64, seed=3)
    logdir = tmp_path / "prof"
    res = P.Tracer(device="cpu").trace(src, scene(P), trace_iterations=2,
                                       profile_logdir=str(logdir))
    assert res.iterations_run == 2
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    path = logdir / files[0]
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_trace_profile_none_is_a_no_op():
    with Timer() as t, trace_profile(None):
        x = sum(range(1000))
    assert x == 499500 and t.elapsed >= 0.0
