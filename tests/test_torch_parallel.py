"""The port's ray-sharded tracing (lightpycl_tpu_torch.parallel.sharding and
Tracer.trace(mode="multichip")) against the JAX package's
(lightpycl_tpu.parallel.sharding on the conftest's 8 virtual devices), on
the same rays, at the reference tests' sizes (tests/test_sharding.py).

The port's side runs in spawned ranks of a gloo group (1, 2 and 4 ranks:
tests/torch_dist_common.py, one launch a rank count, every case inside:
tests/torch_parallel_common.multichip_scenarios); the JAX side runs here,
on a mesh of the same size. Tolerances: the ledger to rel 1e-4 and the
histogram to atol 1e-5 (the reference's own bounds for a sharded against
a single-device trace: the shards sum in another order), conservation to
1e-5, the split-heavy zero-cull case to atol 1e-4 (tests/test_sharding.py
:197). A rank count's repeat, and every rank's copy, are bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.parallel import sharding as RSH
from lightpycl_tpu_torch.parallel import sharding as PSH
from torch_dist_common import run_ranks
from torch_parallel_common import (CPU, beam, multichip_scenarios, same,
                                   scene_els)

torch.set_num_threads(1)
WORLDS = (1, 2, 4)
LEDGER_REL = 1e-4
HIST_ATOL = 1e-5
CONSERVE = 1e-5

_RUNS = {}
_REF = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> every rank's scenario results (one launch a world)."""
    def get(world):
        if world not in _RUNS:
            _RUNS[world] = run_ranks(multichip_scenarios, world,
                                     tmp_path_factory.mktemp("ranks"))
        return _RUNS[world]
    return get


def ref(name, world):
    """The reference's run of case `name` on a `world`-device ray mesh."""
    key = (name, world)
    if key in _REF:
        return _REF[key]
    mesh = RSH.make_ray_mesh(world)
    cfg = L.TraceConfig(hist_azimuth_bins=16, hist_polar_bins=8)
    if name == "direct":
        o, d, p = beam(L, 2048, 3).sample()
        scene, _ = L.build_scene(scene_els(L))
        _, det, led = RSH.trace_multichip(
            scene, RSH.shard_rays(L.RayBatch.from_arrays(o, d, p), mesh),
            cfg, 5, mesh)
        out = {"hist": np.asarray(det.hist),
               "ledger": {k: float(v) for k, v in led._asdict().items()}}
    elif name == "engine":
        out = L.Tracer(cfg).trace(beam(L, 2048, 3), scene_els(L),
                                  trace_iterations=5, mode="multichip",
                                  mesh=mesh)
    elif name == "pads":
        out = L.Tracer(L.TraceConfig()).trace(
            beam(L, 1001, 5), scene_els(L), trace_iterations=5,
            mode="multichip", mesh=mesh)
    else:
        out = L.CL_Tracer().iterative_tracer(
            beam(L, 2048, 3), scene_els(L), trace_iterations=5,
            mode="multichip", mesh=mesh)
    _REF[key] = out
    return out


def assert_ledger(port, want, rel=LEDGER_REL, abs_=1e-7):
    for k, v in want.items():
        assert port[k] == pytest.approx(v, rel=rel, abs=abs_), k


# ---- the slot permutation, in this process ---------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_interleave_matches_reference(n):
    rng = np.random.default_rng(0)
    args = (rng.normal(size=(64, 3)), np.tile([0, 0, 1.0], (64, 1)),
            rng.uniform(0.1, 1.0, 64))
    ref_rays = L.RayBatch.from_arrays(*args, capacity=256)
    port_rays = P.RayBatch.from_arrays(*args, capacity=256, device=CPU)
    ref_perm = RSH.interleave_rays(ref_rays, n)
    port_perm = PSH.interleave_rays(port_rays, n)
    for a, b in zip(ref_perm, port_perm):
        assert np.array_equal(np.asarray(a), b.numpy())
    back = PSH.deinterleave_rays(port_perm, n)
    for a, b in zip(back, port_rays):
        assert torch.equal(a, b)
    for a, b in zip(RSH.deinterleave_rays(ref_perm, n),
                    PSH.deinterleave_rays(port_perm, n)):
        assert np.array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="divisible"):
        PSH.interleave_rays(port_rays, n - 1 if n > 2 else 3)
    with pytest.raises(ValueError, match="divisible"):
        RSH.interleave_rays(ref_rays, n - 1 if n > 2 else 3)


# ---- the ranks --------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same(runs, world):
    """Every rank returns the same global results (the layout case, which
    is each rank's own shard, aside)."""
    res = runs(world)
    assert len(res) == world
    for r in res[1:]:
        assert same({k: v for k, v in r.items() if k != "layout"},
                    {k: v for k, v in res[0].items() if k != "layout"})


@pytest.mark.parametrize("world", WORLDS)
def test_shard_rays_layout(runs, world):
    for rank, r in enumerate(runs(world)):
        lay = r["layout"]
        assert lay["capacity"] == 256 // world, rank
        assert lay["is_block"] and lay["raw_block"] and lay["gathered"], rank


@pytest.mark.parametrize("world", WORLDS)
def test_trace_multichip_matches_reference(runs, world):
    port = runs(world)[0]["direct"]
    want = ref("direct", world)
    assert port["ledger"]["emitted"] == pytest.approx(
        want["ledger"]["emitted"], rel=1e-6)
    assert_ledger(port["ledger"], want["ledger"])
    np.testing.assert_allclose(port["hist"], want["hist"], atol=HIST_ATOL)
    assert runs(world)[0]["direct"]["local_capacity"] == 2048 // world


@pytest.mark.parametrize("world", WORLDS)
def test_trace_multichip_matches_device_mode(runs, world):
    """Against the port's own single-device trace (tests/test_sharding.py
    :30 holds the reference so); at one rank, bit for bit."""
    r = runs(world)[0]
    port, dev = r["engine"], r["engine_device"]
    assert port["ledger"]["emitted"] == pytest.approx(
        dev["ledger"]["emitted"], rel=1e-6)
    assert_ledger(port["ledger"], dev["ledger"])
    np.testing.assert_allclose(port["hist"], dev["hist"], atol=HIST_ATOL)
    np.testing.assert_allclose(port["per_detector"], dev["per_detector"],
                               atol=HIST_ATOL)
    assert port["names"] == dev["names"]
    assert same(r["engine_mesh"], port)  # an explicit mesh of every rank
    if world == 1:
        for k in ("hist", "per_detector", "image", "ledger"):
            assert same({k: port[k]}, {k: dev[k]}), k


@pytest.mark.parametrize("world", WORLDS)
def test_conservation_under_sharding(runs, world):
    c = runs(world)[0]["conservation"]
    led = c["ledger"]
    acc = led["measured"] + led["absorbed"] + led["escaped"] + led["culled"]
    assert acc + c["live"] == pytest.approx(2.0, rel=CONSERVE)
    d = runs(world)[0]["direct"]
    assert (sum(v for k, v in d["ledger"].items() if k != "emitted")
            + d["live"] == pytest.approx(1.0, rel=CONSERVE))


@pytest.mark.parametrize("world", WORLDS)
def test_engine_multichip_matches_reference(runs, world):
    port = runs(world)[0]["engine"]
    want = ref("engine", world)
    assert_ledger(port["ledger"], want.ledger)
    np.testing.assert_allclose(port["hist"], want.hist, atol=HIST_ATOL)
    # a detector's total is a ledger column
    np.testing.assert_allclose(port["per_detector"], want.per_detector,
                               rtol=LEDGER_REL)
    assert port["names"] == want.detector_names
    assert port["iterations"] == want.iterations_run
    assert port["rays_traced"] == want.rays_traced
    assert port["live"] == pytest.approx(want.final_live_power, abs=1e-6)
    assert port["conservation"] < CONSERVE


@pytest.mark.parametrize("world", WORLDS)
def test_engine_mode_pads_capacity(runs, world):
    """1,001 rays divide neither 2 nor 4 ranks: the engine pads and traces
    as the reference does at the same mesh size. (With no headroom the
    lens's splits overflow each shard's own top-k, so the culled power
    depends on the rank count, in both packages: 1.2e-4 of the measured
    power at 4 ranks; one rank equals device mode.)"""
    pads = runs(world)[0]["pads"]
    want = ref("pads", world)
    assert_ledger(pads["multichip"]["ledger"], want.ledger)
    assert pads["multichip"]["rays_traced"] == want.rays_traced == (
        -(-1001 // world) * world * 5)
    assert pads["multichip"]["conservation"] < CONSERVE
    if world == 1:
        assert pads["multichip"]["ledger"] == pads["device"]["ledger"]


@pytest.mark.parametrize("world", WORLDS)
def test_nine_plus_detectors(runs, world):
    nine = runs(world)[0]["nine"]
    assert len(nine["multichip"]["names"]) == 10
    assert nine["multichip"]["per_detector"].shape == (10,)
    assert (nine["device"]["per_detector"] > 0).all()
    np.testing.assert_allclose(nine["multichip"]["per_detector"],
                               nine["device"]["per_detector"],
                               atol=HIST_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_roulette_multichip_conserves(runs, world):
    r = runs(world)[0]["roulette"]
    assert r["conservation"] < CONSERVE
    assert r["ledger"]["measured"] > 0.5


@pytest.mark.parametrize("world", WORLDS)
def test_roulette_requires_key(runs, world):
    msg = runs(world)[0]["missing_key"]
    assert msg is not None and msg.startswith("ValueError")
    assert "PRNG key" in msg


@pytest.mark.parametrize("world", WORLDS)
def test_multichip_headroom_zero_cull(runs, world):
    """The split-heavy window with 4x headroom: interleaved shards cull
    nothing, as the single-device trace (atol 1e-4: the reference's bound,
    f32 summation order over the shards and 8 bounces)."""
    h = runs(world)[0]["headroom"]
    assert abs(h["device"]["ledger"]["culled"]) < 1e-6
    assert abs(h["multichip"]["ledger"]["culled"]) < 1e-6
    for k in ("emitted", "measured", "absorbed", "escaped"):
        assert h["multichip"]["ledger"][k] == pytest.approx(
            h["device"]["ledger"][k], abs=1e-4), k
    np.testing.assert_allclose(h["multichip"]["per_detector"],
                               h["device"]["per_detector"], atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_cull_multichip_matches_brute(runs, world):
    c = runs(world)[0]["cull"]
    assert c[True]["ledger"]["measured"] == pytest.approx(
        c[False]["ledger"]["measured"], rel=CONSERVE)
    np.testing.assert_allclose(c[True]["hist"], c[False]["hist"],
                               atol=HIST_ATOL)
    assert c[True]["conservation"] < CONSERVE


@pytest.mark.parametrize("world", WORLDS)
def test_repeat_is_bit_identical(runs, world):
    r = runs(world)[0]
    assert same(r["engine"], r["engine_repeat"])


@pytest.mark.parametrize("world", WORLDS)
def test_iterative_tracer_multichip_matches_reference(runs, world):
    port = runs(world)[0]["iterative_tracer"]
    want = ref("iterative_tracer", world)
    assert_ledger(port["ledger"], want.ledger)
    np.testing.assert_allclose(port["hist"], want.hist, atol=HIST_ATOL)


def test_reference_mesh_sizes():
    assert len(jax.devices()) == 8  # the JAX side's virtual devices
