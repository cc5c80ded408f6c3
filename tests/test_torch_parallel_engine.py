"""The engine's sharded modes beyond Tracer.trace: trace_batched
(multichip and mesh2d, a run resumed from its checkpoint), trace_spectral
(the shared and the wavelength-batched method) and the compat facade's
spectral iterative_tracer, each against the JAX package's engine at the
same mesh shape (the conftest's 8 virtual devices), on the same rays.

The port's side runs in spawned ranks of a gloo group (2 and 4 ranks:
tests/torch_parallel_common.engine_scenarios). Tolerances: the batched
ledger and maps to rel 1e-5 / atol 1e-7 (tests/test_torch_batched.py's
bounds: 512-ray batches of fixed rays with 4x headroom); the spectral
columns to 1e-5 (the per-column closure of tests/test_torch_spectral.py,
2e-6, plus the shards' summation order); a resumed run and the default
mesh's run equal the first bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightpycl_tpu as L
from lightpycl_tpu.materials import SF10
from lightpycl_tpu.parallel.mesh2d import make_mesh2d
from lightpycl_tpu.parallel.sharding import make_ray_mesh
from torch_dist_common import run_ranks
from torch_parallel_common import (SPECTRAL_MAPS, WL3, WLS, batched_kw,
                                   bowl_els, coated_window_els,
                                   engine_scenarios, fixed_rays, prism_els,
                                   same)

torch.set_num_threads(1)
WORLDS = (2, 4)
FIELDS = ("hist", "per_detector", "image", "time_hist", "per_batch_detector")
SPECTRAL_COLUMN = 1e-5

_RUNS = {}
_REF = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    def get(world):
        if world not in _RUNS:
            tmp = tmp_path_factory.mktemp("ranks")
            _RUNS[world] = run_ranks(engine_scenarios, world, tmp, str(tmp))
        return _RUNS[world]
    return get


class RefFixedSource:
    center = (0.0, 0.0, 5.0)

    def rays_on_device(self, key, n):
        return tuple(jnp.asarray(a) for a in fixed_rays(n))


def ref(name, world):
    key = (name, world)
    if key in _REF:
        return _REF[key]
    if name in ("batched", "batched_mesh2d"):
        mode = "multichip" if name == "batched" else "mesh2d"
        mesh = (make_ray_mesh(world) if mode == "multichip"
                else make_mesh2d(2, world // 2))
        out = L.Tracer().trace_batched(RefFixedSource(), elements=bowl_els(L),
                                       mode=mode, mesh=mesh,
                                       **batched_kw(mode))
    elif name == "spectral_shared":
        src = L.sources.CollimatedSource(
            center=(0, 0, -1.0), direction=(0, 0, 1), diameter=0.5,
            ray_count=256, power=1.0, seed=3)
        rays = L.RayBatch.from_arrays(*src.sample(), capacity=1024)
        out = L.Tracer().trace_spectral(
            None, WLS, elements=coated_window_els(L), rays=rays,
            trace_iterations=8, mode="multichip", mesh=make_ray_mesh(world),
            **SPECTRAL_MAPS)
    elif name == "spectral_batched":
        src = L.sources.CollimatedSource(
            center=(0.3, -0.5, 0), direction=(0, 1, 0), diameter=0.04,
            ray_count=200, power=1.0, seed=2)
        rays = L.RayBatch.from_arrays(*src.sample(), capacity=400)
        out = L.Tracer().trace_spectral(
            None, WL3, elements=prism_els(L, *SF10), rays=rays,
            trace_iterations=4, mode="multichip", mesh=make_ray_mesh(world))
    elif name == "compat_spectral":
        src = L.sources.CollimatedSource(
            center=(0, 0, -1.0), direction=(0, 0, 1), diameter=0.5,
            ray_count=256, power=1.0, seed=3)
        out = L.CL_Tracer().iterative_tracer(
            src, coated_window_els(L), trace_iterations=8, wavelengths=WLS,
            capacity=1024, mode="multichip", mesh=make_ray_mesh(world))
    else:  # the host-mode refusal of the batched method
        src = L.sources.CollimatedSource(
            center=(0.3, -0.5, 0), direction=(0, 1, 0), diameter=0.04,
            ray_count=200, power=1.0, seed=2)
        rays = L.RayBatch.from_arrays(*src.sample(), capacity=400)
        with pytest.raises(ValueError) as e:
            L.Tracer().trace_spectral(None, WL3, elements=prism_els(L, *SF10),
                                      rays=rays, trace_iterations=4,
                                      mode="host")
        out = f"ValueError: {e.value}"
    _REF[key] = out
    return out


def assert_batched(port, want, fields=FIELDS):
    for k, v in want.ledger.items():
        assert port["ledger"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for f in fields:
        a = getattr(want, f)
        assert port[f].shape == a.shape, f
        assert np.allclose(port[f], a, rtol=1e-5, atol=1e-7), f
    assert port["conservation"] < 1e-5


def assert_spectral(port, want):
    for k, v in want.spectral_ledger.items():
        np.testing.assert_allclose(port["spectral_ledger"][k], v,
                                   rtol=0, atol=SPECTRAL_COLUMN, err_msg=k)
    np.testing.assert_allclose(port["per_detector_spectrum"],
                               want.per_detector_spectrum, rtol=0,
                               atol=SPECTRAL_COLUMN)
    np.testing.assert_allclose(port["hist"], want.hist, rtol=0,
                               atol=SPECTRAL_COLUMN)
    assert port["names"] == list(want.detector_names)
    assert port["rays_traced"] == want.rays_traced
    assert port["live"] == pytest.approx(want.final_live_power,
                                         abs=SPECTRAL_COLUMN)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same(runs, world):
    res = runs(world)
    for r in res[1:]:
        assert same(r, res[0])


@pytest.mark.parametrize("world", WORLDS)
def test_trace_batched_multichip_matches_reference(runs, world):
    r = runs(world)[0]
    assert_batched(r["batched"], ref("batched", world),
                   FIELDS + ("tri_flux",))
    # the default mesh is every rank: the same run, bit for bit
    assert same(r["batched"], r["batched_default_mesh"])
    # and the device run, to the same bounds
    for k, v in r["batched_device"]["ledger"].items():
        assert r["batched"]["ledger"][k] == pytest.approx(
            v, rel=1e-5, abs=1e-7), k


@pytest.mark.parametrize("world", WORLDS)
def test_trace_batched_mesh2d_matches_reference(runs, world):
    """Every field to the reference's, the time map too: the reference's
    trace_mesh2d starts its DetectorState without time bins
    (lightpycl_tpu/parallel/mesh2d.py:90), so its mesh2d time map is
    detector 0's measured power broadcast over every bin, and the port
    reproduces that array."""
    port = runs(world)[0]["batched_mesh2d"]
    assert_batched(port, ref("batched_mesh2d", world))
    assert np.allclose(port["time_hist"], port["per_detector"][0],
                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_trace_batched_mesh2d_resume_is_bit_identical(runs, world):
    res = runs(world)[0]["resume"]
    assert res["checkpoint"]
    assert res["first_batches"].shape == (2, 1)
    # rays_traced counts this call's batches (1 of 3 after the resume)
    full, resumed = dict(res["full"]), dict(res["resumed"])
    assert resumed.pop("rays_traced") * 3 == full.pop("rays_traced")
    assert same(full, resumed)
    # roulette acted: batches 0 and 1, of the same rays, differ in their
    # ledgers (the power roulette culls); their detector totals may tie,
    # since survivors carry whole weights (at 2 ranks they do), but not
    # every batch's
    led = res["full_ledger_rows"]
    assert not np.array_equal(led[0], led[1])
    rows = res["full"]["per_batch_detector"]
    assert any(not np.array_equal(rows[0], r) for r in rows[1:])
    assert res["full"]["conservation"] < 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_trace_batched_multichip_roulette_conserves(runs, world):
    r = runs(world)[0]["batched_multichip_roulette"]
    assert r["conservation"] < 1e-5
    assert r["ledger"]["measured"] > 0.5


@pytest.mark.parametrize("world", WORLDS)
def test_trace_spectral_shared_multichip_matches_reference(runs, world):
    r = runs(world)[0]
    assert_spectral(r["spectral_shared"], ref("spectral_shared", world))
    dev = r["spectral_shared_device"]
    for k in dev["spectral_ledger"]:
        np.testing.assert_allclose(r["spectral_shared"]["spectral_ledger"][k],
                                   dev["spectral_ledger"][k], rtol=0,
                                   atol=SPECTRAL_COLUMN, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_trace_spectral_batched_multichip_matches_reference(runs, world):
    r = runs(world)[0]
    assert_spectral(r["spectral_batched"], ref("spectral_batched", world))
    dev = r["spectral_batched_device"]
    np.testing.assert_allclose(r["spectral_batched"]["per_detector_spectrum"],
                               dev["per_detector_spectrum"], rtol=0,
                               atol=SPECTRAL_COLUMN)


@pytest.mark.parametrize("world", WORLDS)
def test_trace_spectral_refuses_as_reference(runs, world):
    assert runs(world)[0]["spectral_host_refused"] == ref("host", world)


@pytest.mark.parametrize("world", WORLDS)
def test_compat_spectral_multichip_matches_reference(runs, world):
    assert_spectral(runs(world)[0]["compat_spectral"],
                    ref("compat_spectral", world))
