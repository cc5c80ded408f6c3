"""The port's triangle-sharded paths (lightpycl_tpu_torch.parallel
.tri_sharding and .mesh2d, Tracer.trace(mode="mesh2d")) against the JAX
package's (lightpycl_tpu.parallel on the conftest's 8 virtual devices), at
the reference tests' sizes (tests/test_tri_sharding.py, test_mesh2d.py).

The port's side runs in spawned ranks of a gloo group (2 and 4 ranks,
one launch each: tests/torch_parallel_common.tri_scenarios); the JAX side
runs here on a mesh of the same shape. Tolerances: the sharded nearest hit
equals the port's unsharded one bit for bit (one MIN over packed keys:
tri_sharding's docstring) and the reference's to its own bounds (indices
equal, t to 1e-6); trace_mesh2d's ledger to rel 1e-4 and histogram to atol
1e-5 of the reference at the same mesh shape (the reference's bounds for
a sharded trace); the engine's mesh2d mode equal to the port's device mode
bit for bit where the ray axis has one rank, else to those bounds; the
reference's refusals word for word.
"""

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.parallel.mesh2d import make_mesh2d, place, trace_mesh2d
from lightpycl_tpu.tracer.step import intersect_jnp
from test_torch_spectral import refused_scenes
from torch_dist_common import run_ranks
from torch_parallel_common import (CPU, MESH2D_SHAPES, beam, same,
                                   scene_els, tri_rays, tri_scenarios,
                                   tri_scene_els)

torch.set_num_threads(1)
LEDGER_REL = 1e-4
HIST_ATOL = 1e-5
CONSERVE = 1e-5

_RUNS = {}
_REF = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    def get(world):
        if world not in _RUNS:
            _RUNS[world] = run_ranks(tri_scenarios, world,
                                     tmp_path_factory.mktemp("ranks"))
        return _RUNS[world]
    return get


def ref_mesh2d(shape):
    """The reference's trace_mesh2d on tests/test_mesh2d.py's case."""
    if shape not in _REF:
        cfg = L.TraceConfig(hist_azimuth_bins=16, hist_polar_bins=8)
        o, d, p = beam(L, 1024, 3).sample()
        scene, _ = L.build_scene(scene_els(L))
        mesh = make_mesh2d(*shape)
        scene_sh, rays_sh = place(scene, L.RayBatch.from_arrays(o, d, p),
                                  mesh)
        rays_out, det, led = trace_mesh2d(scene_sh, rays_sh, cfg, 5, mesh)
        _REF[shape] = {
            "hist": np.asarray(det.hist),
            "ledger": {k: float(v) for k, v in led._asdict().items()},
            "live": float(np.asarray((rays_out.power
                                      * rays_out.alive).sum()))}
    return _REF[shape]


def assert_ledger(port, want, rel=LEDGER_REL, abs_=1e-6):
    for k, v in want.items():
        assert port[k] == pytest.approx(v, rel=rel, abs=abs_), k


# ---- the triangle-sharded intersect ----------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cull", [False, True])
def test_intersect_tri_sharded_matches_unsharded(runs, world, cull):
    r = runs(world)[0][f"tri_cull{cull}"]
    assert np.array_equal(r["tri"], r["tri_whole"])
    assert np.array_equal(r["t"].view(np.int32), r["t_whole"].view(np.int32))
    scene, _ = L.build_scene(tri_scene_els(L))
    o, d = tri_rays()
    t1, i1 = map(np.asarray, intersect_jnp(scene, o, d, L.TraceConfig()))
    assert (r["tri"] == i1).all()
    both = np.isfinite(t1)
    assert np.array_equal(np.isfinite(r["t"]), both)
    assert np.allclose(r["t"][both], t1[both], atol=1e-6)
    assert (r["tri"] >= 0).sum() > 100


@pytest.mark.parametrize("world", [2, 4])
def test_gather_hit_attributes(runs, world):
    mat, normal, ior, refl, det = runs(world)[0]["attrs"]
    tri = runs(world)[0]["tri_cullFalse"]["tri"]
    scene, _ = P.build_scene(tri_scene_els(P), device=CPU)
    hit = tri >= 0
    safe = np.maximum(tri, 0)
    assert np.array_equal(mat[hit], scene.mat.numpy()[safe][hit])
    assert np.array_equal(normal[hit], scene.normal.numpy()[safe][hit])
    assert np.array_equal(ior[hit], scene.ior.numpy()[safe][hit])
    assert np.array_equal(refl[hit], scene.reflectivity.numpy()[safe][hit])
    assert np.array_equal(det[hit], scene.detector_id.numpy()[safe][hit])
    assert (det[~hit] == -1).all() and (mat[~hit] == 0).all()


@pytest.mark.parametrize("world", [2, 4])
def test_shards_cover_the_scene(runs, world):
    scene, _ = P.build_scene(tri_scene_els(P), device=CPU)
    assert runs(world)[0]["shard_rows"] * world == \
        scene.num_triangles_padded


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_returns_the_same(runs, world):
    res = runs(world)
    for r in res[1:]:
        assert same(r, res[0])


# ---- trace_mesh2d on every 2-D shape of 4 ranks ----------------------------

@pytest.mark.parametrize("shape", MESH2D_SHAPES)
def test_mesh2d_matches_reference(runs, shape):
    port = runs(4)[0][f"mesh{shape}"]
    want = ref_mesh2d(shape)
    assert port["ledger"]["emitted"] == pytest.approx(
        want["ledger"]["emitted"], rel=1e-6)
    assert_ledger(port["ledger"], want["ledger"])
    np.testing.assert_allclose(port["hist"], want["hist"], atol=HIST_ATOL)
    led = port["ledger"]
    acc = led["measured"] + led["absorbed"] + led["escaped"] + led["culled"]
    assert acc + port["live"] == pytest.approx(1.0, rel=CONSERVE)


@pytest.mark.parametrize("shape", MESH2D_SHAPES)
def test_mesh2d_matches_device_mode(runs, shape):
    """Against the device loop on the same scene and rays: with one ray
    rank the ray order is the device loop's, so bit for bit (the nearest
    hit and every hit attribute are exact); else to the sharded bounds."""
    r = runs(4)[0]
    port, dev = r[f"mesh{shape}"], r["loop"]
    if shape[1] == 1:
        assert port["ledger"] == dev["ledger"]
        assert np.array_equal(port["hist"], dev["hist"])
    assert_ledger(port["ledger"], dev["ledger"])
    np.testing.assert_allclose(port["hist"], dev["hist"], atol=HIST_ATOL)


def test_engine_mesh2d_mode(runs):
    r = runs(4)[0]
    port, dev = r["engine"], r["device"]
    assert_ledger(port["ledger"], dev["ledger"])
    np.testing.assert_allclose(port["hist"], dev["hist"], atol=HIST_ATOL)
    assert port["per_detector"].shape == dev["per_detector"].shape
    assert port["conservation"] < CONSERVE
    assert same(port, r["engine_repeat"])  # a repeat, bit for bit
    want = L.Tracer(L.TraceConfig(hist_azimuth_bins=16,
                                  hist_polar_bins=8)).trace(
        beam(L, 1024, 3), scene_els(L), trace_iterations=5, mode="mesh2d",
        mesh=make_mesh2d(2, 2))
    assert_ledger(port["ledger"], want.ledger)
    np.testing.assert_allclose(port["hist"], want.hist, atol=HIST_ATOL)


def test_engine_mesh2d_requires_mesh(runs):
    msg = runs(4)[0]["requires_mesh"]
    with pytest.raises(ValueError) as e:
        L.Tracer().trace(beam(L, 1024, 3), scene_els(L), trace_iterations=2,
                         mode="mesh2d")
    assert msg == f"ValueError: {e.value}"


def test_mesh2d_dual_order_grating_matches_single_device(runs):
    r = runs(4)[0]
    port, dev = r["grating"], r["grating_device"]
    for k in ("measured", "absorbed", "escaped", "culled"):
        assert port["ledger"][k] == pytest.approx(dev["ledger"][k],
                                                  rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(port["hist"], dev["hist"], atol=HIST_ATOL)
    assert port["ledger"]["measured"] > 0.5


def test_mesh2d_cull_exact_parity(runs):
    c = runs(4)[0]["cull"]
    for k in ("measured", "absorbed", "escaped"):
        assert c[True]["ledger"][k] == pytest.approx(
            c[False]["ledger"][k], rel=2e-5, abs=1e-7), k
    np.testing.assert_allclose(c[True]["hist"], c[False]["hist"],
                               atol=HIST_ATOL)
    # auto (cull=None) resolves on for the collimated bundle
    assert same(c[None], c[True])


def test_mesh2d_roulette_conserves(runs):
    r = runs(4)[0]["roulette"]
    led = r["ledger"]
    acc = led["measured"] + led["absorbed"] + led["escaped"] + led["culled"]
    assert acc + r["live"] == pytest.approx(1.0, rel=CONSERVE)
    assert led["measured"] > 0.5


def test_mesh2d_roulette_requires_key(runs):
    msg = runs(4)[0]["missing_key"]
    assert msg is not None and msg.startswith("ValueError")
    assert "PRNG key" in msg


def test_mesh2d_many_detectors(runs):
    r = runs(4)[0]
    assert r["nine"]["per_detector"].shape == (10,)
    assert (r["nine_device"]["per_detector"] > 0).all()
    np.testing.assert_allclose(r["nine"]["per_detector"],
                               r["nine_device"]["per_detector"],
                               atol=HIST_ATOL)


def test_mesh2d_headroom_zero_cull(runs):
    h = runs(4)[0]["headroom"]
    assert abs(h["ledger"]["culled"]) < 1e-6
    assert h["conservation"] < CONSERVE


# ---- the reference's refusals, in this process -----------------------------

class MeshShape:
    """Only the shape of a ("tris", "rays") mesh: the refusals below come
    before any collective."""

    mesh_dim_names = ("tris", "rays")
    device_type = "cpu"

    def __init__(self, n_tris, n_rays):
        self.shape = (n_tris, n_rays)

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


def refusal(M, els, mesh, **kw):
    tracer = (L.Tracer() if M is L else P.Tracer(device=CPU))
    src = beam(M, 16, 1)
    with pytest.raises(ValueError) as e:
        tracer.trace(src, els, trace_iterations=2, mode="mesh2d", mesh=mesh,
                     **kw)
    with pytest.raises(ValueError) as e_b:
        tracer.trace_batched(src, 16, 16, elements=els, mode="mesh2d",
                             mesh=mesh, trace_iterations=2, **kw)
    return str(e.value), str(e_b.value)


@pytest.mark.parametrize("case", ["fluorescence", "grin", "analytic",
                                  "flux_map", "tris_not_divisible"])
def test_mesh2d_refusals_as_reference(case):
    def scene(M):
        if case in ("fluorescence", "grin"):
            return refused_scenes(M)[case]
        if case == "analytic":
            return [M.analytic_disc(1.0, name="det")]
        return scene_els(M)

    kw = dict(flux_map=True) if case == "flux_map" else {}
    shape = (7, 1) if case == "tris_not_divisible" else (2, 2)
    port = refusal(P, scene(P), MeshShape(*shape), **kw)
    want = refusal(L, scene(L), make_mesh2d(*shape), **kw)
    assert port == want
