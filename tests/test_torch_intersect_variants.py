"""The nearest hit's epilogue variants (lightpycl_tpu_torch/ops/
intersect_variants.py, variant_bench.py) against the JAX package.

The reference's variant kernels (benchmarks/micro_variants.py,
benchmarks/epilogue_variants.py) are closures of TPU-only scripts that claim
one thing: each returns what the shipped kernel returns. So every variant's
plain torch version is held to the JAX package's nearest hit
(step.intersect_jnp and the Pallas kernel in interpret mode) on the same
seeded rays: identical triangles, t abs 1e-5. Among themselves the variants
must agree bit for bit (`recip` to RECIP_RTOL). The CUDA kernels run only on
the card (the test marked `cuda`, and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.ops.intersect_pallas import intersect_pallas
from lightpycl_tpu.tracer.step import intersect_jnp
from lightpycl_tpu_torch import variant_bench as VB
from lightpycl_tpu_torch.ops import _build
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.ops import intersect_variants as IV
from lightpycl_tpu_torch.tracer.scene import Scene as PortScene

torch.set_num_threads(1)
CPU = torch.device("cpu")
REF_CFG = L.TraceConfig()
ARGS = (1e-4, 1e-6, 1e3)


def random_rays(seed, n, span=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    oe = L.optical_elements(16, 6)
    els = [oe.parabolic_mirror(0.5, 2.0), oe.hemisphere(4.0),
           oe.cube(0.4, center=(0.6, 0.1, 0.8), material="refractive",
                   ior=1.5),
           oe.biconvex_lens(1.0, 0.8, 0.2, center=(-0.5, 0, 1.0))]
    rs, _ = L.build_scene(els)
    return rs, PortScene.from_reference(rs, CPU)


@pytest.fixture(scope="module")
def reference_hits(scenes):
    rs, _ = scenes
    o, d = random_rays(11, 400)
    out = {"jnp": intersect_jnp(rs, jnp.asarray(o), jnp.asarray(d), REF_CFG),
           "pallas_interpret": intersect_pallas(
               rs, jnp.asarray(o), jnp.asarray(d), REF_CFG, ray_block=128,
               tri_tile=256, interpret=True)}
    return o, d, {k: tuple(map(np.asarray, v)) for k, v in out.items()}


def variant_hit(ps, o, d, name, **kw):
    t, i = IV.nearest_hit_variant(torch.from_numpy(o), torch.from_numpy(d),
                                  ps.wu, ps.wv, ps.ww, *ARGS, variant=name,
                                  **kw)
    return t.numpy(), i.numpy()


@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("name", list(IV.VARIANTS))
def test_variant_matches_reference(scenes, reference_hits, name, ref):
    o, d, hits = reference_hits
    t1, i1 = hits[ref]
    t2, i2 = variant_hit(scenes[1], o, d, name)
    assert (i1 == i2).all()
    assert np.array_equal(np.isfinite(t1), np.isfinite(t2))
    both = np.isfinite(t1)
    assert both.sum() > 100
    assert np.allclose(t1[both], t2[both], atol=1e-5)
    assert t2.dtype == np.float32 and i2.dtype == np.int32


@pytest.mark.parametrize("name", [n for n in IV.VARIANTS if n != "base"])
def test_variants_agree_with_base(scenes, name):
    o, d = random_rays(5, 700, span=3.0)
    t0, i0 = variant_hit(scenes[1], o, d, "base")
    t1, i1 = variant_hit(scenes[1], o, d, name)
    assert np.array_equal(i0, i1)
    if name == "recip":  # two roundings where the others divide once
        hit = i0 >= 0
        assert np.array_equal(np.isinf(t0), np.isinf(t1))
        assert (np.abs(t1[hit] - t0[hit]) <= VB.RECIP_RTOL * t0[hit]).all()
    else:
        assert np.array_equal(t0, t1)


@pytest.mark.parametrize("name", ["base", "ieee", "notmax", "min2_notmax"])
def test_variant_equals_shipped_kernels_plain_version(scenes, name):
    # t = -OW / DW with the minimum of t against q = OW / DW with the maximum
    # of q: the same roundings, so the same bits
    _, ps = scenes
    o, d = (torch.from_numpy(a) for a in random_rays(7, 500, span=3.0))
    t0, i0 = PI.nearest_hit_torch(o, d, ps.wu, ps.wv, ps.ww, *ARGS)
    t1, i1 = IV.nearest_hit_variant_torch(o, d, ps.wu, ps.wv, ps.ww, *ARGS,
                                          variant=name)
    assert torch.equal(i0, i1) and torch.equal(t0, t1)


@pytest.mark.parametrize("name", ["base", "recip", "tuned", "min2_notmax"])
def test_edge_cases(name):
    # a hit, a miss beside the triangle, a ray in the triangle's plane
    # (DW == 0: the guard, or inf / NaN in the IEEE variants), a triangle
    # behind the ray, a self-hit inside eps, one beyond t_max, and 255
    # all-zero padding rows that must never be reported
    tri = P.GeoObject(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
                      np.array([[0, 1, 2]]))
    scene, _ = P.build_scene([tri], device=CPU)
    assert scene.num_triangles_padded == 256
    o = np.array([[0.2, 0.2, 1.0], [0.9, 0.9, 1.0], [0.2, 0.2, 0.0],
                  [0.2, 0.2, -1.0], [0.2, 0.2, 5e-5], [0.2, 0.2, 2e3],
                  [0.0, 0.0, 0.0]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1], [1, 0, 0], [0, 0, -1], [0, 0, -1],
                  [0, 0, -1], [0, 0, 1]], np.float32)
    t, i = variant_hit(scene, o, d, name)
    assert i.tolist() == [0, -1, -1, -1, -1, -1, -1]
    assert t[0] == pytest.approx(1.0, abs=1e-6) and np.isinf(t[1:]).all()
    assert (t[1:] > 0).all()


def test_coincident_triangles_lowest_index():
    a = P.optical_elements(8, 4).rectangle(1, 1, center=(0, 0, 1))
    b = P.optical_elements(8, 4).rectangle(1, 1, center=(0, 0, 1))
    scene, _ = P.build_scene([a, b], device=CPU)
    o = torch.tensor([[0.1, 0.2, 0.0], [-0.3, 0.1, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    for name in ("base", "tuned", "min2_notmax"):
        for chunk in (1, 2, 256):
            t, i = IV.nearest_hit_variant_torch(
                o, d, scene.wu, scene.wv, scene.ww, *ARGS, variant=name,
                tri_chunk=chunk)
            assert (i < a.num_triangles).all() and (i >= 0).all()
            assert torch.allclose(t, torch.ones(2))


def test_chunking_does_not_change_bits(scenes):
    _, ps = scenes
    o, d = (torch.from_numpy(a) for a in random_rays(3, 300))
    args = (ps.wu, ps.wv, ps.ww, *ARGS)
    for name in ("base", "min2_notmax"):
        t0, i0 = IV.nearest_hit_variant_torch(o, d, *args, variant=name)
        t1, i1 = IV.nearest_hit_variant_torch(o, d, *args, variant=name,
                                              ray_block=7, tri_chunk=33)
        assert torch.equal(i0, i1) and torch.equal(t0, t1)


@pytest.mark.parametrize("entry", ["micro_variants", "epilogue_variants"])
def test_bench_entry_points_on_the_cpu(entry):
    inputs = VB.bench_inputs(n_rays=400, n_segments=16, n_radial=6,
                             device="cpu")
    before = dict(IV.nearest_hit_variant_cuda.launches)
    rows = getattr(VB, entry)(inputs, reps=1)
    names = (IV.MICRO_VARIANTS if entry == "micro_variants"
             else IV.EPILOGUE_VARIANTS)
    assert [r["variant"] for r in rows] == list(names)
    for r in rows:
        assert r["ok"] and r["tri_mismatch"] == 0
        assert r["identical"] or r["variant"] == "recip"
        assert r["hits"] == 400  # every ray starts inside the sphere
        assert r["ms"] > 0 and r["tests_per_s"] > 0
    # CPU tensors use the plain version: no kernel launch is counted
    assert dict(IV.nearest_hit_variant_cuda.launches) == before


def test_bench_cli_on_the_cpu(capsys):
    rc = VB.main(["--rays", "200", "--segments", "16", "--radial", "6",
                  "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert len(out) == len(IV.MICRO_VARIANTS) + len(IV.EPILOGUE_VARIANTS)
    assert out[0].startswith("micro_variants base")


def test_wrapper_contract(scenes):
    _, ps = scenes
    o, d = (torch.from_numpy(a) for a in random_rays(1, 5))
    args = (ps.wu, ps.wv, ps.ww, *ARGS)
    with pytest.raises(ValueError, match="CUDA"):
        IV.nearest_hit_variant_cuda(o, d, *args)
    with pytest.raises(ValueError, match="unknown variant"):
        IV.nearest_hit_variant(o, d, *args, variant="argmin")
    if not torch.cuda.is_available():  # the entry points default to the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VB.bench_inputs(n_rays=8, n_segments=16, n_radial=6)


def test_every_variant_has_an_instantiation():
    # the table in csrc/intersect_variants.cu lists exactly the
    # (denom, notmax, min2, n_sub, reg) tuples of VARIANTS
    src = (_build.CSRC_DIR / "intersect_variants.cu").read_text()
    rows = [ln.split("LPCL_VARIANT(")[1].split(")")[0].replace(" ", "")
            for ln in src.splitlines()
            if ln.strip().startswith("LPCL_VARIANT(")]
    enum = {"guard": "kGuard", "recip": "kRecip", "ieee": "kIeee"}
    want = [f"{enum[v.denom]},{str(v.notmax).lower()},{str(v.min2).lower()},"
            f"{v.n_sub},{str(v.reg).lower()}" for v in IV.VARIANTS.values()]
    assert rows == want
    cmd = _build.build_command("intersect_variants.cu", {},
                               _build.BUILD_DIR / "x.so")
    assert "-fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in cmd


@pytest.mark.cuda
def test_kernels_bit_equal_to_plain_on_card(scenes):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    ps = PortScene.from_reference(scenes[0], "cuda")
    o, d = (torch.from_numpy(a).cuda() for a in random_rays(2, 3000))
    args = (ps.wu, ps.wv, ps.ww, *ARGS)
    for name in IV.VARIANTS:
        before = IV.nearest_hit_variant_cuda.launches[name]
        t1, i1 = IV.nearest_hit_variant(o, d, *args, variant=name)
        assert IV.nearest_hit_variant_cuda.launches[name] == before + 1
        t0, i0 = IV.nearest_hit_variant_torch(o, d, *args, variant=name)
        torch.cuda.synchronize()
        assert torch.equal(i0, i1) and torch.equal(t0, t1)
