"""The epilogue variants' CUDA kernel (lightpycl_tpu_torch/csrc/
intersect_variants.cu) on the reject-test schedule, mirrored in plain torch.

The kernel runs csrc/intersect.cu's division-free reject test on every
(ray, triangle) pair and each variant's own exact lines only on the pairs
the test keeps. Two things make it bit-equal to the variant's plain
version (ops/intersect_variants.py::nearest_hit_variant_torch):

* the test never skips a pair that the variant's exact lines accept as a
  hit: `variant_pairs` repeats each variant's exact lines (guard, recip,
  ieee, min2, notmax) op for op, with the kernel's fminf, and
  test_torch_intersect_reject.py's `fused_skip` the test itself (fmaf
  emulated in float64), with the margin of CTAs of 32 rays, the narrowest
  any `ray_block` gives; on random rays and on every kind of edge_rays.py
  over a sphere, a Morton-sorted bowl and two coincident meshes (built by
  the JAX package and copied bit for bit);
* the schedule keeps the nearest hit: `mirrored_kernel` walks the kernel's
  stages of n_sub x 32 triangles, its warps of rays (rays_per_thread a
  thread) and their votes, the warp slices that share a stage's tiles
  (stage_split), the per-tile or per-stage merges into each slice's
  accumulator, the reduction over the slices and the `notmax` filter, and
  must equal the plain version bit for bit for all 13 variants at 32, 64,
  128 and 256 rays a block.
"""

import functools
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from edge_rays import EDGE_RAY_KINDS, edge_rays
from lightpycl_tpu_torch.ops import _build
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.ops import intersect_variants as IV
from lightpycl_tpu_torch.tracer.scene import Scene as PortScene
from test_torch_intersect_reject import (EPS, EPS_B, SCENES, T_MAX,
                                         fused_skip)

torch.set_num_threads(1)
ARGS = (EPS, EPS_B, T_MAX)
# each kind of exact lines, by the variant that has it
EXACT_KINDS = {"guard": "base", "recip": "recip", "ieee": "ieee",
               "min2": "min2", "notmax": "notmax"}
NARROWEST_BLOCK = 32  # the fewest rays a CTA: the tightest margin
TILE, TV = 32, 2      # the kernel's kTile and kTV


@functools.cache
def scene(name):
    return SCENES[name]()[1]


def variant_pairs(o, d, wu, wv, ww, name, eps_b=EPS_B):
    """(C, T) t and hit of the variant's exact lines as the kernel runs them
    on a kept pair (its operations in its order; fminf drops a NaN)."""
    v = IV.VARIANTS[name]
    neg_eps, neg_eps_b, one_eps_b, t_max32 = PI._thresholds(EPS, eps_b, T_MAX)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    a, b, c = wu, wv, ww
    OU = ox * a[:, 0] + oy * a[:, 1] + oz * a[:, 2] + a[:, 3]
    DU = dx * a[:, 0] + dy * a[:, 1] + dz * a[:, 2]
    OV = ox * b[:, 0] + oy * b[:, 1] + oz * b[:, 2] + b[:, 3]
    DV = dx * b[:, 0] + dy * b[:, 1] + dz * b[:, 2]
    OW = ox * c[:, 0] + oy * c[:, 1] + oz * c[:, 2] + c[:, 3]
    DW = dx * c[:, 0] + dy * c[:, 1] + dz * c[:, 2]
    if v.denom == "ieee":
        t = -OW / DW
        hit = torch.ones_like(t, dtype=torch.bool)
    else:
        hit = DW.abs() > IV._TINY
        safe = torch.where(hit, DW, 1.0)
        t = (-OW * torch.reciprocal(safe) if v.denom == "recip"
             else -OW / safe)
    u = OU + t * DU
    w_ = OV + t * DV
    hit = hit & (t > -neg_eps)
    if not v.notmax:
        hit = hit & (t < t_max32)
    if v.min2:
        hit = hit & (torch.fmin(u, w_) >= neg_eps_b)
    else:
        hit = hit & (u >= neg_eps_b) & (w_ >= neg_eps_b)
    hit = hit & (u + w_ <= one_eps_b)
    return t, hit


def assert_no_hit_skipped(ps, o, d, name, eps_b=EPS_B, **kw):
    _, hit = variant_pairs(o, d, ps.wu, ps.wv, ps.ww, name, eps_b)
    skip = fused_skip(o, d, ps.wu, ps.wv, ps.ww, eps_b=eps_b,
                      ray_block=kw.pop("ray_block", NARROWEST_BLOCK), **kw)
    lost = hit & skip
    assert not bool(lost.any()), f"{int(lost.sum())} {name} hits skipped"
    return hit, skip


def warp_votes(keep, ray_block):
    """(steps,) share of the kernel's warp steps whose vote goes exact:
    ray r of a CTA belongs to thread r % threads, warp thread // 32, and a
    step tests kTV triangles."""
    C, T = keep.shape
    threads = ray_block // IV.rays_per_thread(ray_block)
    pad_r, pad_t = -C % ray_block, -T % TV
    k = torch.nn.functional.pad(keep, (0, pad_t, 0, pad_r))
    ctas = k.shape[0] // ray_block
    # (cta, rpt, warps, lanes, steps, kTV)
    k = k.reshape(ctas, ray_block // threads, threads // 32, 32, -1, TV)
    return k.any(dim=5).any(dim=3).any(dim=1)


def mirrored_kernel(o, d, wu, wv, ww, name, ray_block):
    """Nearest hit as csrc/intersect_variants.cu forms it at `ray_block`
    rays a CTA: the test decides which pairs run the exact lines; slice w
    of the CTA's stage_split(ray_block, n_sub) warp slices walks tiles w,
    w + split, ... of each stage of n_sub x 32 triangles; each ray keeps the
    strict minimum of t since the last merge, in ascending triangle order; a
    merge into the slice's accumulator (strict) after every 32-triangle
    tile, or with `reg` once a stage; then the smallest t over the slices,
    the lowest index on a tie; `notmax` filters once at the end. Returns
    (t, tri, share of the pairs with a real triangle and share of the warp
    steps that run the exact lines)."""
    v = IV.VARIANTS[name]
    C, T = o.shape[0], wu.shape[0]
    split = IV.stage_split(ray_block, v.n_sub)
    skip = fused_skip(o, d, wu, wv, ww, ray_block=ray_block)
    t, hit = variant_pairs(o, d, wu, wv, ww, name)
    hit = hit & ~skip
    inf = torch.full((C,), float("inf"))
    none = torch.full((C,), -1, dtype=torch.int32)
    out_t, out_i = inf.clone(), none.clone()
    stage = v.n_sub * TILE
    for w in range(split):
        acc_t, acc_i = inf.clone(), none.clone()
        best, best_i = inf.clone(), none.clone()

        def merge():
            nonlocal best, acc_t, acc_i
            better = best < acc_t
            acc_t = torch.where(better, best, acc_t)
            acc_i = torch.where(better, best_i, acc_i)
            best = inf.clone()

        for base in range(0, T, stage):
            end = min(base + stage, T)
            for t0 in range(base + w * TILE, end, split * TILE):
                for k in range(t0, min(t0 + TILE, end)):
                    better = hit[:, k] & (t[:, k] < best)
                    best = torch.where(better, t[:, k], best)
                    best_i = torch.where(
                        better, torch.tensor(k, dtype=torch.int32), best_i)
                if not v.reg:
                    merge()
            if v.reg:
                merge()
        take = (acc_t < out_t) | ((acc_t == out_t) & (acc_i < out_i))
        out_t = torch.where(take, acc_t, out_t)
        out_i = torch.where(take, acc_i, out_i)
    acc_t, acc_i = out_t, out_i
    if v.notmax:
        ok = acc_t < np.float32(T_MAX)
        acc_t = torch.where(ok, acc_t, float("inf"))
        acc_i = torch.where(ok, acc_i, -1)
    real = (ww != 0).any(dim=1)  # padding rows are never skipped
    pair_share = float((~skip[:, real]).float().mean())
    warp_share = float(warp_votes(~skip, ray_block).float().mean())
    return acc_t, acc_i, pair_share, warp_share


@functools.cache
def mixed_rays(name, n=600):
    """Edge rays of every kind, then random rays through the scene."""
    ps = scene(name)
    eo, ed = edge_rays(ps, n, seed=21)
    rng = np.random.default_rng(22)
    span = float(ps.v0.abs().max())
    ro = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return (torch.cat([eo, torch.from_numpy(ro)]),
            torch.cat([ed, torch.from_numpy(rd)]))


@pytest.mark.parametrize("kind", EDGE_RAY_KINDS)
@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("exact", sorted(EXACT_KINDS))
def test_edge_rays_never_skip_a_variant_hit(exact, scene_name, kind):
    ps = scene(scene_name)
    o, d = edge_rays(ps, 5 * 300, seed=11)
    sel = torch.from_numpy(np.arange(5 * 300) % 5
                           == EDGE_RAY_KINDS.index(kind))
    hit, skip = assert_no_hit_skipped(ps, o[sel], d[sel], EXACT_KINDS[exact])
    # not vacuous: the rays do hit, and the test skips most pairs
    assert bool(hit.any())
    assert float(skip.float().mean()) > 0.5


@pytest.mark.parametrize("exact", sorted(EXACT_KINDS))
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       span=st.sampled_from([0.5, 3.0, 40.0]),
       scene_name=st.sampled_from(sorted(SCENES)),
       eps_b=st.sampled_from([EPS_B, 0.0, -1e-4, 0.25, 3.0]))
def test_random_rays_never_skip_a_variant_hit(exact, seed, span, scene_name,
                                              eps_b):
    ps = scene(scene_name)
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-span, span, (64, 3)).astype(np.float32))
    dn = rng.normal(size=(64, 3))
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    d = torch.from_numpy(dn.astype(np.float32))
    assert_no_hit_skipped(ps, o, d, EXACT_KINDS[exact], eps_b)


def test_recip_hits_fit_the_amended_bound():
    # recip rounds twice, so its worst gap grows from 43u to 45u (u =
    # 2^-24): with no eps_b slack, a margin of 64u (a quarter of
    # REJECT_DELTA's 256u) still keeps every recip hit on rays aimed at
    # vertices and edges, and no margin at all loses some
    ps = scene("sphere")
    o, d = edge_rays(ps, 3000, seed=5)
    assert_no_hit_skipped(ps, o, d, "recip", eps_b=0.0, delta=2.0 ** -18)
    _, hit = variant_pairs(o, d, ps.wu, ps.wv, ps.ww, "recip", eps_b=0.0)
    lost = hit & fused_skip(o, d, ps.wu, ps.wv, ps.ww, eps_b=0.0, delta=0.0,
                            ray_block=NARROWEST_BLOCK)
    assert bool(lost.any())


def test_min2_fminf_drops_nan_but_the_sum_rejects():
    # the kernel's fminf(u, v) returns v when u is NaN (torch.minimum, in
    # the plain version, returns NaN); u + v is NaN then, so both reject
    u = torch.tensor([float("nan"), 0.2, float("nan")])
    v = torch.tensor([0.3, float("nan"), float("nan")])
    assert torch.equal(torch.fmin(u, v) >= 0, torch.tensor([True, True,
                                                            False]))
    assert not bool((u + v <= 1.0).any())


@pytest.mark.parametrize("ray_block", [32, 64, 128, 256])
@pytest.mark.parametrize("name", list(IV.VARIANTS))
def test_mirrored_schedule_equals_plain(name, ray_block):
    for scene_name in sorted(SCENES):
        ps = scene(scene_name)
        o, d = mixed_rays(scene_name)
        args = (ps.wu, ps.wv, ps.ww)
        t_k, i_k, pairs, steps = mirrored_kernel(o, d, *args, name,
                                                 ray_block)
        t_p, i_p = IV.nearest_hit_variant_torch(o, d, *args, *ARGS,
                                                variant=name)
        assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p), scene_name
        assert int((i_p >= 0).sum()) > 100
        # the test keeps few pairs; on these small meshes (a few hundred
        # triangles) a warp step of 32 x rays-a-thread x 2 pairs still
        # often holds one, so the vote goes exact on some steps, not all
        assert 0.0 < pairs < 0.05 and pairs < steps < 1.0


def test_schedule_shapes():
    # rays a thread divide the block into whole warps; every stage fits
    # the card's 232,448 B of shared memory a CTA
    for rb in range(32, 1025, 32):
        rpt = IV.rays_per_thread(rb)
        assert rpt in (1, 2, 4) and rb % (32 * rpt) == 0
        assert rpt == max(r for r in (1, 2, 4) if rb % (32 * r) == 0)
        for v in IV.VARIANTS.values():
            assert IV.dyn_smem_bytes(v.n_sub, rb) <= 232_448
        # a one-warp ray block is held by four warp slices, within the
        # kernel's 1024 / rays-a-thread threads
        for n_sub in (1, 2, 4, 8, 16):
            split = IV.stage_split(rb, n_sub)
            assert split == (min(4, n_sub) if rb // rpt == 32 else 1)
            assert rb // rpt * split <= 1024 // rpt
    # NSUB 16 at 64 rays: 2 x 512 records of 64 B, 32 warp scales, the
    # accumulator of 4 slices; above the 48 KB static limit, so dynamic
    assert IV.dyn_smem_bytes(16, 64) == 2 * 512 * 64 + 32 * 8 + 4 * 64 * 8
    assert IV.dyn_smem_bytes(16, 64) > 48 * 1024
    assert IV.dyn_smem_bytes(8, 256) == 2 * 256 * 64 + 32 * 8 + 256 * 8
    assert (IV.rays_per_thread(256), IV.rays_per_thread(64),
            IV.rays_per_thread(32)) == (4, 2, 1)
    assert [IV.stage_split(rb, 16) for rb in (32, 64, 96, 128, 256)] == [
        4, 4, 1, 4, 1]
    assert [IV.stage_split(64, n) for n in (1, 2, 4, 8)] == [1, 2, 4, 4]


def test_every_variant_is_instantiated_at_each_rays_per_thread():
    # LPCL_VARIANT expands to one instantiation for each rays-a-thread
    # value that rays_per_thread gives, and the C layout's constants are
    # the wrapper's
    src = (_build.CSRC_DIR / "intersect_variants.cu").read_text()
    macro = src.split("#define LPCL_VARIANT(", 1)[1].split("\n\n", 1)[0]
    rpts = {int(r) for r in re.findall(
        r"LPCL_VARIANT_RPT\(D, NM, M2, NS, RG, (\d+)\)", macro)}
    assert rpts == {IV.rays_per_thread(rb) for rb in range(32, 1025, 32)}
    assert "constexpr int kTile = 32;" in src
    assert "constexpr int kTV = 2;" in src
    assert "constexpr int kMaxWarps = 32;" in src
    assert (IV._TILE, IV._MAX_WARPS, TILE, TV) == (32, 32, 32, 2)
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


def test_changed_header_changes_library_path(tmp_path, monkeypatch):
    # an edited csrc/*.cuh must not load a library built from the old one
    for f in _build.CSRC_DIR.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {s: _build.library_path(s, {})
              for s in ("intersect.cu", "intersect_variants.cu")}
    hdr = tmp_path / "nearest_hit_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    for s, path in before.items():
        assert _build.library_path(s, {}) != path
    hdr.write_text(hdr.read_text()[:-len("\n// edited\n")])
    assert {s: _build.library_path(s, {}) for s in before} == before


def test_resources_refuse_bad_blocks_before_any_build():
    for rb in (0, 16, 48, 1056):
        with pytest.raises(ValueError, match="ray_block"):
            IV.kernel_resources("base", rb)


@pytest.mark.cuda
@pytest.mark.parametrize("ray_block", [32, 64, 96, 256])
def test_kernels_on_edge_rays_bit_equal_on_card(ray_block):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    for scene_name in sorted(SCENES):
        rs, _ = SCENES[scene_name]()
        ps = PortScene.from_reference(rs, "cuda")
        o, d = edge_rays(ps, 4096, seed=7)
        args = (ps.wu, ps.wv, ps.ww, *ARGS)
        for name in IV.VARIANTS:
            t1, i1 = IV.nearest_hit_variant_cuda(o, d, *args, variant=name,
                                                 ray_block=ray_block)
            t0, i0 = IV.nearest_hit_variant_torch(o, d, *args, variant=name)
            torch.cuda.synchronize()
            assert torch.equal(i0, i1) and torch.equal(t0, t1), name
