"""Epilogue variants of the brute-force nearest hit: the CUDA kernels and
their plain torch version.

Port counterpart of the Pallas kernels in benchmarks/micro_variants.py
(kernel V1: base, recip, ieee, 2/4/8 tiles a step, running best in
registers) and benchmarks/epilogue_variants.py (kernel V2: the `t < t_max`
compare moved out of the pair test, min(u, v) for two compares). They
compute what ops/intersect.py computes without a cull mask, in the
reference's first formulation (t = -OW / DW, minimum of t), and exist to be
timed against each other (variant_bench.py).

* `nearest_hit_variant_cuda` launches csrc/intersect_variants.cu on CUDA
  tensors (and only on them) and counts its launches per variant in
  `nearest_hit_variant_cuda.launches`. The kernel runs csrc/intersect.cu's
  design (the division-free reject test before the variant's exact lines,
  rays blocked in registers, cp.async stages of `n_sub` x 32 triangles);
  the dispatch picks its rays a thread from `ray_block`
  (`rays_per_thread`), how many warp slices share a stage's tiles
  (`stage_split`), and passes the dynamic shared memory it needs
  (`dyn_smem_bytes`).
* `nearest_hit_variant_torch` is the same function in plain torch, in the
  kernel's operation order, so the two agree bit for bit. The CPU uses it.

The reference's `argmin` variant (another lowering of the same argmin) and
its `pf` / `cost` rounds (a scalar-prefetch grid and a cost estimate, knobs
of the Pallas call) have no counterpart in a CUDA kernel; its `rb` rounds
are the `ray_block` argument here.

Returns (t (C,) f32, tri (C,) i32); a miss gives (inf, -1).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from lightpycl_tpu_torch.ops import _build
from lightpycl_tpu_torch.ops.intersect import (REJECT_DELTA, _check,
                                              _thresholds)

_SOURCE = "intersect_variants.cu"
_INF = float("inf")
_DENOMS = {"guard": 0, "recip": 1, "ieee": 2}
# the guard's threshold as the float32 the kernel compares with
_TINY = float(np.float32(1e-30))
# the kernel's layout (csrc/intersect_variants.cu): triangles a tile, bytes
# of a Plücker record, warps a CTA at most
_TILE, _RECORD_BYTES, _MAX_WARPS = 32, 64, 32


class Variant(NamedTuple):
    denom: str          # 'guard' | 'recip' | 'ieee'
    notmax: bool = False
    min2: bool = False
    n_sub: int = 1      # triangle tiles a step
    reg: bool = False   # running best in registers over a step


# name -> variant, the reference scripts' own names: micro_variants.py's
# rounds 1 and 2, then epilogue_variants.py's four at its 16 tiles a step
# (its `base` is `tuned` here: two scripts, two bases)
VARIANTS = {
    "base": Variant("guard"),
    "recip": Variant("recip"),
    "ieee": Variant("ieee"),
    "2tile": Variant("guard", n_sub=2),
    "2t_ieee": Variant("ieee", n_sub=2),
    "4t_ieee": Variant("ieee", n_sub=4),
    "8t_ieee": Variant("ieee", n_sub=8),
    "4t_reg": Variant("ieee", n_sub=4, reg=True),
    "8t_reg": Variant("ieee", n_sub=8, reg=True),
    "tuned": Variant("ieee", n_sub=16),
    "notmax": Variant("ieee", notmax=True, n_sub=16),
    "min2": Variant("ieee", min2=True, n_sub=16),
    "min2_notmax": Variant("ieee", notmax=True, min2=True, n_sub=16),
}
MICRO_VARIANTS = ("base", "recip", "ieee", "2tile", "2t_ieee", "4t_ieee",
                  "8t_ieee", "4t_reg", "8t_reg")
EPILOGUE_VARIANTS = ("tuned", "notmax", "min2", "min2_notmax")


def rays_per_thread(ray_block: int) -> int:
    """The kernel's rays a thread at `ray_block` rays a CTA: 4 where it
    divides by 128, else 2 where it divides by 64, else 1."""
    return 4 if ray_block % 128 == 0 else 2 if ray_block % 64 == 0 else 1


def stage_split(ray_block: int, n_sub: int) -> int:
    """Warp slices that share each stage's `n_sub` tiles: 4 (at most one a
    tile) where the ray block is one warp of threads, so that an SM that
    holds few CTAs still holds four warps of each, else 1."""
    if ray_block // rays_per_thread(ray_block) != 32:
        return 1
    return min(4, n_sub)


def dyn_smem_bytes(n_sub: int, ray_block: int) -> int:
    """A CTA's dynamic shared memory: two record buffers of a stage of
    n_sub x 32 triangles, the warps' ray scales, the (t, tri) accumulator
    of its rays in each warp slice
    (csrc/intersect_variants.cu::variant_smem_bytes)."""
    return (2 * n_sub * _TILE * _RECORD_BYTES + _MAX_WARPS * 8
            + stage_split(ray_block, n_sub) * ray_block * 8)


def _check_ray_block(ray_block: int):
    if ray_block % 32 or not 32 <= ray_block <= 1024:
        raise ValueError(f"ray_block {ray_block}: a multiple of 32 in "
                         "[32, 1024]")


def load_kernel() -> ctypes.CDLL:
    """Build (once) and load the variants' kernel library."""
    lib = _build.load(_SOURCE)
    fn = lib.lpcl_nearest_hit_variant
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, i, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, f,
                   f, f, p, p, p]
    fn.restype = ctypes.c_int
    res = lib.lpcl_nearest_hit_variant_resources
    res.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 6
    res.restype = ctypes.c_int
    return lib


def kernel_resources(variant: str, ray_block: int) -> dict:
    """One instantiation's compiled resources at `ray_block` (on the
    card): registers, static and dynamic shared memory, local (spill)
    bytes, threads and resident CTAs an SM, with its rays a thread and
    warp slices. Raises on a CUDA error."""
    v = _variant(variant)
    _check_ray_block(ray_block)
    out = [ctypes.c_int() for _ in range(6)]
    err = load_kernel().lpcl_nearest_hit_variant_resources(
        _DENOMS[v.denom], int(v.notmax), int(v.min2), v.n_sub, int(v.reg),
        ray_block, rays_per_thread(ray_block),
        stage_split(ray_block, v.n_sub), *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"lpcl_nearest_hit_variant_resources({variant}) "
                           f"failed: cudaError {err}")
    keys = ("registers", "static_smem_bytes", "local_bytes", "threads",
            "dyn_smem_bytes", "ctas_per_sm")
    return dict(zip(keys, (x.value for x in out)),
                rays_per_thread=rays_per_thread(ray_block),
                split=stage_split(ray_block, v.n_sub))


def _variant(name: str) -> Variant:
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r} "
                         f"(expected one of {', '.join(VARIANTS)})")
    return VARIANTS[name]


def nearest_hit_variant_cuda(o, d, wu, wv, ww, eps, eps_b, t_max,
                             variant: str = "base", ray_block: int = 256):
    """Launch one variant's CUDA kernel. o, d (C, 3) f32; wu, wv, ww (T, 4)
    f32; all CUDA, contiguous. `ray_block` rays a CTA, a multiple of 32 up
    to 1024 (`rays_per_thread(ray_block)` of them a thread). Raises on
    anything else, and on any launch or shared-memory attribute error."""
    v = _variant(variant)
    if o.device.type != "cuda":
        raise ValueError(f"nearest_hit_variant_cuda needs CUDA tensors, got "
                         f"{o.device}")
    _check_ray_block(ray_block)
    dev = o.device
    C, T = o.shape[0], wu.shape[0]
    _check("o", o, torch.float32, (C, 3), dev)
    _check("d", d, torch.float32, (C, 3), dev)
    for name, w in (("wu", wu), ("wv", wv), ("ww", ww)):
        _check(name, w, torch.float32, (T, 4), dev)
        if w.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    t = torch.empty((C,), dtype=torch.float32, device=dev)
    tri = torch.empty((C,), dtype=torch.int32, device=dev)
    if C == 0:
        return t, tri
    if T == 0:
        return t.fill_(_INF), tri.fill_(-1)
    neg_eps, neg_eps_b, one_eps_b, t_max32 = _thresholds(eps, eps_b, t_max)
    lib = load_kernel()
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.lpcl_nearest_hit_variant(
            o.data_ptr(), d.data_ptr(), C, wu.data_ptr(), wv.data_ptr(),
            ww.data_ptr(), T, _DENOMS[v.denom], int(v.notmax), int(v.min2),
            v.n_sub, int(v.reg), ray_block, rays_per_thread(ray_block),
            stage_split(ray_block, v.n_sub),
            dyn_smem_bytes(v.n_sub, ray_block), -neg_eps, neg_eps_b,
            one_eps_b, t_max32, REJECT_DELTA, t.data_ptr(), tri.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lpcl_nearest_hit_variant({variant}) launch "
                           f"failed: cudaError {err}")
    nearest_hit_variant_cuda.launches[variant] += 1
    return t, tri


nearest_hit_variant_cuda.launches = collections.Counter()


def nearest_hit_variant_torch(o, d, wu, wv, ww, eps, eps_b, t_max,
                              variant: str = "base",
                              ray_block: int | None = None,
                              tri_chunk: int | None = None):
    """Plain torch version of one variant (same operations, same order).
    Tiles a step and the register variants only schedule the same
    arithmetic, so they share one plain version with their denominator and
    compares. Default chunks as ops/intersect.py::nearest_hit_torch;
    chunking never changes the result."""
    v = _variant(variant)
    neg_eps, neg_eps_b, one_eps_b, t_max32 = _thresholds(eps, eps_b, t_max)
    eps32 = -neg_eps
    C, T = o.shape[0], wu.shape[0]
    on_cuda = o.device.type == "cuda"
    ray_block = ray_block or (4096 if on_cuda else 512)
    tri_chunk = tri_chunk or (2048 if on_cuda else 256)
    best = torch.full((C,), _INF, dtype=torch.float32, device=o.device)
    best_i = torch.full((C,), -1, dtype=torch.int32, device=o.device)
    for r0 in range(0, C, ray_block):
        ob, db = o[r0:r0 + ray_block], d[r0:r0 + ray_block]
        ox, oy, oz = ob[:, 0:1], ob[:, 1:2], ob[:, 2:3]
        dx, dy, dz = db[:, 0:1], db[:, 1:2], db[:, 2:3]
        bt, bi = best[r0:r0 + ray_block], best_i[r0:r0 + ray_block]
        for k0 in range(0, T, tri_chunk):
            a, b, c = (w[k0:k0 + tri_chunk] for w in (wu, wv, ww))
            OU = ox * a[:, 0] + oy * a[:, 1] + oz * a[:, 2] + a[:, 3]
            DU = dx * a[:, 0] + dy * a[:, 1] + dz * a[:, 2]
            OV = ox * b[:, 0] + oy * b[:, 1] + oz * b[:, 2] + b[:, 3]
            DV = dx * b[:, 0] + dy * b[:, 1] + dz * b[:, 2]
            OW = ox * c[:, 0] + oy * c[:, 1] + oz * c[:, 2] + c[:, 3]
            DW = dx * c[:, 0] + dy * c[:, 1] + dz * c[:, 2]
            if v.denom == "ieee":
                t = -OW / DW
                hit = t > eps32
            else:
                ok = torch.abs(DW) > _TINY
                safe = torch.where(ok, DW, 1.0)
                t = (-OW * torch.reciprocal(safe) if v.denom == "recip"
                     else -OW / safe)
                hit = ok & (t > eps32)
            u = OU + t * DU
            w_ = OV + t * DV
            if not v.notmax:
                hit = hit & (t < t_max32)
            if v.min2:
                hit = hit & (torch.minimum(u, w_) >= neg_eps_b)
            else:
                hit = hit & (u >= neg_eps_b) & (w_ >= neg_eps_b)
            hit = hit & (u + w_ <= one_eps_b)
            tt = torch.where(hit, t, _INF)
            t_tile = tt.min(dim=1).values
            col = torch.arange(tt.shape[1], dtype=torch.int32,
                               device=o.device)
            # first (lowest) index among the chunk's minima
            i_tile = torch.where(tt == t_tile[:, None], col,
                                 torch.iinfo(torch.int32).max).min(dim=1)
            better = t_tile < bt
            bt.copy_(torch.where(better, t_tile, bt))
            bi.copy_(torch.where(better, i_tile.values + k0, bi))
    if v.notmax:  # the filter moved out of the pair test
        ok = best < t_max32
        best = torch.where(ok, best, _INF)
        best_i = torch.where(ok, best_i, -1)
    return best, best_i


def nearest_hit_variant(o, d, wu, wv, ww, eps, eps_b, t_max,
                        variant: str = "base", ray_block: int = 256):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.device.type == "cuda":
        return nearest_hit_variant_cuda(o, d, wu, wv, ww, eps, eps_b, t_max,
                                        variant=variant, ray_block=ray_block)
    return nearest_hit_variant_torch(o, d, wu, wv, ww, eps, eps_b, t_max,
                                     variant=variant)
