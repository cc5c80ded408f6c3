"""Ray x triangle nearest hit: the CUDA kernel, its plain torch version, and
the cull mask.

Port counterpart of lightpycl_tpu/ops/intersect_pallas.py (kernel B1 in
brute mode, B2 in cull mode) and of the `intersect_jnp` / `intersect`
dispatch in lightpycl_tpu/tracer/step.py.

* `nearest_hit_cuda` launches csrc/intersect.cu on CUDA tensors (and only
  on them) and counts its launches in `nearest_hit_cuda.launches`, those
  with a cull mask also in `nearest_hit_cuda.cull_launches`.
* `nearest_hit_torch` is the same function in plain torch, tiled (ray block
  x triangle chunk) with broadcast elementwise ops in the kernel's exact
  operation order, so the two agree bit for bit. The CPU uses it, and so
  does TraceConfig(backend="torch") on the card.
* `cull_mask` / `pack_aabbs` are the reference's conservative (ray block x
  triangle tile) reachability mask in torch, at the kernel's own block
  shape (RAY_BLOCK rays, TRI_TILE triangles). Unlike the TPU kernel, the
  mask lives in device memory, so it needs no ray chunking. `cull_frame`
  holds a scene's boxes for all the culled launches of a trace.

Returns (t (C,) f32, tri (C,) i32); a miss gives (inf, -1).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from typing import NamedTuple

from lightpycl_tpu_torch.ops import _build
from lightpycl_tpu_torch.utils.profiling import count, enabled, span

# CUDA block shape, compiled into the kernel: rays per CTA and triangles
# per cull tile. The cull mask is laid out for exactly this shape.
RAY_BLOCK = 256
TRI_TILE = 256
# Triangles a cp.async pipeline stage holds: csrc/intersect.cu's `kChunk`
# (a constexpr there; tests/test_torch_bench.py pins the two together).
TRI_CHUNK = 64

# Relative margin of the kernel's division-free reject test (2^-16 = 256
# units of f32 roundoff): a pair is skipped only when its fused barycentric
# values fail by more than REJECT_DELTA times the bound on their terms'
# magnitudes. Derived in csrc/intersect.cu's header (the worst gap between
# the fused and the exact evaluation is 43 units); tests/
# test_torch_intersect_reject.py holds a plain mirror of the test to the
# same number.
REJECT_DELTA = 2.0 ** -16

_SOURCE = "intersect.cu"
_DEFINES = (("LPCL_RAY_BLOCK", RAY_BLOCK), ("LPCL_TRI_TILE", TRI_TILE))

_INF = float("inf")


def _mask_words(n_tris: int) -> int:
    """32-bit mask words per ray block: one bit per triangle tile."""
    return -(-(-(-n_tris // TRI_TILE)) // 32)


def _thresholds(eps, eps_b, t_max):
    """The kernel's float32 constants: -eps, -eps_b, 1 + eps_b (summed in
    double, then rounded, as the reference kernel's static literal) and
    t_max, as Python floats exactly representable in float32."""
    return (float(-np.float32(eps)), float(-np.float32(eps_b)),
            float(np.float32(1.0 + float(eps_b))), float(np.float32(t_max)))


def load_kernel() -> ctypes.CDLL:
    """Build (once) and load the nearest-hit kernel library."""
    lib = _build.load(_SOURCE, _DEFINES)
    fn = lib.lpcl_nearest_hit
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, i, p, p, p, i, p, i, i, i, f, f, f, f, f, p, p, p]
    fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def nearest_hit_cuda(o, d, wu, wv, ww, eps, eps_b, t_max, mask=None):
    """Launch the CUDA kernel. o, d (C, 3) f32; wu, wv, ww (T, 4) f32;
    optional mask (n_blocks * n_words,) i32 from `cull_mask`. All CUDA,
    contiguous. Raises on anything else."""
    if o.device.type != "cuda":
        raise ValueError(f"nearest_hit_cuda needs CUDA tensors, got "
                         f"{o.device}")
    dev = o.device
    C, T = o.shape[0], wu.shape[0]
    _check("o", o, torch.float32, (C, 3), dev)
    _check("d", d, torch.float32, (C, 3), dev)
    for name, w in (("wu", wu), ("wv", wv), ("ww", ww)):
        _check(name, w, torch.float32, (T, 4), dev)
        if w.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    n_blocks = -(-C // RAY_BLOCK)
    n_words = _mask_words(T)
    if mask is not None:
        _check("mask", mask, torch.int32, (n_blocks * n_words,), dev)
    t = torch.empty((C,), dtype=torch.float32, device=dev)
    tri = torch.empty((C,), dtype=torch.int32, device=dev)
    if C == 0:
        return t, tri
    if T == 0:
        return t.fill_(_INF), tri.fill_(-1)
    neg_eps, neg_eps_b, one_eps_b, t_max32 = _thresholds(eps, eps_b, t_max)
    lib = load_kernel()
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.lpcl_nearest_hit(
            o.data_ptr(), d.data_ptr(), C, wu.data_ptr(), wv.data_ptr(),
            ww.data_ptr(), T, None if mask is None else mask.data_ptr(),
            n_words, RAY_BLOCK, TRI_TILE, neg_eps, neg_eps_b, one_eps_b,
            t_max32, REJECT_DELTA, t.data_ptr(), tri.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lpcl_nearest_hit launch failed: cudaError {err}")
    nearest_hit_cuda.launches += 1
    if mask is not None:
        nearest_hit_cuda.cull_launches += 1
    return t, tri


nearest_hit_cuda.launches = 0
nearest_hit_cuda.cull_launches = 0


def nearest_hit_torch(o, d, wu, wv, ww, eps, eps_b, t_max, mask=None,
                      ray_block: int | None = None,
                      tri_chunk: int | None = None):
    """Plain torch version of the kernel (same operations, same order).
    Default chunks: (4096 rays x 2048 triangles) on CUDA, cache-sized
    (512 x 256) on the CPU; chunking never changes the result. With a cull
    mask the blocks and chunks are the kernel's own (RAY_BLOCK, TRI_TILE)
    and masked pairs are skipped."""
    neg_eps, neg_eps_b, one_eps_b, t_max32 = _thresholds(eps, eps_b, t_max)
    C, T = o.shape[0], wu.shape[0]
    on_cuda = o.device.type == "cuda"
    ray_block = ray_block or (4096 if on_cuda else 512)
    tri_chunk = tri_chunk or (2048 if on_cuda else 256)
    if mask is not None:
        ray_block, tri_chunk = RAY_BLOCK, TRI_TILE
        mask = mask.cpu().numpy().view(np.uint32).reshape(-1, _mask_words(T))
    best = torch.full((C,), -_INF, dtype=torch.float32, device=o.device)
    best_i = torch.full((C,), -1, dtype=torch.int32, device=o.device)
    # contiguous columns (ray components, triangle rows): the same
    # operations on the same values, without strided reads
    oc, dc = o.t().contiguous()[:, :, None], d.t().contiguous()[:, :, None]
    wt = [w.t().contiguous() for w in (wu, wv, ww)]
    for r0 in range(0, C, ray_block):
        ox, oy, oz = oc[:, r0:r0 + ray_block]
        dx, dy, dz = dc[:, r0:r0 + ray_block]
        bq, bi = best[r0:r0 + ray_block], best_i[r0:r0 + ray_block]
        for k0 in range(0, T, tri_chunk):
            if mask is not None:
                j = k0 // TRI_TILE
                if not (mask[r0 // RAY_BLOCK, j // 32] >> (j % 32)) & 1:
                    continue
            a, b, c = (w[:, k0:k0 + tri_chunk] for w in wt)
            OU = ox * a[0] + oy * a[1] + oz * a[2] + a[3]
            OV = ox * b[0] + oy * b[1] + oz * b[2] + b[3]
            OW = ox * c[0] + oy * c[1] + oz * c[2] + c[3]
            DU = dx * a[0] + dy * a[1] + dz * a[2]
            DV = dx * b[0] + dy * b[1] + dz * b[2]
            DW = dx * c[0] + dy * c[1] + dz * c[2]
            q = OW / DW
            u = OU - q * DU
            v = OV - q * DV
            hit = ((q < neg_eps) & (u >= neg_eps_b) & (v >= neg_eps_b)
                   & (u + v <= one_eps_b))
            qq = torch.where(hit, q, -_INF)
            q_tile = qq.max(dim=1).values
            col = torch.arange(qq.shape[1], dtype=torch.int32,
                               device=o.device)
            # first (lowest) index among the tile's maxima
            i_tile = torch.where(qq == q_tile[:, None], col,
                                 torch.iinfo(torch.int32).max).min(dim=1)
            better = q_tile > bq
            bq.copy_(torch.where(better, q_tile, bq))
            bi.copy_(torch.where(better, i_tile.values + k0, bi))
    t = -best
    valid = torch.isfinite(t) & (t < t_max32)
    return torch.where(valid, t, _INF), torch.where(valid, best_i, -1)


def nearest_hit(o, d, wu, wv, ww, eps, eps_b, t_max, mask=None,
                backend: str = "auto", ray_block: int | None = None):
    """Dispatch: 'cuda' -> the kernel (raises off CUDA), 'torch' -> the
    plain version, 'auto' -> the kernel for CUDA tensors and the plain
    version for CPU tensors. `ray_block`: the plain version's ray block
    (its default when None; the result does not depend on it); the kernel
    keeps its own."""
    if backend == "auto":
        backend = "cuda" if o.device.type == "cuda" else "torch"
    if backend == "cuda":
        return nearest_hit_cuda(o, d, wu, wv, ww, eps, eps_b, t_max,
                                mask=mask)
    if backend == "torch":
        return nearest_hit_torch(o, d, wu, wv, ww, eps, eps_b, t_max,
                                 mask=mask, ray_block=ray_block)
    raise ValueError(f"unknown intersect backend {backend!r} "
                     "(expected 'auto', 'cuda' or 'torch')")


# --------------------------------------------------------------------------
# Cull mask (reference: intersect_pallas.py::_cull_mask, pack_aabbs)
# --------------------------------------------------------------------------

_BIG = 3.4e38


def _valid_rows(scene):
    """(T, 1) bool, False on padding / degenerate (all-zero plane) rows."""
    return torch.any(scene.ww != 0.0, dim=1)[:, None]


def pack_aabbs(scene, tri_tile: int = TRI_TILE):
    """Per-tile AABBs (n_tt, 3) lo/hi. Degenerate/padding triangles
    (all-zero plane row) contribute an empty box."""
    Tp = scene.wu.shape[0]
    K = tri_tile
    Tt = -(-Tp // K) * K
    valid = _valid_rows(scene)
    v0, e1, e2 = scene.v0, scene.e1, scene.e2
    tri_lo = torch.minimum(v0, torch.minimum(v0 + e1, v0 + e2))
    tri_hi = torch.maximum(v0, torch.maximum(v0 + e1, v0 + e2))
    tri_lo = torch.where(valid, tri_lo, _BIG)
    tri_hi = torch.where(valid, tri_hi, -_BIG)

    def _tile(a, fill):
        if Tt != Tp:
            a = torch.cat([a, torch.full((Tt - Tp, 3), fill,
                                         dtype=torch.float32,
                                         device=a.device)])
        return a.reshape(Tt // K, K, 3)

    return _tile(tri_lo, _BIG).amin(dim=1), _tile(tri_hi, -_BIG).amax(dim=1)


def cull_mask(o, d, aabb_lo, aabb_hi, R, t_max, alive=None):
    """(n_rb, n_tt) int32 conservative reachability of triangle-tile AABBs
    from ray blocks of R rays (o, d: (Cp, >= 3), Cp a multiple of R). Never
    false-culls: the axis-interval test, the direction-cone test and the
    any-alive test each keep every truly reachable tile. While a profiler
    records, counts the ray blocks that hold a live ray
    (`intersect.blocks_live`) and those among them whose rays, dead and
    padding ones too, point both ways along some axis, where the axis test
    bounds that axis on neither side (`intersect.blocks_mixed`)."""
    n_rb = o.shape[0] // R
    dev = o.device
    o_b = o[:, :3].reshape(n_rb, R, 3)
    d_b = d[:, :3].reshape(n_rb, R, 3)
    if alive is None:
        alive_b = torch.ones((n_rb, R), dtype=torch.bool, device=dev)
    else:
        pad = o.shape[0] - alive.shape[0]
        if pad:
            alive = torch.cat([alive, torch.zeros((pad,), dtype=torch.bool,
                                                  device=dev)])
        alive_b = alive.reshape(n_rb, R)
    any_alive = alive_b.any(dim=1)

    o_lo, o_hi = o_b.amin(dim=1), o_b.amax(dim=1)
    d_lo, d_hi = d_b.amin(dim=1), d_b.amax(dim=1)
    if enabled():
        count("intersect.blocks_live", any_alive.sum())
        count("intersect.blocks_mixed",
              (((d_lo < 0.0) & (d_hi > 0.0)).any(dim=1) & any_alive).sum())
    tiny = 1e-12
    pos = d_lo > tiny
    neg = d_hi < -tiny
    par = (torch.abs(d_lo) <= tiny) & (torch.abs(d_hi) <= tiny)
    reach_lo = torch.where(pos | par, o_lo, -_BIG)
    reach_hi = torch.where(neg | par, o_hi, _BIG)
    reach_lo = torch.maximum(reach_lo, o_lo - t_max)
    reach_hi = torch.minimum(reach_hi, o_hi + t_max)
    miss_axis = ((aabb_lo[None, :, :] > reach_hi[:, None, :])
                 | (aabb_hi[None, :, :] < reach_lo[:, None, :])).any(dim=2)

    # cone test (live rays only; dead rays would blow up the cone)
    af = alive_b.to(torch.float32)[:, :, None]
    m = torch.sum(d_b * af, dim=1)
    m_len = torch.sqrt(torch.sum(m * m, dim=1, keepdim=True))
    m = m / torch.clamp_min(m_len, 1e-20)
    cosm = torch.sum(d_b * m[:, None, :], dim=2)
    cos_bundle = torch.where(alive_b, cosm, 1.0).amin(dim=1)
    cos_bundle = torch.clamp(cos_bundle, -1.0, 1.0)
    sin_bundle = torch.sqrt(1.0 - cos_bundle ** 2)
    full_cone = (cos_bundle <= 0.0) | (m_len[:, 0] < 1e-12)

    o_c = 0.5 * (o_lo + o_hi)
    o_r = 0.5 * torch.sqrt(torch.sum((o_hi - o_lo) ** 2, dim=1))
    t_c = 0.5 * (aabb_lo + aabb_hi)
    t_r = 0.5 * torch.sqrt(torch.sum((aabb_hi - aabb_lo) ** 2, dim=1))
    v = t_c[None, :, :] - o_c[:, None, :]
    dist = torch.sqrt(torch.sum(v * v, dim=2))
    rad = t_r[None, :] + o_r[:, None]
    overlap = dist <= rad
    s_beta = torch.clamp(rad / torch.clamp_min(dist, 1e-20), 0.0, 1.0)
    c_beta = torch.sqrt(1.0 - s_beta ** 2)
    cos_needed = cos_bundle[:, None] * c_beta - sin_bundle[:, None] * s_beta
    cos_actual = (torch.sum(v * m[:, None, :], dim=2)
                  / torch.clamp_min(dist, 1e-20))
    miss_cone = overlap.logical_not() & (cos_actual < cos_needed) \
        & full_cone.logical_not()[:, None]
    miss_cone = miss_cone | ((dist - rad) > t_max)

    reach = (miss_axis | miss_cone).logical_not() & any_alive[:, None]
    return reach.to(torch.int32)


def pack_mask_bits(m: torch.Tensor) -> torch.Tensor:
    """(n_rb, n_tt) 0/1 -> flat (n_rb * n_words,) int32 words, bit
    (tile % 32) of word (block * n_words + tile // 32)."""
    n_rb, n_tt = m.shape
    n_words = -(-n_tt // 32)
    m = torch.nn.functional.pad(m, (0, n_words * 32 - n_tt))
    weights = torch.ones(32, dtype=torch.int64, device=m.device) << \
        torch.arange(32, dtype=torch.int64, device=m.device)
    words = torch.sum(m.reshape(n_rb, n_words, 32).to(torch.int64) * weights,
                      dim=2)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.reshape(-1).to(torch.int32)


class CullFrame(NamedTuple):
    """A scene's constants for its culled launches: the box of the valid
    triangles' v0 (the ray order's frame) and `pack_aabbs`' tile boxes."""

    lo: torch.Tensor
    hi: torch.Tensor
    tile_lo: torch.Tensor
    tile_hi: torch.Tensor


def cull_frame(scene) -> CullFrame:
    """The scene's CullFrame (padding rows would stretch the box to the
    origin, so they stay out)."""
    valid = _valid_rows(scene)
    lo = torch.where(valid, scene.v0, _BIG).amin(dim=0)
    hi = torch.where(valid, scene.v0, -_BIG).amax(dim=0)
    return CullFrame(lo, hi, *pack_aabbs(scene, TRI_TILE))


# --------------------------------------------------------------------------
# Scene-level entry (reference: step.intersect / intersect_pallas)
# --------------------------------------------------------------------------

def block_tile_mask(frame: CullFrame, o, d, t_max, alive=None):
    """The bit-packed cull mask of rays (o, d) over the frame's tiles at the
    kernel's block shape (ray padding as in the reference: dead rays at
    the origin pointing along (1, 1, 1)). While a profiler records, counts
    the (ray block, triangle tile) pairs it keeps (`intersect.tiles_kept`)
    of all of them (`intersect.tiles`); `cull_mask` counts the ray blocks."""
    C = o.shape[0]
    pad = -C % RAY_BLOCK
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype,
                                      device=o.device)])
        d = torch.cat([d, torch.ones((pad, 3), dtype=d.dtype,
                                     device=d.device)])
    reach = cull_mask(o, d, frame.tile_lo, frame.tile_hi, RAY_BLOCK,
                      float(t_max), alive=alive)
    if enabled():
        count("intersect.tiles_kept", reach.sum())
        count("intersect.tiles", reach.numel())
    return pack_mask_bits(reach)


def intersect(scene, o, d, cfg, alive=None, frame: CullFrame | None = None):
    """Nearest hit of rays (o, d) over the scene with cfg's eps, eps_bary,
    max_ray_len and backend; with cfg.cull the conservative mask over
    `frame`'s tiles (built here when None) skips unreachable (ray block,
    triangle tile) pairs (identical results)."""
    mask = None
    if cfg.cull:
        with span("step.cull_mask"):
            if frame is None:
                frame = cull_frame(scene)
            mask = block_tile_mask(frame, o, d, cfg.max_ray_len, alive=alive)
    o, d = o.contiguous(), d.contiguous()
    if intersect.observer is not None:
        intersect.observer(scene, o, d, cfg, alive, mask)
    with span("step.nearest_hit"):
        return nearest_hit(o, d, scene.wu, scene.wv, scene.ww, cfg.eps,
                           cfg.eps_bary, cfg.max_ray_len, mask=mask,
                           backend=cfg.backend)


# A measuring script's tap on what a trace really gives the kernel: when
# set, called before every nearest hit of a trace with (scene, o, d, cfg,
# alive, mask), the rays as launched and the cull mask (None when cfg.cull
# is off). None in normal use.
intersect.observer = None

