"""The detector maps' weighted bincount: the CUDA kernel and its plain torch
version.

Not the port of a Pallas kernel: the reference sums each detector map
with an XLA scatter-add (lightpycl_tpu/tracer/step.py:1478). The port
fixes the association, so that the same inputs give the same bits on the
CPU and the card: a stable sort by bin, then a segmented Hillis-Steele
scan whose every run adds the same numbers in the same order, with no
atomics. (PyTorch's deterministic index_put_ accumulates each bin serially
in one warp: 23 ms for 524,288 rays into one detector bin on an H100.)

* `bincount_sorted_torch` is the plain version: the scan, log2(n)
  elementwise passes, then one write a bin. The CPU uses it.
* `bincount_sorted_cuda` sorts on the card, then launches
  csrc/bincount.cu (CUDA tensors only), which computes the scan's closed
  form (see the source's header) with no host read and three launches, bit
  for bit the plain version. It counts its calls in
  `bincount_sorted_cuda.launches`.
* `bincount_sorted` dispatches on the tensors' device.

Bound on the card (`bound_ms`): bytes; each sorted key and each value read
once and the sums written (`order_bytes=8` adds the sort's permutation,
through which the kernel reads the values).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lightpycl_tpu_torch.ops import _build

_SOURCE = "bincount.cu"


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (once) and load the bincount kernel library."""
    lib = _build.load(_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.lpcl_bincount_sorted
    fn.argtypes = [p, i, p, p, i, ll, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    slots = lib.lpcl_bincount_slots
    slots.argtypes = [ll, i]
    slots.restype = ll
    return lib


def bincount_sorted_torch(idx: torch.Tensor, vals: torch.Tensor,
                          n_bins: int):
    """Weighted bincount (n_bins, ...) of the rows of vals (n, ...) at idx
    (keys outside [0, n_bins) are left out): a stable sort by bin, then a
    segmented inclusive scan with a fixed (Hillis-Steele) association, so
    every run adds the same numbers in the same order; log2(n) elementwise
    passes. Each column of a 2-D vals sums exactly as it would alone. Each
    run's last partial is written to its bin, every other slot's, and those
    of keys out of range, to one extra bin that is dropped, so no host read
    is needed."""
    out = torch.zeros((n_bins + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    n = idx.shape[0]
    if n == 0:
        return out[:n_bins]
    order = torch.argsort(idx, stable=True)
    k, x = idx[order], vals[order]
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = k[1:] != k[:-1]
    f, s = head, 1
    row = (-1,) + (1,) * (vals.dim() - 1)
    while s < n:
        # (x, f)[i] <- (x, f)[i - s] (+) (x, f)[i]: a segment head keeps
        # its own partial sum; otherwise the earlier partial is added first
        x = torch.cat([x[:s], torch.where(f[s:].view(row), x[s:],
                                          x[:-s] + x[s:])])
        f = torch.cat([f[:s], f[s:] | f[:-s]])
        s *= 2
    last = torch.ones(n, dtype=torch.bool, device=idx.device)
    last[:-1] = head[1:]
    keep = last & (k >= 0) & (k < n_bins)
    out[torch.where(keep, k, n_bins).long()] = x  # one write a bin
    return out[:n_bins]


def bincount_sorted_cuda(idx: torch.Tensor, vals: torch.Tensor,
                         n_bins: int):
    """`bincount_sorted_torch` on the card: torch's stable sort, then the
    kernel. idx (n,) int32 or int64 and vals (n, ...) float32 or float64,
    both CUDA and without grad; raises on anything else."""
    if idx.device.type != "cuda" or vals.device != idx.device:
        raise ValueError(f"bincount_sorted_cuda needs CUDA tensors on one "
                         f"device, got {idx.device} and {vals.device}")
    if idx.dim() != 1 or vals.shape[:1] != idx.shape:
        raise ValueError(f"idx (n,) and vals (n, ...) expected, got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx: dtype {idx.dtype}, expected int32 or int64")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vals: dtype {vals.dtype}, expected float32 or "
                        f"float64")
    if vals.requires_grad:
        raise ValueError("vals requires grad, and the kernel has no "
                         "backward (use bincount_sorted_torch)")
    dev = idx.device
    out = torch.empty((n_bins,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=dev)
    n = idx.shape[0]
    if n == 0 or out.numel() == 0:
        return out.zero_()
    keys, order = torch.sort(idx, stable=True)
    return _launch(keys, order, vals.reshape(n, -1).contiguous(), out)


def _launch(keys, order, vals, out):
    """The kernel on keys sorted ascending, `order` their rows (int64),
    vals (n, W) contiguous, into out (n_bins, ...)."""
    n, W = vals.shape
    n_bins = out.shape[0]
    lib = load_kernel()
    dev = keys.device
    slots = lib.lpcl_bincount_slots(n, n_bins)
    runs = torch.empty((n_bins, 2), dtype=torch.int64, device=dev)
    owner = torch.empty(slots, dtype=torch.int32, device=dev)
    partial = torch.empty((slots, W), dtype=vals.dtype, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.lpcl_bincount_sorted(
            keys.data_ptr(), keys.element_size(), order.data_ptr(),
            vals.data_ptr(), vals.element_size(), n, W, n_bins,
            runs.data_ptr(), owner.data_ptr(), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lpcl_bincount_sorted launch failed: cudaError "
                           f"{err}")
    bincount_sorted_cuda.launches += 1
    return out


bincount_sorted_cuda.launches = 0


def bincount_sorted(idx: torch.Tensor, vals: torch.Tensor, n_bins: int):
    """Weighted bincount (n_bins, ...) of the rows of vals (n, ...) at idx
    (keys outside [0, n_bins) are left out), deterministic, with no host
    read: the kernel on CUDA tensors, the plain version elsewhere; the same
    bits on both."""
    if idx.device.type == "cuda":
        return bincount_sorted_cuda(idx, vals, n_bins)
    return bincount_sorted_torch(idx, vals, n_bins)


def bound_ms(n: int, n_bins: int, W: int = 1, key_bytes: int = 4,
             val_bytes: int = 4, order_bytes: int = 0,
             peak_bytes: float = 3.35e12) -> float:
    """Least time of one kernel call, in ms: its bytes (each sorted key and
    value read once, order_bytes a slot more for the sort's permutation,
    the sums written once) over the card's memory rate (H100 SXM:
    3.35 TB/s)."""
    nbytes = (n * (key_bytes + order_bytes + W * val_bytes)
              + n_bins * W * val_bytes)
    return 1e3 * nbytes / peak_bytes
