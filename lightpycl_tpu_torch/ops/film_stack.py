"""Unpolarized reflectance of a lossless dielectric film stack: the CUDA
kernel and its plain torch version.

Not the port of a Pallas kernel: the reference computes this function as
XLA-fused jnp (lightpycl_tpu/physics.py:450 `multilayer_rs_rp`, :660
`multilayer_reflectance`), and the port's plain version,
`physics.multilayer_reflectance`, runs it as dozens of separate complex64
torch passes over the (C, W) surface. The trace paths call it here:
`spectral.spectral_step` (a wavelength row, reference spectral.py:185)
and `step.shade` (one wavelength a ray, reference step.py:804).

* `film_stack_cuda` launches csrc/film_stack.cu on CUDA tensors (and only
  on them) and counts its launches in `film_stack_cuda.launches`.
* `film_stack_torch` is the plain version: `physics.multilayer_reflectance`
  on the same columns, then the trace's two selects. The CPU uses it, and
  so does TraceConfig(backend="torch") on the card. The kernel performs
  torch's own operations in torch's order, so the two agree bit for bit on
  the card.
* `film_stack_reflectance` dispatches on `backend` as `ops.intersect` does.

Bound on the card: FP32 work, ~60 operations an entry and layer
(`FLOPS_PER_ENTRY_LAYER`) of the rays that run the recursion, against
their (2 L + 3) x 4 bytes read a ray and 4 bytes written an entry; see
`bound_ms`.

Arguments: cos_i, n1, n_sub (C,) f32; layers_n, layers_h (C, L) f32, layer
0 next to the incident medium (the caller flips the stack for exiting
rays); wl either a row (1, W), giving R (C, W), or one wavelength a ray
(C,), giving R (C,). Per ray (C,), the trace's selects: `tir` (bool),
`coated` (bool) and `r_fresnel` (f32). The surface is R where `coated` (1
where also `tir`: under substrate TIR the stack's |r| is 1, forced exactly
so that complex64 roundoff cannot leak power into the refracted slot) and
`r_fresnel` elsewhere; the kernel skips the recursion for the rays that
do not need it. `every_ray(C)` gives selects under which every ray runs
it (the surface is then the stack's R).
"""

from __future__ import annotations

import ctypes

import torch

from lightpycl_tpu_torch import physics
from lightpycl_tpu_torch.ops import _build

_SOURCE = "film_stack.cu"

# FP32 operations the function itself needs per entry and layer, a
# transcendental counted as one: the phase factor (a division, 2 x c_k in
# two products, exp, sin, cos, two products: 8) and two Moebius steps (r e:
# 6, rho + r e: 2, rho r e: 6, 1 + rho r e: 1, |den|: 1, the scaled complex
# division: 10; 26 each). The kernel spends more (it repeats torch's
# products by the zero imaginary parts of promoted reals), so this bounds
# it from below.
FLOPS_PER_ENTRY_LAYER = 60


def load_kernel() -> ctypes.CDLL:
    """Build (once) and load the film-stack kernel library."""
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.lpcl_film_stack
    fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    res = lib.lpcl_film_stack_resources
    res.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    res.restype = ctypes.c_int
    return lib


def _shapes(cos_i, layers_n, wl):
    """(C, L, W, per_ray) of a call; raises on a shape it does not take."""
    if cos_i.dim() != 1 or layers_n.dim() != 2:
        raise ValueError(f"cos_i (C,) and layers (C, L) expected, got "
                         f"{tuple(cos_i.shape)} and {tuple(layers_n.shape)}")
    C, L = layers_n.shape
    if wl.dim() == 1:
        return C, L, 1, True
    if wl.dim() == 2 and wl.shape[0] == 1:
        return C, L, wl.shape[1], False
    raise ValueError(f"wl must be (C,) or (1, W), got {tuple(wl.shape)}")


def _check(name, x, shape, device, dtype=torch.float32):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if x.requires_grad:
        raise ValueError(f"{name}: requires grad, and the kernel has no "
                         f"backward (use physics.multilayer_reflectance)")


def film_stack_cuda(cos_i, n1, n_sub, layers_n, layers_h, wl, tir, coated,
                    r_fresnel):
    """Launch the CUDA kernel. All CUDA, contiguous, no grad; float32 but
    tir and coated (bool); raises on anything else."""
    if cos_i.device.type != "cuda":
        raise ValueError(f"film_stack_cuda needs CUDA tensors, got "
                         f"{cos_i.device}")
    dev = cos_i.device
    C, L, W, per_ray = _shapes(cos_i, layers_n, wl)
    for name, x, shape in (("cos_i", cos_i, (C,)), ("n1", n1, (C,)),
                           ("n_sub", n_sub, (C,)),
                           ("layers_n", layers_n, (C, L)),
                           ("layers_h", layers_h, (C, L)),
                           ("wl", wl, (C,) if per_ray else (1, W)),
                           ("tir", tir, (C,)), ("coated", coated, (C,)),
                           ("r_fresnel", r_fresnel, (C,))):
        _check(name, x, shape, dev,
               torch.bool if name in ("tir", "coated") else torch.float32)
    out = torch.empty((C,) if per_ray else (C, W), dtype=torch.float32,
                      device=dev)
    if C == 0 or W == 0:
        return out
    if L == 0:
        raise ValueError("need >= 1 layer")
    lib = load_kernel()
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.lpcl_film_stack(
            cos_i.data_ptr(), n1.data_ptr(), n_sub.data_ptr(),
            layers_n.data_ptr(), layers_h.data_ptr(), wl.data_ptr(),
            tir.data_ptr(), coated.data_ptr(), r_fresnel.data_ptr(), C, L,
            W, int(per_ray),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lpcl_film_stack launch failed: cudaError {err}")
    film_stack_cuda.launches += 1
    return out


film_stack_cuda.launches = 0


def film_stack_torch(cos_i, n1, n_sub, layers_n, layers_h, wl, tir, coated,
                     r_fresnel):
    """Plain torch version: physics.multilayer_reflectance on the columns
    of the stack, broadcast against the wavelength row (or per ray), then
    1 under `tir` and `r_fresnel` where not `coated`."""
    C, L, W, per_ray = _shapes(cos_i, layers_n, wl)
    col = (lambda x: x) if per_ray else (lambda x: x[:, None])
    R = physics.multilayer_reflectance(
        col(cos_i), col(n1), [col(layers_n[:, k]) for k in range(L)],
        [col(layers_h[:, k]) for k in range(L)], col(n_sub), wl)
    R = torch.where(col(tir), 1.0, R)
    return torch.where(col(coated), R, col(r_fresnel))


def film_stack_reflectance(cos_i, n1, n_sub, layers_n, layers_h, wl, tir,
                           coated, r_fresnel, backend: str = "auto"):
    """R of the stack (with the trace's selects, see the module's
    docstring). backend: 'auto' (the kernel on CUDA tensors, the plain
    version on the CPU), 'cuda' (the kernel; raises on CPU tensors),
    'torch' (the plain version anywhere; also under 'jnp', the reference's
    name for its differentiable path, which diff.py's configs carry). The
    kernel has no backward, so 'auto' and 'cuda' refuse a tensor that
    requires grad; 'torch' passes it to autograd."""
    if backend not in ("auto", "cuda", "torch", "jnp"):
        raise ValueError(f"unknown film-stack backend {backend!r} "
                         f"(auto, cuda, torch)")
    args = (cos_i, n1, n_sub, layers_n, layers_h, wl, tir, coated, r_fresnel)
    if backend in ("torch", "jnp"):
        return film_stack_torch(*args)
    if any(x.requires_grad for x in args):
        raise ValueError("film_stack_reflectance: a tensor requires grad; "
                         "the kernel has no backward, pass backend='torch' "
                         "or call physics.multilayer_reflectance")
    if backend == "cuda" or cos_i.device.type == "cuda":
        return film_stack_cuda(*(x.contiguous() for x in args))
    return film_stack_torch(*args)


def bound_ms(C: int, L: int, W: int, computed: int | None = None,
             peak_flops: float = 67e12, peak_bytes: float = 3.35e12):
    """(bound_ms, bound_by) of one call of C rays, L layers and a row of W
    wavelengths, of which `computed` (default all) run the recursion (the
    others are uncoated or under TIR): the larger of its FP32 operations
    over the card's FP32 peak and its bytes (each input of those rays read
    once, the selects' columns of every ray, the output written once) over
    its memory rate (H100 SXM: 67 TFLOP/s, 3.35 TB/s)."""
    n = C if computed is None else computed
    flops = float(n) * W * (L * FLOPS_PER_ENTRY_LAYER + 6)
    nbytes = 4 * (n * (3 + 2 * L) + W + C * W) + 6 * C
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def computed_rays(tir, coated) -> int:
    """How many rays of a call run the recursion: the coated ones not under
    TIR."""
    return int((coated & ~tir).sum())


def every_ray(C: int, device=None) -> dict:
    """Selects under which every one of C rays runs the recursion (each
    coated, none under TIR): the surface is the stack's R itself."""
    return {"tir": torch.zeros(C, dtype=torch.bool, device=device),
            "coated": torch.ones(C, dtype=torch.bool, device=device),
            "r_fresnel": torch.zeros(C, dtype=torch.float32, device=device)}
