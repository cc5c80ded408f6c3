"""The least time the card could take for a nearest-hit launch, copied
from `lightpycl_tpu_torch/bench.py` (`bound`): the flops of the kernel's
division-free reject test, which every (ray, triangle) pair needs (29: 12
FMAs, 3 multiplies, 2 adds), at the H100 SXM's FP32 peak, or the bytes
(o, d, the rows and the mask read once, t and tri written once) at its
memory rate, whichever is larger. NVIDIA's data sheet, at 700 W."""

FLOPS_PER_PAIR = 29
FP32_FLOP_PER_S = 67e12
HBM_BYTE_PER_S = 3.35e12
KERNEL = "nearest_hit_kernel"


def bound_s(pairs, n_rays, n_tris, mask_words=0):
    return max(FLOPS_PER_PAIR * pairs / FP32_FLOP_PER_S,
               (n_rays * 32 + n_tris * 48 + mask_words * 4) / HBM_BYTE_PER_S)


def kernel_s(profile, match=KERNEL):
    """Device seconds of the ops whose name holds `match`."""
    return sum(s for name, s in profile["kernel_s"].items() if match in name)


def is_nccl(name: str) -> bool:
    """An NCCL kernel (its device time includes waiting for the other
    ranks)."""
    return name.startswith(("ncclDevKernel", "ncclKernel"))


def profiled_calls(ctx):
    return [c for c in ctx["calls"] if c["profiled"]]
