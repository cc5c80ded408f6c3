"""Device time of every op but the nearest-hit kernel and NCCL kernels in
the profiled sub-window, over the bounces its calls ran, in ms."""

from perfcells.harness.catalog import load_module

R = load_module("metrics", "_roofline")


def read(ctx):
    p = ctx["profile"]
    bounces = sum(c["bounces"] for c in R.profiled_calls(ctx))
    if p is None or bounces <= 0:
        return None
    other = sum(s for name, s in p["kernel_s"].items()
                if R.KERNEL not in name and not R.is_nccl(name))
    return other / bounces * 1e3
