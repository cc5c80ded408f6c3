"""The nearest-hit kernel's device time in the profiled sub-window over
its calls, in ms."""

from perfcells.harness.catalog import load_module

R = load_module("metrics", "_roofline")


def read(ctx):
    p, calls = ctx["profile"], R.profiled_calls(ctx)
    if p is None or not calls:
        return None
    k = R.kernel_s(p)
    return k / len(calls) * 1e3 if k > 0 else None
