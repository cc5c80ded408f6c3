"""Device time of NCCL kernels in the profiled sub-window over its calls,
in ms (the all-reduce of the detector state and ledger)."""

from perfcells.harness.catalog import load_module

R = load_module("metrics", "_roofline")


def read(ctx):
    p, calls = ctx["profile"], R.profiled_calls(ctx)
    if p is None or not calls:
        return None
    s = sum(v for name, v in p["kernel_s"].items() if R.is_nccl(name))
    return s / len(calls) * 1e3 if s > 0 else None
