"""Host reads of the device loop (the program's counter `step.host_reads`,
one a `step.sync` span: a host call that may wait on the device's queue),
over the bounces the profiled calls ran. None where the program keeps no
such counter."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    bounces = sum(c["bounces"] for c in calls)
    if bounces <= 0 or not any(c.name == "step.host_reads" for c in counts):
        return None
    return S.total(counts, "step.host_reads") / bounces
