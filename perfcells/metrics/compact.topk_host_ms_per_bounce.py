"""Host time of the top-k fit (the program's `compact.topk` spans: the
sort of the 2C children's keys and the gather of their columns), over the
bounces the profiled calls ran, in ms. None where no fit ran."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    bounces = sum(c["bounces"] for c in calls)
    if bounces <= 0 or not any(s.name == "compact.topk" for s in spans):
        return None
    return S.total_ms(spans, "compact.topk") / bounces
