"""Share of the ray slots that hold a live ray at the bounces' launches
(the program's `step.live_rays` over `step.slots`) in the profiled calls,
in %."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    slots = S.total(counts, "step.slots")
    if slots <= 0:
        return None
    return 100.0 * S.total(counts, "step.live_rays") / slots
