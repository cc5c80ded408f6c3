"""Host time of a bounce less its waits on the device (the program's
`step.bounce` spans less the `_spans.WAITS` spans inside them), over the
bounces the profiled calls ran, in ms: the host's own work to enqueue a
bounce, the profiler's cost for each op included."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    bounces = sum(c["bounces"] for c in calls)
    if bounces <= 0 or not any(s.name == "step.bounce" for s in spans):
        return None
    waits = S.waits_ms(spans, outer="step.bounce")
    return (S.total_ms(spans, "step.bounce") - waits) / bounces
