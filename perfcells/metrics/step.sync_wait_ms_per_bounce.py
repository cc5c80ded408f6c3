"""Host time the device loop waits on the device (the program's spans in
`_spans.WAITS`: its `step.sync` spans, and the nearest hit's launch,
where a tap reads the launch's results in the calls the check samples),
over the bounces the profiled calls ran, in ms."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    bounces = sum(c["bounces"] for c in calls)
    if bounces <= 0 or not any(s.name == "step.sync" for s in spans):
        return None
    return S.waits_ms(spans) / bounces
