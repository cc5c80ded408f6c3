"""Host time of the image map's update (the program's `step.image` spans:
the pixel indices and the image's bincount), over the bounces the
profiled calls ran, in ms. None where no image was made."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    bounces = sum(c["bounces"] for c in calls)
    if bounces <= 0 or not any(s.name == "step.image" for s in spans):
        return None
    return S.total_ms(spans, "step.image") / bounces
