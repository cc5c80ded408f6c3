"""Host time a call spends in `build_scene` (the program's `scene.build`
spans, its Morton sort included), over the profiled calls, in ms."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    return S.total_ms(spans, "scene.build") / len(calls)
