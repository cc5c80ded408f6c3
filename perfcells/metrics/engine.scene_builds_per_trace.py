"""Scene builds a call (the program's `scene.builds` counter, one a
`build_scene`), over the profiled calls."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    return S.total(counts, "scene.builds") / len(calls)
