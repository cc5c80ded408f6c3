"""Share of the live children that the top-k fits of the profiled calls
throw away (the program's `compact.children` less `compact.kept`, over
`compact.children`), in %: the split work that no later bounce traces.
None where no fit ran (a scene that does not split)."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    children = S.total(counts, "compact.children")
    if children <= 0:
        return None
    return 100.0 * (children - S.total(counts, "compact.kept")) / children
