"""Share of the (ray block, triangle tile) pairs that the cull masks of
the profiled calls keep (the program's `intersect.tiles_kept` over
`intersect.tiles`), in %. None without a cull mask."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    tiles = S.total(counts, "intersect.tiles")
    if tiles <= 0:
        return None
    return 100.0 * S.total(counts, "intersect.tiles_kept") / tiles
