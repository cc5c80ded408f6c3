"""Share of the ray blocks holding a live ray whose rays, as the cull
mask's axis test sees them, point both ways along some axis (the program's
`intersect.blocks_mixed` over `intersect.blocks_live`, over the profiled
calls' cull masks), in %. The axis test bounds such a block on neither
side of that axis.
None without a cull mask, or with a program that keeps no such counter."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    live = S.total(counts, "intersect.blocks_live")
    if live <= 0:
        return None
    return 100.0 * S.total(counts, "intersect.blocks_mixed") / live
