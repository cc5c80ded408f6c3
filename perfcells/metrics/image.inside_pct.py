"""Share of the slots with measured power whose hit lands inside the
image grid (the program's `image.inside` over `image.measured`, over the
profiled calls), in %: a guard that the cell's map still receives the
measured power. None where no image was made."""

from perfcells.harness.catalog import load_module

S = load_module("metrics", "_spans")


def read(ctx):
    got = S.in_profiled_calls(ctx)
    if got is None:
        return None
    spans, counts, calls = got
    measured = S.total(counts, "image.measured")
    if measured <= 0:
        return None
    return 100.0 * S.total(counts, "image.inside") / measured
