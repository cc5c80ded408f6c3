"""The reader of `intersect.mixed_block_pct`: the program's
`intersect.blocks_mixed` over `intersect.blocks_live`, in %, summed over
the calls the profiler covered and only over them; nothing from a program
that keeps no such counters (an older one, or one without the record),
from a window without profiled calls, or from calls that built no cull
mask."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lightpycl_tpu_torch.utils import profiling as PF  # noqa: E402
from perfcells.harness import catalog  # noqa: E402

MS = 1_000_000  # ns
NAME = "intersect.mixed_block_pct"

# (t0, t1) in s, profiled, (blocks_live, blocks_mixed) counted in the call
CALLS = [((1.0, 2.0), False, (40, 40)),
         ((3.0, 4.0), True, (300, 4)),
         ((4.5, 5.5), True, (500, 7))]


def record(calls, names=("intersect.blocks_live", "intersect.blocks_mixed")):
    spans, counts = [], []
    for i, ((t0, t1), _, values) in enumerate(calls):
        a, b = int(t0 * 1e9) + 1000, int(t1 * 1e9) - 1000
        spans.append(PF.Span("engine.call", i, None, a, b))
        spans.append(PF.Span("step.bounce", i, len(spans) - 1, a + 10,
                             a + 10 + MS))
        counts += [PF.Count(n, i, a + 20, b - 20, 5, float(v))
                   for n, v in zip(names, values)]
    return PF.Record(spans, counts, 0)


def ctx(calls=CALLS):
    return {"calls": [{"i": i, "t0": t0, "t1": t1, "profiled": prof,
                       "bounces": 5, "span_s": t1 - t0, "wall_s": 0.0,
                       "rays": 1}
                      for i, ((t0, t1), prof, _) in enumerate(calls)]}


def read(c):
    return catalog.load_module("metrics", NAME).read(c)


def test_reads_the_profiled_calls_share(monkeypatch):
    monkeypatch.setattr(PF, "recorded", lambda: record(CALLS))
    assert read(ctx()) == pytest.approx(100.0 * (4 + 7) / (300 + 500),
                                        rel=1e-12)


@pytest.mark.parametrize("case", ["no_recorded", "unprofiled",
                                  "empty_record", "no_block_counters",
                                  "no_live_blocks"])
def test_reads_nothing(monkeypatch, case):
    monkeypatch.setattr(PF, "recorded", lambda: record(CALLS))
    c = ctx()
    if case == "no_recorded":
        monkeypatch.delattr(PF, "recorded")
    elif case == "unprofiled":
        for call in c["calls"]:
            call["profiled"] = False
    elif case == "empty_record":
        monkeypatch.setattr(PF, "recorded", lambda: PF.Record([], [], 0))
    elif case == "no_block_counters":
        # a parent program: the cull mask's tile counters, no block ones
        monkeypatch.setattr(PF, "recorded", lambda: record(
            CALLS, names=("intersect.tiles_kept", "intersect.tiles")))
    else:
        calls = [(w, p, (0, 0)) for w, p, _ in CALLS]
        monkeypatch.setattr(PF, "recorded", lambda: record(calls))
    assert read(c) is None


def test_listed_in_the_benchmark_for_both_culled_cells():
    bench = catalog.benchmark()
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m["moves"] == "rays_per_s" and m["layer"] == "ops.intersect"
    for cell in ("config4.collimated_100m", "config3.lens_stack_split"):
        assert m in catalog.metrics_of(bench, cell, traced=True)
        assert m not in catalog.metrics_of(bench, cell, traced=False)
