"""`step.host_reads_per_bounce` reads the program's counter
`step.host_reads` over the bounces of the profiled calls only, and reads
nothing where the program keeps no such counter."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lightpycl_tpu_torch.utils import profiling as PF  # noqa: E402
from perfcells.harness import catalog  # noqa: E402

# (t0, t1) in s, profiled, bounces, host reads; the last call is the warm
# call under the profiler, inside no profiled call
CALLS = [((1.0, 2.0), False, 3, 3), ((3.0, 4.0), True, 2, 2),
         ((4.5, 5.5), True, 4, 5)]
WARM = ((2.1, 2.9), 9)


def fake_record(reads=True):
    """Each call's root span, a `step.sync` span and its read count."""
    spans, counts = [], []
    for (t0, t1), n in [(c[0], c[3]) for c in CALLS] + [WARM]:
        base, end = int(t0 * 1e9) + 1000, int(t1 * 1e9) - 1000
        spans += [PF.Span("engine.call", 1, None, base, end),
                  PF.Span("step.sync", 1, 0, base + 10, base + 20)]
        if reads:
            counts.append(PF.Count("step.host_reads", 1, base + 15,
                                   end - 5, n, float(n)))
    return PF.Record(spans, counts, 0)


def ctx(profiled=True):
    return {"calls": [{"i": i, "t0": t0, "t1": t1,
                       "profiled": prof and profiled, "bounces": bounces,
                       "span_s": t1 - t0, "wall_s": 0.0, "rays": 1}
                      for i, ((t0, t1), prof, bounces, _) in
                      enumerate(CALLS)]}


def read(c):
    return catalog.load_module("metrics", "step.host_reads_per_bounce").read(c)


def test_reads_per_bounce_of_the_profiled_calls(monkeypatch):
    monkeypatch.setattr(PF, "recorded", fake_record)
    prof = [c for c in CALLS if c[1]]
    assert read(ctx()) == pytest.approx(
        sum(c[3] for c in prof) / sum(c[2] for c in prof), rel=1e-12)


@pytest.mark.parametrize("what", ["no_counter", "unprofiled", "no_record"])
def test_reads_nothing_without_the_counter(what, monkeypatch):
    """The parent of the counter has `step.sync` spans but no
    `step.host_reads`; a window without profiled calls, or a program
    without the record, reads None."""
    monkeypatch.setattr(PF, "recorded", lambda: fake_record(
        reads=what != "no_counter"))
    if what == "no_record":
        monkeypatch.delattr(PF, "recorded")
    assert read(ctx(profiled=what != "unprofiled")) is None
