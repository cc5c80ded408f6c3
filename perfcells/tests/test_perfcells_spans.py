"""The readers of the program's own spans and counters keep only what
falls inside the window's profiled calls: not the calls the profiler did
not cover, not the warm call under the profiler before them. A program
without the record (`profiling.recorded`) reads as nothing."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lightpycl_tpu_torch.utils import profiling as PF  # noqa: E402
from perfcells.harness import catalog  # noqa: E402

MS = 1_000_000  # ns

# (t0, t1) in s, profiled, bounces; then each call's record: scene.build
# ms, step.sync ms (the early-exit read), step.bounce ms, the ms of the
# step.nearest_hit and of the step.sync inside it, and the counters
CALLS = [((1.0, 2.0), False, 3, 100, 50, 9, (1, 2),
          dict(builds=2, live=10, slots=40, kept=1, tiles=10)),
         ((3.0, 4.0), True, 2, 400, 30, 4, (2, 1),
          dict(builds=2, live=30, slots=40, kept=3, tiles=100)),
         ((4.5, 5.5), True, 4, 600, 90, 8, (1, 3),
          dict(builds=3, live=50, slots=60, kept=5, tiles=100))]
WARM = ((2.1, 2.9), 300, 70, 7, (3, 2), dict(builds=5, live=1, slots=99,
                                             kept=99, tiles=99))


def record_of(t0, build, sync, bounce, inner, c):
    """One call's spans and counters, `t0` s into the clock."""
    base = int(t0 * 1e9) + 1000
    spans = [PF.Span("engine.call", 1, None, base, base + 1)]
    at = base + 10
    for name, ms in (("scene.build", build), ("step.sync", sync),
                     ("step.bounce", bounce)):
        spans.append(PF.Span(name, 1, 0, at, at + ms * MS))
        at += ms * MS + 10
    at_b, b = spans[-1].t0_ns + 5, len(spans) - 1
    for name, ms in zip(("step.nearest_hit", "step.sync"), inner):
        spans.append(PF.Span(name, 1, b, at_b, at_b + ms * MS))
        at_b += ms * MS + 5
    spans[0] = spans[0]._replace(t1_ns=at)
    counts = [PF.Count(n, 1, base + 20, at - 5, 2, float(c[k]))
              for n, k in (("scene.builds", "builds"),
                           ("step.live_rays", "live"), ("step.slots", "slots"),
                           ("intersect.tiles_kept", "kept"),
                           ("intersect.tiles", "tiles"))]
    return spans, counts


def fake_record():
    """The calls' record and the warm call's, between them."""
    spans, counts = [], []
    parts = [(w, *rest) for w, _, _, *rest in CALLS] + [WARM]
    for (t0, _), build, sync, bounce, inner, c in parts:
        s, n = record_of(t0, build, sync, bounce, inner, c)
        spans += s
        counts += n
    return PF.Record(spans, counts, 0)


def ctx():
    return {"calls": [{"i": i, "t0": t0, "t1": t1, "profiled": prof,
                       "bounces": bounces, "span_s": t1 - t0, "wall_s": 0.0,
                       "rays": 1}
                      for i, ((t0, t1), prof, bounces, *_) in
                      enumerate(CALLS)]}


PROFILED = [c for c in CALLS if c[1]]
N = len(PROFILED)
BOUNCES = sum(c[2] for c in PROFILED)


def counted(key):
    return sum(c[7][key] for c in PROFILED)


EXPECTED = {
    "engine.scene_builds_per_trace": counted("builds") / N,
    "engine.scene_build_ms_per_trace": sum(c[3] for c in PROFILED) / N,
    "step.sync_wait_ms_per_bounce":
        sum(c[4] + sum(c[6]) for c in PROFILED) / BOUNCES,
    "step.host_ms_per_bounce":
        sum(c[5] - sum(c[6]) for c in PROFILED) / BOUNCES,
    "step.live_pct": 100.0 * counted("live") / counted("slots"),
    "intersect.cull_kept_pct": 100.0 * counted("kept") / counted("tiles"),
}


def reader(name):
    return catalog.load_module("metrics", name).read


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_keeps_only_profiled_calls(name, monkeypatch):
    monkeypatch.setattr(PF, "recorded", fake_record)
    assert reader(name)(ctx()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_the_record(name, monkeypatch):
    """The parent commit's program has no `recorded`; a window without
    profiled calls, or a record with nothing inside them, reads None."""
    monkeypatch.setattr(PF, "recorded", fake_record)
    unprofiled = ctx()
    for c in unprofiled["calls"]:
        c["profiled"] = False
    assert reader(name)(unprofiled) is None
    monkeypatch.setattr(PF, "recorded", lambda: PF.Record([], [], 0))
    assert reader(name)(ctx()) is None
    monkeypatch.delattr(PF, "recorded")
    assert reader(name)(ctx()) is None


def test_brute_cell_has_no_kept_share(monkeypatch):
    rec = fake_record()
    monkeypatch.setattr(PF, "recorded", lambda: rec._replace(counts=[
        c for c in rec.counts if not c.name.startswith("intersect.")]))
    assert reader("intersect.cull_kept_pct")(ctx()) is None
    assert reader("step.live_pct")(ctx()) == pytest.approx(
        EXPECTED["step.live_pct"])


def test_a_running_sum_over_several_calls_is_left_out(monkeypatch):
    """A counter summed outside any `engine.call` runs from its first to
    its last increment; spanning two calls, it is attributed to neither."""
    rec = fake_record()
    t0 = int(CALLS[1][0][0] * 1e9) + 100
    t1 = int(CALLS[2][0][0] * 1e9) + 100
    stray = PF.Count("scene.builds", None, t0, t1, 7, 7.0)
    monkeypatch.setattr(PF, "recorded",
                        lambda: rec._replace(counts=rec.counts + [stray]))
    assert reader("engine.scene_builds_per_trace")(ctx()) == pytest.approx(
        EXPECTED["engine.scene_builds_per_trace"], rel=1e-12)
