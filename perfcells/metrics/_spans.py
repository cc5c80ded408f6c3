"""The program's own record (`lightpycl_tpu_torch.utils.profiling`:
spans and counters kept while the profiler records), cut to the calls of
the window that the profiler covered: a span or count is kept when its
times fall inside such a call's span, so the warm call under the profiler
is left out. A program without the record reads as None."""

from __future__ import annotations

import bisect


def in_profiled_calls(ctx):
    """(spans, counts, profiled calls) of the record inside the profiled
    calls, or None when the program keeps no record or recorded no span
    there."""
    from lightpycl_tpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    calls = sorted((c["t0"] * 1e9, c["t1"] * 1e9) for c in ctx["calls"]
                   if c["profiled"])
    if recorded is None or not calls:
        return None
    starts = [a for a, _ in calls]

    def inside(t0, t1):
        k = bisect.bisect_right(starts, t0) - 1
        return k >= 0 and t1 <= calls[k][1]

    rec = recorded()
    spans = [s for s in rec.spans
             if s.t1_ns is not None and inside(s.t0_ns, s.t1_ns)]
    if not spans:
        return None
    counts = [c for c in rec.counts if inside(c.t0_ns, c.t1_ns)]
    return spans, counts, [c for c in ctx["calls"] if c["profiled"]]


def total_ms(spans, name):
    return sum(s.t1_ns - s.t0_ns for s in spans if s.name == name) * 1e-6


def nested_ms(spans, name, outer):
    """Total of the `name` spans that lie inside an `outer` span, in ms."""
    around = sorted((s.t0_ns, s.t1_ns) for s in spans if s.name == outer)
    starts = [a for a, _ in around]
    ms = 0.0
    for s in spans:
        if s.name == name:
            k = bisect.bisect_right(starts, s.t0_ns) - 1
            if k >= 0 and s.t1_ns <= around[k][1]:
                ms += (s.t1_ns - s.t0_ns) * 1e-6
    return ms


def total(counts, name):
    return sum(c.value for c in counts if c.name == name)


# Where the host of a bounce may wait on the device: the program's
# `step.sync` spans (the early-exit read, the detector's constant uploads,
# which wait for the stream, and the detector sums' index reads) and
# the nearest hit's launch (`step.nearest_hit`: an enqueue, unless a tap
# on the launch reads its results, as the check does in the calls it
# samples; so the wait counts the same whichever call the check takes).
WAITS = ("step.sync", "step.nearest_hit")


def waits_ms(spans, outer=None):
    """Total of the WAITS spans, or of those inside an `outer` span, in
    ms."""
    if outer is None:
        return sum(total_ms(spans, w) for w in WAITS)
    return sum(nested_ms(spans, w, outer) for w in WAITS)
