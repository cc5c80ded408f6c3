"""Host time a call spends outside the program's timed `_run`: the
benchmark's span around the call minus the program's
TraceResult.wall_time, averaged over the calls the profiler did not
cover (its overhead would count here), in ms."""


def read(ctx):
    calls = [c for c in ctx["calls"] if not c["profiled"]]
    if not calls:
        return None
    return sum(c["span_s"] - c["wall_s"] for c in calls) / len(calls) * 1e3
