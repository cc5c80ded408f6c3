"""Source rays of every call of the window over the time from the window's
start to the last call's return."""


def read(ctx):
    calls = ctx["calls"]
    if not calls:
        return None
    return sum(c["rays"] for c in calls) / (calls[-1]["t1"] - ctx["window_t0"])
