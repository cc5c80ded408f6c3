"""100 x (1 - the union of device activity / the profiled sub-window)."""


def read(ctx):
    p = ctx["profile"]
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
