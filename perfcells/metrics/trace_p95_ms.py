"""95th percentile of the benchmark's span around every call of the
window (sampling, scene build, device work, readback), in ms."""

import numpy as np


def read(ctx):
    spans = [c["span_s"] for c in ctx["calls"]]
    return float(np.percentile(spans, 95)) * 1e3 if spans else None
