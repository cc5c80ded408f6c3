"""Profiling helpers.

Port counterpart of lightpycl_tpu/utils/profiling.py: wall-clock timing
(`Timer`, verbatim) and a profiler trace context (`trace_profile`), here on
torch.profiler where the reference uses jax.profiler. The trace records
CPU and, on a CUDA device, CUDA activity, and is written into the log
directory as a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import time


class Timer:
    """Wall-clock timer; `with Timer() as t: ...; t.elapsed`."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def trace_profile(logdir: str | None):
    """torch.profiler trace context writing `logdir`/trace-<pid>-<n>.json;
    no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    n = len([f for f in os.listdir(logdir) if f.startswith("trace-")])
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{os.getpid()}-{n}.json"))
