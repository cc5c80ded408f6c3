"""Profiling helpers: wall-clock timing (`Timer`), a torch.profiler trace
context (`trace_profile`, behind `Tracer.trace(profile_logdir=...)`), and
the program's own spans and counters (`span`, `count`), on exactly while a
torch profiler records: each span is then a `lightpycl.<name>` range in
the profiler's trace, beside the kernels, and `recorded()` gives the spans
and counters in memory.

Port counterpart of lightpycl_tpu/utils/profiling.py: `Timer` verbatim,
`trace_profile` here on torch.profiler where the reference uses
jax.profiler. The trace records CPU and, on a CUDA device, CUDA activity,
and is written into the log directory as a Chrome trace (open it in
Perfetto or chrome://tracing).

Spans and counters have no switch of their own: they follow the profiler
on this thread (`enabled`). Off, a span is one shared no-op context and a
counter returns at once. On, spans and counters are also kept in memory
(`recorded`, `clear`). A span inside the root span `engine.call`
(Tracer.trace, trace_batched, trace_spectral) carries that call's
identifier. A counter keeps one running sum for each call (and device):
a device-valued increment is added on the device, and read back only
when the record is read, so counting adds no host sync to a trace and
its memory grows with the calls, not with the increments. The record
holds at most MAX_RECORDS spans and as many running sums, and counts
what it drops.

    spans and their parents   counters
    engine.call               scene.builds (one a build_scene)
      engine.sample           step.live_rays, step.slots (each launch of
      scene.build               a bounce: live rays, ray slots)
        scene.morton_sort     intersect.tiles_kept, intersect.tiles (each
      engine.resolve_cull       cull mask: the (ray block, triangle tile)
      engine.resolve_ray_len    pairs kept, and all of them)
                              intersect.blocks_live, intersect.blocks_mixed
                                (each cull mask: ray blocks holding a live
                                ray, those whose rays point both ways
                                along some axis)
                              compact.children, compact.kept (each top-k
                                fit: live children above the cutoff that
                                enter it, and those it keeps)
                              image.measured, image.inside (each image
                                map's update: slots with measured power,
                                those whose pixel is inside the grid)
      engine.batch
        engine.assemble
        engine.readback
        step.bounce
          step.reorder, step.cull_mask, step.nearest_hit, step.shade,
          step.accumulate, step.compact
            step.image (in step.accumulate, with an image map: the pixel
              indices and the image's bincount)
            compact.topk (in step.compact, splitting scenes' top-k fit:
              the sort and the gather)
        step.sync (the early-exit read, after each bounce but the last;
          bounce 0's test is read with bounce 1's; counter step.host_reads,
          one a read)
      parallel.all_reduce

    step.sync is each host call of the step's path that may wait on the
    device's queue, and step.host_reads counts them.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import NamedTuple, Optional

import torch

PREFIX = "lightpycl."
ROOT = "engine.call"
MAX_RECORDS = 1_000_000

# True while a torch profiler records on this thread
enabled = torch._C._autograd._profiler_enabled


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


class Span(NamedTuple):
    """A recorded span: times from time.perf_counter_ns; `parent` is the
    index in `Record.spans` of the span it ran in (None: none recorded);
    t1_ns is None while it is open."""

    name: str
    call_id: Optional[int]
    parent: Optional[int]
    t0_ns: int
    t1_ns: Optional[int]


class Count(NamedTuple):
    """A counter's running sum over one call: `n` increments between
    t0_ns and t1_ns (time.perf_counter_ns), their sum on the host."""

    name: str
    call_id: Optional[int]
    t0_ns: int
    t1_ns: int
    n: int
    value: float


class Record(NamedTuple):
    """What `recorded` returns: the spans, the counts, and how many of
    either the record dropped when full."""

    spans: list
    counts: list
    dropped: int


class _Recorder:
    """The process's record: spans as [name, call_id, parent, t0, t1]
    lists, counters as {(name, call_id, device): [t0, t1, n, sum]} with a
    host sum (device None) or a float64 device tensor, the stack of open
    span indices."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self.stack: list = []
        self.dropped = 0
        self.calls = 0
        self.call_id: Optional[int] = None


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Open:
    """A span while the profiler records: a record_function range and an
    entry of the record."""

    __slots__ = ("name", "rf", "entry", "root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        self.root = self.name == ROOT and rec.call_id is None
        if self.root:
            rec.calls += 1
            rec.call_id = rec.calls
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        parent = rec.stack[-1] if rec.stack else None
        if len(rec.spans) < MAX_RECORDS:
            rec.stack.append(len(rec.spans))
            self.entry = [self.name, rec.call_id, parent,
                          time.perf_counter_ns(), None]
            rec.spans.append(self.entry)
        else:
            rec.dropped += 1
            rec.stack.append(parent)
            self.entry = None
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = _REC
        if self.entry is not None:
            self.entry[4] = t1
        if rec.stack:
            rec.stack.pop()
        if self.root:
            rec.call_id = None
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """Context of the program's span `name`: a `lightpycl.<name>` range on
    the profiler's timeline and an entry of the record while a profiler
    records, else a shared no-op."""
    if not enabled():
        return _OFF
    return _Open(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add `value` (a number or a 0-d device tensor) to the counter `name`
    of the current call while a profiler records: a tensor is added to a
    running sum on its device, with no host read. A site whose value costs
    device work to form checks `enabled()` first."""
    if not enabled():
        return
    rec = _REC
    t = time.perf_counter_ns()
    dev = value.device if isinstance(value, torch.Tensor) else None
    key = (name, rec.call_id, dev)
    acc = rec.counts.get(key)
    if acc is not None:
        acc[1] = t
        acc[2] += 1
        if dev is None:
            acc[3] += value
        else:
            with torch.no_grad():
                acc[3].add_(value)
    elif len(rec.counts) < MAX_RECORDS:
        if dev is not None:
            with torch.no_grad():
                value = value.to(torch.float64, copy=True)
        rec.counts[key] = [t, t, 1, value]
    else:
        rec.dropped += 1


def recorded() -> Record:
    """The spans and counters recorded so far, the counters' device sums
    read back (one transfer a device), and how many the record dropped."""
    rec = _REC
    keys = list(rec.counts)
    values = [rec.counts[k][3] for k in keys]
    by_dev: dict = {}
    for i, k in enumerate(keys):
        if k[2] is not None:
            by_dev.setdefault(k[2], []).append(i)
    for idx in by_dev.values():
        host = torch.stack([values[i] for i in idx]).cpu().tolist()
        for i, h in zip(idx, host):
            values[i] = h
    return Record(
        spans=[Span(*s) for s in rec.spans],
        counts=[Count(k[0], k[1], *rec.counts[k][:3], float(v))
                for k, v in zip(keys, values)],
        dropped=rec.dropped)


def clear() -> None:
    """Empty the record (between traces: a span open now is left out)."""
    _REC.spans.clear()
    _REC.counts.clear()
    _REC.stack.clear()
    _REC.dropped = 0
