"""The traced sub-window: torch.profiler over CPU and CUDA activity, and
its reduction to device time by kernel name, the union of device
activity, and the idle gaps labelled by what the host was in.

The benchmark marks the sub-window with the range `perfcells.window` and
each call with `perfcells.call`; the profiler also lists such host ranges
as device-side annotations, which are not device work and are left out."""

from __future__ import annotations

import collections

SPAN = "perfcells."


def start(device):
    """A running profiler over CPU and, on a card, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, top: int = 10) -> dict:
    """kernel_s (device seconds by op name), busy_s, window_s, device_ops
    and idle_gaps (the `top` largest of each, [name, seconds]), all of the
    device work inside the `perfcells.window` range."""
    from torch.autograd import DeviceType

    dev, cpu, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end  # us
        if ev.device_type == DeviceType.CUDA:
            dev.append((s, e, ev.name))
        elif ev.name == SPAN + "window":
            window = (s, e)
        else:
            cpu.append((s, e, ev.name))
    # a host range (ours, or torch's such as `nccl:all_reduce`) is also
    # listed on the device's timeline under its own name: not device work
    host_names = {n for _, _, n in cpu} | {SPAN + "window"}
    dev = [ev for ev in dev if ev[2] not in host_names]
    if window is None:
        raise RuntimeError("the profile holds no perfcells.window range")
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    kernel_s = collections.Counter()
    for s, e, name in dev:
        kernel_s[name] += (e - s) * 1e-6
    busy = _union((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    by_label = collections.Counter()
    for (g0, g1), label in zip(gaps, _labels([0.5 * (a + b) for a, b in gaps],
                                              cpu)):
        by_label[label] += (g1 - g0) * 1e-6
    return {"kernel_s": dict(kernel_s), "busy_s": busy_s,
            "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[n[:120], s] for n, s in kernel_s.most_common(top)],
            "idle_gaps": [[n[:120], s] for n, s in by_label.most_common(top)]}


def _labels(points, cpu):
    """For each of the sorted `points`, the host's state then: the
    benchmark range it was in and the innermost CPU op inside it."""
    cpu = sorted(cpu)
    out, active, k = [], [], 0
    for x in points:
        while k < len(cpu) and cpu[k][0] <= x:
            active.append(cpu[k])
            k += 1
        active = [ev for ev in active if ev[1] >= x]
        spans = [ev for ev in active if ev[2].startswith(SPAN)]
        ops = [ev for ev in active if not ev[2].startswith(SPAN)]
        outer = max(spans, key=lambda ev: ev[1] - ev[0])[2] if spans else None
        inner = min(ops, key=lambda ev: ev[1] - ev[0])[2] if ops else None
        out.append(" > ".join(n for n in (outer, inner) if n) or "host")
    return out
