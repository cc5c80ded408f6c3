"""One reader a metric, `<metric>.py` named as BENCHMARK.json names the
metric, each with `read(ctx) -> float | None` (None: nothing to read, and
the metric is left out of the line). `ctx` holds:

* calls: one dict a window call: i, t0, t1 (host clock), span_s (the
  benchmark's span around the entry call), wall_s (the program's
  TraceResult.wall_time), rays (source rays), bounces, profiled;
* window_t0: the window's start; setup_s: process start to it;
* profile (traced runs): kernel_s (device seconds by op name), busy_s,
  window_s, device_ops, idle_gaps (harness/profile.py);
* bounds_s (traced runs): the least time of each nearest-hit launch in the
  profiled sub-window (`_roofline.bound_s`).
"""
