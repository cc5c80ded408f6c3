"""One run of one cell: set-up, the measured window, the traced
sub-window, the metrics, the check, and the result line.

    python3 perfcells/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The window is a closed loop with one client: call i starts as soon as call
i - 1 has returned, and the loop stops with the first call that returns
after `--seconds`. Every call is timed by the host clock around the entry
call, which ends in the program's readback. With `--trace 1` the profiler
covers a steady sub-window (`profile.after_s` into the window, for at
least `profile.for_s` of whole calls, after one warm call under the
profiler) and the run still lasts `--seconds`.
After the window: the device's memory peak, the metrics, then the check,
with the program's state freed first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pickle
import socket
import subprocess
import sys
import time


from perfcells.harness import catalog, seeds, verdict
from perfcells.entries._common import kept as keep_result
from perfcells.harness.taps import Tap, pairs_of

FORBIDDEN = ("jax", "jaxlib", "flax", "lightpycl_tpu")
RAY_BLOCK, TRI_TILE = 256, 256  # the nearest-hit kernel's cull-mask layout


@dataclasses.dataclass
class Run:
    """What an entry is given: the configuration, the cell's traffic and
    check, the device and the run's seed, the elements' arrays."""

    config: dict
    load: dict
    check: dict
    device: object
    seed: int
    arrays: list


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the port must not use."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def checked_calls(seed: int, check: dict) -> set[int]:
    """The calls the check compares: `check.calls` indices drawn from the
    seed among the first `check.within` calls of the window."""
    rng = seeds.rng(seed, 0xC4EC)
    return set(int(i) for i in rng.choice(int(check["within"]),
                                          size=int(check["calls"]),
                                          replace=False))


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Crew:
    """How the ranks of a run agree. One process: every decision is its
    own. Several (one a card): rank 0 decides, publishes the decision in a
    TCP store of the benchmark's own, and the other ranks read it, so that
    every rank makes the same collective calls; after the window each rank
    hands its readings to rank 0 the same way."""

    def __init__(self, rank=0, world=1, store=None):
        self.rank, self.world, self.store = rank, world, store

    def agree(self, key, decide):
        if self.world == 1:
            return decide()
        if self.rank == 0:
            value = decide()
            self.store.set(f"d/{key}", json.dumps(value))
            return value
        return json.loads(self.store.get(f"d/{key}"))

    def gather(self, value):
        """Rank 0: every rank's value in rank order; others: None."""
        if self.world == 1:
            return [value]
        if self.rank != 0:
            self.store.set(f"g/{self.rank}", pickle.dumps(value))
            return None
        return [value] + [pickle.loads(self.store.get(f"g/{r}"))
                          for r in range(1, self.world)]


def window(entry, run, seconds, traced, tap, profile_opts, crew):
    """The measured window; returns (calls, kept, prof, window start)."""
    from torch.profiler import record_function

    from perfcells.harness import profile

    to_check = checked_calls(run.seed, run.check)
    calls, kept = [], {}
    prof = rf_window = kept_prof = None
    state = {"started": False, "last_t1": None}
    t_w0 = time.perf_counter()
    t_p0 = None
    i = 0

    def plan():
        now = time.perf_counter()
        return {"go": state["last_t1"] is None
                or state["last_t1"] - t_w0 < seconds,
                "start": (traced and not state["started"]
                          and now - t_w0 >= profile_opts.get("after_s", 0))}

    while True:
        d = crew.agree(f"{i}", plan)
        if not d["go"]:
            break
        if d["start"]:
            state["started"] = True
            sync(run.device)
            prof = profile.start(run.device)
            # the profiler's first traced work stalls on its own set-up
            # (seconds on a fresh machine): a warm call under it, outside
            # the sub-window
            entry.warm()
            sync(run.device)
            rf_window = record_function(profile.SPAN + "window")
            rf_window.__enter__()
            tap.count = True
            t_p0 = time.perf_counter()
        tap.begin_call(i in to_check)
        span = (record_function(profile.SPAN + "call") if prof is not None
                else contextlib.nullcontext())
        with span:
            s0 = time.perf_counter()
            res = entry.call(i)
            s1 = time.perf_counter()
        state["last_t1"] = s1
        calls.append({"i": i, "t0": s0, "t1": s1, "span_s": s1 - s0,
                      "wall_s": float(res.wall_time),
                      "rays": entry.rays_per_call,
                      "bounces": res.rays_traced / entry.capacity,
                      "profiled": prof is not None})
        if i in to_check:
            kept[i] = keep_result(res)
        del res
        stop = crew.agree(f"{i}/stop", lambda: prof is not None and (
            s1 - t_p0 >= profile_opts.get("for_s", 0)
            or s1 - t_w0 >= seconds))
        if stop:
            rf_window.__exit__(None, None, None)
            sync(run.device)
            tap.count = False
            prof.__exit__(None, None, None)
            kept_prof, prof = prof, None
        i += 1
    return calls, kept, kept_prof, t_w0


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             bench: dict | None = None, crew: Crew | None = None):
    """Run one cell on this rank; rank 0 returns the result line as a
    dict, the other ranks None."""
    import torch

    from perfcells.harness import profile
    from perfcells.harness.scene import element_arrays
    from perfcells.reference import trace as ref_trace

    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    crew = Crew() if crew is None else crew
    bench = catalog.benchmark() if bench is None else bench
    wl = catalog.load_json("workloads", cell)
    config = catalog.load_json("configs", wl["config"])
    dev = torch.device(device)
    torch.ones(1, device=dev).add_(1)  # the CUDA context
    sync(dev)
    marks.append(("device context", time.perf_counter()))
    run = Run(config, wl["load"], wl["check"], dev, int(seed),
              element_arrays(config))
    n_real = sum(len(a["triangles"]) for a in run.arrays)
    entry = catalog.load_module("entries", config["entry"]).Entry(run)
    marks.append(("scene", time.perf_counter()))
    entry.warm()  # builds or loads the kernel library, warms every shape
    sync(dev)
    marks.append(("warm call", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    if crew.rank == 0:
        prev = t_start
        parts = []
        for name, t in marks:
            parts.append(f"{name} {t - prev:.3f} s")
            prev = t
        print(f"run: set-up {setup_s:.3f} s: " + ", ".join(parts),
              file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tap = Tap(run.seed + crew.rank, int(run.check["launch_rays"]),
              entry.source_rays, RAY_BLOCK)
    with tap:
        calls, kept, prof, t_w0 = window(entry, run, seconds, traced, tap,
                                         wl.get("profile", {}), crew)
    sync(dev)
    mem_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    entry.release()  # the program's state, before the check
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    mine = {"mem": int(mem_peak), "profile": None, "bounds_s": [],
            "kept": kept}
    if prof is not None:
        mine["profile"] = profile.reduce(prof)
        del prof
        bounds = catalog.load_module("metrics", "_roofline")
        mine["bounds_s"] = [bounds.bound_s(
            pairs_of(rec, n_real, RAY_BLOCK, TRI_TILE), rec["n_rays"],
            n_real, rec["mask_words"]) for rec in tap.counted]
    tap.counted.clear()
    # the check, after the window, with the program's state freed: each
    # rank judges its own launches; rank 0 compares every rank's outcome
    scene = ref_trace.scene_arrays(run.arrays, dev)
    bad, judged = verdict.judge_launches(
        tap.captured, scene, verdict.TriangleIndex(scene), entry.opts)
    dead, first = verdict.first_launch_dead(tap.first_live)
    tap.captured.clear()
    mine.update(bad=bad, judged=judged, dead=dead, first=first)
    ranks = crew.gather(mine)
    if ranks is None:
        return None

    ctx = {"calls": calls, "setup_s": setup_s, "window_t0": t_w0,
           "profile": merged_profile([r["profile"] for r in ranks]),
           "bounds_s": [b / len(ranks) for r in ranks for b in r["bounds_s"]]}
    metrics = {}
    for m in catalog.metrics_of(bench, cell, traced):
        v = catalog.load_module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    bad, judged = sum(r["bad"] for r in ranks), sum(r["judged"] for r in ranks)
    dead, first = sum(r["dead"] for r in ranks), sum(r["first"] for r in ranks)
    rows = [{"hit_bad_share": bad / judged if judged else float("nan"),
             "first_launch_dead_share": dead / first if first
             else float("nan")}]
    wants = {}
    for r in ranks:
        rows += outcome_gaps(entry, r["kept"], scene, wants)
    correct, checks = verdict.judged(verdict.worst(rows),
                                     run.check["limits"])
    correct = correct and len(kept) > 0 and judged > 0

    line = {"correct": bool(correct), "attempted": len(calls), "failed": 0,
            "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": int(wl["chips"]),
                       "memory_peak_bytes": max(r["mem"] for r in ranks)}}
    if ctx["profile"] is not None:
        p = ctx["profile"]
        line["device"].update(busy_s=p["busy_s"], window_s=p["window_s"])
        line["breakdown"] = {"device_ops": p["device_ops"],
                             "idle_gaps": p["idle_gaps"]}
    line["checked"] = {"calls": len(kept), "ranks": len(ranks),
                       "rays": judged}
    line["checks"] = checks
    return line


def merged_profile(profiles):
    """The ranks' profiles: device seconds, busy and window averaged over
    the cards; the breakdown is rank 0's."""
    if not profiles or profiles[0] is None:
        return None
    n = len(profiles)
    kernel_s = {}
    for p in profiles:
        for name, v in p["kernel_s"].items():
            kernel_s[name] = kernel_s.get(name, 0.0) + v / n
    out = dict(profiles[0])
    out.update(kernel_s=kernel_s,
               busy_s=sum(p["busy_s"] for p in profiles) / n,
               window_s=sum(p["window_s"] for p in profiles) / n)
    return out


def outcome_gaps(entry, kept, scene, wants, dtype=None):
    """verdict.gaps of each checked call's outcome against the float64
    reference's: the program's (`kept`), or with `dtype` the reference's
    own in that dtype (the control). `wants` caches the reference's."""
    import torch

    rows = []
    for i in sorted(kept):
        if i not in wants:
            wants[i] = entry.reference_outcome(i, torch.float64, scene)
        seen = (entry.program_outcome(kept[i]) if dtype is None
                else entry.reference_outcome(i, dtype, scene))
        rows.append(verdict.gaps(seen, wants[i]))
    return rows


def check_numbers(entry, tap, kept, scene, dtype=None, wants=None):
    """(numbers, judged rays) of the check on one rank: the program's
    answers, or with `dtype` the control's, against the float64
    reference."""
    bad, judged = verdict.judge_launches(
        tap.captured, scene, verdict.TriangleIndex(scene), entry.opts,
        dtype=dtype)
    dead, first = verdict.first_launch_dead(tap.first_live)
    rows = [{"hit_bad_share": bad / judged if judged else float("nan"),
             "first_launch_dead_share": (0.0 if dtype is not None else
                                         dead / first if first
                                         else float("nan"))}]
    rows += outcome_gaps(entry, kept, scene, {} if wants is None else wants,
                         dtype)
    return verdict.worst(rows), judged


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rank(cell, seed, seconds, traced, rank, world, dist_port,
             store_port, device="cuda", t_start=None, bench=None):
    """One rank of a cell on several cards: its card, the benchmark's
    control store, the program's process group (NCCL on cards, gloo on the
    CPU, started through the port's `init_distributed`), then run_cell."""
    import datetime

    import torch
    import torch.distributed as dist

    from lightpycl_tpu_torch.parallel.distributed import init_distributed

    if device == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    store = dist.TCPStore("127.0.0.1", store_port, world, rank == 0,
                          timeout=datetime.timedelta(seconds=600))
    init_distributed(f"127.0.0.1:{dist_port}", world, rank)
    try:
        return run_cell(cell, seed, seconds, traced, device=device,
                        t_start=t_start, bench=bench,
                        crew=Crew(rank, world, store))
    finally:
        dist.destroy_process_group()


def run_ranks(argv_of_rank, cell, seed, seconds, traced, world,
              device="cuda", t_start=None, bench=None):
    """Rank 0 in this process, ranks 1.. as processes started from
    `argv_of_rank(rank, dist_port, store_port)`; waits for every one of
    them. Returns rank 0's line, or raises when a rank failed."""
    dist_port, store_port = free_port(), free_port()
    procs = [subprocess.Popen(argv_of_rank(r, dist_port, store_port),
                              stdout=subprocess.DEVNULL)
             for r in range(1, world)]
    try:
        line = run_rank(cell, seed, seconds, traced, 0, world, dist_port,
                        store_port, device, t_start, bench)
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"ranks 1-{world - 1} exited with {rcs}")
    return line
