"""The repository's headline bench on the port: one JSON line.

Port counterpart of the root bench.py, section by section, at bench.py's
large (TPU) sizes on the card:

    python3 -m lightpycl_tpu_torch.bench [--device cuda|cpu]

1. Intersect headline (bench.py:42-102): 524,288 rays (origins in the unit
   cube, isotropic directions, `np.random.default_rng(0)`) against a
   256 x 256 terminator sphere of 130,560 triangles, through the
   nearest-hit kernel B1 (`ops.intersect.nearest_hit_cuda`, brute). The
   kernel is built or loaded (`kernel_load_s`) and launched once before
   the timing; then `reps` launches run back to back, each between two
   CUDA events, with no host sync among them. `value` is rays x triangles
   / the median launch (bench.py's `tests_per_s`, which bench.py takes as
   the mean of a `lax.scan`); `vs_baseline` is value / 1e10, BASELINE.md's
   target. Every launch's hit checksum must be the same, and 65,536 rays
   of the first launch (whole ray blocks spread over the batch) must equal
   the plain `nearest_hit_torch` bit for bit, t and triangle index.
2. Full trace (bench.py:104-121): config 1 (a parabolic mirror and a dome,
   (128, 32)), a point source of the same ray count, 8 bounces, device
   mode. The first trace is dropped. `rays_per_sec_full_trace` is the best
   of the warm traces, as in bench.py; beside it their median and
   quartiles. Each ledger must close to 1e-5.
3. Cull on the bowl (bench.py:123-145): a (256, 128) paraboloid bowl and a
   dome, a collimated bundle, 6 bounces, with `cull=False` and then
   `cull=True`, the first trace of each dropped.
   `culled_effective_tests_per_s` and `cull_speedup_bowl` are bench.py's
   (best walls); beside them both sides' medians and quartiles. The
   `cull=True` traces must launch with a cull mask, the others without,
   both ledgers must close to 1e-5 and the culled run must measure the
   brute run's power within 1e-5 relative (the Morton reorder changes the
   order of the sums, nothing else).
4. Parity (bench.py:147-156): 4,096 rays of config 1's source (seed 9), 6
   bounces, `Tracer.trace` on them against the port's float64 oracle
   (`tracer.oracle.trace_oracle`); `detected_power_parity_rel_err` must be
   at most 1e-3 (BASELINE.md's 0.1%).

The line holds every key of bench.py's (`BENCH_PY_KEYS`) with the port's
values: `backend` "cuda", `device` the card's name, `ray_block` /
`tri_tile` the kernel's block shape (`ops.intersect.RAY_BLOCK`,
`TRI_TILE`), and `tri_sub` the triangles a cp.async pipeline stage holds
(`ops.intersect.TRI_CHUNK`, csrc/intersect.cu's `kChunk`: the kernel's
counterpart of the TPU kernel's sub-tile). Beside them: `power_limit`
(nvidia-smi), for each timed quantity its `_median`, `_q1`, `_q3` (the
quartiles) and `_n` (the sample count), B1's bound (29 flops a pair at the
H100's FP32 peak, or the bytes at its memory rate) and share of it, and
the kernel launches of the whole run. Times are CUDA events (kernel) or
the host clock around a synchronised trace (`TraceResult.wall_time`).

Knobs, as bench.py's: BENCH_RAYS (rays of sections 1-3, default 524,288)
and BENCH_REPS (timed launches, default 16).

Without a card the command exits non-zero; it never falls back by itself.
`--device cpu` runs bench.py's CPU branch through the plain versions
(4,096 rays, a (48, 24) sphere, 2 reps, the bowl at (48, 12)): a check of
the code, not a measurement. A failed check exits non-zero, says which
and prints no line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from lightpycl_tpu_torch.geometry.primitives import optical_elements
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.ops.intersect import nearest_hit_torch
from lightpycl_tpu_torch.sources import CollimatedSource, light_source
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.engine import Tracer, resolve_device
from lightpycl_tpu_torch.tracer.oracle import trace_oracle
from lightpycl_tpu_torch.tracer.rays import RayBatch
from lightpycl_tpu_torch.tracer.scene import build_scene

# The keys of bench.py's line (bench.py:158-175), in its order.
BENCH_PY_KEYS = ("metric", "value", "unit", "vs_baseline",
                 "rays_per_sec_full_trace", "culled_effective_tests_per_s",
                 "cull_speedup_bowl", "detected_power_parity_rel_err",
                 "n_rays", "n_triangles", "backend", "device", "ray_block",
                 "tri_tile", "tri_sub")

# The timed quantities: each has `_median`, `_q1`, `_q3` and `_n` keys.
TIMED = ("kernel_ms", "full_trace_rays_per_s", "bowl_brute_wall_s",
         "bowl_cull_wall_s")

BENCH_RAYS = 1 << 19      # 524,288 rays (bench.py's default)
BENCH_REPS = 16           # timed launches: at least ten samples
WARM_TRACES = 10          # timed traces of config 1 and each bowl side
HOLD_RAYS = 1 << 16       # headline rays held to the plain version
PARITY_RAYS = 4096        # bench.py's parity co-metric
PARITY_MAX = 1e-3         # BASELINE.md: detected power within 0.1%
LEDGER_TOL = 1e-5         # every ledger closes, cull == brute
BASELINE_TESTS_PER_S = 1e10   # BASELINE.md's headline target

# The least time the card could take for a nearest hit: the flops of the
# kernel's division-free reject test, which every (ray, triangle) pair
# needs (29: 12 FMAs, 3 multiplies, 2 adds; the exact lines run only for
# the few pairs a ray that it keeps, and are left out), at the H100 SXM's
# FP32 peak, or the bytes (o, d, the rows and the mask read once, t and
# tri written once) at its memory rate; NVIDIA's data sheet at 700 W.
FLOPS_PER_PAIR = 29
FP32_FLOP_PER_S = 67e12
HBM_BYTE_PER_S = 3.35e12

# Sizes: the card's (bench.py's TPU branch) and bench.py's CPU branch.
CARD = dict(sphere=(256, 256), bowl=(256, 128), warm=WARM_TRACES,
            bowl_warm=WARM_TRACES)
CPU = dict(rays=1 << 12, sphere=(48, 24), bowl=(48, 12), reps=2, warm=3,
           bowl_warm=1)


class CheckFailed(AssertionError):
    """A check of the bench's own outputs failed."""


def check(cond, what):
    if not cond:
        raise CheckFailed(f"check failed: {what}")


def bound(pairs, n_rays, n_tris, mask_words=0):
    """(bound_ms, bound_by) of a nearest-hit launch over `pairs` pairs."""
    t_ops = FLOPS_PER_PAIR * pairs / FP32_FLOP_PER_S
    t_bytes = (n_rays * 32 + n_tris * 48 + mask_words * 4) / HBM_BYTE_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def launch_times_ms(fn, reps, on_card=True):
    """(times, outputs) of `reps` calls of fn queued back to back: on the
    card each call sits between two CUDA events and one sync ends them all;
    off it the host's clock times each call."""
    outs = []
    if not on_card:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            outs.append(fn())
            times.append((time.perf_counter() - t0) * 1e3)
        return times, outs
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        outs.append(fn())
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)], outs


def cuda_ms(fn, reps=3):
    """Median time of `reps` calls of fn on the card (CUDA events, back to
    back), after one warm-up call."""
    fn()
    return float(np.median(launch_times_ms(fn, reps)[0]))


def spread(name, samples):
    """`name`'s median, quartiles and sample count, as line keys."""
    q1, med, q3 = np.percentile(samples, [25, 50, 75])
    return {f"{name}_median": float(med), f"{name}_q1": float(q1),
            f"{name}_q3": float(q3), f"{name}_n": len(samples)}


def bench_rays(n, seed=0, device="cuda"):
    """The bench's intersect rays (bench.py:57-60): origins in the unit
    cube, isotropic directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def headline_sphere(n_segments=256, n_radial=256):
    """bench.py's "bigmesh": a radius-5 terminator sphere."""
    return optical_elements(n_segments=n_segments, n_radial=n_radial).sphere(
        radius=5.0, material="terminator", name="bigmesh")


def config1_elements():
    """Config 1 (bench.py:109-112): a parabolic mirror and a dome."""
    oe = optical_elements(n_segments=128, n_radial=32)
    return [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.98),
            oe.hemisphere(30.0, name="dome")]


def config1_source(n, seed=7):
    """Config 1's point source (bench.py:113-114; seed 9 for parity)."""
    return light_source(center=(0, 0, 0.5), direction=(0, 0, -1), power=1.0,
                        ray_count=n, seed=seed)


def bowl_elements(n_segments=256, n_radial=128):
    """The coherent bowl (bench.py:127-130): a paraboloid and config 1's
    (128, 32) dome at radius 100."""
    oe = optical_elements(n_segments=n_segments, n_radial=n_radial)
    return [oe.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95),
            optical_elements(n_segments=128, n_radial=32).hemisphere(
                radius=100.0, name="dome")]


def bowl_source(n):
    """The bowl's collimated bundle (bench.py:131-133)."""
    return CollimatedSource(center=(0, 0, 3.0), direction=(0, 0, -1),
                            diameter=3.5, ray_count=n, power=1.0, seed=3)


class MaskedLaunches:
    """Counts a trace's nearest-hit launches and those with a cull mask
    (sits on ops.intersect.intersect.observer while active)."""

    def __init__(self):
        self.all = self.masked = 0

    def __call__(self, scene, o, d, cfg, alive, mask):
        self.all += 1
        self.masked += mask is not None

    def __enter__(self):
        PI.intersect.observer = self
        return self

    def __exit__(self, *exc):
        PI.intersect.observer = None


def power_limit():
    """The card's power limit as nvidia-smi gives it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].rsplit(",", 1)[-1].strip()


def headline(dev, n_rays, reps, sphere):
    """Section 1: B1 at the bench's intersect shape, timed and held."""
    big = headline_sphere(*sphere)
    scene, _ = build_scene([big], device=dev)
    o, d = bench_rays(n_rays, device=dev)
    cfg = TraceConfig()
    args = (scene.wu, scene.wv, scene.ww, cfg.eps, cfg.eps_bary,
            cfg.max_ray_len)
    backend = "cuda" if dev.type == "cuda" else "torch"

    def launch():
        return PI.nearest_hit(o, d, *args, backend=backend)

    t0 = time.perf_counter()
    if dev.type == "cuda":
        PI.load_kernel()  # nvcc at first use, else the library's load
    load_s = time.perf_counter() - t0
    launch()  # warm-up
    times, outs = launch_times_ms(launch, reps, dev.type == "cuda")
    sums = {(int(tri.sum(dtype=torch.int64)),
             float(torch.where(torch.isfinite(t), t, 0.0).sum(
                 dtype=torch.float64))) for t, tri in outs}
    check(len(sums) == 1, f"headline: the {reps} launches' hit checksums "
          f"are identical ({len(sums)} differ)")
    # whole ray blocks of the first launch, spread over the batch
    t_k, i_k = outs[0]
    n_rb = -(-n_rays // PI.RAY_BLOCK)
    take = min(HOLD_RAYS // PI.RAY_BLOCK, n_rb)
    blocks = torch.arange(take, device=dev) * (n_rb // take)
    idx = (blocks[:, None] * PI.RAY_BLOCK
           + torch.arange(PI.RAY_BLOCK, device=dev)).reshape(-1)
    idx = idx[idx < n_rays]
    t_p, i_p = nearest_hit_torch(o[idx], d[idx], *args)
    tri_mismatch = int((i_k[idx] != i_p).sum())
    t_mismatch = int((t_k[idx].view(torch.int32)
                      != t_p.view(torch.int32)).sum())
    check(tri_mismatch == 0 and t_mismatch == 0,
          f"headline: {len(idx)} rays of the timed launch bit for bit equal "
          f"to the plain nearest_hit_torch ({tri_mismatch} triangle indices "
          f"and {t_mismatch} t differ)")
    T = scene.wu.shape[0]
    med_ms = float(np.median(times))
    bound_ms, bound_by = bound(n_rays * T, n_rays, T)
    return {"value": n_rays * big.num_triangles / med_ms * 1e3,
            "n_triangles": big.num_triangles, "reps": reps,
            "kernel_load_s": load_s, **spread("kernel_ms", times),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / med_ms, "held_rays": len(idx)}


def full_trace(dev, n_rays, warm):
    """Section 2: config 1, 8 bounces, device mode; the first dropped."""
    els, src = config1_elements(), config1_source(n_rays)
    tr = Tracer(device=dev)
    rates = []
    for i in range(1 + warm):
        res = tr.trace(src, els, trace_iterations=8, mode="device")
        check(res.power_conservation_error() <= LEDGER_TOL,
              f"config 1 trace {i}: the ledger closes to {LEDGER_TOL}")
        if i > 0:
            rates.append(res.rays_traced / max(res.iterations_run, 1)
                         / max(res.wall_time, 1e-12))
    return {"rays_per_sec_full_trace": max(rates),
            **spread("full_trace_rays_per_s", rates)}


def bowl(dev, n_rays, warm, mesh):
    """Section 3: the bowl with cull off, then on; the first of each
    dropped."""
    els, src = bowl_elements(*mesh), bowl_source(n_rays)
    n_tris = sum(e.num_triangles for e in els)
    walls, measured = {}, {}
    for cull in (False, True):
        tr = Tracer(device=dev)
        walls[cull] = []
        for i in range(1 + warm):
            with MaskedLaunches() as seen:
                res = tr.trace(src, els, trace_iterations=6, mode="device",
                               cull=cull)
            check(seen.all > 0 and seen.masked == (seen.all if cull else 0),
                  f"bowl cull={cull} trace {i}: {seen.masked} of "
                  f"{seen.all} launches carry a cull mask")
            check(res.power_conservation_error() <= LEDGER_TOL,
                  f"bowl cull={cull} trace {i}: the ledger closes to "
                  f"{LEDGER_TOL}")
            if i > 0:
                walls[cull].append(res.wall_time)
        measured[cull] = res.ledger["measured"]
    rel = abs(measured[True] - measured[False]) / max(measured[False], 1e-30)
    check(rel <= LEDGER_TOL, f"bowl: the culled trace measures the brute "
          f"trace's power within {LEDGER_TOL} relative (off by {rel:.3e})")
    return {"culled_effective_tests_per_s":
            n_rays * n_tris * res.iterations_run / min(walls[True]),
            "cull_speedup_bowl": min(walls[False]) / min(walls[True]),
            **spread("bowl_brute_wall_s", walls[False]),
            **spread("bowl_cull_wall_s", walls[True])}


def parity(dev):
    """Section 4: detected power against the float64 oracle."""
    els, src = config1_elements(), config1_source(PARITY_RAYS, seed=9)
    org, dr, pw = src.sample()
    res = Tracer(device=dev).trace(
        src, els, trace_iterations=6,
        rays=RayBatch.from_arrays(org, dr, pw, device=dev))
    ora = trace_oracle(els, org, dr, pw, trace_iterations=6)
    err = (abs(res.ledger["measured"] - ora["measured"])
           / max(ora["measured"], 1e-30))
    check(err <= PARITY_MAX, f"parity: detected power within {PARITY_MAX} "
          f"of the float64 oracle (off by {err:.3e})")
    return {"detected_power_parity_rel_err": err,
            "parity_measured": res.ledger["measured"],
            "parity_oracle_measured": ora["measured"]}


def measure(device="cuda"):
    """Every section on `device`; returns the line as a dict. Raises
    CheckFailed when a check fails."""
    dev = resolve_device(device)  # raises for CUDA without a card
    if dev.type == "cuda":
        n_rays = int(os.environ.get("BENCH_RAYS", BENCH_RAYS))
        reps = int(os.environ.get("BENCH_REPS", BENCH_REPS))
        sizes = CARD
        name = torch.cuda.get_device_name(dev)
    else:
        n_rays, reps, sizes, name = CPU["rays"], CPU["reps"], CPU, "cpu"
    PI.nearest_hit_cuda.launches = PI.nearest_hit_cuda.cull_launches = 0
    out = {"metric": "ray_triangle_tests_per_sec_per_chip", "unit": "tests/s",
           "n_rays": n_rays}
    out.update(headline(dev, n_rays, reps, sizes["sphere"]))
    out["vs_baseline"] = out["value"] / BASELINE_TESTS_PER_S
    out.update(full_trace(dev, n_rays, sizes["warm"]))
    out.update(bowl(dev, n_rays, sizes["bowl_warm"], sizes["bowl"]))
    out.update(parity(dev))
    out.update(backend=dev.type, device=name, ray_block=PI.RAY_BLOCK,
               tri_tile=PI.TRI_TILE, tri_sub=PI.TRI_CHUNK,
               power_limit=power_limit() if dev.type == "cuda" else None,
               kernel_launches=PI.nearest_hit_cuda.launches,
               cull_kernel_launches=PI.nearest_hit_cuda.cull_launches)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: bench.py's CPU sizes on the plain versions")
    ns = ap.parse_args(argv)
    if ns.device == "cuda" and not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; this bench needs "
              "an NVIDIA GPU (--device cpu runs bench.py's CPU sizes on "
              "the plain versions)", file=sys.stderr)
        return 2
    try:
        out = measure(ns.device)
    except CheckFailed as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
