"""Time the nearest hit's epilogue variants against each other.

Port counterpart of benchmarks/micro_variants.py (`micro_variants`) and
benchmarks/epilogue_variants.py (`epilogue_variants`): the bench's
intersect shape (a 256 x 256 sphere of 130,560 triangles, 524,288 rays
with origins in the unit cube and isotropic directions), each variant of
ops/intersect_variants.py launched over it, its time, its tests a second
and whether its (t, tri) equal the first variant's bit for bit, which each
of them must (`recip` rounds twice where the others divide once: it is held
to the same hit rays and t within RECIP_RTOL; where a ray crosses an edge
that two triangles share, both are hits a rounding apart and its last bit
may pick the other one, which `tri_mismatch` counts).

    python -m lightpycl_tpu_torch.variant_bench [--rays N] [--segments S]
        [--radial R] [--reps K] [--device cuda|cpu]

On CUDA tensors the variants run their CUDA kernels; on the CPU (small
shapes only) their plain torch version, timed on the host's clock.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lightpycl_tpu_torch.geometry.primitives import optical_elements
from lightpycl_tpu_torch.ops import intersect_variants as IV
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.engine import resolve_device
from lightpycl_tpu_torch.tracer.scene import build_scene

BENCH_RAYS = 1 << 19
# -OW * (1 / DW) against -OW / DW: two roundings against one, 1.5 ulp
RECIP_RTOL = 2.0 ** -22


def bench_inputs(n_rays: int = BENCH_RAYS, n_segments: int = 256,
                 n_radial: int = 256, seed: int = 0, device="cuda"):
    """(o, d, wu, wv, ww, n_triangles): the reference scripts' rays and
    sphere (radius 5, terminator) on `device`."""
    device = resolve_device(device)
    big = optical_elements(n_segments=n_segments, n_radial=n_radial).sphere(
        radius=5.0, material="terminator")
    scene, _ = build_scene([big], device=device)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
            scene.wu, scene.wv, scene.ww, big.num_triangles)


def _time_ms(fn, reps: int, device: torch.device) -> float:
    """Median time of `reps` calls after one warm-up: CUDA events on the
    card, the host's clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_variants(names, inputs, ray_block: int = 256, reps: int = 3):
    """One row per variant of `names`, in order: {'variant', 'ms',
    'tests_per_s', 'identical', 'tri_mismatch', 'max_rel_dt', 'hits',
    'ok'}; `identical` compares (t, tri) with the first variant's, bit for
    bit; `ok` is `identical`, or for `recip` the same rays hit and t within
    RECIP_RTOL."""
    o, d, wu, wv, ww, n_tris = inputs
    cfg = TraceConfig()
    args = (wu, wv, ww, cfg.eps, cfg.eps_bary, cfg.max_ray_len)
    rows, ref = [], None
    for name in names:
        def call(name=name):
            return IV.nearest_hit_variant(o, d, *args, variant=name,
                                          ray_block=ray_block)
        t, tri = call()
        if ref is None:
            ref = (t, tri)
        ms = _time_ms(call, reps, o.device)
        identical = bool(torch.equal(t, ref[0]) and torch.equal(tri, ref[1]))
        tri_mismatch = int((tri != ref[1]).sum())
        both = (tri >= 0) & (ref[1] >= 0)
        same_rays = bool(torch.equal(tri >= 0, ref[1] >= 0))
        rel = (((t - ref[0]).abs() / ref[0])[both].max().item()
               if both.any() else 0.0)
        rows.append({"variant": name, "ms": ms,
                     "tests_per_s": o.shape[0] * n_tris / ms * 1e3,
                     "identical": identical, "tri_mismatch": tri_mismatch,
                     "max_rel_dt": rel, "hits": int((tri >= 0).sum()),
                     "ok": identical or (name == "recip" and same_rays
                                         and rel <= RECIP_RTOL)})
    return rows


def micro_variants(inputs=None, device="cuda", **kw):
    """The rounds of benchmarks/micro_variants.py that translate: guarded
    base, reciprocal, unguarded IEEE, 2 / 4 / 8 tiles a step, the running
    best in registers; 256 rays a block."""
    inputs = bench_inputs(device=device) if inputs is None else inputs
    return run_variants(IV.MICRO_VARIANTS, inputs, ray_block=256, **kw)


def epilogue_variants(inputs=None, device="cuda", **kw):
    """benchmarks/epilogue_variants.py: at 64 rays a block and 16 tiles a
    step, the shipped epilogue against `notmax`, `min2` and both."""
    inputs = bench_inputs(device=device) if inputs is None else inputs
    return run_variants(IV.EPILOGUE_VARIANTS, inputs, ray_block=64, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=BENCH_RAYS)
    ap.add_argument("--segments", type=int, default=256)
    ap.add_argument("--radial", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    inputs = bench_inputs(ns.rays, ns.segments, ns.radial, device=ns.device)
    ok = True
    for title, fn in (("micro_variants", micro_variants),
                      ("epilogue_variants", epilogue_variants)):
        rows = fn(inputs, reps=ns.reps)
        base = rows[0]["tests_per_s"]
        for r in rows:
            ok &= r["ok"]
            print(f"{title} {r['variant']:12s}: {r['ms']:9.3f} ms  "
                  f"{r['tests_per_s']:.3e} tests/s  "
                  f"{r['tests_per_s'] / base:.3f}x  "
                  f"identical={r['identical']} "
                  f"tri_mismatch={r['tri_mismatch']} "
                  f"max_rel_dt={r['max_rel_dt']:.3e}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
