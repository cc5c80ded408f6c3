"""Smoke run of the PyTorch/CUDA port (lightpycl_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's CUDA kernel from csrc/, drives the tracer's main paths
(Tracer.trace in device and host mode at the sizes the repository's bench
uses, and Tracer.trace_batched on BASELINE config 4 at its full 100M rays),
holds the kernel against its plain torch version (also on rays built to sit
on the kernel's reject margin, from edge_rays.py), and checks the physics
(power ledger, detected power, repeatability, checkpoint resume). It prints
the kernel's resources, its times beside their bound, and the profiler's
split of three warm traces. Any failed check raises, so the script exits
non-zero and prints no result. Without a CUDA device it exits non-zero at
once. It imports nothing of JAX.

Output: one line per phase; then the kernel table as JSON, the card's
`nvidia-smi` name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

BENCH_RAYS = 1 << 19      # 524,288 rays (bench.py)
CMP_RAYS = 1 << 16        # 65,536 rays: kernel vs plain comparisons
EDGE_RAYS = 1 << 16       # rays on the reject margin, per scene
EDGE_CULL_RAYS = 1 << 13  # of them, Morton-sorted, through the cull mask
CFG4_BATCH = 4_000_000    # config 4 (benchmarks/baseline_configs.py:117)
CFG4_RAYS = 100_000_000   # BASELINE.json configs[3]
CFG4_CMP_RAYS = 16_000_000  # brute vs culled
SEM_BATCH = 1 << 20       # phase 11: batched semantics, 4 batches
SEM_CMP_BATCH = 1 << 16   # phase 11 (c): kernel vs plain version, 2 batches
BATCH_FIELDS = ("hist", "per_detector", "image", "image_amp", "tri_flux",
                "time_hist", "per_batch_detector")
KERNEL_SRC = "lightpycl_tpu_torch/csrc/intersect.cu"
TPU_KERNEL = "lightpycl_tpu/ops/intersect_pallas.py"

# The least time the card could take for a nearest hit: the flops of the
# kernel's division-free reject test, which every (ray, triangle) pair
# needs (29: 12 FMAs, 3 multiplies, 2 adds; the exact lines run only for
# the few pairs a ray that it keeps, and are left out), at the H100 SXM's
# FP32 peak, or the bytes (o, d, the rows and the mask read once, t and
# tri written once) at its memory rate; NVIDIA's data sheet at 700 W.
FLOPS_PER_PAIR = 29
FP32_FLOP_PER_S = 67e12
HBM_BYTE_PER_S = 3.35e12


def check(cond, what):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def line(phase, **numbers):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps=3):
    """Median wall of `reps` calls of fn on the card (CUDA events), after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(pairs, n_rays, n_tris, mask_words=0):
    """(bound_ms, bound_by) of a nearest-hit launch over `pairs` pairs."""
    t_ops = FLOPS_PER_PAIR * pairs / FP32_FLOP_PER_S
    t_bytes = (n_rays * 32 + n_tris * 48 + mask_words * 4) / HBM_BYTE_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kept_pairs(mask, n_rays, n_tris, ray_block, tri_tile):
    """(ray, triangle) pairs in the (ray block, triangle tile) pairs the
    bit-packed cull mask keeps."""
    n_rb = -(-n_rays // ray_block)
    n_tt = -(-n_tris // tri_tile)
    words = mask.view(n_rb, -1).to(torch.int64) & 0xFFFFFFFF
    bits = torch.stack([(words >> k) & 1 for k in range(32)], dim=2)
    bits = bits.reshape(n_rb, -1)[:, :n_tt].to(torch.float64)
    rays = torch.clamp(n_rays - ray_block * torch.arange(
        n_rb, device=mask.device), max=ray_block).to(torch.float64)
    tris = torch.clamp(n_tris - tri_tile * torch.arange(
        n_tt, device=mask.device), max=tri_tile).to(torch.float64)
    return int(rays @ bits @ tris)


def profile_trace(fn, top=3):
    """Device time of one trace fn() under torch.profiler: the nearest-hit
    kernel's and the rest's (with its `top` largest ops); beside it the
    trace's own wall (TraceResult.wall_time) from a call without the
    profiler, and the device's idle share of that wall."""
    from torch.profiler import ProfilerActivity, profile

    wall = fn().wall_time * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    kern, rest, tops = 0.0, 0.0, []
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA":
            continue
        ms = getattr(ev, "device_time_total", None)
        if ms is None:
            ms = getattr(ev, "cuda_time_total", 0.0)
        ms /= 1e3
        if ms <= 0:
            continue
        if "nearest_hit_kernel" in ev.key:
            kern += ms
        else:
            rest += ms
            tops.append((ms, ev.key[:40].replace(" ", "_")))
    tops.sort(reverse=True)
    return {"trace_wall_ms": wall, "bounces": res.iterations_run,
            "kernel_ms": kern, "rest_ms": rest, "busy_ms": kern + rest,
            "idle_share": f"{1 - (kern + rest) / wall:.4f}",
            "top_rest": ",".join(f"{k}:{ms:.3f}" for ms, k in tops[:top])}


def same_batched(a, b):
    """Two trace_batched results equal bit for bit in every accumulator and
    the ledger."""
    return a.ledger == b.ledger and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in BATCH_FIELDS)


def bench_rays(n, seed=0):
    """The bench's intersect rays (bench.py): origins in the unit cube,
    isotropic directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import lightpycl_tpu_torch as P
    from edge_rays import edge_rays
    from lightpycl_tpu_torch.ops import _build
    from lightpycl_tpu_torch.ops import intersect as PI
    from lightpycl_tpu_torch.tracer import step as S

    kind = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    line("1 env", card=repr(smi), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=repr(nvcc))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build the kernel from the checkout's sources ------------------
    t0 = time.perf_counter()
    lib = PI.load_kernel()
    build_s = time.perf_counter() - t0
    line("2 build", seconds=f"{build_s:.3f}",
         library=_build.library_path("intersect.cu", dict(PI._DEFINES)).name)
    attrs = [ctypes.c_int() for _ in range(5)]
    check(lib.lpcl_nearest_hit_resources(*map(ctypes.byref, attrs)) == 0,
          "kernel resources readable")
    regs, smem, local, threads, ctas = (a.value for a in attrs)
    line("2 resources", registers=regs, static_smem_bytes=smem,
         local_bytes=local, threads=threads, ctas_per_sm=ctas)
    for ptx in _build.ptxas_report("intersect.cu", PI._DEFINES):
        if ptx.strip():
            print(f"[2 ptxas] {ptx.strip()}", flush=True)
    check(local == 0, "no local memory (no register spills)")

    # ---- 3. B1 kernel vs plain at the bench's intersect shape -------------
    big = P.optical_elements(256, 256).sphere(5.0, material="terminator",
                                              name="bigmesh")
    scene, _ = P.build_scene([big], device="cuda")
    n_tris = big.num_triangles
    o, d = bench_rays(BENCH_RAYS)
    args = (scene.wu, scene.wv, scene.ww, 1e-4, 1e-6, 1e3)
    t_k, i_k = PI.nearest_hit_cuda(o[:CMP_RAYS], d[:CMP_RAYS], *args)
    t_p, i_p = PI.nearest_hit_torch(o[:CMP_RAYS], d[:CMP_RAYS], *args)
    torch.cuda.synchronize()
    n_idx = int((i_k != i_p).sum())
    n_bits = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    fin = torch.isfinite(t_p)
    b1_err = float((t_k[fin] - t_p[fin]).abs().max())
    line("3 B1 compare", rays=CMP_RAYS, triangles=n_tris,
         hits=int((i_k >= 0).sum()), tri_mismatch=n_idx,
         t_bit_mismatch=n_bits, max_abs_err=b1_err)
    check(n_idx == 0, "B1 tri identical to the plain version")
    check(n_bits == 0, "B1 t bitwise equal to the plain version")
    b1_ms = cuda_ms(lambda: PI.nearest_hit_cuda(o, d, *args))
    b1_plain_ms = cuda_ms(lambda: PI.nearest_hit_torch(
        o[:CMP_RAYS], d[:CMP_RAYS], *args))
    T = scene.wu.shape[0]
    b1_bound_ms, b1_bound_by = bound(BENCH_RAYS * T, BENCH_RAYS, T)
    line("3 B1 time", kernel_ms=b1_ms, kernel_rays=BENCH_RAYS,
         kernel_tests_per_s=f"{BENCH_RAYS * n_tris / b1_ms * 1e3:.4e}",
         bound_ms=b1_bound_ms, bound_by=b1_bound_by,
         share_of_bound=f"{b1_bound_ms / b1_ms:.4f}",
         plain_ms=b1_plain_ms, plain_rays=CMP_RAYS,
         plain_tests_per_s=f"{CMP_RAYS * n_tris / b1_plain_ms * 1e3:.4e}")
    del o, d

    # ---- scenes of the main path (bench.py configs) ------------------------
    oe2 = P.optical_elements(n_segments=128, n_radial=32)
    cfg1_els = [oe2.parabolic_mirror(0.5, 2.0, reflectivity=0.98),
                oe2.hemisphere(30.0, name="dome")]

    def cfg1_src(n):
        return P.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                              power=1.0, ray_count=n, seed=7)

    oe_b = P.optical_elements(n_segments=256, n_radial=128)
    bowl = [oe_b.parabolic_mirror(focus=1.0, diameter=4.0,
                                  reflectivity=0.95),
            oe2.hemisphere(radius=100.0, name="dome")]
    bowl_src = P.CollimatedSource(center=(0, 0, 3.0), direction=(0, 0, -1),
                                  diameter=3.5, ray_count=BENCH_RAYS,
                                  power=1.0, seed=3)
    oe3 = P.optical_elements(n_segments=32, n_radial=12)
    cfg3_els = [oe3.biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
                oe3.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate(
                    (0, 0, 0.5)),
                oe3.sphere(radius=6.0, material="measure", name="enclosure")]
    cfg3_src = P.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                                  diameter=0.5, ray_count=CMP_RAYS,
                                  power=1.0, seed=23)

    # ---- the main path, counted: the kernel must carry it -----------------
    PI.nearest_hit_cuda.launches = 0
    PI.nearest_hit_cuda.cull_launches = 0
    res1 = P.Tracer().trace(cfg1_src(BENCH_RAYS), cfg1_els,
                            trace_iterations=8, mode="device")
    tr_b = P.Tracer()
    res_cull = tr_b.trace(bowl_src, bowl, trace_iterations=6, mode="device")
    res3 = P.Tracer().trace(cfg3_src, cfg3_els, trace_iterations=5,
                            capacity=4 * CMP_RAYS, mode="host")
    torch.cuda.synchronize()
    launches = PI.nearest_hit_cuda.launches
    cull_launches = PI.nearest_hit_cuda.cull_launches
    check(tr_b._scene_sorted, "auto-cull turned on for the collimated bowl")

    # ---- 4. config 1 ------------------------------------------------------
    emitted = res1.ledger["emitted"]
    check(res1.power_conservation_error() <= 1e-5, "config 1 ledger closes")
    check(abs(res1.ledger["measured"] - 0.98) <= 5e-3,
          "config 1 detects the mirror's 0.98")
    check(np.isfinite(res1.hist).all() and res1.hist.shape == (36, 18),
          "config 1 histogram finite, (36, 18)")
    rates = []
    for _ in range(3):
        again = P.Tracer().trace(cfg1_src(BENCH_RAYS), cfg1_els,
                                 trace_iterations=8, mode="device")
        check(np.array_equal(again.hist, res1.hist)
              and np.array_equal(again.per_detector, res1.per_detector)
              and again.ledger == res1.ledger,
              "config 1 repeat run bit-identical")
        rates.append(again.rays_traced / max(again.iterations_run, 1)
                     / max(again.wall_time, 1e-12))
    small = {b: P.Tracer().trace(cfg1_src(CMP_RAYS), cfg1_els,
                                 trace_iterations=8, mode="device",
                                 backend=b) for b in ("cuda", "torch")}
    check(small["cuda"].ledger == small["torch"].ledger
          and np.array_equal(small["cuda"].hist, small["torch"].hist),
          "config 1 kernel ledger equal to backend='torch'")
    line("4 config1", rays=BENCH_RAYS, iterations=res1.iterations_run,
         measured=res1.ledger["measured"], emitted=emitted,
         conservation_err=res1.power_conservation_error(),
         first_wall_s=res1.wall_time,
         rays_per_sec_full_trace=f"{max(rates):.6e}",
         rates=",".join(f"{r:.4e}" for r in rates))

    # ---- 5. config 3: splitting + top-k, host mode -------------------------
    check(res3.power_conservation_error() <= 1e-5, "config 3 ledger closes")
    plain3 = P.Tracer().trace(cfg3_src, cfg3_els, trace_iterations=5,
                              capacity=4 * CMP_RAYS, mode="host",
                              backend="torch")
    check(res3.ledger == plain3.ledger
          and np.array_equal(res3.hist, plain3.hist)
          and np.array_equal(res3.measured_pos, plain3.measured_pos),
          "config 3 kernel equal to backend='torch'")
    line("5 config3", rays=CMP_RAYS, capacity=4 * CMP_RAYS,
         iterations=res3.iterations_run, measured=res3.ledger["measured"],
         culled=res3.ledger["culled"], measured_rays=len(res3.measured_power),
         conservation_err=res3.power_conservation_error(),
         wall_s=res3.wall_time, plain_wall_s=plain3.wall_time)

    # ---- 6. B2: cull vs brute on the coherent bowl -------------------------
    res_brute = P.Tracer().trace(bowl_src, bowl, trace_iterations=6,
                                 mode="device", cull=False)
    for k, v in res_brute.ledger.items():
        check(abs(res_cull.ledger[k] - v) <= 1e-6 * max(abs(v), emitted),
              f"bowl ledger[{k}] cull vs brute to 1e-6")
    walls = {True: [res_cull.wall_time], False: [res_brute.wall_time]}
    for cull in (False, True, True, False):
        walls[cull].append(P.Tracer().trace(
            bowl_src, bowl, trace_iterations=6, mode="device",
            cull=cull).wall_time)
    # first bounce, per ray, after undoing the Morton permutation
    scene_b = tr_b.scene
    rays = P.RayBatch.from_arrays(*bowl_src.sample(), device="cuda")
    order = S.morton_permutation(scene_b, rays)
    srt = rays.permuted(order)
    cfg_c = P.TraceConfig(cull=True)
    t_c, i_c = PI.intersect(scene_b, srt.o, srt.d, cfg_c, alive=srt.alive)
    t_b, i_b = PI.intersect(scene_b, rays.o, rays.d,
                            cfg_c.replace(cull=False))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), device=order.device)
    check(torch.equal(i_c[inv], i_b) and torch.equal(t_c[inv], t_b),
          "bowl first bounce: culled (t, tri) == brute per ray")
    # B2 vs its plain version (same mask) on the first 32 ray blocks
    nb = 32 * PI.RAY_BLOCK
    bargs = (scene_b.wu, scene_b.wv, scene_b.ww, 1e-4, 1e-6, 1e3)
    mask = PI.block_tile_mask(scene_b, srt.o[:nb], srt.d[:nb], 1e3,
                              alive=srt.alive[:nb])
    t2k, i2k = PI.nearest_hit_cuda(srt.o[:nb], srt.d[:nb], *bargs, mask=mask)
    t2p, i2p = PI.nearest_hit_torch(srt.o[:nb], srt.d[:nb], *bargs,
                                    mask=mask)
    torch.cuda.synchronize()
    check(torch.equal(i2k, i2p) and torch.equal(t2k, t2p),
          "B2 bitwise equal to its plain version")
    fin = torch.isfinite(t2p)
    b2_err = float((t2k[fin] - t2p[fin]).abs().max()) if fin.any() else 0.0
    full_mask = PI.block_tile_mask(scene_b, srt.o, srt.d, 1e3,
                                   alive=srt.alive)
    kept = float(torch.cat([((full_mask >> k) & 1) for k in range(32)])
                 .sum()) / (-(-BENCH_RAYS // PI.RAY_BLOCK)
                            * -(-scene_b.num_triangles_padded // PI.TRI_TILE))
    b2_ms = cuda_ms(lambda: PI.nearest_hit_cuda(srt.o, srt.d, *bargs,
                                                mask=full_mask))
    b2_brute_ms = cuda_ms(lambda: PI.nearest_hit_cuda(srt.o, srt.d, *bargs))
    b2_plain_ms = cuda_ms(lambda: PI.nearest_hit_torch(
        srt.o[:nb], srt.d[:nb], *bargs, mask=mask), reps=1)
    Tb = scene_b.wu.shape[0]
    b2_pairs = kept_pairs(full_mask, BENCH_RAYS, Tb, PI.RAY_BLOCK,
                          PI.TRI_TILE)
    b2_bound_ms, b2_bound_by = bound(b2_pairs, BENCH_RAYS, Tb,
                                     full_mask.numel())
    line("6 bowl cull", rays=BENCH_RAYS, triangles=scene_b.num_triangles_padded,
         iterations=res_cull.iterations_run,
         measured=res_cull.ledger["measured"],
         wall_brute_s=min(walls[False]), wall_cull_s=min(walls[True]),
         cull_speedup=f"{min(walls[False]) / min(walls[True]):.4f}",
         pairs_kept=f"{kept:.4f}",
         b2_first_bounce_ms=b2_ms, b1_first_bounce_ms=b2_brute_ms,
         b2_pairs=b2_pairs, bound_ms=b2_bound_ms, bound_by=b2_bound_by,
         share_of_bound=f"{b2_bound_ms / b2_ms:.4f}",
         b2_plain_ms=b2_plain_ms, b2_plain_rays=nb)

    # ---- 7. the main path went through the kernel --------------------------
    line("7 kernel use", launches=launches, cull_launches=cull_launches)
    check(launches - cull_launches > 0, "brute kernel launched on the path")
    check(cull_launches > 0, "cull kernel launched on the path")

    # ---- 8. rays on the kernel's reject margin ----------------------------
    # aimed at vertices, shared-edge midpoints and centroids, grazing in a
    # triangle's plane, starting on a triangle; over the bench sphere, the
    # Morton-sorted bowl and two coincident copies of a mesh; isotropic
    # through the brute kernel, and as a Morton-sorted, nearly parallel
    # bundle through the cull kernel
    twin = P.optical_elements(64, 32).sphere(2.0, material="terminator")
    scene_t, _ = P.build_scene([twin, twin], device="cuda")
    for name, sc in (("sphere", scene), ("bowl", scene_b), ("twin", scene_t)):
        eo, ed = edge_rays(sc, EDGE_RAYS, seed=5)
        eargs = (sc.wu, sc.wv, sc.ww, 1e-4, 1e-6, 1e3)
        t_k, i_k = PI.nearest_hit_cuda(eo, ed, *eargs)
        t_p, i_p = PI.nearest_hit_torch(eo, ed, *eargs)
        bo, bd = edge_rays(sc, EDGE_RAYS, seed=6, direction=(0, 0, -1))
        order = S.morton_permutation(sc, types.SimpleNamespace(
            o=bo, alive=torch.ones(EDGE_RAYS, dtype=torch.bool,
                                   device="cuda")))[:EDGE_CULL_RAYS]
        co, cd = bo[order].contiguous(), bd[order].contiguous()
        emask = PI.block_tile_mask(sc, co, cd, 1e3)
        tc_k, ic_k = PI.nearest_hit_cuda(co, cd, *eargs, mask=emask)
        tc_p, ic_p = PI.nearest_hit_torch(co, cd, *eargs, mask=emask)
        torch.cuda.synchronize()
        mism = {"brute_tri": int((i_k != i_p).sum()),
                "brute_t_bits": int((t_k.view(torch.int32)
                                     != t_p.view(torch.int32)).sum()),
                "cull_tri": int((ic_k != ic_p).sum()),
                "cull_t_bits": int((tc_k.view(torch.int32)
                                    != tc_p.view(torch.int32)).sum())}
        e_kept = kept_pairs(emask, EDGE_CULL_RAYS, sc.wu.shape[0],
                            PI.RAY_BLOCK, PI.TRI_TILE) / (
            EDGE_CULL_RAYS * sc.wu.shape[0])
        line(f"8 edge rays {name}", rays=EDGE_RAYS, cull_rays=EDGE_CULL_RAYS,
             triangles=sc.wu.shape[0], hits=int((i_k >= 0).sum()),
             cull_pairs_kept=f"{e_kept:.4f}", **mism)
        check(sum(mism.values()) == 0,
              f"edge rays on {name}: kernel bitwise equal to the plain "
              "version, brute and culled")
        check(int((i_k >= 0).sum()) > EDGE_RAYS // 4,
              f"edge rays on {name} hit")
        if name == "twin":
            check(bool(((i_k >= 0) <= (i_k < twin.num_triangles)).all()),
                  "coincident copies: the lowest index wins")

    # ---- 9. where the device time goes (torch.profiler, warm traces) -----
    for name, src, els in (("config1", cfg1_src(BENCH_RAYS), cfg1_els),
                           ("bowl_cull", bowl_src, bowl)):
        split = profile_trace(lambda: P.Tracer().trace(
            src, els, trace_iterations=8, mode="device"))
        check(split["kernel_ms"] > 0, f"{name}: profiler saw the kernel")
        line(f"9 profile {name}", **split)

    # ---- 10. config 4 at full size: trace_batched, the mega-batch path ----
    oe4 = P.optical_elements(360, 180)
    cfg4_els = [oe4.parabolic_mirror(focus=1.0, diameter=4.0,
                                     reflectivity=0.95),
                P.optical_elements(128, 32).hemisphere(radius=100.0,
                                                       name="dome")]
    src4 = P.CollimatedSource(center=(0, 0, 5), direction=(0, 0, -1),
                              diameter=3.5, power=1.0)

    def cfg4(total, cull, **kw):
        tr = P.Tracer(P.TraceConfig(trace_iterations=4, cull=cull))
        res = tr.trace_batched(src4, total_rays=total, batch_size=CFG4_BATCH,
                               elements=cfg4_els, **kw)
        return tr, res

    t0 = time.perf_counter()
    cfg4(CFG4_BATCH, None)  # one batch: first-use costs
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PI.nearest_hit_cuda.launches = 0
    PI.nearest_hit_cuda.cull_launches = 0
    tr4, res4 = cfg4(CFG4_RAYS, None)
    torch.cuda.synchronize()
    launches4 = PI.nearest_hit_cuda.launches
    cull_launches4 = PI.nearest_hit_cuda.cull_launches
    peak4 = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    cfg4(CFG4_BATCH, None)
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tris4 = tr4.num_triangles
    led4 = res4.ledger
    check(tr4._scene_sorted and cull_launches4 > 0,
          "config 4: auto-cull resolved on")
    check(res4.power_conservation_error() <= 1e-5, "config 4 ledger closes")
    check(abs(led4["measured"] - 0.95) <= 1e-3, "config 4 measures 0.95")
    check(abs(res4.hist.sum() - led4["measured"]) <= 1e-4 * led4["measured"],
          "config 4 histogram sums to the measured power")
    check(np.isfinite(res4.detector_stderr("dome")),
          "config 4 per-batch standard error finite")
    check(peak4 <= 1.25 * warm_peak,
          "config 4 device memory does not grow from batch to batch")
    line("10 config4 100M", rays=CFG4_RAYS, batches=CFG4_RAYS // CFG4_BATCH,
         triangles=n_tris4, iterations=res4.iterations_run,
         measured=led4["measured"], emitted=led4["emitted"],
         conservation_err=res4.power_conservation_error(),
         stderr_dome=res4.detector_stderr("dome"), wall_s=res4.wall_time,
         tests_per_s=f"{res4.intersection_tests / res4.wall_time:.4e}",
         rays_per_s=f"{CFG4_RAYS / res4.wall_time:.4e}",
         launches=launches4, cull_launches=cull_launches4,
         peak_mem_gib=f"{peak4:.3f}", one_batch_peak_mem_gib=f"{warm_peak:.3f}",
         warmup_batch_s=f"{warm_s:.3f}")
    res16 = {}
    for cull in (False, None):
        PI.nearest_hit_cuda.launches = 0
        PI.nearest_hit_cuda.cull_launches = 0
        _, res16[cull] = cfg4(CFG4_CMP_RAYS, cull)
        torch.cuda.synchronize()
        launches4 += PI.nearest_hit_cuda.launches
        cull_launches4 += PI.nearest_hit_cuda.cull_launches
        r = res16[cull]
        check(r.power_conservation_error() <= 1e-5,
              f"config 4 16M cull={cull} ledger closes")
        line(f"10 config4 16M cull={cull}", rays=CFG4_CMP_RAYS,
             iterations=r.iterations_run, measured=r.ledger["measured"],
             wall_s=r.wall_time,
             tests_per_s=f"{r.intersection_tests / r.wall_time:.4e}",
             rays_per_s=f"{CFG4_CMP_RAYS / r.wall_time:.4e}",
             launches=PI.nearest_hit_cuda.launches,
             cull_launches=PI.nearest_hit_cuda.cull_launches)
    for k, v in res16[False].ledger.items():
        check(abs(res16[None].ledger[k] - v) <= 1e-6 * max(abs(v), 1.0),
              f"config 4 16M ledger[{k}] cull vs brute to 1e-6")
    line("10 config4 cull", cull_speedup_config4=(
        f"{res16[False].wall_time / res16[None].wall_time:.4f}"))

    # ---- 11. batched semantics on the card: maps, roulette, resume -------
    sem_src = P.CollimatedSource(center=(0, 0, 5), direction=(0, 0, -1),
                                 diameter=3.5, power=1.0, sampling="random")
    # roulette above the per-ray child power (0.95 / 2^22 = 2.3e-7); the
    # OPL window around the source -> dish -> dome path (~104-106); the
    # image plane z = 0, normal to the axis, wide enough for every dome hit
    sem_kw = dict(trace_iterations=4, seed=11, roulette_threshold=5e-7,
                  time_bins=64, opl_min=95.0, opl_max=115.0, flux_map=True,
                  image_bins=128, coherent=True, image_center=(0, 0, 0),
                  image_normal=(0, 0, 1), image_halfwidth=100.0)

    def sem(total, batch, **kw):
        args = dict(sem_kw)
        args.update(kw)
        return P.Tracer().trace_batched(sem_src, total_rays=total,
                                        batch_size=batch, elements=cfg4_els,
                                        **args)

    a = sem(4 * SEM_BATCH, SEM_BATCH)
    check(a.power_conservation_error() <= 1e-5, "phase 11 ledger closes")
    check(same_batched(a, sem(4 * SEM_BATCH, SEM_BATCH)),
          "phase 11 (a): repeat run bit-identical")
    no_rr = sem(4 * SEM_BATCH, SEM_BATCH, roulette_threshold=0.0)
    check(no_rr.ledger["measured"] != a.ledger["measured"],
          "phase 11: roulette acted")
    check(abs(a.time_hist.sum() - a.ledger["measured"])
          <= 1e-4 * a.ledger["measured"] and a.image_amp.shape == (2, 128, 128)
          and a.tri_flux.shape == (n_tris4,),
          "phase 11 maps hold the measured power")
    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/run"
        part = sem(4 * SEM_BATCH, SEM_BATCH, checkpoint_path=ck,
                   max_batches=2)
        resumed = sem(4 * SEM_BATCH, SEM_BATCH, checkpoint_path=ck)
    check(part.per_batch_detector.shape[0] == 2 and same_batched(a, resumed),
          "phase 11 (b): interrupted + resumed == uninterrupted")
    kern = sem(2 * SEM_CMP_BATCH, SEM_CMP_BATCH)
    plain = sem(2 * SEM_CMP_BATCH, SEM_CMP_BATCH, backend="torch")
    check(same_batched(kern, plain),
          "phase 11 (c): backend='cuda' == backend='torch'")
    line("11 batched semantics", rays=4 * SEM_BATCH,
         measured=a.ledger["measured"], measured_no_roulette=no_rr.ledger[
             "measured"], culled=a.ledger["culled"],
         image_coherent_max=float(a.image_coherent.max()),
         time_hist_peak_bin=int(a.time_hist.argmax()),
         repeat_equal=True, resume_equal=True, kernel_equals_plain=True,
         plain_rays=2 * SEM_CMP_BATCH, plain_wall_s=plain.wall_time,
         kernel_wall_s=kern.wall_time)

    # ---- 12. where config 4's device time goes (one warm batch) ----------
    split4 = profile_trace(lambda: cfg4(CFG4_BATCH, None)[1], top=6)
    check(split4["kernel_ms"] > 0, "config 4: profiler saw the kernel")
    line("12 profile config4", **split4)

    table = {"kernels": [
        {"name": "nearest_hit (B1, brute)", "route": "cuda",
         "source": KERNEL_SRC, "replaces": f"{TPU_KERNEL}:154",
         "launches": launches - cull_launches + launches4 - cull_launches4,
         "launches_trace_batched": launches4 - cull_launches4,
         "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound_ms,
         "bound_by": b1_bound_by, "share_of_bound": b1_bound_ms / b1_ms,
         "library_ms": None,
         "rays": BENCH_RAYS, "plain_rays": CMP_RAYS, "triangles": n_tris},
        {"name": "nearest_hit (B2, cull)", "route": "cuda",
         "source": KERNEL_SRC, "replaces": f"{TPU_KERNEL}:185",
         "launches": cull_launches + cull_launches4,
         "launches_trace_batched": cull_launches4, "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound_ms,
         "bound_by": b2_bound_by, "share_of_bound": b2_bound_ms / b2_ms,
         "library_ms": None, "pairs": b2_pairs,
         "rays": BENCH_RAYS, "plain_rays": nb,
         "triangles": scene_b.num_triangles_padded},
    ]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
