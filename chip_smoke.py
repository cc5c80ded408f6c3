"""Smoke run of the PyTorch/CUDA port (lightpycl_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc a source, started
together), drives the tracer's main paths
(Tracer.trace in device and host mode at the sizes the repository's bench
uses, Tracer.trace_batched on BASELINE config 4 at its full 100M rays, and
the surface and volume physics at 524,288 rays: a polarized beam through a
coated doublet onto a silver mirror and a grating; a diffuser, a rough
mirror and a turbid fluorescent slab; an exact quadric lens beside its
mesh; a gradient-index rod; Tracer.trace_spectral at the spectral benches'
shapes: 32 wavelengths through a coated high reflector in one geometry
pass, 16 through a dispersive prism wavelength-batched, and the white-light
Michelson's per-wavelength field planes) and the epilogue-variant bench
(variant_bench.micro_variants / epilogue_variants at the bench's intersect
shape), holds every kernel against its plain torch version (the nearest-hit
kernel also on rays built to sit on its reject margin, from edge_rays.py,
and on the rays and cull masks that the physics traces and config 4 really
launch it with), and checks the physics (power ledger, detected power,
statistics of the random branches, repeatability, checkpoint resume). It
prints the kernel's resources, its times beside their bound, and the
profiler's split of six warm traces. Any failed check raises, so the script exits
non-zero and prints no result. Without a CUDA device it exits non-zero at
once. It imports nothing of JAX.

Output: one line per phase; then the kernel table as JSON, the card's
`nvidia-smi` name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

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
PHYS_CMP_RAYS = 1 << 12   # phase 13: kernel vs plain version, whole trace
BATCH_FIELDS = ("hist", "per_detector", "image", "image_amp", "tri_flux",
                "time_hist", "per_batch_detector")
KERNEL_SRC = "lightpycl_tpu_torch/csrc/intersect.cu"
TPU_KERNEL = "lightpycl_tpu/ops/intersect_pallas.py"
VARIANT_SRC = "lightpycl_tpu_torch/csrc/intersect_variants.cu"
TPU_MICRO = "benchmarks/micro_variants.py:173"
TPU_EPILOGUE = "benchmarks/epilogue_variants.py:120"

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


_T0 = time.perf_counter()


def line(phase, **numbers):
    """One phase line; `at_s` is the script's own clock when it prints."""
    numbers["at_s"] = f"{time.perf_counter() - _T0:.1f}"
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


class LaunchTap:
    """While active, keeps (cloned) what a trace gives the nearest hit at
    the chosen launches of a run (0 = the first bounce): the scene, the
    rays as launched, the cfg, the alive flags and the cull mask. Sits on
    ops.intersect.intersect.observer."""

    def __init__(self, PI, keep):
        self.PI, self.keep, self.n, self.kept = PI, set(keep), 0, {}

    def __call__(self, scene, o, d, cfg, alive, mask):
        if self.n in self.keep:
            self.kept[self.n] = (
                scene, o.clone(), d.clone(), cfg,
                torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
                if alive is None else alive.clone(),
                None if mask is None else mask.clone())
        self.n += 1

    def __enter__(self):
        self.PI.intersect.observer = self
        return self

    def __exit__(self, *exc):
        self.PI.intersect.observer = None


def hold_to_plain(PI, phase, bounce, launch, n_rays=CMP_RAYS):
    """One launch of a main path, as a LaunchTap kept it, made again: the
    kernel with the launch's own cull mask on `n_rays` of its rays (whole
    ray blocks spread evenly over the launch) against the plain version
    without a mask, (t, tri) of every live ray bitwise. The mask never
    changes a live ray's result, so the plain version's culled path (a
    Python loop over (ray block, tile) pairs, minutes on 2,056 tiles) is
    not needed. Dead slots are left out: the mask is built from the live
    rays only."""
    scene, o, d, cfg, alive, mask = launch
    RB, C, T = PI.RAY_BLOCK, o.shape[0], scene.wu.shape[0]
    n_rb = C // RB
    check(n_rb > 0, f"phase {phase}: the launch holds a whole ray block")
    n_sel = min(n_rays // RB, n_rb)
    sel = torch.arange(n_sel, device=o.device) * (n_rb // n_sel)

    def blocks(x):
        x = x[:n_rb * RB].reshape(n_rb, RB, *x.shape[1:])[sel]
        return x.reshape(n_sel * RB, *x.shape[2:]).contiguous()

    ob, db, live = blocks(o), blocks(d), blocks(alive)
    mk = (None if mask is None else
          mask.view(-(-C // RB), -1)[sel].reshape(-1).contiguous())
    args = (scene.wu, scene.wv, scene.ww, cfg.eps, cfg.eps_bary,
            cfg.max_ray_len)
    t_k, i_k = PI.nearest_hit_cuda(ob, db, *args, mask=mk)
    t_p, i_p = PI.nearest_hit_torch(ob, db, *args)
    torch.cuda.synchronize()
    tri_mismatch = int(((i_k != i_p) & live).sum())
    t_bit_mismatch = int(((t_k.view(torch.int32) != t_p.view(torch.int32))
                          & live).sum())
    kept = (1.0 if mk is None else kept_pairs(
        mk, n_sel * RB, T, RB, PI.TRI_TILE) / (n_sel * RB * T))
    line(f"{phase} launch {bounce} vs plain", rays=n_sel * RB, of_rays=C,
         triangles=T, culled=mk is not None, pairs_kept=f"{kept:.5f}",
         live=int(live.sum()), hits=int(((i_k >= 0) & live).sum()),
         tri_mismatch=tri_mismatch, t_bit_mismatch=t_bit_mismatch)
    check(int(live.sum()) > 0, f"phase {phase} launch {bounce}: live rays")
    check(tri_mismatch == 0 and t_bit_mismatch == 0,
          f"phase {phase} launch {bounce}: the kernel on the main path's own "
          "rays and mask bitwise equal to the plain version")


def _device_ms(ev):
    ms = getattr(ev, "device_time_total", None)
    if ms is None:
        ms = getattr(ev, "cuda_time_total", 0.0)
    return ms / 1e3


def profile_trace(fn, top=3, span=None):
    """Device time of one trace fn() under torch.profiler: the nearest-hit
    kernel's and the rest's (with its `top` largest ops); beside it the
    trace's own wall (TraceResult.wall_time) from a call without the
    profiler, and the device's idle share of that wall. `span` names a
    torch.profiler.record_function range: the profiler lists it as a
    device-side annotation (first to last kernel of each range), given as
    `span_ms` and kept out of the kernel sums (its kernels are in `rest`)."""
    from torch.profiler import ProfilerActivity, profile

    wall = fn().wall_time * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    kern, rest, span_ms, tops = 0.0, 0.0, 0.0, []
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA":
            continue
        ms = _device_ms(ev)
        if ms <= 0:
            continue
        if ev.key == span:
            span_ms += ms
        elif "nearest_hit_kernel" in ev.key:
            kern += ms
        else:
            rest += ms
            tops.append((ms, ev.key[:40].replace(" ", "_")))
    tops.sort(reverse=True)
    out = {"trace_wall_ms": wall, "bounces": res.iterations_run,
           "kernel_ms": kern, "rest_ms": rest, "busy_ms": kern + rest,
           "idle_share": f"{1 - (kern + rest) / wall:.4f}",
           "top_rest": ",".join(f"{k}:{ms:.3f}" for ms, k in tops[:top])}
    if span is not None:
        out["span_ms"] = span_ms
    return out


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


TRACE_FIELDS = ("hist", "per_detector", "image", "measured_pos",
                "measured_dir", "measured_power", "measured_stokes",
                "measured_opl", "measured_wavelength", "measured_path")


def same_trace(a, b):
    """Two trace results equal bit for bit: ledger, bounce count, live
    power, every detector map and every measured ray."""
    return (a.ledger == b.ledger and a.iterations_run == b.iterations_run
            and a.final_live_power == b.final_live_power
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in TRACE_FIELDS))


def physics_scene(P, n_segments, n_radial):
    """A doublet of coated lenses (a two-layer and a one-layer stack), a
    silver fold mirror at 45 degrees, a reflection grating (order -1, a
    tenth of the reflected power left in order 0) and a measuring sphere."""
    oe = P.optical_elements(n_segments, n_radial)
    small = P.optical_elements(64, 16)
    stack = [(1.38, 0.1064), (2.1, 0.0350)]
    first = oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, coating=stack)
    second = oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7,
                              coating=stack[:1]).translate((0, 0, 0.5))
    fold = small.rectangle(1.2, 1.2, center=(0, 0, 2.0), material="mirror",
                           reflectivity=0.98, metal_n=0.13, metal_k=3.9)
    fold.rotate((0, 1, 0), 0.75 * np.pi, pivot=(0, 0, 2.0))
    grating = small.rectangle(5.0, 5.0, center=(2.5, 0, 2.0),
                              material="grating", axis=(1, 0, 0),
                              grating_period=1.0, grating_order=-1,
                              reflectivity=0.9, order0_fraction=0.1)
    grating.rotate((0, 1, 0), 0.35 - 0.5 * np.pi, pivot=(2.5, 0, 2.0))
    return [first, second, fold, grating,
            small.sphere(radius=12.0, material="measure", name="dome")]


def physics_source(P, n):
    """Collimated, linearly polarized along the frame's s-direction."""
    return P.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                              diameter=0.5, ray_count=n, power=1.0, seed=23,
                              stokes=(1.0, 0.0, 0.0))


def beam_up(P, n, **kw):
    return P.CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                              diameter=0.4, power=1.0, ray_count=n, seed=1,
                              **kw)


ALBEDO, ROUGH_SIGMA, ROUGH_G, ROUGH_TILT = 0.7, 0.03, 0.7, 0.3
PUMP_UM, EMIT_UM, QUANTUM_YIELD = 0.45, 0.60, 0.8


def diffuser_scene(P):
    oe = P.optical_elements(64, 16)
    return [oe.disc(radius=0.5, material="diffuse", reflectivity=ALBEDO,
                    name="plate"),
            oe.hemisphere(radius=6.0, name="dome"),
            oe.disc(radius=6.0, center=(0, 0, -0.01), material="terminator")]


def rough_mirror(P):
    mirror = P.optical_elements(64, 16).rectangle(
        6.0, 6.0, center=(0, 0, 0), material="mirror", reflectivity=0.9,
        roughness=ROUGH_SIGMA, roughness_lobe=ROUGH_G)
    return mirror.rotate((1.0, 0.0, 0.0), np.pi - ROUGH_TILT).translate(
        (0, 0, 3.5))


def turbid_phosphor(P, mu_s=1.0):
    return P.optical_elements(64, 16).cube(
        (6.0, 6.0, 1.0), center=(0, 0, 1.5), material="refractive", ior=1.2,
        fluorescence=2.0, fluor_yield=QUANTUM_YIELD, fluor_emission=EMIT_UM,
        fluor_edge=0.50, scattering=mu_s, scatter_g=0.8)


def world(P, r=30.0):
    return P.optical_elements(64, 16).sphere(radius=r, material="measure",
                                             name="world")


def random_scene(P):
    """The pump beam crosses the turbid phosphor, meets the rough mirror,
    and what comes back down lands on a diffusing floor."""
    floor = P.optical_elements(64, 16).disc(
        radius=8.0, center=(0, 0, -0.5), material="diffuse",
        reflectivity=ALBEDO, name="floor")
    return [turbid_phosphor(P), rough_mirror(P), floor, world(P)]


def random_statistics(P, dev, n):
    """The random branches held to what they must give, each alone in host
    mode with n rays: (name, value, expected, bound) rows. The bounds are 5
    sigma of n draws where the quantity is a mean of draws, else the
    float32 sum's accuracy."""
    rows = []
    # Lambertian plate: the albedo split is deterministic; the scattered
    # directions follow the cosine law, E[cos] = 2/3, Var = 1/18
    res = P.Tracer(device=dev).trace(
        P.CollimatedSource(center=(0, 0, 1.0), direction=(0, 0, -1),
                           diameter=0.5, ray_count=n, seed=1),
        diffuser_scene(P), trace_iterations=4, hist_mode="direction", seed=3)
    rows += [("diffuse_measured", res.ledger["measured"], ALBEDO, 1e-4),
             ("diffuse_absorbed", res.ledger["absorbed"], 1 - ALBEDO, 1e-4),
             ("diffuse_mean_cos", float(res.measured_dir[:, 2].mean()),
              2 / 3, 5 * np.sqrt(1 / 18 / n))]
    # rough mirror: Rayleigh-Rice split (deterministic), and the lobe's
    # mean cosine about the specular direction against the same folded
    # Henyey-Greenstein lobe drawn independently in numpy
    res = P.Tracer(device=dev).trace(
        beam_up(P, n), [rough_mirror(P), world(P)], trace_iterations=3,
        seed=3, capacity=2 * n)
    tis = 1 - np.exp(-(4 * np.pi * ROUGH_SIGMA * np.cos(ROUGH_TILT)
                       / 0.5876) ** 2)
    nrm = np.array([0.0, -np.sin(ROUGH_TILT), -np.cos(ROUGH_TILT)])
    spec = np.array([0, 0, 1.0]) - 2 * nrm[2] * nrm
    c = res.measured_dir.astype(np.float64) @ spec
    is_spec = c > 1 - 1e-6
    rng = np.random.default_rng(0)
    m = 1 << 20
    u, phi = rng.uniform(size=m), rng.uniform(0, 2 * np.pi, m)
    g = ROUGH_G
    ct = (1 + g * g - ((1 - g * g) / (1 + g - 2 * g * u)) ** 2) / (2 * g)
    st = np.sqrt(1 - ct ** 2)
    e1 = np.cross(spec, [1.0, 0, 0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(spec, e1)
    d = ((st * np.cos(phi))[:, None] * e1 + (st * np.sin(phi))[:, None] * e2
         + ct[:, None] * spec)
    d = d - 2 * np.minimum(d @ nrm, 0.0)[:, None] * nrm
    lobe, want = c[~is_spec], d @ spec
    rows += [("rough_specular_power",
              float(res.measured_power[is_spec].sum()), 0.9 * (1 - tis),
              2e-4),
             ("rough_reflected_power", float(res.measured_power.sum())
              + res.final_live_power, 0.9, 1e-4),
             ("rough_lobe_mean_cos", float(lobe.mean()), float(want.mean()),
              5 * np.sqrt(lobe.var() / len(lobe) + want.var() / m))]
    # turbid phosphor: every conversion keeps QY x (pump / emission
    # wavelength) of its power and absorbs the rest, and nothing else
    # absorbs, so converted / (converted + absorbed) is that factor up to
    # the converted power still in flight or culled when the trace stops
    res = P.Tracer(device=dev).trace(
        beam_up(P, n, wavelength=PUMP_UM), [turbid_phosphor(P), world(P)],
        trace_iterations=40, seed=5, capacity=2 * n, dissipation_target=1.0)
    red = float(res.measured_power[res.measured_wavelength > 0.55].sum())
    absorbed = res.ledger["absorbed"]
    loose = res.ledger["culled"] + res.final_live_power
    rows += [("fluorescence_power_factor", red / (red + absorbed),
              QUANTUM_YIELD * PUMP_UM / EMIT_UM,
              1e-4 + abs(loose) / (red + absorbed))]
    if red + absorbed < 0.3:
        raise AssertionError("check failed: the phosphor converted the pump")
    # the bound must come from the statistic, not from an unfinished trace
    if abs(loose) / (red + absorbed) > 1e-3:
        raise AssertionError("check failed: the phosphor trace ran out: "
                             f"{loose} of {red + absorbed} still in flight")
    return rows


def best_focus(res):
    """(z, rms radius) of the least-rms plane of the measured rays that
    carry more than half the strongest ray's power (the primary beam)."""
    main = res.measured_power > 0.5 * res.measured_power.max()
    p = res.measured_pos[main].astype(np.float64)
    d = res.measured_dir[main].astype(np.float64)
    v = d[:, :2] / d[:, 2:3]
    s = -(p[:, :2] * v).sum() / (v * v).sum()
    xy = p[:, :2] + s * v
    return float(p[:, 2].mean() + s), float(np.sqrt((xy ** 2).sum(1).mean()))


def lens_focus(P, dev, n, lens):
    """Trace a paraxial beam through `lens` (a list of elements) onto an
    exact plane past the focus; returns best_focus and the result."""
    det = P.analytic_disc(3.0, vertex=(0, 0, 1.5), name="det")
    src = P.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                             diameter=0.08, ray_count=n, seed=3)
    res = P.Tracer(device=dev).trace(src, [*lens, det], trace_iterations=4,
                                     capacity=2 * n, mode="host")
    return best_focus(res), res


GRIN_N0, GRIN_A = 1.6, 4.0


def grin_trace(P, dev, n, substeps, iterations):
    """A quarter-pitch, absorbing SELFOC rod under a collimated beam, host
    mode: the reference's own sub-step check (tests/test_grin.py,
    test_beer_lambert_uses_total_arc) at n rays."""
    length = 0.25 * 2.0 * np.pi / np.sqrt(GRIN_A)
    oe = P.optical_elements(64, 16)
    rod = oe.cube((1.2, 1.2, length), center=(0, 0, 1.0 + length / 2),
                  material="refractive", ior=GRIN_N0, grin_a=GRIN_A,
                  axis=(0, 0, 1), grin_center=(0, 0, 1.0), absorption=0.8)
    screen = oe.rectangle(width=10.0, depth=10.0,
                          center=(0, 0, 1.0 + length + 5e-3),
                          material="measure", name="exit")
    src = P.CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                             diameter=0.4, power=1.0, ray_count=n, seed=11)
    return P.Tracer(P.TraceConfig(grin_substeps=substeps), device=dev).trace(
        src, [rod, screen, oe.sphere(radius=20.0, material="measure",
                                     name="world")],
        trace_iterations=iterations, capacity=8 * n, mode="host")


def exit_spot(res):
    """(power, centroid (2,), rms radius), power-weighted, of the primary
    beam on detector 0: the rays with more than half the strongest one's
    power (ghosts arrive bounces later, and how many of them a run still
    sees depends on when its early exit ends it)."""
    sel = (res.measured_det == 0) & (
        res.measured_power > 0.5 * res.measured_power.max())
    w = res.measured_power[sel].astype(np.float64)
    xy = res.measured_pos[sel][:, :2].astype(np.float64)
    return (float(w.sum()), np.average(xy, axis=0, weights=w),
            float(np.sqrt(np.average((xy ** 2).sum(1), weights=w))))


def physics_phases(P, PI):
    """Phases 13-17: the surface and volume physics at full width. Returns
    the (brute, culled) kernel launches of its counted traces."""
    # ---- 13. surface physics at full width: polarized, coated, metal,
    #          grating ------------------------------------------------------
    phys_els = physics_scene(P, 256, 256)
    phys_kw = dict(trace_iterations=10, mode="device", polarization=True)
    PI.nearest_hit_cuda.launches = 0
    PI.nearest_hit_cuda.cull_launches = 0
    tr_p = P.Tracer()
    with LaunchTap(PI, (0, 3)) as tap_p:
        res_p = tr_p.trace(physics_source(P, BENCH_RAYS), phys_els,
                           capacity=2 * BENCH_RAYS, **phys_kw)
    torch.cuda.synchronize()
    launches_p = PI.nearest_hit_cuda.launches
    cull_launches_p = PI.nearest_hit_cuda.cull_launches
    cfg_p = tap_p.kept[0][3]  # the cfg as the trace resolved it
    check(cfg_p.has_coatings and cfg_p.has_metals and cfg_p.has_gratings
          and not cfg_p.has_birefringence, "phase 13 scene turns on "
          "coatings, metals and gratings")
    check(launches_p > 0, "phase 13: the kernel carried the physics trace")
    check(res_p.power_conservation_error() <= 1e-5, "phase 13 ledger closes")
    check(res_p.ledger["measured"] > 0.7 and np.isfinite(res_p.hist).all(),
          "phase 13 measures the diffracted beam")
    again_p = P.Tracer().trace(physics_source(P, BENCH_RAYS), phys_els,
                               capacity=2 * BENCH_RAYS, **phys_kw)
    check(same_trace(res_p, again_p), "phase 13 repeat run bit-identical")
    # the culled launches of the trace itself, first bounce and a ghost one
    check(sorted(tap_p.kept) == [0, 3], "phase 13: two launches kept")
    for bounce, launch in sorted(tap_p.kept.items()):
        check(launch[5] is not None, "phase 13 launches are culled")
        hold_to_plain(PI, "13", bounce, launch)
    del tap_p
    # the whole trace against backend='torch' (cull off: the plain
    # version's culled path is a Python loop over (ray block, triangle
    # tile) pairs, minutes on this scene's 2,056 tiles)
    small_p = {b: P.Tracer().trace(
        physics_source(P, PHYS_CMP_RAYS), phys_els,
        capacity=2 * PHYS_CMP_RAYS, trace_iterations=10, mode="host",
        polarization=True, cull=False, backend=b) for b in ("cuda", "torch")}
    check(same_trace(small_p["cuda"], small_p["torch"]),
          "phase 13 kernel equal to backend='torch' in every field")
    check(np.abs(small_p["cuda"].measured_stokes).max() > 0.1,
          "phase 13 measured rays carry Stokes fractions")
    line("13 physics trace", rays=BENCH_RAYS, capacity=2 * BENCH_RAYS,
         triangles=tr_p.num_triangles, iterations=res_p.iterations_run,
         measured=res_p.ledger["measured"], absorbed=res_p.ledger["absorbed"],
         culled=res_p.ledger["culled"],
         conservation_err=res_p.power_conservation_error(),
         first_wall_s=res_p.wall_time, wall_s=again_p.wall_time,
         rays_per_sec_full_trace=(
             f"{BENCH_RAYS / max(again_p.wall_time, 1e-12):.6e}"),
         slots_per_sec=f"{again_p.rays_per_second:.6e}",
         launches=launches_p, cull_launches=cull_launches_p,
         plain_rays=PHYS_CMP_RAYS,
         plain_wall_s=small_p["torch"].wall_time,
         kernel_wall_s=small_p["cuda"].wall_time)

    # ---- 14. random physics: diffuser, rough mirror, turbid phosphor -----
    rand_kw = dict(trace_iterations=8, capacity=2 * BENCH_RAYS,
                   mode="device", seed=2)
    PI.nearest_hit_cuda.launches = 0
    PI.nearest_hit_cuda.cull_launches = 0
    with LaunchTap(PI, (0, 2)) as tap_r:
        res_r = P.Tracer().trace(beam_up(P, BENCH_RAYS, wavelength=PUMP_UM),
                                 random_scene(P), **rand_kw)
    torch.cuda.synchronize()
    launches_r = PI.nearest_hit_cuda.launches
    cull_launches_r = PI.nearest_hit_cuda.cull_launches
    for bounce, launch in sorted(tap_r.kept.items()):
        hold_to_plain(PI, "14", bounce, launch)
    check(len(tap_r.kept) == 2, "phase 14: two launches kept")
    del tap_r
    check(launches_r > 0, "phase 14: the kernel carried the random trace")
    check(res_r.power_conservation_error() <= 1e-5, "phase 14 ledger closes")
    again_r = P.Tracer().trace(beam_up(P, BENCH_RAYS, wavelength=PUMP_UM),
                               random_scene(P), **rand_kw)
    check(same_trace(res_r, again_r), "phase 14 repeat run bit-identical")
    other_r = P.Tracer().trace(beam_up(P, BENCH_RAYS, wavelength=PUMP_UM),
                               random_scene(P), **dict(rand_kw, seed=3))
    check(not np.array_equal(other_r.hist, res_r.hist),
          "phase 14: another seed draws other numbers")
    stats = random_statistics(P, "cuda", BENCH_RAYS)
    for name, got, want, tol in stats:
        check(abs(got - want) <= tol,
              f"phase 14 {name}: {got} within {tol} of {want}")
    line("14 random physics", rays=BENCH_RAYS,
         iterations=res_r.iterations_run, measured=res_r.ledger["measured"],
         absorbed=res_r.ledger["absorbed"], culled=res_r.ledger["culled"],
         live=res_r.final_live_power,
         conservation_err=res_r.power_conservation_error(),
         wall_s=again_r.wall_time,
         rays_per_sec_full_trace=(
             f"{BENCH_RAYS / max(again_r.wall_time, 1e-12):.6e}"),
         launches=launches_r, cull_launches=cull_launches_r,
         repeat_equal=True)
    for name, got, want, tol in stats:
        line(f"14 statistic {name}", value=got, expected=want, bound=tol)

    # ---- 15. the same plano-convex lens, exact and as a 256 x 256 mesh ---
    PI.nearest_hit_cuda.launches = 0
    PI.nearest_hit_cuda.cull_launches = 0
    with LaunchTap(PI, (0,)) as tap_a:
        (z_exact, rms_exact), res_a = lens_focus(
            P, "cuda", BENCH_RAYS,
            P.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5))
    launches_a = PI.nearest_hit_cuda.launches
    cull_launches_a = PI.nearest_hit_cuda.cull_launches
    with LaunchTap(PI, (1,)) as tap_m:  # inside the meshed lens
        (z_mesh, rms_mesh), res_m = lens_focus(
            P, "cuda", BENCH_RAYS,
            [P.optical_elements(256, 256).plano_convex_lens(
                r=0.5, aperture=0.4, thickness=0.05, ior=1.5)])
    torch.cuda.synchronize()
    hold_to_plain(PI, "15 analytic", 0, tap_a.kept[0])
    hold_to_plain(PI, "15 mesh", 1, tap_m.kept[1])
    del tap_a, tap_m
    for r in (res_a, res_m):
        check(r.power_conservation_error() <= 1e-5,
              "phase 15 ledger closes")
    check(launches_a > 0, "phase 15: the kernel ran beside the quadrics")
    check(rms_exact <= rms_mesh,
          "phase 15: the analytic spot is no larger than the mesh's")
    # the mesh's rings are 0.2 / 256 wide on a radius of 0.5: facet slopes
    # are off by up to 8e-4, and so, at a focal length of 1, is its focus
    check(abs(z_exact - z_mesh) <= 2e-3,
          "phase 15: both focus at the same place within the facet error")
    line("15 analytic vs mesh", rays=BENCH_RAYS, focus_z_analytic=z_exact,
         focus_z_mesh=z_mesh, rms_spot_analytic=rms_exact,
         rms_spot_mesh=rms_mesh, measured_analytic=res_a.ledger["measured"],
         measured_mesh=res_m.ledger["measured"], wall_analytic_s=res_a.wall_time,
         wall_mesh_s=res_m.wall_time, launches=launches_a,
         cull_launches=cull_launches_a)

    # ---- 16. GRIN rod: 8 sub-steps a bounce against one ------------------
    PI.nearest_hit_cuda.launches = 0
    PI.nearest_hit_cuda.cull_launches = 0
    with LaunchTap(PI, (1,)) as tap_g:  # inside the rod
        g1 = grin_trace(P, "cuda", BENCH_RAYS, 1, 60)
    g8 = grin_trace(P, "cuda", BENCH_RAYS, 8, 12)
    torch.cuda.synchronize()
    launches_g = PI.nearest_hit_cuda.launches
    cull_launches_g = PI.nearest_hit_cuda.cull_launches
    hold_to_plain(PI, "16", 1, tap_g.kept[1])
    del tap_g
    (_, c1, r1), (_, c8, r8) = exit_spot(g1), exit_spot(g8)
    for r in (g1, g8):
        check(r.power_conservation_error() <= 1e-4, "phase 16 ledger closes")
    check(g1.ledger["absorbed"] > 0.3, "phase 16: the rod absorbs")
    # the reference's own bounds (tests/test_grin.py): power and absorbed
    # 2e-4 at 8 sub-steps, exit centroid and rms radius 1e-5
    check(abs(g8.ledger["absorbed"] - g1.ledger["absorbed"]) < 2e-4
          and abs(g8.detector_power("exit") - g1.detector_power("exit"))
          < 2e-4, "phase 16: absorbed and exit power agree to 2e-4")
    check(np.abs(c8 - c1).max() < 1e-5 and abs(r8 - r1) < 1e-5,
          "phase 16: exit centroid and rms radius agree to 1e-5")
    check(g8.iterations_run < g1.iterations_run,
          "phase 16: sub-steps need fewer bounces")
    line("16 grin rod", rays=BENCH_RAYS, capacity=8 * BENCH_RAYS,
         iterations_1=g1.iterations_run, iterations_8=g8.iterations_run,
         exit_power_1=g1.detector_power("exit"),
         exit_power_8=g8.detector_power("exit"),
         absorbed_1=g1.ledger["absorbed"], absorbed_8=g8.ledger["absorbed"],
         centroid_diff=float(np.abs(c8 - c1).max()), rms_1=r1, rms_8=r8,
         wall_1_s=g1.wall_time, wall_8_s=g8.wall_time, launches=launches_g,
         cull_launches=cull_launches_g)

    # ---- 17. where the physics trace's device time goes ------------------
    split_p = profile_trace(lambda: P.Tracer().trace(
        physics_source(P, BENCH_RAYS), phys_els, capacity=2 * BENCH_RAYS,
        **phys_kw), top=8)
    check(split_p["kernel_ms"] > 0, "physics trace: profiler saw the kernel")
    line("17 profile physics", kernel_share_of_busy=(
        f"{split_p['kernel_ms'] / split_p['busy_ms']:.4f}"), **split_p)

    new_brute = sum(a - b for a, b in (
        (launches_p, cull_launches_p), (launches_r, cull_launches_r),
        (launches_a, cull_launches_a), (launches_g, cull_launches_g)))
    new_cull = (cull_launches_p + cull_launches_r + cull_launches_a
                + cull_launches_g)
    check(new_brute + new_cull > 0 and cull_launches_p > 0,
          "the physics phases went through the kernel, culled on the "
          "collimated beam")
    return new_brute, new_cull


SPEC_RAYS = 1 << 19   # benchmarks/spectral_bench.py: rays, in 2x the slots,
SPEC_W = 32           # wavelengths,
SPEC_ITERS = 10       # bounces
DISP_RAYS = 1 << 14   # benchmarks/dispersive_bench.py: rays a wavelength,
DISP_W = 16           # in 4x the slots, wavelengths,
DISP_ITERS = 6        # bounces
MICH_RAYS = 1 << 16   # the white-light Michelson (8x the slots, 6 bounces)
MICHELSON_MAP = dict(coherent=True, image_bins=32,
                     image_center=(1.5, 0.0, 0.0),
                     image_normal=(1.0, 0.0, 0.0), image_halfwidth=0.6)
SPECTRAL_FIELDS = ("per_detector_spectrum", "hist", "image", "per_detector")


def hr_window(P):
    """benchmarks/spectral_bench.py's scene: an (HL)^3 high reflector at
    0.55 um on a window (36,364 triangles with the rest), two measuring
    discs, a terminating shell."""
    n_hi, n_lo = 2.35, 1.46
    stack = [(n_hi, 0.55 / (4 * n_hi)), (n_lo, 0.55 / (4 * n_lo))] * 3
    oe = P.optical_elements(n_segments=128, n_radial=48)
    return [oe.cube(size=(1.2, 1.2, 0.3), material="refractive", ior=1.52,
                    coating=stack, name="hr"),
            oe.disc(radius=2.0, center=(0, 0, 2.0), material="measure",
                    name="T"),
            oe.disc(radius=2.0, center=(0, 0, -2.0), material="measure",
                    name="R"),
            oe.sphere(radius=8.0, material="terminator")]


def sf10_prism(P):
    """benchmarks/dispersive_bench.py's scene: an SF10 (Cauchy) prism in a
    measuring dome (5,960 triangles)."""
    from lightpycl_tpu_torch.materials import SF10

    oe = P.optical_elements(n_segments=96, n_radial=32)
    prism = oe.prism(width=1.04, height=0.3, length=1.0, ior=SF10[0])
    prism.dispersion_b = SF10[1]
    return [prism, oe.sphere(10.0, material="measure", name="dome")]


def michelson(P, arm):
    """examples/example_michelson.py: a 50/50 beamsplitter at 45 degrees,
    two arm mirrors (one moved out by `arm`), the output port's panel."""
    oe = P.optical_elements(n_segments=16, n_radial=6)
    return [oe.rectangle(2.0, 2.0, material="beamsplitter",
                         reflectivity=0.5).rotate((0, 1, 0), np.pi / 4),
            oe.rectangle(2.0, 2.0, material="mirror").rotate(
                (0, 1, 0), np.pi / 2).translate((-1.5 - arm, 0, 0)),
            oe.rectangle(2.0, 2.0, material="mirror").rotate(
                (0, 1, 0), np.pi).translate((0, 0, 1.5)),
            oe.rectangle(2.0, 2.0, material="measure", name="output").rotate(
                (0, 1, 0), -np.pi / 2).translate((1.5, 0, 0))]


def same_spectral(a, b):
    """Two spectral results equal bit for bit: ledgers, spectra, maps."""
    return (a.ledger == b.ledger and a.final_live_power == b.final_live_power
            and all(np.array_equal(a.spectral_ledger[k], b.spectral_ledger[k])
                    for k in a.spectral_ledger)
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in SPECTRAL_FIELDS))


class FilmTap:
    """While active, wraps physics.multilayer_reflectance, the film stack
    of the shared spectral step: each call runs inside a
    torch.profiler.record_function('film_stack') range, and the first
    call's arguments are kept (cloned) to time the stack alone."""

    def __init__(self, physics):
        self.physics, self.args = physics, None

    def __enter__(self):
        self.orig = fn = self.physics.multilayer_reflectance

        def clone(a):
            if isinstance(a, torch.Tensor):
                return a.clone()
            return [clone(x) for x in a] if isinstance(a, list) else a

        def wrapped(*args):
            if self.args is None:
                self.args = [clone(a) for a in args]
            with torch.profiler.record_function("film_stack"):
                return fn(*args)

        self.physics.multilayer_reflectance = wrapped
        return self

    def __exit__(self, *exc):
        self.physics.multilayer_reflectance = self.orig


def counted(PI, fn):
    """fn()'s result and the (brute, culled) kernel launches it made."""
    PI.nearest_hit_cuda.launches = 0
    PI.nearest_hit_cuda.cull_launches = 0
    out = fn()
    torch.cuda.synchronize()
    cull = PI.nearest_hit_cuda.cull_launches
    return out, PI.nearest_hit_cuda.launches - cull, cull


def spectral_phases(P, PI):
    """Phases 19-22: spectral tracing at the repository's spectral benches'
    shapes. Returns the (brute, culled) kernel launches of the counted
    traces."""
    from lightpycl_tpu_torch import physics
    from lightpycl_tpu_torch import spectral as PS

    # ---- 19. shared geometry: spectral_bench's shape, unreduced ---------
    els = hr_window(P)
    o, d, p = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                                 diameter=0.6, ray_count=SPEC_RAYS,
                                 power=1.0, seed=7).sample()
    wls = np.linspace(0.40, 0.75, SPEC_W)

    def rays(n=SPEC_RAYS, wl=None):
        return P.RayBatch.from_arrays(o[:n], d[:n], p[:n], capacity=2 * n,
                                      wavelengths=wl, device="cuda")

    def spec(n=SPEC_RAYS, **kw):
        return P.Tracer().trace_spectral(None, wls, elements=els,
                                         trace_iterations=SPEC_ITERS,
                                         rays=rays(n), **kw)

    spec()  # first use
    torch.cuda.reset_peak_memory_stats()
    with LaunchTap(PI, (0, 3)) as tap:
        res, brute_s, cull_s = counted(PI, spec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = [res, spec(), spec()]
    check(all(same_spectral(res, r) for r in runs[1:]),
          "phase 19 repeat runs bit-identical")
    wall = min(r.wall_time for r in runs)
    check(res.rays_traced == 2 * SPEC_RAYS * SPEC_ITERS,
          "phase 19 took the shared method (one geometry pass)")
    check(cull_s == SPEC_ITERS and brute_s == 0,
          "phase 19: auto-cull on, one culled launch a bounce")
    peak_wl = float(wls[res.detector_spectrum("R").argmax()])
    check(abs(peak_wl - 0.55) < 0.03,
          "phase 19: the high reflector's peak at its design wavelength")
    # every column closes: the module entry point the engine calls, on the
    # same rays, returns the live remainder by column
    per_det, led, _, sr, _ = PS.trace_spectral(
        els, rays(), wls, cfg=P.TraceConfig(cull=True),
        iterations=SPEC_ITERS)
    live = torch.sum(torch.where(sr.alive[:, None], sr.P, 0.0), dim=0)
    col_err = float((led.emitted - led.accounted() - live).abs().max())
    check(col_err <= 1e-5, "phase 19: every ledger column closes to 1e-5")
    check(np.array_equal(per_det.cpu().numpy(), res.per_detector_spectrum),
          "phase 19: spectral.trace_spectral == Tracer.trace_spectral")
    del per_det, led, sr, live

    def scalar(wl):
        return P.Tracer().trace(None, els, trace_iterations=SPEC_ITERS,
                                rays=rays(wl=wl), mode="device",
                                dissipation_target=1.0)

    scalar(0.55)
    t_scalar = scalar(0.55).wall_time
    worst = 0.0
    for k in (0, int(np.abs(wls - 0.55).argmin()), SPEC_W - 1):
        r = scalar(float(wls[k]))
        for j, name in enumerate(res.detector_names):
            a = float(res.per_detector_spectrum[j, k]) * SPEC_W
            b = r.detector_power(name)
            worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
            check(abs(a - b) <= 2e-4 * abs(b) + 1e-6,
                  f"phase 19: column {k} on {name} == the scalar trace")
    kept = {}
    for bounce, launch in sorted(tap.kept.items()):
        scene, lo, _, _, _, mask = launch
        check(mask is not None, "phase 19 launches are culled")
        kept[bounce] = kept_pairs(mask, lo.shape[0], scene.wu.shape[0],
                                  PI.RAY_BLOCK, PI.TRI_TILE)
        hold_to_plain(PI, "19", bounce, launch)
    T_s = tap.kept[0][0].wu.shape[0]
    del tap, launch, scene, lo, mask
    small = {b: spec(PHYS_CMP_RAYS, cull=False, backend=b)
             for b in ("cuda", "torch")}
    check(same_spectral(small["cuda"], small["torch"]),
          "phase 19 kernel equal to backend='torch' in every field")
    line("19 spectral shared", rays=SPEC_RAYS, capacity=2 * SPEC_RAYS,
         wavelengths=SPEC_W, bounces=SPEC_ITERS, triangles=T_s,
         wall_s=wall, walls=",".join(f"{r.wall_time:.4f}" for r in runs),
         source_rays_per_s=f"{SPEC_RAYS / wall:.6e}",
         scalar_wall_s=t_scalar,
         speedup_vs_scalar_spectrum=f"{SPEC_W * t_scalar / wall:.4f}",
         peak_wl=peak_wl, measured=res.ledger["measured"],
         live=res.final_live_power, column_closure_err=col_err,
         scalar_column_rel_err=worst,
         kept_pairs=",".join(f"{b}:{n}" for b, n in kept.items()),
         kept_share=",".join(f"{b}:{n / (2 * SPEC_RAYS * T_s):.5f}"
                             for b, n in kept.items()),
         peak_mem_gib=f"{peak:.3f}", launches=brute_s + cull_s,
         cull_launches=cull_s, plain_rays=PHYS_CMP_RAYS,
         plain_wall_s=small["torch"].wall_time,
         kernel_wall_s=small["cuda"].wall_time)
    del small

    # ---- 20. wavelength-batched: dispersive_bench's shape, unreduced -----
    els2 = sf10_prism(P)
    o2, d2, p2 = P.CollimatedSource(center=(0.3, -0.5, 0),
                                    direction=(0, 1, 0), diameter=0.04,
                                    ray_count=DISP_RAYS, power=1.0,
                                    seed=7).sample()
    wl2 = np.linspace(0.38, 0.70, DISP_W)

    def rays2(wl=None):
        return P.RayBatch.from_arrays(o2, d2, p2, capacity=4 * DISP_RAYS,
                                      wavelengths=wl, device="cuda")

    def batched():
        return P.Tracer().trace_spectral(None, wl2, elements=els2,
                                         trace_iterations=DISP_ITERS,
                                         rays=rays2())

    batched()  # first use
    torch.cuda.reset_peak_memory_stats()
    with LaunchTap(PI, (1,)) as tap2:  # inside the prism
        res2, brute_b, cull_b = counted(PI, batched)
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 30
    runs2 = [res2, batched(), batched()]
    check(all(same_spectral(res2, r) for r in runs2[1:]),
          "phase 20 repeat runs bit-identical")
    wall2 = min(r.wall_time for r in runs2)
    check(res2.rays_traced == DISP_W * 4 * DISP_RAYS * DISP_ITERS,
          "phase 20 took the batched method (W geometry passes)")
    check(cull_b == DISP_ITERS, "phase 20: auto-cull on")

    def scalar2(wl):
        return P.Tracer().trace(None, els2, trace_iterations=DISP_ITERS,
                                rays=rays2(float(wl)), mode="device",
                                dissipation_target=1.0)

    scalar2(wl2[0])
    seq = [scalar2(w) for w in wl2]
    t_seq = sum(r.wall_time for r in seq)
    worst2 = 0.0
    for k, r in enumerate(seq):
        a = float(res2.per_detector_spectrum[0, k]) * DISP_W
        b = r.detector_power("dome")
        worst2 = max(worst2, abs(a - b) / b)
        check(abs(a - b) <= 5e-4 * b + 1e-6,
              f"phase 20: column {k} dome power == the scalar trace")
    per_dw, _, _, rays_out, _, led_w, _ = PS.trace_spectral_dispersive(
        els2, rays2(), wl2, cfg=P.TraceConfig(cull=True),
        iterations=DISP_ITERS)
    grid = torch.as_tensor(wl2, dtype=torch.float32, device="cuda")
    idx = torch.argmin(torch.abs(rays_out.wavelength[:, None] - grid), dim=1)
    live2 = torch.bincount(idx, torch.where(rays_out.alive, rays_out.power,
                                            0.0).double(), DISP_W)
    col_err2 = float((led_w.emitted.double() - led_w.accounted().double()
                      - live2).abs().max())
    check(col_err2 <= 1e-5, "phase 20: every ledger column closes to 1e-5")
    check(np.array_equal(per_dw.cpu().numpy(), res2.per_detector_spectrum),
          "phase 20: spectral.trace_spectral_dispersive == the engine's")
    del per_dw, rays_out, led_w, idx, live2
    hold_to_plain(PI, "20", 1, tap2.kept[1])
    del tap2
    line("20 spectral batched", rays_per_wavelength=DISP_RAYS,
         wavelengths=DISP_W, slots=DISP_W * 4 * DISP_RAYS,
         bounces=DISP_ITERS, triangles=sum(e.num_triangles for e in els2),
         wall_s=wall2, walls=",".join(f"{r.wall_time:.4f}" for r in runs2),
         sequential_scalar_s=t_seq,
         speedup_vs_sequential=f"{t_seq / wall2:.4f}",
         measured=res2.ledger["measured"], live=res2.final_live_power,
         column_closure_err=col_err2, scalar_column_rel_err=worst2,
         peak_mem_gib=f"{peak2:.3f}", launches=brute_b + cull_b,
         cull_launches=cull_b)

    # ---- 21. white-light Michelson: per-wavelength field planes ----------
    o3, d3, p3 = P.CollimatedSource(center=(0, 0, -2.0), direction=(0, 0, 1),
                                    diameter=0.5, power=1.0,
                                    ray_count=MICH_RAYS, seed=1).sample()
    wl3 = np.linspace(0.45, 0.60, 6)

    def white(arm):
        return P.Tracer().trace_spectral(
            None, wl3, elements=michelson(P, arm), trace_iterations=6,
            rays=P.RayBatch.from_arrays(o3, d3, p3, capacity=8 * MICH_RAYS,
                                        device="cuda"), **MICHELSON_MAP)

    (w0, w4), brute_w, cull_w = counted(PI, lambda: (white(0.0), white(4.0)))
    a = w0.image_amp_spectral
    check(a.shape == (6, 2, 32, 32) and w0.image_amp is None,
          "phase 21: one field plane a wavelength")
    check(np.array_equal(w0.image_coherent,
                         (a[:, 0] ** 2 + a[:, 1] ** 2).sum(axis=0)),
          "phase 21: image_coherent is the planes' intensities summed")
    i0, i4 = w0.image_coherent.sum(), w4.image_coherent.sum()
    check(i4 < 0.75 * i0, "phase 21: the fringe envelope falls at 4.0")
    for r in (w0, w4):
        check(abs(r.detector_power("output") - 0.5) <= 1e-3
              and r.power_conservation_error() <= 1e-5,
              "phase 21: 2RT = 0.5 at the output port, ledger closed")
    line("21 white light", rays=MICH_RAYS, slots=6 * 8 * MICH_RAYS,
         wavelengths=6, intensity_0=i0, intensity_4=i4,
         envelope_ratio=f"{i4 / i0:.4f}",
         output_power=w0.detector_power("output"), wall_0_s=w0.wall_time,
         wall_4_s=w4.wall_time, launches=brute_w + cull_w,
         cull_launches=cull_w)
    del w0, w4, a

    # ---- 22. where the spectral traces' device time goes -----------------
    with FilmTap(physics) as film:
        split = profile_trace(spec, top=6, span="film_stack")
    film_ms = cuda_ms(lambda: physics.multilayer_reflectance(*film.args))
    del film
    check(split["kernel_ms"] > 0, "phase 19 trace: profiler saw the kernel")
    film_total = split.pop("span_ms")
    check(film_total > 0, "phase 19 trace: profiler saw the film stack")
    line("22 profile shared", film_stack_ms=film_total,
         other_ms=split["busy_ms"] - split["kernel_ms"] - film_total,
         film_stack_one_bounce_ms=film_ms,
         kernel_share_of_busy=f"{split['kernel_ms'] / split['busy_ms']:.4f}",
         film_share_of_busy=f"{film_total / split['busy_ms']:.4f}", **split)
    split2 = profile_trace(batched, top=6)
    check(split2["kernel_ms"] > 0, "phase 20 trace: profiler saw the kernel")
    line("22 profile batched", film_stack_ms=0.0,
         kernel_share_of_busy=(
             f"{split2['kernel_ms'] / split2['busy_ms']:.4f}"), **split2)
    return brute_s + brute_b + brute_w, cull_s + cull_b + cull_w


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import lightpycl_tpu_torch as P
    from edge_rays import edge_rays
    from lightpycl_tpu_torch.ops import _build
    from lightpycl_tpu_torch import variant_bench as VB
    from lightpycl_tpu_torch.ops import intersect as PI
    from lightpycl_tpu_torch.ops import intersect_variants as IV
    from lightpycl_tpu_torch.tracer import step as S

    kind = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    line("1 env", card=repr(smi), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=repr(nvcc))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build the kernels from the checkout's sources, together ------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(PI.load_kernel), pool.submit(IV.load_kernel)]
        lib = builds[0].result()
        builds[1].result()
    build_s = time.perf_counter() - t0
    line("2 build", seconds=f"{build_s:.3f}",
         library=_build.library_path("intersect.cu", dict(PI._DEFINES)).name,
         variants_library=_build.library_path("intersect_variants.cu",
                                              {}).name)
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
    # the variants' registers, each under its template arguments as the
    # entry's mangled name carries them (denom, notmax, min2, n_sub, reg)
    by_args = {(IV._DENOMS[v.denom], int(v.notmax), int(v.min2), v.n_sub,
                int(v.reg)): name for name, v in IV.VARIANTS.items()}
    entry, n_used = None, 0
    for ptx in _build.ptxas_report("intersect_variants.cu"):
        m = re.search(r"variant_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d+)"
                      r"ELb(\d)EE", ptx)
        if m:
            entry = by_args[tuple(map(int, m.groups()))]
        elif "Used" in ptx and entry is not None:
            print(f"[2 ptxas variants] {entry}: "
                  f"{ptx.split('Used', 1)[1].strip()}", flush=True)
            n_used += 1
    check(n_used == len(IV.VARIANTS), "one compiled kernel a variant")

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
    # the culled kernel's work on config 4's two bounces: the rays and masks
    # that one batch of trace_batched itself gives the kernel
    with LaunchTap(PI, (0, 1)) as tap4:
        cfg4(CFG4_BATCH, None)
    check(sorted(tap4.kept) == [0, 1], "config 4: a batch takes two bounces")
    cfg4_bounces = []
    for bounce, launch in sorted(tap4.kept.items()):
        scene4, so, sd, cfg4_cfg, alive4, mask4 = launch
        check(mask4 is not None, "config 4: the batch ran culled")
        T4 = scene4.wu.shape[0]
        args4 = (scene4.wu, scene4.wv, scene4.ww, cfg4_cfg.eps,
                 cfg4_cfg.eps_bary, cfg4_cfg.max_ray_len)
        pairs4 = kept_pairs(mask4, CFG4_BATCH, T4, PI.RAY_BLOCK, PI.TRI_TILE)
        ms4 = cuda_ms(lambda: PI.nearest_hit_cuda(so, sd, *args4, mask=mask4))
        bound4, by4 = bound(pairs4, CFG4_BATCH, T4, mask4.numel())
        cfg4_bounces.append({"pairs": pairs4, "ms": ms4, "bound_ms": bound4,
                             "bound_by": by4})
        line(f"10 config4 bounce {bounce}", rays=CFG4_BATCH, triangles=T4,
             live_rays=int(alive4.sum()), kept_pairs=pairs4,
             pairs_kept=f"{pairs4 / (CFG4_BATCH * T4):.5f}", kernel_ms=ms4,
             bound_ms=bound4, bound_by=by4,
             share_of_bound=f"{bound4 / ms4:.4f}")
        hold_to_plain(PI, "10 config4", bounce, launch)
    del tap4, launch, scene4, so, sd, alive4, mask4
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

    new_brute, new_cull = physics_phases(P, PI)
    spec_brute, spec_cull = spectral_phases(P, PI)

    # ---- 18. the epilogue variants (V1, V2): the two bench entry points at
    #          the bench's intersect shape, then each kernel against its
    #          plain version -----------------------------------------------
    v_inputs = VB.bench_inputs(BENCH_RAYS)
    vo, vd, vwu, vwv, vww, v_tris = v_inputs
    check(v_tris == n_tris and vo.shape[0] == BENCH_RAYS,
          "phase 18 runs at phase 3's shape")
    IV.nearest_hit_variant_cuda.launches.clear()
    v_rows = VB.micro_variants(v_inputs) + VB.epilogue_variants(v_inputs)
    torch.cuda.synchronize()
    v_launches = dict(IV.nearest_hit_variant_cuda.launches)
    v_cfg = P.TraceConfig()
    vargs = (vwu, vwv, vww, v_cfg.eps, v_cfg.eps_bary, v_cfg.max_ray_len)
    v_bound_ms, v_bound_by = bound(BENCH_RAYS * vwu.shape[0], BENCH_RAYS,
                                   vwu.shape[0])
    t_b1, i_b1 = PI.nearest_hit_cuda(vo, vd, *vargs)
    v_entries = []
    for r in v_rows:
        name = r["variant"]
        micro = name in IV.MICRO_VARIANTS
        rb = 256 if micro else 64
        v_base = v_rows[0 if micro else len(IV.MICRO_VARIANTS)]
        check(v_launches.get(name, 0) > 0,
              f"variant {name}: the bench launched its kernel")
        check(r["ok"], f"variant {name}: same result as its script's base "
              f"({r['tri_mismatch']} triangles differ, t by "
              f"{r['max_rel_dt']} relative)")
        check(r["tri_mismatch"] <= (BENCH_RAYS >> 16 if name == "recip"
                                    else 0),
              f"variant {name}: triangles as the base's (recip: but for a "
              "few ties on shared edges)")
        t_k, i_k = IV.nearest_hit_variant_cuda(
            vo[:CMP_RAYS], vd[:CMP_RAYS], *vargs, variant=name, ray_block=rb)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t_p, i_p = IV.nearest_hit_variant_torch(
            vo[:CMP_RAYS], vd[:CMP_RAYS], *vargs, variant=name)
        ev[1].record()
        torch.cuda.synchronize()
        v_plain_ms = ev[0].elapsed_time(ev[1])
        n_idx = int((i_k != i_p).sum())
        n_bits = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
        fin = torch.isfinite(t_p)
        v_err = float((t_k[fin] - t_p[fin]).abs().max())
        line(f"18 variant {name}", script=("micro_variants" if micro
                                            else "epilogue_variants"),
             ray_block=rb, rays=BENCH_RAYS, triangles=v_tris,
             kernel_ms=r["ms"], tests_per_s=f"{r['tests_per_s']:.4e}",
             vs_base=f"{r['tests_per_s'] / v_base['tests_per_s']:.4f}",
             identical_to_base=r["identical"],
             tri_mismatch_to_base=r["tri_mismatch"],
             max_rel_dt=r["max_rel_dt"],
             hits=r["hits"], launches=v_launches[name],
             bound_ms=v_bound_ms, share_of_bound=f"{v_bound_ms / r['ms']:.4f}",
             plain_ms=v_plain_ms, plain_rays=CMP_RAYS, tri_mismatch=n_idx,
             t_bit_mismatch=n_bits, max_abs_err=v_err)
        check(n_idx == 0 and n_bits == 0,
              f"variant {name}: kernel bitwise equal to its plain version")
        if name != "recip":
            t_v, i_v = IV.nearest_hit_variant_cuda(vo, vd, *vargs,
                                                   variant=name, ray_block=rb)
            check(torch.equal(i_v, i_b1) and torch.equal(t_v, t_b1),
                  f"variant {name}: same bits as the B1 kernel")
        v_entries.append(
            {"name": f"nearest_hit variant {name} "
                     f"({'V1' if micro else 'V2'})", "route": "cuda",
             "source": VARIANT_SRC,
             "replaces": TPU_MICRO if micro else TPU_EPILOGUE,
             "launches": v_launches[name], "max_abs_err": v_err,
             "ms": r["ms"], "plain_ms": v_plain_ms, "bound_ms": v_bound_ms,
             "bound_by": v_bound_by, "share_of_bound": v_bound_ms / r["ms"],
             "library_ms": None, "ray_block": rb, "rays": BENCH_RAYS,
             "plain_rays": CMP_RAYS, "triangles": v_tris})
    del t_b1, i_b1, vo, vd, v_inputs

    table = {"kernels": [
        {"name": "nearest_hit (B1, brute)", "route": "cuda",
         "source": KERNEL_SRC, "replaces": f"{TPU_KERNEL}:154",
         "launches": (launches - cull_launches + launches4 - cull_launches4
                      + new_brute + spec_brute),
         "launches_trace_batched": launches4 - cull_launches4,
         "launches_physics": new_brute, "launches_spectral": spec_brute,
         "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound_ms,
         "bound_by": b1_bound_by, "share_of_bound": b1_bound_ms / b1_ms,
         "library_ms": None,
         "rays": BENCH_RAYS, "plain_rays": CMP_RAYS, "triangles": n_tris},
        {"name": "nearest_hit (B2, cull)", "route": "cuda",
         "source": KERNEL_SRC, "replaces": f"{TPU_KERNEL}:185",
         "launches": cull_launches + cull_launches4 + new_cull + spec_cull,
         "launches_trace_batched": cull_launches4,
         "launches_physics": new_cull, "launches_spectral": spec_cull,
         "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound_ms,
         "bound_by": b2_bound_by, "share_of_bound": b2_bound_ms / b2_ms,
         "library_ms": None, "pairs": b2_pairs,
         "config4_bounces": cfg4_bounces,
         "rays": BENCH_RAYS, "plain_rays": nb,
         "triangles": scene_b.num_triangles_padded},
    ] + v_entries}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
