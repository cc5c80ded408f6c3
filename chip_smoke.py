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
Michelson's per-wavelength field planes), the epilogue-variant bench
(variant_bench.micro_variants / epilogue_variants at the bench's intersect
shape), the film-stack kernel against its plain version on phase 19's own
arguments and on stacks built to sit on its guards, BASELINE configs 1-3
against the port's float64 oracle (detected
power within 0.1 %, the oracle on its native g++ core where there is one),
the 30 example scripts that need no multi-device mode (each copied with its
import root swapped and run in its own process at its default size),
differentiable design on torch autograd (diff.py: the lensmaker and
stigmatic-conic descents, the loss and gradient on the card against the
CPU, a V-coat designed and traced), the sharded modes, and last the
port's bench entry point (`python3 -m lightpycl_tpu_torch.bench`) in its
own process, its line checked and its B1 rate held to phase 3's, and the
detector bincount kernel against its plain version at configs 2, 3 and
4's sizes and on spectral columns; it
holds every kernel against its plain
torch version (the nearest-hit kernel and every epilogue variant also on
rays built to sit on their reject margin, from edge_rays.py, and the
nearest hit on the rays and cull masks that the physics traces and config
4 really launch it with), and checks the physics
(power ledger, detected power, statistics of the random branches,
repeatability, checkpoint resume). It prints the kernels' resources, their
times beside their bound, and the profiler's split of six warm traces and
one design step, and each variant instantiation's registers, shared
memory and CTAs an SM. Any failed check raises, so the script exits non-zero
and prints no result. Without a CUDA device it exits non-zero at once. It
imports nothing of JAX.

Output: one line per phase; then the kernel table as JSON, the card's
`nvidia-smi` name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lightpycl_tpu_torch.bench import (BENCH_PY_KEYS, BENCH_RAYS, TIMED,
                                       bench_rays, bound, bowl_elements,
                                       bowl_source, check, config1_elements,
                                       config1_source, cuda_ms,
                                       headline_sphere)

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
FILM_SRC = "lightpycl_tpu_torch/csrc/film_stack.cu"
# no TPU kernel: the reference's XLA-fused jnp film stack
FILM_REPLACES = "lightpycl_tpu/physics.py:660"
FILM_EDGE_RAYS = 1 << 16  # film stacks on the kernel's guards, per depth
# the card's checks of the film-stack kernel's shortcuts (modulus test,
# sincosf); chip_smoke alone builds and loads this library
FILM_CHECKS_SRC = "film_stack_checks.cu"
BINCOUNT_SRC = "lightpycl_tpu_torch/csrc/bincount.cu"
# no TPU kernel: the reference's XLA scatter-add of the detector maps
BINCOUNT_REPLACES = "lightpycl_tpu/tracer/step.py:1478"
HIST_BINS = 36 * 18       # the histogram of configs 3 and 4
IMAGE_BINS = 128          # config 2's focal map: 128^2 pixels
TPU_MICRO = "benchmarks/micro_variants.py:173"
TPU_EPILOGUE = "benchmarks/epilogue_variants.py:120"


_T0 = time.perf_counter()


def line(phase, **numbers):
    """One phase line; `at_s` is the script's own clock when it prints."""
    numbers["at_s"] = f"{time.perf_counter() - _T0:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


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


def plain_mismatch(PI, launch, n_rays=CMP_RAYS):
    """One launch of a main path, as a LaunchTap kept it, made again: the
    kernel with the launch's own cull mask on `n_rays` of its rays (whole
    ray blocks that hold a live ray, spread evenly over the launch) against
    the plain version without a mask, (t, tri) of every live ray bitwise.
    The mask never changes a live ray's result, so the plain version's
    culled path (a Python loop over (ray block, tile) pairs, minutes on
    2,056 tiles) is not needed. Dead slots are left out: the mask is built
    from the live rays only. Returns the comparison's numbers."""
    scene, o, d, cfg, alive, mask = launch
    RB, C, T = PI.RAY_BLOCK, o.shape[0], scene.wu.shape[0]
    n_rb = C // RB
    check(n_rb > 0, "the launch holds a whole ray block")
    cand = torch.nonzero(alive[:n_rb * RB].view(n_rb, RB).any(1))[:, 0]
    check(len(cand) > 0, "the launch holds live rays")
    n_sel = min(n_rays // RB, len(cand))
    sel = cand[torch.arange(n_sel, device=o.device) * (len(cand) // n_sel)]

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
    return dict(rays=n_sel * RB, of_rays=C, triangles=T,
                culled=mk is not None, pairs_kept=f"{kept:.5f}",
                live=int(live.sum()), hits=int(((i_k >= 0) & live).sum()),
                tri_mismatch=tri_mismatch, t_bit_mismatch=t_bit_mismatch)


def hold_to_plain(PI, phase, bounce, launch, n_rays=CMP_RAYS):
    """`plain_mismatch` of a tapped launch, printed and checked: the kernel
    on the main path's own rays and mask bitwise equal to the plain
    version."""
    r = plain_mismatch(PI, launch, n_rays)
    line(f"{phase} launch {bounce} vs plain", **r)
    check(r["tri_mismatch"] == 0 and r["t_bit_mismatch"] == 0,
          f"phase {phase} launch {bounce}: the kernel on the main path's own "
          "rays and mask bitwise equal to the plain version")


def _device_ms(ev):
    ms = getattr(ev, "device_time_total", None)
    if ms is None:
        ms = getattr(ev, "cuda_time_total", 0.0)
    return ms / 1e3


def _device_work(prof, keep=None):
    """(event, ms) of each op the profiler lists on the device. A host
    range (a record_function of the program's, `lightpycl.*`, or of this
    script's) is listed there too, under its own name: not device work,
    and left out, but for the range named `keep`."""
    avgs = prof.key_averages()
    host = {ev.key for ev in avgs if ev.device_type.name != "CUDA"}
    for ev in avgs:
        if ev.device_type.name != "CUDA":
            continue
        ms = _device_ms(ev)
        if ms > 0 and (ev.key == keep or ev.key not in host):
            yield ev, ms


def profile_trace(fn, top=3, span=None):
    """Device time of one trace fn() under torch.profiler: the nearest-hit
    kernel's and the rest's (with its `top` largest ops); beside it the
    trace's own wall (TraceResult.wall_time) from a call without the
    profiler, and the device's idle share of that wall. `span` names a
    torch.profiler.record_function range: the profiler lists it as a
    device-side annotation (first to last kernel of each range), given as
    `span_ms` and kept out of the kernel sums (its kernels are in `rest`);
    every other host range is such an annotation too and counts nowhere
    (`_device_work`). The film-stack kernel's time, part of `rest`, is
    `film_kernel_ms`."""
    from torch.profiler import ProfilerActivity, profile

    wall = fn().wall_time * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    kern, rest, span_ms, film, tops = 0.0, 0.0, 0.0, 0.0, []
    for ev, ms in _device_work(prof, keep=span):
        if ev.key == span:
            span_ms += ms
        elif "nearest_hit_kernel" in ev.key:
            kern += ms
        else:
            rest += ms
            if "film_stack_kernel" in ev.key:
                film += ms
            tops.append((ms, ev.key[:40].replace(" ", "_")))
    tops.sort(reverse=True)
    out = {"trace_wall_ms": wall, "bounces": res.iterations_run,
           "kernel_ms": kern, "rest_ms": rest, "busy_ms": kern + rest,
           "film_kernel_ms": film,
           "idle_share": f"{1 - (kern + rest) / wall:.4f}",
           "top_rest": ",".join(f"{k}:{ms:.3f}" for ms, k in tops[:top])}
    if span is not None:
        out["span_ms"] = span_ms
    return out


def cfg4_elements(P):
    """BASELINE config 4's scene (benchmarks/baseline_configs.py:117): a
    360 x 180 paraboloid dish and a dome, 137,304 triangles."""
    oe4 = P.optical_elements(360, 180)
    return [oe4.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95),
            P.optical_elements(128, 32).hemisphere(radius=100.0,
                                                   name="dome")]


def cfg4_source(P):
    return P.CollimatedSource(center=(0, 0, 5), direction=(0, 0, -1),
                              diameter=3.5, power=1.0)


def same_batched(a, b):
    """Two trace_batched results equal bit for bit in every accumulator and
    the ledger."""
    return a.ledger == b.ledger and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in BATCH_FIELDS)


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


def sass_layer_loop(library, kernel="film_stack_kernel"):
    """The instructions on the common path of the film-stack kernel's layer
    loop, from the SASS of its library (`cuobjdump -sass`), by pipe: FMA
    (FFMA, FMUL, FADD, HFMA2, IMAD), MUFU, control (BRA, BSSY, BSYNC) and
    the rest. The loop is the shortest one that reads the shared-memory
    records (LDS); along it a forward branch over a slow path (a CALL, a
    MUFU.RSQ, local memory, a BREAK out of a special case) is taken, any
    other falls through. None where the toolkit has no cuobjdump."""
    from lightpycl_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = run([tool, "-sass", str(library)])
    body = sass.split(kernel, 1)[1].split("Function :", 1)[0]
    ins = {int(a, 16): i.strip() for a, i in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)}
    addrs = sorted(ins)
    loops = []
    for pc in addrs:
        m = re.search(r"BRA\s.*?(0x[0-9a-f]+)", ins[pc])
        if m and int(m.group(1), 16) < pc:
            head = int(m.group(1), 16)
            if any("LDS" in ins[a] for a in addrs if head <= a <= pc):
                loops.append((pc - head, head, pc))
    _, pc, end = min(loops)
    slow = ("CALL", "MUFU.RSQ", "LDL", "STL", "BREAK")
    ops = {}
    while True:
        i = ins[pc]
        op = i.split()[1] if i.startswith("@") else i.split()[0]
        op = op.split(".")[0]
        ops[op] = ops.get(op, 0) + 1
        if pc == end:
            break
        m = re.search(r"BRA\s.*?(0x[0-9a-f]+)", i)
        if m and (not i.startswith("@") or any(
                k in ins[a] for a in addrs
                if pc < a < int(m.group(1), 16) for k in slow)):
            pc = int(m.group(1), 16)
        else:
            pc = addrs[addrs.index(pc) + 1]
    fma = sum(ops.get(k, 0) for k in ("FFMA", "FMUL", "FADD", "HFMA2",
                                      "IMAD"))
    ctrl = sum(ops.get(k, 0) for k in ("BRA", "BSSY", "BSYNC"))
    total = sum(ops.values())
    return {"layer_loop_instructions": total, "fma_pipe": fma,
            "mufu": ops.get("MUFU", 0), "control": ctrl,
            "other": total - fma - ctrl - ops.get("MUFU", 0),
            "kernel_instructions": len(ins)}


class SubstepTap:
    """While active, wraps tracer.step.nearest_t_rows, the GRIN sub-step
    path's own-surface check: counts its calls and the nearest-hit kernel
    launches they make, and keeps (cloned) the first `keep` calls' rays,
    rows, cfg and result, to hold them to the plain version."""

    def __init__(self, S, PI, keep):
        self.S, self.PI, self.keep = S, PI, keep
        self.calls, self.launches, self.kept = 0, 0, []

    def __enter__(self):
        self.orig = fn = self.S.nearest_t_rows

        def wrapped(o, d, wu, wv, ww, cfg):
            before = self.PI.nearest_hit_cuda.launches
            t = fn(o, d, wu, wv, ww, cfg)
            self.launches += self.PI.nearest_hit_cuda.launches - before
            self.calls += 1
            if len(self.kept) < self.keep:
                self.kept.append((o.contiguous().clone(),
                                  d.contiguous().clone(), (wu, wv, ww), cfg,
                                  t.clone()))
            return t

        self.S.nearest_t_rows = wrapped
        return self

    def __exit__(self, *exc):
        self.S.nearest_t_rows = self.orig


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
    from lightpycl_tpu_torch.tracer import step as S

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
    torch.cuda.synchronize()
    launches_g1 = PI.nearest_hit_cuda.launches
    with SubstepTap(S, PI, keep=3) as sub:
        g8 = grin_trace(P, "cuda", BENCH_RAYS, 8, 12)
    torch.cuda.synchronize()
    launches_g = PI.nearest_hit_cuda.launches
    cull_launches_g = PI.nearest_hit_cuda.cull_launches
    hold_to_plain(PI, "16", 1, tap_g.kept[1])
    del tap_g
    # the sub-step checks ran on the kernel: each call launched it once,
    # and the kept calls' results equal the plain version bit for bit
    check(sub.calls > 0 and sub.launches == sub.calls,
          "phase 16: every sub-step check launched the nearest-hit kernel")
    for i, (o_s, d_s, rows, cfg_s, t_trace) in enumerate(sub.kept):
        args = (*rows, cfg_s.eps, cfg_s.eps_bary, cfg_s.max_ray_len)
        t_plain = PI.nearest_hit_torch(o_s, d_s, *args, ray_block=1 << 16)[0]
        t_k = PI.nearest_hit_cuda(o_s, d_s, *args)[0]
        torch.cuda.synchronize()
        bits = int((t_trace.view(torch.int32)
                    != t_plain.view(torch.int32)).sum())
        bits_k = int((t_k.view(torch.int32)
                      != t_plain.view(torch.int32)).sum())
        line("16 sub-step launch vs plain", call=i, rays=o_s.shape[0],
             rows=rows[0].shape[0], hits=int(torch.isfinite(t_trace).sum()),
             t_bit_mismatch=bits, t_bit_mismatch_relaunch=bits_k)
        check(bits == 0 and bits_k == 0, f"phase 16 sub-step check {i}: the "
              "kernel bitwise equal to the plain version")
    substep_calls, substep_launches = sub.calls, sub.launches
    del sub
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
         wall_1_s=g1.wall_time, wall_8_s=g8.wall_time,
         wall_8_below_1=g8.wall_time < g1.wall_time, launches=launches_g,
         cull_launches=cull_launches_g, launches_1=launches_g1,
         launches_8=launches_g - launches_g1,
         substep_launches=substep_launches, substep_calls=substep_calls)

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


class CallTap:
    """While active, wraps module.`name`: each call runs inside a
    torch.profiler.record_function(`span`) range when a span is given, and
    the first and last calls' arguments are kept (tensors cloned) to make
    the call again alone. On spectral.film_stack_reflectance (the film
    stack of the shared spectral step) and step.intersect_bounce (its
    nearest hit)."""

    def __init__(self, module, name, span=None):
        self.module, self.name, self.span = module, name, span
        self.first, self.last = None, None

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def keep(a):
            return (a.clone(memory_format=torch.contiguous_format)
                    if isinstance(a, torch.Tensor) else a)

        def wrapped(*args, **kw):
            kept = ([keep(a) for a in args],
                    {k: keep(a) for k, a in kw.items()})
            if self.first is None:
                self.first = kept
            self.last = kept
            if self.span is None:
                return fn(*args, **kw)
            with torch.profiler.record_function(self.span):
                return fn(*args, **kw)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def film_tap(PS):
    """The film stack of the shared spectral step, in a 'film_stack'
    profiler range."""
    return CallTap(PS, "film_stack_reflectance", span="film_stack")


SELECTS = ("tir", "coated", "r_fresnel")


def film_compare(FS, args, sel):
    """(bit mismatches, max abs error, entries) of the film-stack kernel
    against its plain version on one call's arguments and the trace's
    selects `sel`, a dict of SELECTS."""
    sel = {k: sel[k] for k in SELECTS}
    k = FS.film_stack_cuda(*args, **sel)
    p = FS.film_stack_torch(*args, **sel)
    torch.cuda.synchronize()
    bits = int((k.view(torch.int32) != p.view(torch.int32)).sum())
    return bits, float((k - p).abs().max()), k.numel()


def edge_selects(n, seed):
    """Selects for n edge stacks, as the trace gives them: about 60%
    coated, 20% under TIR, a Fresnel R for the rest."""
    rng = np.random.default_rng(seed)
    return {"tir": torch.from_numpy(rng.uniform(size=n) < 0.2).cuda(),
            "coated": torch.from_numpy(rng.uniform(size=n) < 0.6).cuda(),
            "r_fresnel": torch.from_numpy(
                rng.uniform(size=n).astype(np.float32)).cuda()}


def load_film_checks():
    """Build (once) and load csrc/film_stack_checks.cu."""
    from lightpycl_tpu_torch.ops import _build

    lib = _build.load(FILM_CHECKS_SRC)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, types in (("lpcl_film_modulus_test", [p, p, i, p, p]),
                        ("lpcl_film_sincos_test", [p, p])):
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def modulus_test():
    """The film-stack kernel's modulus test (|z| > 1e-20 settled from the
    sum of the parts' moduli, hypotf only in the band between) against
    hypotf on the card: 2^24 pairs log-uniform over the band and a decade
    around it, random signs, and every pair of a set of special values and
    band edges with their float32 neighbours. Returns (pairs,
    mismatches)."""
    rng = np.random.default_rng(9)
    n = 1 << 24
    xy = (10.0 ** rng.uniform(-21.5, -19.0, (2, n))
          * rng.choice([-1.0, 1.0], (2, n))).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-45, 1.17549435e-38, 9.9e-21, 2.9e-20,
                        1.45e-20, 4.95e-21, 1e-20, 7.07e-21, 1.4142e-20, 1.0,
                        3.4e38, np.inf, -np.inf, np.nan], np.float32)
    special = np.concatenate([special, np.nextafter(special, np.float32(0)),
                              np.nextafter(special, np.float32(np.inf))])
    gx, gy = np.meshgrid(special, -special)
    x = torch.from_numpy(np.concatenate([xy[0], gx.ravel()])).cuda()
    y = torch.from_numpy(np.concatenate([xy[1], gy.ravel()])).cuda()
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = load_film_checks().lpcl_film_modulus_test(
        x.data_ptr(), y.data_ptr(), x.numel(), count.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, "film-stack modulus test launched")
    torch.cuda.synchronize()
    return x.numel(), int(count.item())


def film_edge_args(L, per_ray):
    """edge_rays.film_edge_inputs on the card: 65,536 stacks of depth L
    against 32 wavelengths, or one wavelength a ray."""
    from edge_rays import film_edge_inputs

    args = [torch.from_numpy(a).cuda()
            for a in film_edge_inputs(FILM_EDGE_RAYS, L, seed=L)]
    rng = np.random.default_rng(100 + L)
    wl = (rng.uniform(0.4, 0.75, FILM_EDGE_RAYS) if per_ray
          else np.linspace(0.40, 0.75, SPEC_W)[None, :])
    return args + [torch.from_numpy(wl.astype(np.float32)).cuda()]


def sincos_test():
    """sincosf, which the film-stack kernel calls in place of sinf and
    cosf, against them on every float32 bit pattern on the card: (sine,
    cosine) mismatches."""
    count = torch.zeros(2, dtype=torch.int64, device="cuda")
    err = load_film_checks().lpcl_film_sincos_test(
        count.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(err == 0, "film-stack sincos test launched")
    torch.cuda.synchronize()
    return int(count[0]), int(count[1])


def morton_vs_slot_order(PI, S, call):
    """The shared step's first culled launch made again two ways, from the
    arguments `call` = (scene, SpectralRays, cfg, cull frame) of its
    step.intersect_bounce: in Morton order, scattered back (what the step
    runs), and in slot order; (t, tri) of every live ray bitwise, the
    pairs each launch's mask keeps, and each launch's kernel time."""
    scene, sr, cfg, frame = call
    _, t_m, tri_m = S.intersect_bounce(scene, sr, cfg, frame,
                                       slot_order=True)
    t_s, tri_s = PI.intersect(scene, sr.o, sr.d, cfg, alive=sr.alive,
                              frame=frame)
    torch.cuda.synchronize()
    live = sr.alive
    t_bits = int(((t_m.view(torch.int32) != t_s.view(torch.int32))
                  & live).sum())
    tri_bits = int(((tri_m != tri_s) & live).sum())
    perm = S.morton_order(sr.o, sr.d, sr.alive, frame.lo, frame.hi)
    C, T = sr.o.shape[0], scene.wu.shape[0]
    out = {"rays": C, "live": int(live.sum()),
           "hits": int(((tri_s >= 0) & live).sum()), "triangles": T,
           "t_bit_mismatch": t_bits, "tri_mismatch": tri_bits}
    rows = (scene.wu, scene.wv, scene.ww, cfg.eps, cfg.eps_bary,
            cfg.max_ray_len)
    for name, idx in (("slot", None), ("morton", perm)):
        o, d, a = ((sr.o, sr.d, sr.alive) if idx is None else
                   (sr.o[idx].contiguous(), sr.d[idx].contiguous(),
                    sr.alive[idx]))
        mask = PI.block_tile_mask(frame, o, d, cfg.max_ray_len, alive=a)
        n = kept_pairs(mask, C, T, PI.RAY_BLOCK, PI.TRI_TILE)
        out[f"kept_share_{name}"] = f"{n / (C * T):.5f}"
        out[f"kernel_ms_{name}"] = cuda_ms(
            lambda: PI.nearest_hit_cuda(o, d, *rows, mask=mask))
    line("19 morton vs slot order", **out)
    check(t_bits == 0 and tri_bits == 0, "phase 19: the Morton-ordered "
          "launch, scattered back, bitwise equal to the slot-order launch")
    return out


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
    shapes, and the film-stack kernel against its plain version. Returns
    the (brute, culled) nearest-hit launches of the counted traces and the
    film-stack kernel's row of the kernel table."""
    from lightpycl_tpu_torch import spectral as PS
    from lightpycl_tpu_torch.ops import film_stack as FS
    from lightpycl_tpu_torch.tracer import step as S

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
    with LaunchTap(PI, (0, 3)) as tap, \
            CallTap(S, "intersect_bounce") as slots:
        FS.film_stack_cuda.launches = 0
        res, brute_s, cull_s = counted(PI, spec)
        film_s = FS.film_stack_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = [res, spec(), spec()]
    check(all(same_spectral(res, r) for r in runs[1:]),
          "phase 19 repeat runs bit-identical")
    wall = min(r.wall_time for r in runs)
    check(res.rays_traced == 2 * SPEC_RAYS * SPEC_ITERS,
          "phase 19 took the shared method (one geometry pass)")
    check(cull_s == SPEC_ITERS and brute_s == 0,
          "phase 19: auto-cull on, one culled launch a bounce")
    check(film_s == SPEC_ITERS,
          "phase 19: the film-stack kernel launched once a bounce")
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
    morton = morton_vs_slot_order(PI, S, slots.first[0])
    del slots
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
         morton_kept_share_0=morton["kept_share_morton"],
         slot_order_kept_share_0=morton["kept_share_slot"],
         peak_mem_gib=f"{peak:.3f}", launches=brute_s + cull_s,
         cull_launches=cull_s, film_stack_launches=film_s,
         plain_rays=PHYS_CMP_RAYS,
         plain_wall_s=small["torch"].wall_time,
         kernel_wall_s=small["cuda"].wall_time)
    del small

    # ---- 19 film stack: the kernel against its plain version, on phase
    #      19's own arguments (its first and last bounce, with the trace's
    #      selects and, for the first, every ray computed) and on stacks
    #      built to sit on its guards (with the trace's selects and every
    #      ray computed), bit for bit; its time at phase 19's shape beside
    #      the plain version's and its bound, every ray computed (the
    #      kernel line's `ms`) and with the trace's selects; its modulus
    #      test against hypotf
    with film_tap(PS) as film:
        spec()
    every = FS.every_ray(film.first[0][0].shape[0], device="cuda")
    worst, entries = 0.0, 0
    for name, (args, kw) in (("bounce 0", film.first),
                             (f"bounce {SPEC_ITERS - 1}", film.last),
                             ("bounce 0, every ray", (film.first[0], every))):
        bits, err, n = film_compare(FS, args, kw)
        worst, entries = max(worst, err), entries + n
        line("19 film stack vs plain", call=repr(name), entries=n,
             layers=args[3].shape[1], bit_mismatch=bits, max_abs_err=err,
             computed_rays=FS.computed_rays(kw["tir"], kw["coated"]))
        check(bits == 0, f"phase 19 film stack, {name}: the kernel bitwise "
              "equal to its plain version")
    for L in range(1, 9):
        for per_ray in (False, True):
            for folded in (False, True):
                args = film_edge_args(L, per_ray)
                sel = (edge_selects(FILM_EDGE_RAYS, L) if folded else
                       FS.every_ray(FILM_EDGE_RAYS, device="cuda"))
                bits, err, n = film_compare(FS, args, sel)
                worst, entries = max(worst, err), entries + n
                line("19 film stack edge", layers=L,
                     wavelengths="one a ray" if per_ray else SPEC_W,
                     selects=folded, entries=n, bit_mismatch=bits,
                     max_abs_err=err)
                check(bits == 0, f"film stack on the guards, {L} layers: "
                      "the kernel bitwise equal to its plain version")
    pairs, wrong = modulus_test()
    line("19 film stack modulus test", pairs=pairs, mismatch=wrong)
    check(wrong == 0, "film stack: the settled modulus test == hypotf")
    sin_bad, cos_bad = sincos_test()
    line("19 film stack sincos test", floats=1 << 32, sin_mismatch=sin_bad,
         cos_mismatch=cos_bad)
    check(sin_bad == 0 and cos_bad == 0,
          "film stack: sincosf == sinf, cosf on every float32")
    args, kw = film.first
    sel = {k: kw[k] for k in SELECTS}
    C_f, L_f, W_f = args[3].shape[0], args[3].shape[1], args[5].shape[1]
    computed = FS.computed_rays(sel["tir"], sel["coated"])
    film_ms = cuda_ms(lambda: FS.film_stack_cuda(*args, **every))
    film_sel_ms = cuda_ms(lambda: FS.film_stack_cuda(*args, **sel))
    film_plain_ms = cuda_ms(lambda: FS.film_stack_torch(*args, **every))
    film_plain_sel_ms = cuda_ms(lambda: FS.film_stack_torch(*args, **sel))
    film_bound_ms, film_bound_by = FS.bound_ms(C_f, L_f, W_f)
    bound_sel_ms, bound_sel_by = FS.bound_ms(C_f, L_f, W_f,
                                             computed=computed)
    fs_lib = FS.load_kernel()
    attrs = [ctypes.c_int() for _ in range(4)]
    check(fs_lib.lpcl_film_stack_resources(*map(ctypes.byref, attrs)) == 0,
          "film-stack kernel resources readable")
    regs, smem, local, threads = (a.value for a in attrs)
    line("19 film stack", slots=C_f, layers=L_f, wavelengths=W_f,
         kernel_ms=film_ms, plain_ms=film_plain_ms,
         speedup=f"{film_plain_ms / film_ms:.4f}", bound_ms=film_bound_ms,
         bound_by=film_bound_by,
         share_of_bound=f"{film_bound_ms / film_ms:.4f}",
         computed_rays=computed, kernel_ms_with_selects=film_sel_ms,
         plain_ms_with_selects=film_plain_sel_ms,
         bound_ms_with_selects=bound_sel_ms,
         bound_by_with_selects=bound_sel_by,
         share_of_bound_with_selects=f"{bound_sel_ms / film_sel_ms:.4f}",
         entries_held=entries, max_abs_err=worst, launches=film_s,
         registers=regs, static_smem_bytes=smem, local_bytes=local,
         threads=threads)
    # ms / plain_ms / bound_ms: every ray computed, a workload fixed by the
    # shape alone; the trace's own call (uncoated and TIR rays skipped)
    # under *_with_selects
    film_row = {
        "name": "film_stack (Airy recursion, B 3)", "route": "cuda",
        "source": FILM_SRC, "replaces": FILM_REPLACES, "launches": film_s,
        "max_abs_err": worst, "ms": film_ms, "plain_ms": film_plain_ms,
        "bound_ms": film_bound_ms, "bound_by": film_bound_by,
        "share_of_bound": film_bound_ms / film_ms, "library_ms": None,
        "slots": C_f, "layers": L_f, "wavelengths": W_f,
        "computed_rays": computed, "ms_with_selects": film_sel_ms,
        "plain_ms_with_selects": film_plain_sel_ms,
        "bound_ms_with_selects": bound_sel_ms, "entries_held": entries}
    del film, args, kw, sel, every

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
    with film_tap(PS) as film:
        split = profile_trace(spec, top=6, span="film_stack")
    args, kw = film.first
    sel = {k: kw[k] for k in SELECTS}
    every = FS.every_ray(args[0].shape[0], device="cuda")
    one_ms = cuda_ms(lambda: FS.film_stack_cuda(*args, **sel))
    one_all_ms = cuda_ms(lambda: FS.film_stack_cuda(*args, **every))
    bound_all_ms, _ = FS.bound_ms(args[3].shape[0], args[3].shape[1],
                                  args[5].shape[1])
    del film, args, kw, sel, every
    check(split["kernel_ms"] > 0, "phase 19 trace: profiler saw the kernel")
    film_total = split.pop("span_ms")
    check(film_total > 0, "phase 19 trace: profiler saw the film stack")
    line("22 profile shared", film_stack_ms=film_total,
         other_ms=split["busy_ms"] - split["kernel_ms"] - film_total,
         film_stack_one_bounce_ms=one_ms,
         film_stack_one_bounce_every_ray_ms=one_all_ms,
         film_stack_share_of_bound_every_ray=(
             f"{bound_all_ms / one_all_ms:.4f}"),
         kernel_share_of_busy=f"{split['kernel_ms'] / split['busy_ms']:.4f}",
         film_share_of_busy=f"{film_total / split['busy_ms']:.4f}", **split)
    split2 = profile_trace(batched, top=6)
    check(split2["kernel_ms"] > 0, "phase 20 trace: profiler saw the kernel")
    line("22 profile batched", film_stack_ms=0.0,
         kernel_share_of_busy=(
             f"{split2['kernel_ms'] / split2['busy_ms']:.4f}"), **split2)
    return brute_s + brute_b + brute_w, cull_s + cull_b + cull_w, film_row


# ---- 23. the float64 oracle's parity contract ---------------------------
# BASELINE configs 1-3 (lightpycl_tpu_torch.tracer.parity); config 1 at
# 100,000 rays, configs 2 and 3 at the largest counts the native oracle
# traces in about 30 s each on the card machine's host
ORACLE_RAYS = {1: 100_000, 2: 196_608, 3: 98_304}


def oracle_phases(P, PI):
    """Phase 23: configs 1-3 traced on the card (device mode) and by the
    port's float64 oracle (lightpycl_tpu_torch.tracer.oracle) on the same
    rays; detected power within 0.1 %, as tests/test_parity_oracle.py
    holds the reference. The first two launches of each card trace are
    tapped and held to the plain version. Returns the (brute, culled)
    kernel launches of the card's traces."""
    from lightpycl_tpu_torch import native
    from lightpycl_tpu_torch.tracer.oracle import trace_oracle
    from lightpycl_tpu_torch.tracer.parity import (CONFIGS, PARITY,
                                                   parity_config)

    path = native.backend()
    line("23 oracle", backend=path, library=(native.library_path().name
                                              if path == "native" else None))
    brute = cull = 0
    for k in CONFIGS:
        els, src, iters, per_ray = parity_config(k, ORACLE_RAYS[k])
        o, d, p = src.sample()
        n = len(p)

        def card():
            return P.Tracer().trace(
                None, els, trace_iterations=iters, mode="device",
                rays=P.RayBatch.from_arrays(o, d, p, capacity=per_ray * n,
                                            device="cuda"))

        card()  # first use of this scene's shapes
        with LaunchTap(PI, (0, 1)) as tap:
            res, b, c = counted(PI, card)
        brute, cull = brute + b, cull + c
        t0 = time.perf_counter()
        ora = trace_oracle(els, o, d, p, trace_iterations=iters)
        oracle_s = time.perf_counter() - t0
        led = res.ledger
        rel = abs(led["measured"] - ora["measured"]) / ora["measured"]
        extra = {}
        if k == 1:
            extra = dict(absorbed=led["absorbed"],
                         oracle_absorbed=ora["absorbed"])
            check(abs(led["absorbed"] - ora["absorbed"])
                  <= max(PARITY * ora["absorbed"], 1e-6),
                  "config 1 absorbed within 0.1 % of the oracle")
        if k == 2:
            extra = dict(escaped=led["escaped"],
                         oracle_escaped=ora["escaped"])
            check(abs(led["escaped"] - ora["escaped"])
                  <= max(5e-3 * ora["escaped"], 1e-5),
                  "config 2 escaped within 0.5 % of the oracle")
        if k == 3:
            extra = dict(per_detector=float(res.per_detector[0]))
            check(abs(res.per_detector[0] - ora["measured"])
                  <= PARITY * ora["measured"],
                  "config 3 per-detector power within 0.1 % of the oracle")
        line(f"23 oracle config{k}", rays=n, capacity=per_ray * n,
             triangles=sum(e.num_triangles for e in els), iterations=iters,
             measured=led["measured"], oracle_measured=ora["measured"],
             rel_err=f"{rel:.3e}", conservation_err=(
                 res.power_conservation_error()),
             trace_wall_s=res.wall_time, oracle=path,
             oracle_s=f"{oracle_s:.3f}", launches=b, cull_launches=c,
             **extra)
        for bounce, launch in sorted(tap.kept.items()):
            hold_to_plain(PI, f"23 config{k}", bounce, launch)
        check(rel <= PARITY, f"config {k} detected power within 0.1 % of "
              "the float64 oracle")
        check(res.power_conservation_error() <= 1e-5,
              f"config {k} ledger closes")
    return brute, cull


# ---- 24. the example scripts through the port -----------------------------
# scripts that need a module the port lacks (none since parallel/)
EXAMPLES_NOT_PORTED = {}
# the scripts that run only the differentiable path (diff.py), which never
# launches the nearest-hit kernel
DIFF_ONLY = {"example_bestform.py", "example_lens_design.py"}
# jax.value_and_grad / jax.grad on torch autograd, for the copies of the
# design scripts: the gradient of f in its positional arguments `argnums`
# at leaves on the card
TORCH_AD = """import torch


def value_and_grad(f, argnums=0):
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    def vg(*args):
        args = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
                .detach().requires_grad_(i in nums)
                for i, a in enumerate(args)]
        v = f(*args)
        g = torch.autograd.grad(v, [args[i] for i in nums])
        return v.detach(), g[0] if isinstance(argnums, int) else g
    return vg


def grad(f, argnums=0):
    vg = value_and_grad(f, argnums)
    return lambda *args: vg(*args)[1]
"""
# Six scripts call jax themselves: two for an analytic cross-check of a
# physics function on a handful of numbers, three (the lens-design,
# tolerancing and best-form demos) for their design loops' autodiff and
# optimizer, and the multichip demo to count devices (and to force the CPU
# on request, which the card's copy drops). The card's machine has no jax,
# so their copies also get these lines in torch (the same functions of the
# port, on the same numbers; optax.adam -> torch.optim.Adam, bestform's
# jax.vmap over focus planes -> a loop; jax.devices() -> the cards)
JAX_LINES = {
    "example_multichip.py": [
        ('if os.environ.get("LPCL_FORCE_CPU"):\n    import jax\n\n'
         '    jax.config.update("jax_platforms", "cpu")\n\nimport jax\n'
         'import numpy as np\n', "import numpy as np\nimport torch\n"),
        ("n_avail = len(jax.devices())",
         "n_avail = torch.cuda.device_count()")],
    "example_newtonian.py": [
        ("import jax\nimport jax.numpy as jnp\n", "import torch\n"),
        ("arr = lambda x: jnp.atleast_1d(jnp.asarray(x, jnp.float32))",
         "arr = lambda x: torch.atleast_1d(torch.as_tensor(x, "
         "dtype=torch.float32))"),
        ("metal_rs_rp = jax.jit(metal_rs_rp)\n", ""),
        ("jnp.abs(", "torch.abs(")],
    "example_spectral_coating.py": [
        ("import jax.numpy as jnp\n", "import torch\n"),
        ("arr = jnp.asarray", "arr = lambda x: torch.as_tensor(x, "
         "dtype=torch.float32)"),
        ("import jax as _jax\n\n_ml = _jax.jit(multilayer_reflectance)",
         "_ml = multilayer_reflectance")],
    "example_lens_design.py": [
        ("import jax\nimport jax.numpy as jnp\n", TORCH_AD),
        ("jax.jit(jax.value_and_grad(", "(value_and_grad("),
        ("jnp.float32(", "torch.tensor(")],
    "example_tolerancing.py": [
        ("import jax\nimport jax.numpy as jnp\n", TORCH_AD),
        ("gfn = jax.jit(jax.grad(loss, argnums=0))",
         "gfn = grad(loss, argnums=0)")],
    "example_bestform.py": [
        ("import jax\nimport jax.numpy as jnp\nimport numpy as np\n"
         "import optax\n", "import numpy as np\n" + TORCH_AD),
        ("loss = jax.jit(lambda k2: loss_full(0.0, c2, 0.0, k2, t_c + f))",
         "loss = lambda k2: loss_full(0.0, c2, 0.0, k2, t_c + f)"),
        ("vg = jax.jit(jax.value_and_grad(loss))",
         "vg = value_and_grad(loss)"),
        ("k2 = jnp.float32(0.0)\nopt = optax.adam(0.15)\n"
         "state = opt.init(k2)\n",
         "k2 = torch.zeros((), device=\"cuda\", requires_grad=True)\n"
         "opt = torch.optim.Adam([k2], lr=0.15)\n"),
        ("    upd, state = opt.update(g, state)\n"
         "    k2 = optax.apply_updates(k2, upd)\n",
         "    k2.grad = g\n    opt.step()\n"),
        ("zs = jnp.linspace(", "zs = torch.linspace("),
        ("batch = jax.jit(jax.vmap(\n    lambda z, q: lf(",
         "batch = lambda zs, q: torch.stack([lf("),
        ("0.0, 0.0, z),\n    in_axes=(0, None)))", "0.0, 0.0, z) for z in zs])"),
        ("jnp.min(", "torch.min(")],
}
EXAMPLE_WORKERS = 4
EXAMPLE_TIMEOUT_S = 300
# runs one copied script in its own interpreter, then writes the kernel
# launches it made (the wrapper's counts start at 0 in a new process)
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "from lightpycl_tpu_torch.ops import intersect as PI\n"
    "try:\n"
    "    runpy.run_path(sys.argv[1], run_name='__main__')\n"
    "finally:\n"
    "    with open(sys.argv[2], 'w') as f:\n"
    "        json.dump([PI.nearest_hit_cuda.launches,\n"
    "                   PI.nearest_hit_cuda.cull_launches], f)\n")


def example_copy(src: str, name: str):
    """The script with its import root swapped (and its own jax lines in
    torch where JAX_LINES lists them); returns (text, lines translated)."""
    text = re.sub(r"\blightpycl_tpu\b", "lightpycl_tpu_torch", src)
    for old, new in JAX_LINES.get(name, ()):
        check(old in text, f"{name}: its jax line {old!r} is where expected")
        text = text.replace(old, new)
    check(not re.search(r"^(import|from) jax\b", text, re.M),
          f"{name}: no top-level jax import left")
    return text, len(JAX_LINES.get(name, ()))


def example_phases(P, PI):
    """Phase 24: every example script, copied with its import root swapped, each in its own python3 process
    on the card at its own default size (LPCL_FORCE_CPU unset), four at a
    time. Returns the (brute, culled) kernel launches of the scripts."""
    import glob

    repo = os.path.dirname(os.path.abspath(__file__))
    names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(repo, "examples", "example_*.py")))
    names = [n for n in names if n not in EXAMPLES_NOT_PORTED]
    check(len(names) == 31, f"31 example scripts to run, found {len(names)}")
    tmpdir = tempfile.TemporaryDirectory(prefix="lpcl_examples_")
    tmp = tmpdir.name
    env = dict(os.environ)
    env.pop("LPCL_FORCE_CPU", None)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # example_large_mesh checkpoints to /tmp by default: keep it here
    env["CKPT"] = os.path.join(tmp, "large_mesh_ckpt.npz")

    def run_one(name):
        with open(os.path.join(repo, "examples", name)) as f:
            src = f.read()
        text, translated = example_copy(src, name)
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            f.write(text)
        counts = path + ".launches.json"
        sizes = dict(re.findall(
            r'environ\.get\("([A-Z_]+)", ([0-9_ <]+)\)', src))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXAMPLE_RUNNER, path, counts], cwd=tmp,
            env=env, capture_output=True, text=True,
            timeout=EXAMPLE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        try:
            with open(counts) as f:
                launches, cull_launches = json.load(f)
        except OSError:
            launches = cull_launches = 0
        out = proc.stdout.strip().splitlines()
        err = proc.stderr.strip().splitlines()
        return dict(name=name, wall=wall, rc=proc.returncode,
                    last=(out[-1] if out else ""), err=err[-12:],
                    sizes=sizes, translated=translated,
                    brute=launches - cull_launches, cull=cull_launches)

    t0 = time.perf_counter()
    with tmpdir, ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        rows = list(pool.map(run_one, names))
    phase_s = time.perf_counter() - t0
    brute = cull = 0
    for r in rows:
        brute, cull = brute + r["brute"], cull + r["cull"]
        size = ",".join(f"{k}={v}" for k, v in r["sizes"].items()) or "fixed"
        line(f"24 example {r['name']}", wall_s=f"{r['wall']:.2f}",
             rc=r["rc"], size=f"default:{size}", launches=r["brute"],
             cull_launches=r["cull"], jax_lines_in_torch=r["translated"],
             last=repr(r["last"][:160]))
        if r["rc"] != 0:
            for e in r["err"]:
                print(f"[24 example {r['name']} stderr] {e}", flush=True)
    line("24 examples", scripts=len(rows), workers=EXAMPLE_WORKERS,
         phase_s=f"{phase_s:.1f}", launches=brute, cull_launches=cull,
         not_run=",".join(f"{n}({m})"
                          for n, m in sorted(EXAMPLES_NOT_PORTED.items()))
         or "none")
    failed = [r["name"] for r in rows if r["rc"] != 0]
    check(not failed, f"example scripts exited non-zero: {failed}")
    check(all((r["brute"] + r["cull"] > 0) != (r["name"] in DIFF_ONLY)
              for r in rows),
          "every example script launched the kernel, but for the two that "
          "run only the differentiable path, which launched none")
    return brute, cull


# ---- 25. differentiable design on the card ---------------------------------
LENSMAKER = dict(ior=1.5, thickness=0.3, aperture_radius=0.2, n_rays=150,
                 beam_fill=0.75, n_seg=64, n_rad=24)   # tests/test_diff.py
CONIC_F, CONIC_T = 3.0, 0.15     # the flat-front f/3.3 singlet (demo 3)
CONIC_C2 = -1.0 / (0.5 * CONIC_F)
CONIC_MESH = dict(ior=1.5, thickness=CONIC_T, aperture_radius=0.6,
                  n_rays=300, beam_fill=0.75, n_seg=64, n_rad=96)
VCOAT = dict(n_sub=1.52, wavelengths=[0.55], fixed_n=[1.38, 2.10],
             steps=1500, lr=0.02)
VCOAT_RAYS = 1 << 16


def synced_s(fn):
    """fn()'s result and its wall in seconds, to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_step(fn, top=3):
    """One warm call of fn under torch.profiler: the device's busy time,
    its idle share of the call's wall (from a call without the profiler),
    the number of device kernels and the `top` largest ops (host ranges
    left out, `_device_work`)."""
    from torch.profiler import ProfilerActivity, profile

    _, wall = synced_s(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, kernels, tops = 0.0, 0, []
    for ev, ms in _device_work(prof):
        busy += ms
        kernels += ev.count
        tops.append((ms, ev.key[:40].replace(" ", "_")))
    tops.sort(reverse=True)
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "idle_share": f"{1 - busy / (wall * 1e3):.4f}",
            "kernels": kernels,
            "top": ",".join(f"{k}:{ms:.3f}" for ms, k in tops[:top])}


def design_phases(P, PI):
    """Phase 25: differentiable design (diff.py) on the card: the lensmaker
    descent, make_spot_loss and its gradient on the card against the CPU,
    the stigmatic conic (exact surfaces and mesh), and the V-coat designed
    and traced. Returns the (brute, culled) kernel launches of the V-coat
    traces; the design loops themselves must launch none."""
    from lightpycl_tpu_torch import diff as D

    cuda = torch.device("cuda")
    mesh_cfg = P.TraceConfig(backend="jnp", has_gratings=False,
                             has_coatings=False, has_metals=False)

    def mesh_spot(rays, c1, c2, z_plane, k2=0.0):
        """make_spot_loss's figure of merit for CONIC_MESH's singlet (back
        conic k2) on the given rays, which set the device."""
        scene = D.singlet_scene(c1, c2, CONIC_T, CONIC_MESH["aperture_radius"],
                                CONIC_MESH["ior"], n_seg=CONIC_MESH["n_seg"],
                                n_rad=CONIC_MESH["n_rad"], k2=k2)
        _, esc = D.trace_diff(scene, rays, mesh_cfg, 4, collect_escaped=True)
        return D.spot_rms_at_plane(*esc, z_plane,
                                   min_power=0.25 * rays.power.max().item())

    PI.nearest_hit_cuda.launches = PI.nearest_hit_cuda.cull_launches = 0
    t_phase = time.perf_counter()

    # (a) tests/test_diff.py's lensmaker descent: 60 steps of 0.1 x grad
    loss = D.make_spot_loss(**LENSMAKER)
    c1 = torch.tensor(0.62, device=cuda)
    walls = []

    def step(c):
        x = c.clone().requires_grad_(True)
        v = loss(x, 0.0, 4.0)
        g, = torch.autograd.grad(v, x)
        return v.detach(), g

    for _ in range(60):
        (v, g), wall = synced_s(lambda: step(c1))
        walls.append(wall * 1e3)
        c1 = c1 - 0.1 * g
    c1_opt, v_last = c1.item(), v.item()
    c1_theory = 1.0 / (0.5 * 3.9)
    rel = abs(c1_opt - c1_theory) / c1_theory
    line("25a lensmaker", steps=60, c1=f"{c1_opt:.6f}",
         c1_theory=f"{c1_theory:.6f}", rel_err=f"{rel:.5f}",
         spot_rms=f"{v_last:.6f}", rays=LENSMAKER["n_rays"],
         slots=4 * LENSMAKER["n_rays"],
         triangles=2 * 2 * 64 * 24 + 2 * 64,
         step_ms_first=f"{walls[0]:.3f}",
         step_ms_median=f"{np.median(walls[1:]):.3f}",
         step_ms_min=f"{min(walls[1:]):.3f}",
         loop_s=f"{sum(walls) / 1e3:.3f}")
    check(rel <= 0.02, "phase 25a: c1 within 2% of the lensmaker value")
    check(v_last < 6e-3, "phase 25a: the spot collapsed below 6e-3")
    line("25a profile", **profile_step(lambda: step(c1)))

    # (b) make_spot_loss and its gradient on the card and on the CPU
    args = (0.0, CONIC_C2, CONIC_T + CONIC_F)

    def value_grad(loss_fn, dev):
        xs = [torch.tensor(a, device=dev, requires_grad=True) for a in args]
        v = loss_fn(*xs)
        return v.item(), [x.item() for x in torch.autograd.grad(v, xs)]

    card_loss = D.make_spot_loss(**CONIC_MESH)
    (v_c, g_c), card_s = synced_s(lambda: value_grad(card_loss, cuda))
    (v_c, g_c), card_s = synced_s(lambda: value_grad(card_loss, cuda))
    # the CPU side: the same bundle and trace from tensors on the CPU
    rays_h = D.collimated_bundle(CONIC_MESH["n_rays"], torch.tensor(
        CONIC_MESH["beam_fill"] * CONIC_MESH["aperture_radius"]))
    t0 = time.perf_counter()
    v_h, g_h = value_grad(lambda *xs: mesh_spot(rays_h, *xs),
                          torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(v_c - v_h) / abs(v_h)
    grad_rel = [abs(a - b) / max(abs(b), 1e-7) for a, b in zip(g_c, g_h)]
    line("25b card_vs_cpu", loss_card=f"{v_c:.9g}", loss_cpu=f"{v_h:.9g}",
         loss_rel=f"{loss_rel:.3e}",
         grad_card=",".join(f"{x:.9g}" for x in g_c),
         grad_cpu=",".join(f"{x:.9g}" for x in g_h),
         grad_rel_max=f"{max(grad_rel):.3e}", rays=CONIC_MESH["n_rays"],
         triangles=2 * 2 * 64 * 96 + 2 * 64,
         card_ms=f"{card_s * 1e3:.3f}", cpu_ms=f"{cpu_s * 1e3:.3f}",
         cpu_threads=torch.get_num_threads())
    check(loss_rel <= 1e-5, "phase 25b: loss on the card within 1e-5 of "
          "the CPU's")
    check(max(grad_rel) <= 1e-4, "phase 25b: gradient on the card within "
          "1e-4 of the CPU's")

    # (c) the stigmatic conic k = -n^2: exact surfaces (landscape, Adam),
    # then tests/test_diff.py's meshed momentum descent
    lf = D.make_analytic_spot_loss(ior=1.5, thickness=CONIC_T,
                                   aperture_radius=0.6, n_rays=300,
                                   beam_fill=0.75)

    def conic(k2):
        return lf(0.0, CONIC_C2, 0.0, k2, CONIC_T + CONIC_F)

    with torch.no_grad():
        v_star, v_sph = conic(-2.25).item(), conic(0.0).item()
        v_lo, v_hi = conic(-2.1).item(), conic(-2.4).item()
    check(v_star < 1e-6 and v_sph > 1e-2 and min(v_lo, v_hi) > 100 * v_star,
          "phase 25c: the exact landscape's minimum sits at k = -n^2")
    k2 = torch.zeros((), device=cuda, requires_grad=True)
    opt = torch.optim.Adam([k2], lr=0.15)
    best_v, best_k = np.inf, 0.0

    def adam_loop():
        nonlocal best_v, best_k
        for _ in range(60):
            opt.zero_grad()
            v = conic(k2)
            v.backward()
            if v.item() < best_v:
                best_v, best_k = v.item(), k2.item()
            opt.step()

    _, adam_s = synced_s(adam_loop)
    line("25c analytic_conic", v_at_minus_n2=f"{v_star:.3e}",
         v_sphere=f"{v_sph:.3e}", steps=60, best_k=f"{best_k:.5f}",
         best_v=f"{best_v:.3e}", loop_s=f"{adam_s:.3f}",
         step_ms=f"{adam_s / 60 * 1e3:.3f}")
    check(abs(best_k + 2.25) <= 0.02 and best_v < 1e-4,
          "phase 25c: Adam finds k = -n^2 on exact surfaces")

    rays0 = D.collimated_bundle(CONIC_MESH["n_rays"], CONIC_MESH[
        "beam_fill"] * CONIC_MESH["aperture_radius"])

    def mesh_conic(k):
        return mesh_spot(rays0, 0.0, CONIC_C2, CONIC_T + CONIC_F, k2=k)

    with torch.no_grad():
        v0 = mesh_conic(0.0).item()
    k, mom = torch.zeros((), device=cuda), 0.0

    def momentum_loop():
        nonlocal k, mom
        for _ in range(25):
            x = k.clone().requires_grad_(True)
            v = mesh_conic(x)
            g, = torch.autograd.grad(v, x)
            mom = 0.7 * mom + g
            k = k - 25.0 * mom
        return v.item()

    v_mesh, mesh_s = synced_s(momentum_loop)
    line("25c mesh_conic", steps=25, k2=f"{k.item():.5f}",
         v=f"{v_mesh:.3e}", v_sphere=f"{v0:.3e}", loop_s=f"{mesh_s:.3f}",
         step_ms=f"{mesh_s / 25 * 1e3:.3f}",
         triangles=2 * 2 * 64 * 96 + 2 * 64, slots=1200)
    check(abs(k.item() + 2.25) <= 0.35 and v_mesh < 0.35 * v0,
          "phase 25c: the meshed descent finds k = -n^2 within its facet "
          "bias")
    check(PI.nearest_hit_cuda.launches == 0,
          "phase 25a-c: the design loops launched no nearest-hit kernel")

    # (d) the V-coat designed, then traced on a coated window
    (n, h, r), design_s = synced_s(lambda: D.design_coating(2, **VCOAT))
    check(np.allclose(n, [1.38, 2.10]) and (h > 0).all() and r < 1e-8,
          "phase 25d: the V-coat nulls R below 1e-8")
    oe = P.optical_elements(n_segments=24, n_radial=8)

    def window(coating):
        kw = dict(coating=coating) if coating else {}
        return [oe.cube(size=(0.8, 0.8, 0.2), material="refractive",
                        ior=1.52, name="window", **kw),
                oe.disc(radius=1.2, center=(0, 0, 2.0), material="measure",
                        name="fwd"),
                oe.sphere(radius=6.0, material="terminator")]

    src = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                             diameter=0.3, ray_count=VCOAT_RAYS, power=1.0,
                             seed=3, wavelength=0.55)

    def transmission(coating):
        return P.Tracer().trace(src, window(coating), trace_iterations=10,
                                capacity=4 * VCOAT_RAYS).detector_power(
                                    "fwd")

    with LaunchTap(PI, (0, 1)) as tap:
        (t_coat, brute, cull), coat_s = synced_s(lambda: counted(
            PI, lambda: transmission([(1.38, float(h[0])),
                                      (2.10, float(h[1]))])))
    t_bare = transmission(None)
    r_bare = (0.52 / 2.52) ** 2
    t_pred = (1 - r_bare) ** 2 / (1 - r_bare ** 2)
    line("25d vcoat", steps=VCOAT["steps"], h_nm=",".join(
        f"{x * 1e3:.3f}" for x in h), R=f"{r:.3e}",
         design_s=f"{design_s:.3f}",
         design_step_ms=f"{design_s / VCOAT['steps'] * 1e3:.3f}",
         rays=VCOAT_RAYS, t_coated=f"{t_coat:.6f}", t_bare=f"{t_bare:.6f}",
         t_bare_predicted=f"{t_pred:.6f}", trace_s=f"{coat_s:.3f}",
         launches=brute, cull_launches=cull)
    check(sorted(tap.kept) == [0, 1], "phase 25d: launches 0 and 1 tapped")
    for bounce, launch in sorted(tap.kept.items()):
        hold_to_plain(PI, "25d vcoat", bounce, launch)
    check(t_coat > 0.999, "phase 25d: the designed V-coat transmits > 0.999 "
          "through the tracer")
    check(abs(t_bare - t_pred) <= 2e-4 and t_coat > t_bare + 0.07,
          "phase 25d: the bare window transmits the two-surface series")
    check(brute + cull > 0, "phase 25d: the trace launched the kernel")
    line("25 design", phase_s=f"{time.perf_counter() - t_phase:.1f}")
    return brute, cull

# ---- 26. the sharded modes (parallel/) on the card -------------------------
CFG5_RAYS = 1 << 17     # examples/example_multichip.py (BASELINE config 5)
CFG5_ITERS = 6
# config 4's mesh and source with 1,048,576 rays, not its 4,000,000: ranks
# that share one card sum about 30 hit-attribute floats a ray a bounce on
# the host (gloo), where NCCL on one card a rank would not
MESH2D_RAYS = 1 << 20
MESH2D_SEED = 4
MESH2D_SHAPE = {2: (2, 1), 4: (2, 2)}   # ranks -> ("tris", "rays")
RANK_TIMEOUT_S = 200


def cfg5_scene(P):
    """examples/example_multichip.py's scene and source."""
    oe = P.optical_elements(n_segments=96, n_radial=24)
    els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.95),
           oe.hemisphere(20.0, name="dome")]
    src = P.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                         power=1.0, ray_count=CFG5_RAYS, seed=1)
    return els, src


def mesh2d_rays(P, S, n=MESH2D_RAYS):
    """n rays of config 4's source, drawn on the card from a fixed seed (the
    same on every rank)."""
    o, d, p = cfg4_source(P).rays_on_device(
        S.make_generator("cuda", MESH2D_SEED), n)
    return P.RayBatch.from_arrays(o, d, p, device="cuda")


def tapped(PI, fn):
    """(fn()'s result, its wall in seconds, brute and culled launches, the
    plain-version comparison of its first launch)."""
    PI.nearest_hit_cuda.launches = PI.nearest_hit_cuda.cull_launches = 0
    with LaunchTap(PI, (0,)) as tap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cull = PI.nearest_hit_cuda.cull_launches
    brute = PI.nearest_hit_cuda.launches - cull
    return out, wall, brute, cull, plain_mismatch(PI, tap.kept[0])


def rank_job(rank, world):
    """What one spawned rank of phase 26b runs: config 5 in multichip mode,
    then config 4's mesh in mesh2d mode on MESH2D_SHAPE[world], each with
    its first launch held to the plain version. Returns plain values."""
    import lightpycl_tpu_torch as P
    from lightpycl_tpu_torch.ops import intersect as PI
    from lightpycl_tpu_torch.parallel import mesh2d
    from lightpycl_tpu_torch.tracer import step as S

    out = {}
    els, src = cfg5_scene(P)
    tr = P.Tracer().set_elements(els)
    tr.trace(src, trace_iterations=CFG5_ITERS, mode="multichip")  # first use
    res, wall, brute, cull, plain = tapped(PI, lambda: tr.trace(
        src, trace_iterations=CFG5_ITERS, mode="multichip"))
    out["cfg5"] = dict(ledger=res.ledger, hist=res.hist, wall_s=wall,
                       brute=brute, cull=cull, plain=plain)
    mesh = mesh2d.make_mesh2d(*MESH2D_SHAPE[world])
    tr4 = P.Tracer(P.TraceConfig(trace_iterations=2))
    tr4.set_elements(cfg4_elements(P))
    res, wall, brute, cull, plain = tapped(PI, lambda: tr4.trace(
        None, rays=mesh2d_rays(P, S), mode="mesh2d", mesh=mesh))
    out["mesh2d"] = dict(ledger=res.ledger, hist=res.hist, wall_s=wall,
                         brute=brute, cull=cull, plain=plain,
                         padded=tr4.scene.num_triangles_padded)
    return out


def nccl_job(rank, world):
    """One all-reduce on a multi-rank NCCL group whose ranks share card 0:
    NCCL must refuse it (and nothing may swap in another backend)."""
    x = torch.ones(1, device="cuda")
    torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    return float(x)


def _rank_entry(rank, world, store, out_dir, backend, job):
    import pickle
    import traceback

    from lightpycl_tpu_torch.parallel.distributed import init_distributed

    torch.cuda.set_device(0)
    path = f"{out_dir}/rank{rank}.pkl"
    try:
        init_distributed(f"file://{store}", num_processes=world,
                         process_id=rank, backend=backend)
        result = ("ok", job(rank, world))
        torch.distributed.destroy_process_group()
    except BaseException:  # reported to the parent, then re-raised
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise
    with open(path, "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(world, backend="gloo", job=rank_job,
                timeout=RANK_TIMEOUT_S):
    """`job` on `world` spawned ranks that share card 0 (over gloo: NCCL
    refuses two ranks on one card). A rank that fails, or a launch past
    `timeout`, kills every rank. Returns every rank's (status, result or
    traceback) and the launch's wall."""
    import pickle

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="lpcl_ranks_") as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, world, f"{tmp}/store", tmp, backend,
                                   job))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.perf_counter() - t0 < timeout):
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        wall = time.perf_counter() - t0
        results = []
        for r in range(world):
            try:
                with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                    results.append(pickle.load(f))
            except OSError:
                results.append(("missing", f"exit code {procs[r].exitcode}"))
    return results, wall


def gloo_ranks(world):
    """spawn_ranks over gloo, every rank held to have returned its result
    within the time limit."""
    results, wall = spawn_ranks(world)
    for r, (status, value) in enumerate(results):
        if status != "ok":
            print(f"[26 rank {r} of {world}] {value}", flush=True)
    check(wall < RANK_TIMEOUT_S, f"phase 26: {world} ranks ended within "
          f"{RANK_TIMEOUT_S} s")
    check(all(s == "ok" for s, _ in results),
          f"phase 26: all {world} ranks returned a result")
    return [v for _, v in results], wall


def multi_device_phases(P, PI, smi):
    """Phase 26: the sharded modes. (a) In this process, on a one-rank NCCL
    group: multichip trace, trace_batched and trace_spectral, and a (1, 1)
    mesh2d trace, each bit for bit equal to device mode. (b) 2 and 4
    spawned ranks on this card over gloo: config 5 in multichip mode
    (measured within rel 1e-4 of the one-rank run) and config 4's mesh in
    mesh2d mode at (2, 1) and (2, 2) (ledger within rel 1e-4, histogram
    atol 1e-5 of device mode), every rank's first launch bitwise equal to
    the plain version. (c) Two NCCL ranks on the card are refused. Returns
    the (brute, culled) kernel launches of the sharded runs, the ranks'
    included."""
    import torch.distributed as dist

    from lightpycl_tpu_torch.parallel import mesh2d, sharding
    from lightpycl_tpu_torch.tracer import step as S

    brute = cull = 0

    def count(fn):
        nonlocal brute, cull
        out, b, c = counted(PI, fn)
        brute, cull = brute + b, cull + c
        return out

    # ---- 26a. one process, a one-rank NCCL group on cuda:0 ---------------
    ray_mesh = sharding.make_ray_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "phase 26a: a one-rank NCCL group")
    cfg1_els, cfg1_src = config1_elements(), config1_source(BENCH_RAYS)

    def both(name, fn, same_fn):
        dev = fn("device")
        sharded = count(lambda: fn("sharded"))
        ok = same_fn(dev, sharded)
        line(f"26a {name}", device_wall_s=dev.wall_time,
             sharded_wall_s=sharded.wall_time,
             measured=sharded.ledger["measured"], bit_equal=ok)
        check(ok, f"phase 26a {name}: bit for bit equal to device mode")

    both("multichip config1", lambda m: P.Tracer().trace(
        cfg1_src, cfg1_els, trace_iterations=2,
        mode="device" if m == "device" else "multichip"), same_trace)
    both("multichip trace_batched config4", lambda m: P.Tracer(
        P.TraceConfig(trace_iterations=4)).trace_batched(
            cfg4_source(P), CFG4_BATCH, CFG4_BATCH,
            elements=cfg4_elements(P),
            mode="device" if m == "device" else "multichip"), same_batched)
    o, d, p = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                                 diameter=0.6, ray_count=SPEC_RAYS,
                                 power=1.0, seed=7).sample()
    wls = np.linspace(0.40, 0.75, SPEC_W)
    both("multichip trace_spectral phase19", lambda m: P.Tracer(
        ).trace_spectral(None, wls, elements=hr_window(P),
                         trace_iterations=SPEC_ITERS,
                         rays=P.RayBatch.from_arrays(
                             o, d, p, capacity=2 * SPEC_RAYS, device="cuda"),
                         mode="device" if m == "device" else "multichip"),
         same_spectral)
    tr4 = P.Tracer(P.TraceConfig(trace_iterations=2))
    tr4.set_elements(cfg4_elements(P))
    batch4 = P.RayBatch.from_arrays(*cfg4_source(P).rays_on_device(
        S.make_generator("cuda", 0, 0, 0), CFG4_BATCH), device="cuda")
    both("mesh2d(1,1) config4 batch", lambda m: tr4.trace(
        None, rays=batch4, mode="device") if m == "device" else tr4.trace(
        None, rays=batch4, mode="mesh2d", mesh=mesh2d.make_mesh2d(1, 1)),
        same_trace)
    del batch4

    # config 5 on the one-rank group: the runs of 26b are held to it
    els5, src5 = cfg5_scene(P)
    tr5 = P.Tracer().set_elements(els5)
    one = count(lambda: tr5.trace(src5, trace_iterations=CFG5_ITERS,
                                  mode="multichip", mesh=ray_mesh))
    line("26a config5 1 rank nccl", wall_s=one.wall_time,
         measured=one.ledger["measured"], card=repr(smi))
    # device mode on 26b's mesh2d rays, to hold the sharded runs to
    tr4 = P.Tracer(P.TraceConfig(trace_iterations=2))
    tr4.set_elements(cfg4_elements(P))
    dev2 = count(lambda: tr4.trace(None, rays=mesh2d_rays(P, S),
                                   mode="device"))
    line("26a mesh2d reference device", rays=MESH2D_RAYS,
         wall_s=dev2.wall_time, measured=dev2.ledger["measured"],
         padded_triangles=tr4.scene.num_triangles_padded)
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- 26b. 2 and 4 ranks spawned on this card over gloo ---------------
    for world in (2, 4):
        res, wall = gloo_ranks(world)
        for rank, r in enumerate(res):
            c5, m2 = r["cfg5"], r["mesh2d"]
            brute += c5["brute"] + m2["brute"]
            cull += c5["cull"] + m2["cull"]
            rel = abs(c5["ledger"]["measured"] - one.ledger["measured"]) / \
                one.ledger["measured"]
            line(f"26b config5 {world} ranks rank {rank}",
                 wall_s=c5["wall_s"], measured=c5["ledger"]["measured"],
                 rel_diff_vs_1_rank=f"{rel:.3e}", launches=c5["brute"],
                 cull_launches=c5["cull"])
            line(f"26b config5 {world} ranks rank {rank} launch 0 vs plain",
                 **c5["plain"])
            check(rel <= 1e-4, f"phase 26b: config 5 at {world} ranks "
                  "measures the one-rank power within rel 1e-4")
            led_rel = max(abs(m2["ledger"][k] - v) / max(abs(v), 1e-30)
                          for k, v in dev2.ledger.items() if abs(v) > 1e-7)
            hist_err = float(np.abs(m2["hist"] - dev2.hist).max())
            # one ray rank: the device trace's ray order, so its very bits
            bits = (m2["ledger"] == dev2.ledger
                    and np.array_equal(m2["hist"], dev2.hist))
            if MESH2D_SHAPE[world][1] == 1:
                check(bits, f"phase 26b: mesh2d{MESH2D_SHAPE[world]} bit "
                      "for bit equal to device mode")
            line(f"26b mesh2d{MESH2D_SHAPE[world]} rank {rank}",
                 wall_s=m2["wall_s"], measured=m2["ledger"]["measured"],
                 ledger_rel_max=f"{led_rel:.3e}", hist_err=hist_err,
                 bit_equal_to_device=bits,
                 padded_triangles=m2["padded"],
                 shard_rows=m2["plain"]["triangles"], launches=m2["brute"],
                 cull_launches=m2["cull"])
            line(f"26b mesh2d{MESH2D_SHAPE[world]} rank {rank} launch 0 "
                 "vs plain", **m2["plain"])
            check(led_rel <= 1e-4 and hist_err <= 1e-5,
                  f"phase 26b: mesh2d{MESH2D_SHAPE[world]} within rel 1e-4 "
                  "(ledger) and atol 1e-5 (hist) of device mode")
            for what in (c5, m2):
                check(what["plain"]["tri_mismatch"] == 0
                      and what["plain"]["t_bit_mismatch"] == 0,
                      f"phase 26b: rank {rank} of {world}: its first launch "
                      "bitwise equal to the plain version")
            check(m2["plain"]["culled"] and m2["plain"]["triangles"] * \
                  MESH2D_SHAPE[world][0] == m2["padded"],
                  "phase 26b: a mesh2d launch is one triangle shard's rows "
                  "with its own tile mask")
            check(r["cfg5"]["ledger"] == res[0]["cfg5"]["ledger"]
                  and r["mesh2d"]["ledger"] == res[0]["mesh2d"]["ledger"],
                  "phase 26b: every rank returns the same ledger")
        line(f"26b {world} ranks", launch_wall_s=f"{wall:.1f}",
             card=repr(smi), note="ranks share one card: times show no "
             "scaling")
    # ---- 26c. no fallback: two NCCL ranks on one card are refused --------
    results, wall = spawn_ranks(2, backend="nccl", job=nccl_job, timeout=90)
    errors = [v.strip().splitlines()[-1] for s, v in results if s != "ok"]
    line("26c nccl 2 ranks on one card", refused=len(errors),
         wall_s=f"{wall:.1f}", error=repr(errors[0][:160] if errors else ""))
    check(len(errors) == 2, "phase 26c: a two-rank NCCL group on one card "
          "is refused on every rank, with no other backend swapped in")
    line("26 multi-device", launches=brute, cull_launches=cull)
    check(brute > 0 and cull > 0, "phase 26: the sharded runs launched the "
          "kernel, brute and culled")
    return brute, cull


# ---- 27. the port's bench entry point --------------------------------------
BENCH_TIMEOUT_S = 120
BENCH_PHASE_S = 60
BENCH_VS_B1 = 0.05


def bench_phase(b1_tests_per_s):
    """Phase 27: `python3 -m lightpycl_tpu_torch.bench` in its own process on
    this card, as a user runs it: exit code 0 within BENCH_PHASE_S, a line
    with every key of bench.py's and each timed quantity's median,
    quartiles and count (at least ten), `value` within BENCH_VS_B1 of phase
    3's B1 rate, the bowl's cull speed-up above 1 and both kernel modes
    launched. Returns the line."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lightpycl_tpu_torch.bench"],
                          cwd=root, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(f"[27 bench stderr] {proc.stderr[-4000:]}", flush=True)
    check(proc.returncode == 0, "phase 27: the bench exits 0")
    text = proc.stdout.strip().splitlines()[-1]
    print(f"[27 bench line] {text}", flush=True)
    out = json.loads(text)
    want = list(BENCH_PY_KEYS) + ["power_limit"] + [
        f"{q}_{k}" for q in TIMED for k in ("median", "q1", "q3", "n")]
    missing = [k for k in want if k not in out]
    check(not missing, f"phase 27: the line holds every key ({missing})")
    check(all(out[f"{q}_n"] >= 10 for q in TIMED),
          "phase 27: at least ten samples of each timed quantity")
    ratio = out["value"] / b1_tests_per_s
    line("27 bench", wall_s=f"{wall:.1f}", value=f"{out['value']:.4e}",
         phase3_tests_per_s=f"{b1_tests_per_s:.4e}",
         value_vs_phase3=f"{ratio:.4f}",
         cull_speedup_bowl=out["cull_speedup_bowl"],
         launches=out["kernel_launches"],
         cull_launches=out["cull_kernel_launches"])
    check(wall < BENCH_PHASE_S, f"phase 27: under {BENCH_PHASE_S} s")
    check(abs(ratio - 1) <= BENCH_VS_B1, f"phase 27: value within "
          f"{BENCH_VS_B1:.0%} of phase 3's B1 rate")
    check(out["cull_speedup_bowl"] > 1, "phase 27: culling wins on the bowl")
    check(out["kernel_launches"] > out["cull_kernel_launches"] > 0,
          "phase 27: the bench launched the kernel, brute and culled")
    return out


def bincount_inputs(n, n_bins, W=None, seed=0):
    """Keys and values shaped like a bounce's detector sums: measured power
    on a tenth of the slots (zero elsewhere, of mixed magnitude), 60% of
    the slots in one bin, the rest spread over all of them; W columns of
    values if W is given."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_bins, n)
    idx[rng.random(n) < 0.6] = n_bins // 3
    shape = (n,) if W is None else (n, W)
    v = rng.uniform(0, 1, shape) * 10.0 ** rng.integers(-7, 0, shape)
    v[rng.random(n) >= 0.1] = 0.0
    return (torch.from_numpy(idx.astype(np.int32)).cuda(),
            torch.from_numpy(v.astype(np.float32)).cuda())


def image_inputs(n, n_bins, W=None, seed=0):
    """Keys and values shaped like a bounce of config 2's focal map into
    n_bins = nb^2 + 1 bins, the last the drop bin: over half of the slots
    fall outside the grid (one run of many chunks in the drop bin), a
    third pile into the caustic's central pixels (runs longer than a
    chunk), the rest spread over a central disc of a fourth of the grid's
    width (most pixels stay empty); measured power on 40% of the slots
    (zero elsewhere, of mixed magnitude), float32."""
    rng = np.random.default_rng(seed)
    nb = math.isqrt(n_bins - 1)
    ix = rng.normal(nb / 2, 1.5, n)
    iy = rng.normal(nb / 2, 1.5, n)
    wide = np.flatnonzero(rng.random(n) < 0.3)
    r = nb / 4 * np.sqrt(rng.random(len(wide)))
    phi = rng.uniform(0, 2 * np.pi, len(wide))
    ix[wide] = nb / 2 + r * np.cos(phi)
    iy[wide] = nb / 2 + r * np.sin(phi)
    idx = (np.clip(ix, 0, nb - 1).astype(np.int64) * nb
           + np.clip(iy, 0, nb - 1).astype(np.int64))
    idx[rng.random(n) < 0.55] = nb * nb
    v = rng.uniform(0, 1, n) * 10.0 ** rng.integers(-7, 0, n)
    v[rng.random(n) >= 0.4] = 0.0
    return (torch.from_numpy(idx.astype(np.int32)).cuda(),
            torch.from_numpy(v.astype(np.float32)).cuda())


def bincount_phase(main_path):
    """Phase 28: the detector bincount kernel (csrc/bincount.cu) held bit for
    bit to its plain version at config 3's and config 4's slots and bins
    (the histogram, and the one detector that takes every slot), at config
    2's focal map (more bins than a chunk has slots, `image_inputs`) and on
    spectral (n, W) inputs, twice each; then its card time beside its bound,
    the plain version's and torch.bincount's (1-D cases; atomics, so not the
    port's bits). `main_path` holds the kernel's launches in phases 10 and
    11's traces. Returns the kernel table's row."""
    from lightpycl_tpu_torch.ops import _build
    from lightpycl_tpu_torch.ops import bincount as BC

    for ptx in _build.ptxas_report("bincount.cu"):
        if ptx.strip():
            print(f"[28 ptxas] {ptx.strip()}", flush=True)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ptx)
        check(spill is None or spill.groups() == ("0", "0"),
              "bincount kernels: no register spills")
    cases = [("config3 hist", 800_000, HIST_BINS, None),
             ("config3 detector", 800_000, 1, None),
             ("config4 hist", 4_000_000, HIST_BINS, None),
             ("config4 detector", 4_000_000, 1, None),
             ("spectral per-detector", 524_288, 2, 32),
             ("spectral columns", 524_288, 32, 4),
             ("config2 image", 1_000_000, IMAGE_BINS ** 2 + 1, None)]
    launches0 = BC.bincount_sorted_cuda.launches
    timing, worst = {}, 0.0
    for name, n, n_bins, W in cases:
        make = image_inputs if name == "config2 image" else bincount_inputs
        idx, v = make(n, n_bins, W, seed=n + n_bins)
        k = BC.bincount_sorted(idx, v, n_bins)
        again = BC.bincount_sorted(idx, v, n_bins)
        plain = BC.bincount_sorted_torch(idx, v, n_bins)
        torch.cuda.synchronize()
        same = (torch.equal(k.view(torch.int32), plain.view(torch.int32))
                and torch.equal(k.view(torch.int32),
                                again.view(torch.int32)))
        err = float((k.double() - plain.double()).abs().max())
        worst = max(worst, err)
        keys, order = torch.sort(idx, stable=True)
        flat = v.reshape(n, -1).contiguous()
        out = torch.empty_like(k)
        kernel_ms = cuda_ms(lambda: BC._launch(keys, order, flat, out),
                            reps=20)
        call_ms = cuda_ms(lambda: BC.bincount_sorted(idx, v, n_bins),
                          reps=20)
        plain_ms = cuda_ms(lambda: BC.bincount_sorted_torch(idx, v, n_bins),
                           reps=5)
        library_ms = None if W else cuda_ms(
            lambda: torch.bincount(idx, weights=v, minlength=n_bins),
            reps=20)
        b_ms = BC.bound_ms(n, n_bins, W or 1)
        b_order_ms = BC.bound_ms(n, n_bins, W or 1, order_bytes=8)
        timing[name] = dict(slots=n, bins=n_bins, W=W or 1, ms=kernel_ms,
                            call_ms=call_ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=b_ms,
                            bound_with_order_ms=b_order_ms, max_abs_err=err)
        line(f"28 bincount {name}", slots=n, bins=n_bins, columns=W or 1,
             bit_equal_to_plain=same, repeat_equal=same, max_abs_err=err,
             kernel_ms=f"{kernel_ms:.4f}", call_ms=f"{call_ms:.4f}",
             plain_ms=f"{plain_ms:.4f}", library_ms=library_ms,
             bound_ms=f"{b_ms:.5f}", share_of_bound=f"{b_ms / kernel_ms:.4f}",
             bound_with_order_ms=f"{b_order_ms:.5f}")
        check(same, f"phase 28 {name}: kernel == plain version, bit for bit, "
                    f"twice")
    main = timing["config3 hist"]
    return {"name": "bincount_sorted (detector maps)", "route": "cuda",
            "source": BINCOUNT_SRC, "replaces": BINCOUNT_REPLACES,
            "launches": main_path["launches"],
            "launches_per_bounce": main_path["per_bounce"],
            "launches_phase28": BC.bincount_sorted_cuda.launches - launches0,
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_with_order_ms": main["bound_with_order_ms"],
            "bound_by": "bytes",
            "share_of_bound": main["bound_ms"] / main["ms"],
            "library_ms": main["library_ms"], "slots": main["slots"],
            "bins": main["bins"], "main_path": main_path, "cases": timing}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import lightpycl_tpu_torch as P
    from edge_rays import edge_rays
    from lightpycl_tpu_torch.ops import _build
    from lightpycl_tpu_torch import variant_bench as VB
    from lightpycl_tpu_torch.ops import bincount as BC
    from lightpycl_tpu_torch.ops import film_stack as FS
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

    def timed(load):
        lib = load()
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(5) as pool:
        builds = [pool.submit(timed, PI.load_kernel),
                  pool.submit(timed, IV.load_kernel),
                  pool.submit(timed, FS.load_kernel),
                  pool.submit(timed, load_film_checks),
                  pool.submit(timed, BC.load_kernel)]
        lib, b1_build_s = builds[0].result()
        _, variants_build_s = builds[1].result()
        _, film_build_s = builds[2].result()
        _, checks_build_s = builds[3].result()
        _, bincount_build_s = builds[4].result()
    build_s = time.perf_counter() - t0
    line("2 build", seconds=f"{build_s:.3f}",
         intersect_s=f"{b1_build_s:.3f}",
         variants_s=f"{variants_build_s:.3f}",
         film_stack_s=f"{film_build_s:.3f}",
         film_checks_s=f"{checks_build_s:.3f}",
         bincount_s=f"{bincount_build_s:.3f}",
         film_stack_library=_build.library_path("film_stack.cu", {}).name,
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
    # the variants' instantiations, each under its template arguments as
    # the entry's mangled name carries them (denom, notmax, min2, n_sub,
    # reg, rays a thread): ptxas's registers and spills, then its resources
    # on the card at a ray block of that many rays a thread
    by_args = {(IV._DENOMS[v.denom], int(v.notmax), int(v.min2), v.n_sub,
                int(v.reg)): name for name, v in IV.VARIANTS.items()}
    entry, ptxas = None, {}
    for ptx in _build.ptxas_report("intersect_variants.cu"):
        m = re.search(r"variant_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d+)"
                      r"ELb(\d)ELi(\d+)EE", ptx)
        if m:
            g = tuple(map(int, m.groups()))
            entry = (by_args[g[:5]], g[5])
            ptxas.setdefault(entry, {})
        elif entry is not None and "spill stores" in ptx:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ptx)
            ptxas[entry]["spills"] = spill.groups() if spill else None
        elif entry is not None and "Used" in ptx:
            ptxas[entry]["used"] = ptx.split("Used", 1)[1].strip()
    check(len(ptxas) == 3 * len(IV.VARIANTS)
          and all("used" in p for p in ptxas.values()),
          "one compiled kernel a variant and rays-a-thread value")
    for (name, rpt), p in sorted(ptxas.items()):
        rb = {4: 256, 2: 64, 1: 32}[rpt]
        res = IV.kernel_resources(name, rb)
        line("2 variant resources", variant=name, ray_block=rb,
             **res, ptxas=repr(p["used"]))
        check(res["rays_per_thread"] == rpt, f"variant {name}: ray block "
              f"{rb} picks {rpt} rays a thread")
        check(p.get("spills") == ("0", "0") and res["local_bytes"] == 0,
              f"variant {name} at {rpt} rays a thread: no spills")
    # the film-stack kernel: its stack frame is libdevice's trig argument
    # reduction; no spills
    film_ptx = [x.strip() for x in _build.ptxas_report("film_stack.cu")
                if "Used" in x or "spill" in x]
    for ptx in film_ptx:
        print(f"[2 ptxas film_stack] {ptx}", flush=True)
    check(any("0 bytes spill stores, 0 bytes spill loads" in x
              for x in film_ptx), "film-stack kernel: no spills")
    census = sass_layer_loop(_build.library_path("film_stack.cu", {}))
    line("2 sass film_stack", **(census or {"cuobjdump": "not found"}))

    # ---- 3. B1 kernel vs plain at the bench's intersect shape -------------
    big = headline_sphere()
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
    b1_tests_per_s = BENCH_RAYS * n_tris / b1_ms * 1e3
    line("3 B1 time", kernel_ms=b1_ms, kernel_rays=BENCH_RAYS,
         kernel_tests_per_s=f"{b1_tests_per_s:.4e}",
         bound_ms=b1_bound_ms, bound_by=b1_bound_by,
         share_of_bound=f"{b1_bound_ms / b1_ms:.4f}",
         plain_ms=b1_plain_ms, plain_rays=CMP_RAYS,
         plain_tests_per_s=f"{CMP_RAYS * n_tris / b1_plain_ms * 1e3:.4e}")
    del o, d

    # ---- scenes of the main path (bench.py configs) ------------------------
    cfg1_els = config1_elements()
    bowl, bowl_src = bowl_elements(), bowl_source(BENCH_RAYS)
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
    res1 = P.Tracer().trace(config1_source(BENCH_RAYS), cfg1_els,
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
        again = P.Tracer().trace(config1_source(BENCH_RAYS), cfg1_els,
                                 trace_iterations=8, mode="device")
        check(np.array_equal(again.hist, res1.hist)
              and np.array_equal(again.per_detector, res1.per_detector)
              and again.ledger == res1.ledger,
              "config 1 repeat run bit-identical")
        rates.append(again.rays_traced / max(again.iterations_run, 1)
                     / max(again.wall_time, 1e-12))
    small = {b: P.Tracer().trace(config1_source(CMP_RAYS), cfg1_els,
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
    frame_b = PI.cull_frame(scene_b)
    order = S.morton_order(rays.o, rays.d, rays.alive, frame_b.lo,
                           frame_b.hi)
    cfg_c = P.TraceConfig(cull=True)
    srt, t_c, i_c = S.intersect_bounce(scene_b, rays, cfg_c, frame_b)
    t_b, i_b = PI.intersect(scene_b, rays.o, rays.d,
                            cfg_c.replace(cull=False))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), device=order.device)
    check(torch.equal(i_c[inv], i_b) and torch.equal(t_c[inv], t_b),
          "bowl first bounce: culled (t, tri) == brute per ray")
    # B2 vs its plain version (same mask) on the first 32 ray blocks
    nb = 32 * PI.RAY_BLOCK
    bargs = (scene_b.wu, scene_b.wv, scene_b.ww, 1e-4, 1e-6, 1e3)
    mask = PI.block_tile_mask(frame_b, srt.o[:nb], srt.d[:nb], 1e3,
                              alive=srt.alive[:nb])
    t2k, i2k = PI.nearest_hit_cuda(srt.o[:nb], srt.d[:nb], *bargs, mask=mask)
    t2p, i2p = PI.nearest_hit_torch(srt.o[:nb], srt.d[:nb], *bargs,
                                    mask=mask)
    torch.cuda.synchronize()
    check(torch.equal(i2k, i2p) and torch.equal(t2k, t2p),
          "B2 bitwise equal to its plain version")
    fin = torch.isfinite(t2p)
    b2_err = float((t2k[fin] - t2p[fin]).abs().max()) if fin.any() else 0.0
    full_mask = PI.block_tile_mask(frame_b, srt.o, srt.d, 1e3,
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
        frame = PI.cull_frame(sc)
        order = S.morton_order(bo, bd, torch.ones(EDGE_RAYS, dtype=torch.bool,
                                                  device="cuda"),
                               frame.lo, frame.hi)[:EDGE_CULL_RAYS]
        co, cd = bo[order].contiguous(), bd[order].contiguous()
        emask = PI.block_tile_mask(frame, co, cd, 1e3)
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
        # the epilogue variants on the same rays, each against its plain
        # version, at its script's ray block and at the two other
        # rays-a-thread values: every instantiation
        v_mism, v_launch = {}, 0
        for vname in IV.VARIANTS:
            rb0 = 256 if vname in IV.MICRO_VARIANTS else 64
            t_p, i_p = IV.nearest_hit_variant_torch(eo, ed, *eargs,
                                                    variant=vname)
            for rb in (rb0, 32, 128 if rb0 == 64 else 64):
                t_k, i_k = IV.nearest_hit_variant_cuda(
                    eo, ed, *eargs, variant=vname, ray_block=rb)
                torch.cuda.synchronize()
                v_launch += 1
                v_mism[(vname, rb)] = (
                    int((i_k != i_p).sum())
                    + int((t_k.view(torch.int32)
                           != t_p.view(torch.int32)).sum()))
        bad = {f"{n}@{rb}": m for (n, rb), m in v_mism.items() if m}
        line(f"8 edge rays {name} variants", rays=EDGE_RAYS,
             variants=len(IV.VARIANTS), launches=v_launch,
             hits=int((i_p >= 0).sum()),
             mismatches=sum(v_mism.values()), bad=repr(bad))
        check(not bad, f"edge rays on {name}: every variant kernel bitwise "
              "equal to its plain version")

    # ---- 9. where the device time goes (torch.profiler, warm traces) -----
    for name, src, els in (("config1", config1_source(BENCH_RAYS),
                            cfg1_els),
                           ("bowl_cull", bowl_src, bowl)):
        split = profile_trace(lambda: P.Tracer().trace(
            src, els, trace_iterations=8, mode="device"))
        check(split["kernel_ms"] > 0, f"{name}: profiler saw the kernel")
        line(f"9 profile {name}", **split)

    # ---- 10. config 4 at full size: trace_batched, the mega-batch path ----
    cfg4_els, src4 = cfg4_elements(P), cfg4_source(P)

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
    BC.bincount_sorted_cuda.launches = 0
    tr4, res4 = cfg4(CFG4_RAYS, None)
    torch.cuda.synchronize()
    launches4 = PI.nearest_hit_cuda.launches
    cull_launches4 = PI.nearest_hit_cuda.cull_launches
    # the histogram and the per-detector totals: two sums a bounce
    bincount4 = BC.bincount_sorted_cuda.launches
    bounces4 = res4.rays_traced // CFG4_BATCH
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
    check(bounces4 > 0 and bincount4 >= 2 * bounces4,
          "config 4: the bincount kernel took both sums of every bounce")
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
         bounces=bounces4, bincount_launches=bincount4,
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

    BC.bincount_sorted_cuda.launches = 0
    a = sem(4 * SEM_BATCH, SEM_BATCH)
    torch.cuda.synchronize()
    # a bounce's seven sums: histogram, per-detector totals, image, the
    # coherent field's two planes, time histogram, flux map
    bincount_sem = BC.bincount_sorted_cuda.launches
    bounces_sem = a.rays_traced // SEM_BATCH
    check(bounces_sem > 0 and bincount_sem >= 7 * bounces_sem,
          "phase 11: the bincount kernel took every map of every bounce")
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
         kernel_wall_s=kern.wall_time, bounces=bounces_sem,
         bincount_launches=bincount_sem)

    # ---- 12. where config 4's device time goes (one warm batch) ----------
    split4 = profile_trace(lambda: cfg4(CFG4_BATCH, None)[1], top=6)
    check(split4["kernel_ms"] > 0, "config 4: profiler saw the kernel")
    line("12 profile config4", **split4)

    new_brute, new_cull = physics_phases(P, PI)
    spec_brute, spec_cull, film_row = spectral_phases(P, PI)

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
             ray_block=rb, rays_per_thread=IV.rays_per_thread(rb),
             split=IV.stage_split(rb, IV.VARIANTS[name].n_sub),
             dyn_smem_bytes=IV.dyn_smem_bytes(IV.VARIANTS[name].n_sub, rb),
             rays=BENCH_RAYS, triangles=v_tris,
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
             "library_ms": None, "ray_block": rb,
             "rays_per_thread": IV.rays_per_thread(rb),
             "split": IV.stage_split(rb, IV.VARIANTS[name].n_sub),
             "rays": BENCH_RAYS,
             "plain_rays": CMP_RAYS, "triangles": v_tris})
    del t_b1, i_b1, vo, vd, v_inputs

    oracle_brute, oracle_cull = oracle_phases(P, PI)
    ex_brute, ex_cull = example_phases(P, PI)
    design_brute, design_cull = design_phases(P, PI)
    multi_brute, multi_cull = multi_device_phases(P, PI, smi)
    torch.cuda.empty_cache()
    bench = bench_phase(b1_tests_per_s)
    bincount_row = bincount_phase({
        "launches": bincount4, "bounces": bounces4,
        "per_bounce": bincount4 / bounces4,
        "maps_launches": bincount_sem, "maps_bounces": bounces_sem,
        "maps_per_bounce": bincount_sem / bounces_sem})
    bench_cull = bench["cull_kernel_launches"]
    bench_brute = bench["kernel_launches"] - bench_cull

    table = {"kernels": [
        {"name": "nearest_hit (B1, brute)", "route": "cuda",
         "source": KERNEL_SRC, "replaces": f"{TPU_KERNEL}:154",
         "launches": (launches - cull_launches + launches4 - cull_launches4
                      + new_brute + spec_brute + oracle_brute + ex_brute
                      + design_brute + multi_brute + bench_brute),
         "launches_trace_batched": launches4 - cull_launches4,
         "launches_physics": new_brute, "launches_spectral": spec_brute,
         "launches_oracle_parity": oracle_brute,
         "launches_examples": ex_brute, "launches_design": design_brute,
         "launches_multi_device": multi_brute, "launches_bench": bench_brute,
         "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound_ms,
         "bound_by": b1_bound_by, "share_of_bound": b1_bound_ms / b1_ms,
         "library_ms": None,
         "rays": BENCH_RAYS, "plain_rays": CMP_RAYS, "triangles": n_tris},
        {"name": "nearest_hit (B2, cull)", "route": "cuda",
         "source": KERNEL_SRC, "replaces": f"{TPU_KERNEL}:185",
         "launches": (cull_launches + cull_launches4 + new_cull + spec_cull
                      + oracle_cull + ex_cull + design_cull + multi_cull
                      + bench_cull),
         "launches_trace_batched": cull_launches4,
         "launches_physics": new_cull, "launches_spectral": spec_cull,
         "launches_oracle_parity": oracle_cull,
         "launches_examples": ex_cull, "launches_design": design_cull,
         "launches_multi_device": multi_cull, "launches_bench": bench_cull,
         "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound_ms,
         "bound_by": b2_bound_by, "share_of_bound": b2_bound_ms / b2_ms,
         "library_ms": None, "pairs": b2_pairs,
         "config4_bounces": cfg4_bounces,
         "rays": BENCH_RAYS, "plain_rays": nb,
         "triangles": scene_b.num_triangles_padded},
    ] + v_entries + [film_row, bincount_row]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
