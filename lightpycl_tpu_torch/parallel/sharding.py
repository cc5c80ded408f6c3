"""Multi-device scale-out: rays sharded over a mesh, the scene replicated.

Port counterpart of lightpycl_tpu/parallel/sharding.py on torch.distributed
(BASELINE configs[4]): the ray batch shards over the 1-D "rays" axis of a
torch DeviceMesh, every rank holds the whole scene, and the detector state
and the power ledger are summed over the axis after the loop. Rays never
leave their rank (Fresnel-split children stay with their parent), so the
loop itself has no collective.

SPMD by launch: every rank calls these functions with the same arguments
(the same rays, the same scene), `shard_rays` keeps this rank's share and
`trace_multichip` traces it. `trace_multichip` returns THIS RANK's shard of
the final rays and the GLOBAL DetectorState and Ledger (identical on every
rank); `gather_rays` assembles the whole batch for callers that want it.

Random draws: bounce i of ray rank r draws from
step.make_generator(device, *key, r, i), the counterpart of the
reference's fold_in(fold_in(key, axis_index), i): independent across ranks
and the same for a fixed rank count.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from lightpycl_tpu_torch.parallel.distributed import (all_reduce_packed, axis,
                                                      ensure_process_group,
                                                      rank_device, world_size)
from lightpycl_tpu_torch.tracer import step as step_mod
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene

RAY_AXIS = "rays"


def make_mesh(shape, names, device=None) -> DeviceMesh:
    """A DeviceMesh of `shape` (product = the world size) with axis `names`
    on `device`'s type (default: this rank's device), starting a one-rank
    group first when none exists. Ranks lie row-major, as the reference's
    devs.reshape(shape)."""
    device = rank_device() if device is None else torch.device(device)
    ensure_process_group(device)
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"a mesh of {tuple(shape)} needs {n} ranks; the process group "
            f"has {world} (launch one process a rank: torchrun "
            f"--nproc-per-node {n})")
    return init_device_mesh(device.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_ray_mesh(n_devices: Optional[int] = None, device=None) -> DeviceMesh:
    """The 1-D "rays" mesh over every rank of the process group (which must
    have `n_devices` ranks when given). Without a group, a one-rank group
    on `device` (default: this rank's device) is started first."""
    return make_mesh((n_devices or world_size(device),), (RAY_AXIS,), device)


def padded_for(rays: RayBatch, n_shards: int) -> RayBatch:
    """The batch grown with dead slots to a multiple of n_shards."""
    return rays.padded_to(-(-rays.capacity // n_shards) * n_shards)


def _check_divisible(C: int, n_shards: int) -> None:
    if C % n_shards:
        raise ValueError(
            f"capacity {C} not divisible by {n_shards} shards — pad first "
            "(RayBatch.padded_to)")


def interleave_rays(rays: RayBatch, n_shards: int) -> RayBatch:
    """Round-robin-permute ray slots so contiguous shard blocks each hold
    every n_shards-th slot: shard s, in-shard slot r gets original slot
    r * n_shards + s.

    Why: RayBatch.from_arrays front-packs live rays, so contiguous
    block-sharding piles every live ray (and every Fresnel-split child)
    onto the first shards while the dead-slot headroom sits idle on the
    tail shards, and per-shard compaction then culls power the
    single-device trace keeps. Ray order is semantically free, so the
    interleave is exact; `deinterleave_rays` is the inverse."""
    if n_shards <= 1:
        return rays
    C = rays.capacity
    _check_divisible(C, n_shards)
    S = C // n_shards
    j = torch.arange(C, device=rays.device)
    return rays.permuted((j % S) * n_shards + j // S)


def deinterleave_rays(rays: RayBatch, n_shards: int) -> RayBatch:
    """Inverse of `interleave_rays`: the original slot order."""
    if n_shards <= 1:
        return rays
    C = rays.capacity
    S = C // n_shards
    i = torch.arange(C, device=rays.device)
    return rays.permuted((i % n_shards) * S + i // n_shards)


def shard_rays(rays: RayBatch, mesh: DeviceMesh,
               interleave: bool = True) -> RayBatch:
    """This rank's shard of the ray batch along the mesh's "rays" axis: its
    contiguous block of the interleaved batch (every n-th slot from its
    rank on; see `interleave_rays`), or of the batch as it is with
    interleave=False."""
    n, r, _ = axis(mesh, RAY_AXIS)
    C = rays.capacity
    _check_divisible(C, n)
    S = C // n
    if interleave:
        idx = torch.arange(r, C, n, device=rays.device)
    else:
        idx = torch.arange(r * S, (r + 1) * S, device=rays.device)
    return rays.permuted(idx)


def gather_rays(rays_local: RayBatch, mesh: DeviceMesh,
                interleave: bool = True) -> RayBatch:
    """The whole batch from every rank's shard (the inverse of
    `shard_rays`), on every rank: each rank writes its block into a
    zero-filled full batch and one sum over the "rays" axis assembles it
    (every slot has exactly one writer, so the sum is exact). Off the
    tracing path: for tests and callers that want every ray."""
    n, r, group = axis(mesh, RAY_AXIS)
    S = rays_local.capacity
    C = S * n
    idx = (torch.arange(r, C, n, device=rays_local.device) if interleave
           else torch.arange(r * S, (r + 1) * S, device=rays_local.device))
    out = []
    for a in rays_local:
        dtype = a.dtype
        # bool and int32 ride as int32 sums, floats as float32
        full = torch.zeros((C,) + tuple(a.shape[1:]),
                           dtype=torch.int32 if dtype == torch.bool
                           else dtype, device=a.device)
        full[idx] = a.to(full.dtype)
        dist.all_reduce(full, group=group)
        out.append(full.to(dtype))
    return RayBatch(*out)


def reduce_state(det: DetectorState, led, group):
    """(DetectorState, ledger) summed over `group` in one collective; `led`
    is a Ledger or any NamedTuple of float32 tensors."""
    parts = all_reduce_packed(list(det) + list(led), group)
    return (DetectorState(*parts[:len(det)]),
            type(led)(*parts[len(det):]))


def key_words(key) -> tuple:
    """The generator words of a sharded trace's `key`: an int seed or a
    tuple of ints."""
    return tuple(key) if isinstance(key, (tuple, list)) else (int(key),)


def trace_multichip(scene: Scene, rays: RayBatch, cfg: TraceConfig,
                    iterations: int, mesh: DeviceMesh, n_detectors: int = 8,
                    key=None):
    """Fixed-depth multi-bounce trace, SPMD over the mesh's "rays" axis.

    `rays` is this rank's shard (`shard_rays`), `scene` the whole scene.
    Returns (this rank's final rays, the GLOBAL DetectorState, the GLOBAL
    Ledger): per-shard compaction keeps each rank's capacity fixed, and the
    detector state and ledger are summed over the axis after the loop (one
    all-reduce). A shard whose rays are all dead stops early: its remaining
    bounces would add zeros.

    `n_detectors` sizes the per-detector accumulator (>= the scene's
    measure surfaces; the engine passes len(detector_names)). `key` (an int
    seed or a tuple of ints) is required iff cfg.needs_rng (roulette,
    Lambertian, rough or volume scatter): bounce i of ray rank r draws from
    make_generator(device, *key, r, i), independent across ranks and the
    same for a fixed mesh."""
    if cfg.needs_rng and key is None:
        raise ValueError(
            "cfg.needs_rng (roulette / diffuse) requires a PRNG key "
            "(pass key=<int seed> to trace_multichip)")
    _, r, group = axis(mesh, RAY_AXIS)
    dev = rays.device
    led = Ledger.start(torch.sum(torch.where(rays.alive, rays.power, 0.0)),
                       device=dev)
    det = DetectorState.zeros(
        cfg.hist_azimuth_bins, cfg.hist_polar_bins, n_detectors,
        cfg.image_bins, coherent=cfg.coherent,
        # the scene is replicated, so triangle ids are global and the
        # per-shard flux maps sum like the histogram
        n_tris=scene.num_triangles_padded if cfg.flux_map else 0,
        time_bins=cfg.time_bins, device=dev)
    words = key_words(key) if cfg.needs_rng else ()
    frame = step_mod.cull_frame(scene) if cfg.cull else None
    for i in range(iterations):
        if not bool(rays.alive.any()):
            break
        gen = (step_mod.make_generator(dev, *words, r, i) if cfg.needs_rng
               else None)
        rays, det, led, _ = step_mod.trace_step(scene, rays, det, led, cfg,
                                                with_aux=False, gen=gen,
                                                frame=frame)
    det, led = reduce_state(det, led, group)
    return rays, det, led
