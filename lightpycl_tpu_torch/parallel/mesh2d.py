"""2-D mesh decomposition: rays sharded on one axis, TRIANGLES on the other.

Port counterpart of lightpycl_tpu/parallel/mesh2d.py on torch.distributed,
for scenes too large to replicate on every card AND ray batches too large
for one card: a ("tris", "rays") DeviceMesh (`make_mesh2d`, ranks
row-major as the reference's devs.reshape(n_tris, n_rays)) where

  * the ray batch shards over "rays" and is replicated over "tris";
  * the triangle soup shards over "tris" and is replicated over "rays";
  * each bounce: the nearest-hit kernel on the local shard, one MIN
    all-reduce over "tris" for the global winner
    (tri_sharding.nearest_over_tris), one SUM all-reduce over "tris" of
    every hit-attribute column (the winner contributes), then shade /
    measure / compact computed identically on every "tris" rank (their
    inputs are replicated, so their results are too). Only "tris" rank 0
    books the ledger and the detector; after the loop both are summed over
    "tris", then over "rays".

Two collectives a bounce, both within a "tris" group, so every rank of
such a group must run the same bounces: the loop is the fixed depth, and
its one early exit (no live ray left) is decided on the rays, which the
group holds identically. Random draws fold in the RAY rank only
(make_generator(device, *key, ray_rank, bounce)): shade and compact run
replicated across "tris", so the draws must be the same there.

Misses take the attributes of global triangle 0 (tris rank 0 contributes
them), as the single-device gather of clamp(tri, 0) does; the reference
zeroes them and then sets ior 1 and the terminator material, values that
no outcome of a miss reads.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lightpycl_tpu_torch.ops.intersect import intersect
from lightpycl_tpu_torch.parallel.distributed import all_reduce_packed, axis
from lightpycl_tpu_torch.parallel.sharding import (RAY_AXIS, key_words,
                                                   make_mesh, reduce_state,
                                                   shard_rays)
from lightpycl_tpu_torch.parallel.tri_sharding import (TRI_AXIS,
                                                       nearest_over_tris,
                                                       shard_scene,
                                                       winner_sum)
from lightpycl_tpu_torch.tracer import step as step_mod
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene

__all__ = ["TRI_AXIS", "RAY_AXIS", "make_mesh2d", "place_scene",
           "place_rays", "place", "trace_mesh2d"]


def make_mesh2d(n_tris: int, n_rays: int, device=None) -> DeviceMesh:
    """The ("tris", "rays") mesh over the n_tris x n_rays ranks of the
    process group (a one-rank group is started for (1, 1) when none
    exists)."""
    return make_mesh((n_tris, n_rays), (TRI_AXIS, RAY_AXIS), device)


def place_scene(scene: Scene, mesh: DeviceMesh) -> Scene:
    """This rank's shard of the scene's triangles along "tris"
    (tri_sharding.shard_scene)."""
    return shard_scene(scene, mesh)


def place_rays(rays: RayBatch, mesh: DeviceMesh,
               interleave: bool = True) -> RayBatch:
    """This rank's shard of the ray batch along "rays", round-robin
    interleaved first (sharding.shard_rays)."""
    return shard_rays(rays, mesh, interleave)


def place(scene: Scene, rays: RayBatch, mesh: DeviceMesh,
          interleave: bool = True):
    """(scene shard over "tris", ray shard over "rays")."""
    return place_scene(scene, mesh), place_rays(rays, mesh, interleave)


def _scene_box(scene: Scene, group):
    """The global box of the valid triangles' v0 over every shard of the
    "tris" axis: one MIN all-reduce of (lo, -hi). The Morton resort must
    permute identically on every "tris" rank, so it cannot use the box of
    the shard it holds (step.morton_permutation)."""
    valid = torch.any(scene.ww != 0.0, dim=1)[:, None]
    lo = torch.where(valid, scene.v0, 3.4e38).amin(dim=0)
    neg_hi = -torch.where(valid, scene.v0, -3.4e38).amax(dim=0)
    lo, neg_hi = all_reduce_packed([lo, neg_hi], group,
                                   op=dist.ReduceOp.MIN)
    return lo, -neg_hi


def _hit_attrs(scene: Scene, tri, my_tri: int, group):
    """Every step.gather_hit_attrs column at the global hits `tri` from the
    shard that owns each (misses: global triangle 0, from tris rank 0)."""
    S = scene.num_triangles_padded
    local_i = tri.long() - my_tri * S
    mine = (tri >= 0) & (local_i >= 0) & (local_i < S)
    if my_tri == 0:
        mine = mine | (tri < 0)
    li = torch.where(tri >= 0, torch.clamp(local_i, 0, S - 1), 0)
    return winner_sum(step_mod.gather_hit_attrs(scene, li), mine, group)


def trace_mesh2d(scene: Scene, rays: RayBatch, cfg: TraceConfig,
                 iterations: int, mesh: DeviceMesh, n_detectors: int = 8,
                 key=None):
    """Fixed-depth trace over the 2-D mesh. `scene` is this rank's
    triangle shard (`place_scene`), `rays` its ray shard (`place_rays`).
    Returns (this rank's final rays, the GLOBAL DetectorState, the GLOBAL
    Ledger).

    `n_detectors` must cover every measure surface of the scene. `key` (an
    int seed or a tuple of ints) is required iff cfg.needs_rng: bounce i
    of ray rank r draws from make_generator(device, *key, r, i), the same
    on every "tris" rank."""
    if cfg.needs_rng and key is None:
        raise ValueError(
            "cfg.needs_rng (roulette / diffuse) requires a PRNG key "
            "(pass key=<int seed> to trace_mesh2d)")
    _, my_tri, g_tri = axis(mesh, TRI_AXIS)
    _, my_ray, g_ray = axis(mesh, RAY_AXIS)
    dev = rays.device
    book = my_tri == 0
    det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                              n_detectors, cfg.image_bins,
                              coherent=cfg.coherent, time_bins=cfg.time_bins,
                              device=dev)
    emitted = torch.sum(torch.where(rays.alive, rays.power, 0.0))
    led = Ledger.start(emitted if book else 0.0, device=dev)
    offset = my_tri * scene.num_triangles_padded
    if cfg.cull:
        box_lo, box_hi = _scene_box(scene, g_tri)
    words = key_words(key) if cfg.needs_rng else ()
    for i in range(iterations):
        if not bool(rays.alive.any()):
            break  # the same rays, so the same decision, on every tris rank
        gen = (step_mod.make_generator(dev, *words, my_ray, i)
               if cfg.needs_rng else None)
        if cfg.cull:
            # per-bounce Morton resort on the global box, 20 bits a axis
            # (step.morton_order: a dense beam under a wide box would share
            # one 10-bit code per thousands of rays): each ray block is a
            # tight patch, so each shard's own tile mask bites
            rays = rays.permuted(step_mod.morton_order(rays.o, rays.alive,
                                                       box_lo, box_hi))
        t_loc, i_loc = intersect(scene, rays.o, rays.d, cfg,
                                 alive=rays.alive)
        t, tri = nearest_over_tris(t_loc, i_loc, offset, g_tri)
        attrs = _hit_attrs(scene, tri, my_tri, g_tri)
        rays, det, led, _ = step_mod.finish_step(
            scene, rays, t, tri, attrs, det, led, cfg, with_aux=False,
            gen=gen, book=book)
    det, led = reduce_state(det, led, g_tri)
    det, led = reduce_state(det, led, g_ray)
    if cfg.time_bins > 0:
        # A fault of the reference, reproduced: its trace_mesh2d starts the
        # DetectorState without time bins (lightpycl_tpu/parallel/
        # mesh2d.py:90), so its (1, 1) time map keeps the arrivals whose
        # flat index did * 1 + 0 is in range, detector 0's, drops the
        # rest, and its trace_batched broadcasts that one total over every
        # bin. The port bins them (torch raises on the out-of-range
        # scatter) and returns the reference's array.
        det = det._replace(time_hist=det.time_hist[:1].sum().reshape(1, 1))
    return rays, det, led
