"""Triangle-sharded intersection: the TRIANGLE axis over ranks.

Port counterpart of lightpycl_tpu/parallel/tri_sharding.py, for scenes too
large to replicate on every card: the triangle soup shards over the
"tris" axis of a torch DeviceMesh, every rank intersects the (replicated)
rays with its shard, and the global nearest hit is one MIN all-reduce:

  1. local nearest hit (t_local, i_local + offset) on each shard, the
     nearest-hit kernel on the shard's rows (with its own tile mask under
     cfg.cull);
  2. a MIN over one int64 key a ray: t's float bits high (t > 0 or inf,
     so the bits order like the floats), the global triangle index low.
     The minimum is the nearest t and, among the ranks that found it, the
     lowest global index: the reference's two pmins (t, then the index
     among the ranks at that t) in one collective. A miss is -1.

Hit attributes come from the shard that owns the hit: the owner writes
its row, every other rank -0.0, and a SUM combines them (x + -0.0 == x for
every x, zeros of both signs included, so the sum is exact bit for bit).

`shard_scene` slices only the per-triangle columns. A shard's row count
need not be a multiple of the kernel's 256-triangle tile (137,472 padded
triangles split two ways is 268.5 tiles): the kernel walks a partial last
chunk and `ops.intersect.pack_aabbs` pads the last tile's box. The global
index offset of rank k is k times the shard size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lightpycl_tpu_torch.ops.intersect import intersect
from lightpycl_tpu_torch.parallel.distributed import axis, world_size
from lightpycl_tpu_torch.parallel.sharding import make_mesh
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.scene import Scene

TRI_AXIS = "tris"

# Scene columns with one row a triangle (the rest are per-element tables,
# indexed by a ray's medium or by analytic surface, and stay whole)
TRIANGLE_FIELDS = (
    "v0", "e1", "e2", "normal", "wu", "wv", "ww", "mat", "ior", "ior_b",
    "absorb", "reflectivity", "detector_id", "axis", "retardance",
    "grating_mlp", "grating_g0", "metal_n", "metal_k", "coat_ior",
    "coat_thickness", "ior_c", "bire_ne", "scat_mu", "scat_g", "rough_sigma",
    "rough_g", "element_id")

_MISS_LOW = 0x7FFFFFFF  # the index half of a miss's key


def make_tri_mesh(n_devices=None, device=None) -> DeviceMesh:
    """The 1-D "tris" mesh over every rank of the process group."""
    return make_mesh((n_devices or world_size(device),), (TRI_AXIS,), device)


def shard_scene(scene: Scene, mesh: DeviceMesh) -> Scene:
    """This rank's contiguous slice of the per-triangle columns along the
    mesh's "tris" axis (copies, so the whole scene can be freed). The
    padded triangle count must divide by the axis size (build_scene pads
    to 256)."""
    n, k, _ = axis(mesh, TRI_AXIS)
    Tp = scene.num_triangles_padded
    if Tp % n:
        raise ValueError(f"padded triangle count {Tp} not divisible by the "
                         f"{n}-way triangle axis")
    S = Tp // n
    return scene._replace(**{
        f: getattr(scene, f)[k * S:(k + 1) * S].clone()
        for f in TRIANGLE_FIELDS if getattr(scene, f) is not None})


def nearest_over_tris(t_loc, i_loc, offset: int, group):
    """Global (t, tri) from every shard's local nearest hit (`offset` is
    this shard's first global index): one MIN all-reduce of the packed
    key. Returns (t (C,) f32, inf on a miss; tri (C,) i32, -1 on a miss)."""
    low = torch.where(i_loc >= 0, i_loc.to(torch.int64) + offset, _MISS_LOW)
    key = (t_loc.contiguous().view(torch.int32).to(torch.int64) << 32) | low
    dist.all_reduce(key, op=dist.ReduceOp.MIN, group=group)
    t = (key >> 32).to(torch.int32).view(torch.float32)
    tri = torch.where(torch.isfinite(t), (key & 0xFFFFFFFF).to(torch.int32),
                      -1)
    return t, tri


def winner_sum(cols: dict, contrib, group) -> dict:
    """Each (C,) or (C, k) column of `cols` from the rank whose `contrib`
    is set for that ray: the others give -0.0 and one SUM all-reduce over
    `group` combines every column (integers ride as float32, exact below
    2^24). Returns the columns with their dtypes."""
    names = list(cols)
    flat = [cols[n].reshape(cols[n].shape[0], -1).to(torch.float32)
            for n in names]
    widths = [f.shape[1] for f in flat]
    buf = torch.where(contrib[:, None], torch.cat(flat, dim=1), -0.0)
    dist.all_reduce(buf, group=group)
    out, k = {}, 0
    for n, w in zip(names, widths):
        out[n] = buf[:, k:k + w].reshape(cols[n].shape).to(cols[n].dtype)
        k += w
    return out


def intersect_tri_sharded(scene: Scene, o, d, cfg: TraceConfig,
                          mesh: DeviceMesh):
    """Global nearest hit with the scene sharded over the mesh's "tris"
    axis. `scene` is this rank's shard (`shard_scene`), o, d (C, 3) the
    same rays on every rank. Returns (t (C,), global tri index (C,)), the
    same on every rank and equal to ops.intersect.intersect on the whole
    scene (ties -> lowest global triangle index; a miss -> (inf, -1))."""
    _, k, group = axis(mesh, TRI_AXIS)
    t_loc, i_loc = intersect(scene, o, d, cfg)
    return nearest_over_tris(t_loc, i_loc, k * scene.num_triangles_padded,
                             group)


def _gather_hit_attributes(scene: Scene, tri, mesh: DeviceMesh):
    """PRIVATE (test anchor only): the CORE per-hit attributes (mat,
    normal, ior, reflectivity, detector_id) from the shard that owns each
    hit. tri is the GLOBAL index from intersect_tri_sharded (-1 miss: mat
    0, detector -1, the rest 0). The triangle-sharded trace
    (parallel/mesh2d.py) gathers every column of step.gather_hit_attrs."""
    _, k, group = axis(mesh, TRI_AXIS)
    S = scene.num_triangles_padded
    local_i = tri.long() - k * S
    mine = (tri >= 0) & (local_i >= 0) & (local_i < S)
    li = torch.clamp(local_i, 0, S - 1)
    out = winner_sum({"mat": scene.mat[li], "normal": scene.normal[li],
                      "ior": scene.ior[li],
                      "reflectivity": scene.reflectivity[li],
                      # -1 off measure surfaces: +1 so a miss sums to 0
                      "detector_id": scene.detector_id[li] + 1},
                     mine, group)
    return (out["mat"], out["normal"], out["ior"], out["reflectivity"],
            out["detector_id"] - 1)
