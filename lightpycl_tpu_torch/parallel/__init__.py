"""Sharded tracing on torch.distributed: rays over a "rays" mesh axis
(sharding), triangles over a "tris" axis (tri_sharding), both at once
(mesh2d), and the process-group bootstrap (distributed). Port counterpart
of lightpycl_tpu/parallel/, with the same names and `__all__`."""

from lightpycl_tpu_torch.parallel.sharding import (
    deinterleave_rays,
    interleave_rays,
    make_ray_mesh,
    shard_rays,
    trace_multichip,
)
from lightpycl_tpu_torch.parallel.mesh2d import make_mesh2d, place, trace_mesh2d
from lightpycl_tpu_torch.parallel.tri_sharding import (
    intersect_tri_sharded,
    make_tri_mesh,
    shard_scene,
)

__all__ = [
    "deinterleave_rays",
    "interleave_rays",
    "make_ray_mesh",
    "shard_rays",
    "trace_multichip",
    "make_tri_mesh",
    "shard_scene",
    "intersect_tri_sharded",
    "make_mesh2d",
    "place",
    "trace_mesh2d",
]
