"""Rays built to sit on the nearest-hit kernel's reject margin.

A fixture of the kernel's checks, not part of the tracer: the CPU tests
(tests/test_torch_intersect_reject.py) and chip_smoke.py use it to hold
lightpycl_tpu_torch/csrc/intersect.cu against its plain torch version
where the kernel's fused reject test and the exact test are closest.
Imports torch and numpy only.
"""

import numpy as np
import torch

EDGE_RAY_KINDS = ("vertex", "edge_mid", "centroid", "grazing", "on_surface")


def edge_rays(scene, n: int, seed: int = 0, direction=None):
    """n rays (o, d) f32 on the scene's device: aimed exactly at vertices,
    at midpoints of (shared) edges and at centroids of random real
    triangles; lying in a triangle's plane (DW ~ 0); and starting on a
    triangle (the eps self-hit guard), in both hemispheres. The kinds
    cycle in EDGE_RAY_KINDS order. Directions are isotropic, or within
    ~0.1 rad of `direction` (a coherent bundle, for the cull mask) for all
    but the grazing kind."""
    rng = np.random.default_rng(seed)
    real = np.flatnonzero(torch.any(scene.ww != 0.0, dim=1).cpu().numpy())
    tri = real[rng.integers(0, len(real), n)]
    v0, e1, e2 = (x.cpu().numpy().astype(np.float64)[tri]
                  for x in (scene.v0, scene.e1, scene.e2))
    kind = np.arange(n) % len(EDGE_RAY_KINDS)
    corner = rng.integers(0, 3, n)[:, None]
    vertex = v0 + (corner == 1) * e1 + (corner == 2) * e2
    edge_mid = v0 + np.where(corner == 0, e1 / 2,
                             np.where(corner == 1, e2 / 2, (e1 + e2) / 2))
    centroid = v0 + (e1 + e2) / 3.0
    rnd = rng.normal(size=(n, 3))
    if direction is not None:
        rnd = (0.1 * rnd / np.sqrt(3.0)
               + np.asarray(direction, np.float64)
               / np.linalg.norm(direction))
    rnd /= np.linalg.norm(rnd, axis=1, keepdims=True)
    dist = rng.uniform(0.05, 3.0, (n, 1))
    target = np.where((kind == 0)[:, None], vertex,
                      np.where((kind == 1)[:, None], edge_mid, centroid))
    o = target - dist * rnd
    d = rnd.copy()
    # grazing: start in the plane, outside the triangle, heading across it
    a, b = rng.uniform(-1.0, 2.0, (2, n, 1))
    in_plane = v0 + a * e1 + b * e2
    across = centroid - in_plane
    across /= np.maximum(np.linalg.norm(across, axis=1, keepdims=True),
                         1e-300)
    o = np.where((kind == 3)[:, None], in_plane, o)
    d = np.where((kind == 3)[:, None], across, d)
    # on the surface: start inside the triangle, leave in either hemisphere
    a, b = rng.uniform(0.0, 1.0, (2, n, 1))
    a, b = np.where(a + b > 1, 1 - a, a), np.where(a + b > 1, 1 - b, b)
    o = np.where((kind == 4)[:, None], v0 + a * e1 + b * e2, o)
    dev = scene.wu.device
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))
