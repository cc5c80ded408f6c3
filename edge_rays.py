"""Inputs built to sit on the port's kernels' hard edges: rays on the
nearest-hit kernel's reject margin, film stacks on the film-stack kernel's
guards.

A fixture of the kernels' checks, not part of the tracer: the CPU tests
(tests/test_torch_intersect_reject.py, tests/test_torch_film_stack.py) and
chip_smoke.py use it to hold lightpycl_tpu_torch/csrc/intersect.cu where
the kernel's fused reject test and the exact test are closest, and
csrc/film_stack.cu where its guards and branches decide, against their
plain torch versions. Imports torch and numpy only.
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


FILM_EDGE_KINDS = ("general", "grazing", "normal", "critical", "evanescent",
                   "padded", "flipped")


def film_edge_inputs(n: int, layers: int, seed: int = 0):
    """n film-stack calls as float32 numpy arrays (cos_i, n1, n_sub
    (n,), layers_n, layers_h (n, layers)), kinds cycling in FILM_EDGE_KINDS
    order: a coated window met from air at any angle; grazing (cos_i in
    [0, 2e-3], some 0, below the 1e-6 clamp); normal (some exactly 1);
    from the glass at the critical angle (within 1e-3 of it, every 8th
    ray on the sqrt's guarded branch point, where the substrate's cosine
    is exactly 0); glass on both sides beyond the low-index layers'
    critical angle (evanescent waves); zero-thickness padding (index 1.0,
    anywhere, every 5th stack wholly padded); and an exiting ray's flipped
    stack inside the critical angle (glass above, air below, layers
    reversed)."""
    rng = np.random.default_rng(seed)
    kind = np.arange(n) % len(FILM_EDGE_KINDS)
    cos_i = rng.uniform(0.02, 1.0, n)
    n1, n_sub = np.ones(n), np.full(n, 1.52)
    ln = rng.choice([2.35, 1.46, 1.38, 2.1], (n, layers))
    lh = rng.uniform(0.03, 0.3, (n, layers))
    graz = kind == 1
    cos_i[graz] = rng.uniform(0.0, 2e-3, graz.sum())
    cos_i[graz & (rng.uniform(size=n) < 0.2)] = 0.0
    cos_i[graz & (rng.uniform(size=n) < 0.2)] = 3e-7
    # at grazing incidence an index-1.0 layer puts its wave on the branch
    # point too; a pad of 1.2 keeps these stacks away from it
    ln[graz] = np.where(lh[graz] < 0.1, 1.2, ln[graz])
    norm = kind == 2
    cos_i[norm] = 1.0 - rng.uniform(0.0, 1e-4, norm.sum())
    cos_i[norm & (rng.uniform(size=n) < 0.3)] = 1.0
    exiting = (kind == 3) | (kind == 4) | (kind == 6)
    n1[exiting], n_sub[exiting] = 1.52, 1.0
    crit = kind == 3
    cos_c = np.sqrt(1.0 - (1.0 / 1.52) ** 2)
    cos_i[crit] = cos_c * (1.0 + rng.uniform(-1e-3, 1e-3, crit.sum()))
    # within 2 float32 ulps of it: |1 - n1s2 / n_sub^2| <= 1e-6, inside
    # the guard that makes the substrate's cosine exactly 0
    at = np.flatnonzero(crit)[::8]
    cos_i[at] = cos_c + rng.integers(-2, 3, len(at)) * 6e-8
    # glass on both sides, steep: the 1.2 and 1.38 layers carry evanescent
    # waves that the light tunnels through (frustrated total reflection)
    eva = kind == 4
    n_sub[eva] = 1.52
    cos_i[eva] = rng.uniform(0.02, 0.5, eva.sum())
    ln[eva] = rng.choice([1.38, 1.2, 2.1], (eva.sum(), layers))
    lh[eva] = rng.uniform(0.01, 0.3, (eva.sum(), layers))
    pad = kind == 5
    zero = pad[:, None] & (rng.uniform(size=(n, layers)) < 0.5)
    zero[np.flatnonzero(pad)[::5]] = True
    ln[zero], lh[zero] = 1.0, 0.0
    flip = kind == 6
    cos_i[flip] = rng.uniform(1.02 * cos_c, 1.0, flip.sum())
    ln[flip], lh[flip] = ln[flip][:, ::-1], lh[flip][:, ::-1]
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return f32(cos_i), f32(n1), f32(n_sub), f32(ln), f32(lh)
