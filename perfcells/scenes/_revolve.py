"""Surfaces of revolution: a frozen numpy copy of the port's mesher
(`lightpycl_tpu_torch/geometry/primitives.py`: `_grid_triangles`,
`revolve_profile`, `_weld`), with the same vertex and triangle order."""

from __future__ import annotations

import numpy as np


def grid_triangles(nu: int, nv: int) -> np.ndarray:
    """Two CCW triangles a quad of an (nu x nv) vertex grid (index u * nv +
    v), closed in u; quads in (u, v) order, as the port's loop makes them."""
    u = np.arange(nu)[:, None]
    v = np.arange(nv - 1)[None, :]
    a = u * nv + v
    b = ((u + 1) % nu) * nv + v
    c = b + 1
    d = a + 1
    quads = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], 2)
    return quads.reshape(-1, 3).astype(np.int32)


def weld(V: np.ndarray, T: np.ndarray, tol: float = 1e-12):
    """Merge coincident vertices (first occurrence order) and drop
    triangles with a repeated vertex or about zero area."""
    key = np.round(V / max(tol, 1e-12)).astype(np.int64)
    _, first, inverse = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    Vw = V[np.sort(first)]
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    Tw = rank[inverse.reshape(-1)][T]
    ok = ((Tw[:, 0] != Tw[:, 1]) & (Tw[:, 1] != Tw[:, 2])
          & (Tw[:, 0] != Tw[:, 2]))
    Tw = Tw[ok]
    tv = Vw[Tw]
    area2 = np.linalg.norm(np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]),
                           axis=1)
    return Vw, np.ascontiguousarray(Tw[area2 > 1e-16], dtype=np.int32)


def revolve(profile_rz, n_segments: int, center=(0.0, 0.0, 0.0)):
    """(vertices, triangles) of an (M, 2) (r, z) profile revolved about z,
    poles welded, then moved by `center`."""
    prof = np.asarray(profile_rz, dtype=np.float64)
    M = len(prof)
    phi = np.linspace(0.0, 2.0 * np.pi, n_segments, endpoint=False)
    verts = np.empty((n_segments, M, 3))
    verts[:, :, 0] = np.cos(phi)[:, None] * prof[None, :, 0]
    verts[:, :, 1] = np.sin(phi)[:, None] * prof[None, :, 0]
    verts[:, :, 2] = prof[None, :, 1]
    V, T = weld(verts.reshape(-1, 3), grid_triangles(n_segments, M))
    return V + np.asarray(center, np.float64), T
