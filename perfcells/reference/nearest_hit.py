"""Brute-force Moller-Trumbore nearest hit over every triangle.

A ray (o, d) hits triangle (v0, e1, e2) at distance t when, with
p = d x e2, det = e1 . p, s = o - v0, q = s x e1:
u = s . p / det >= -eps_b, v = d . q / det >= -eps_b, u + v <= 1 + eps_b
and eps < t = e2 . q / det < t_max. The nearest hit is the least such t
(ties: the lower triangle index). Every quantity is computed in `dtype`
(float64 for the reference; the control passes bfloat16)."""

from __future__ import annotations

import torch

# (rays x triangles) elements a block holds: 2^24 keeps a block's two
# dozen temporaries under 3 GB in float64
BLOCK_ELEMENTS = 1 << 24


def nearest_hit(o, d, v0, e1, e2, eps, eps_b, t_max, dtype=torch.float64,
                block_elements=BLOCK_ELEMENTS):
    """(t (N,) float64, tri (N,) int64) of rays o, d (N, 3) over triangles
    v0, e1, e2 (T, 3); a miss gives (inf, -1)."""
    N, T = o.shape[0], v0.shape[0]
    dev = o.device
    t_out = torch.full((N,), float("inf"), dtype=torch.float64, device=dev)
    i_out = torch.full((N,), -1, dtype=torch.int64, device=dev)
    if N == 0 or T == 0:
        return t_out, i_out
    tb = min(T, block_elements)
    rb = max(1, block_elements // tb)
    V0, E1, E2 = (x.to(dtype).t().contiguous()[:, None, :]
                  for x in (v0, e1, e2))
    O, D = (x.to(dtype).t().contiguous()[:, :, None] for x in (o, d))
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    for r0 in range(0, N, rb):
        ox, oy, oz = O[:, r0:r0 + rb]
        dx, dy, dz = D[:, r0:r0 + rb]
        best_t = torch.full((ox.shape[0],), float("inf"), dtype=torch.float64,
                            device=dev)
        best_i = torch.full_like(best_t, -1, dtype=torch.int64)
        for k0 in range(0, T, tb):
            ax, ay, az = V0[:, :, k0:k0 + tb]
            bx, by, bz = E1[:, :, k0:k0 + tb]
            cx, cy, cz = E2[:, :, k0:k0 + tb]
            px, py, pz = (dy * cz - dz * cy, dz * cx - dx * cz,
                          dx * cy - dy * cx)
            det = bx * px + by * py + bz * pz
            sx, sy, sz = ox - ax, oy - ay, oz - az
            u = (sx * px + sy * py + sz * pz) / det
            qx, qy, qz = (sy * bz - sz * by, sz * bx - sx * bz,
                          sx * by - sy * bx)
            v = (dx * qx + dy * qy + dz * qz) / det
            t = (cx * qx + cy * qy + cz * qz) / det
            hit = ((det != 0) & (u >= -eps_b) & (v >= -eps_b)
                   & (u + v <= 1.0 + eps_b) & (t > eps) & (t < t_max))
            tt = torch.where(hit, t, inf).double()
            t_blk, i_blk = tt.min(dim=1)
            better = t_blk < best_t
            best_t = torch.where(better, t_blk, best_t)
            best_i = torch.where(better, i_blk + k0, best_i)
        t_out[r0:r0 + rb] = best_t
        i_out[r0:r0 + rb] = torch.where(torch.isfinite(best_t), best_i, -1)
    return t_out, i_out
