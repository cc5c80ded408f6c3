"""Exact quadric-surface intersection: the analytic-surface path.

Port counterpart of lightpycl_tpu/ops/quadric.py (`intersect_quadrics`,
`_intersect_one`), plain torch on the scene's device. Each
`AnalyticSurface` of a scene (geometry/analytic.py) is intersected exactly
here instead of through its placeholder triangle. The Q surfaces (a handful
of rows) are visited in a Python loop with an O(C) running nearest (t,
surface); a tie keeps the lower surface index (`t < best_t`), as the
reference's scan does. All math is float32 like the triangle path; the ray
is recentred at its closest approach to the surface vertex so the quadratic
stays well conditioned when origins sit far from the element.

The frame transforms are written as explicit multiply-adds, never as a
matrix product: a product that the GPU runs in TF32 would move hit points by
about 1e-3 of the scene scale, the facet-scale error this module exists to
remove, and the result must not depend on a global precision switch.

Surface model (geometry/analytic.py): in the surface's local frame,
alpha (x^2 + y^2) + beta z^2 + gamma z + delta = 0, bounded by r in
[r_min, r_max] and z in [z_lo, z_hi]; conics use gamma = -2, cylinders
alpha = 1, gamma = 0. The outward normal is the gradient
(2 alpha x, 2 alpha y, 2 beta z + gamma).
"""

from __future__ import annotations

import torch

_INF = float("inf")


def _to_local(v, frame):
    """v (..., 3) world -> local: row i of `frame` (..., 3, 3) is local
    axis i (leading axes broadcast). Elementwise products and sums only."""
    return torch.stack(
        [v[..., 0] * frame[..., i, 0] + v[..., 1] * frame[..., i, 1]
         + v[..., 2] * frame[..., i, 2] for i in range(3)], dim=-1)


def _to_world(v, frame):
    """v (..., 3) local -> world: sum_i v_i * (row i of frame)."""
    return torch.stack(
        [v[..., 0] * frame[..., 0, j] + v[..., 1] * frame[..., 1, j]
         + v[..., 2] * frame[..., 2, j] for j in range(3)], dim=-1)


def _intersect_one(o, d, abgd, rlim2, zlim, vertex, frame, eps, eps_b,
                   t_max):
    """Nearest valid hit of C rays on one bounded quadric: t (C,), +inf on
    miss. o, d (C, 3) world; params as in the module docstring (rlim2 holds
    the squared radial bounds)."""
    al, be, ga, de = abgd[0], abgd[1], abgd[2], abgd[3]
    ol = _to_local(o - vertex, frame)
    dl = _to_local(d, frame)
    # recentre the ray at its closest approach to the local origin: the
    # quadratic's coefficients then involve only scene-size magnitudes even
    # when the origin is max_ray_len away
    s0 = -torch.sum(ol * dl, dim=1)
    oc = ol + s0[:, None] * dl
    A = al * (dl[:, 0] ** 2 + dl[:, 1] ** 2) + be * dl[:, 2] ** 2
    B = (2.0 * al * (oc[:, 0] * dl[:, 0] + oc[:, 1] * dl[:, 1])
         + 2.0 * be * oc[:, 2] * dl[:, 2] + ga * dl[:, 2])
    Cq = (al * (oc[:, 0] ** 2 + oc[:, 1] ** 2) + be * oc[:, 2] ** 2
          + ga * oc[:, 2] + de)
    disc = B * B - 4.0 * A * Cq
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    # numerically stable root pair: q = -(B + sign(B) sqrt(disc)) / 2,
    # roots q / A and Cq / q; q == 0 only at a double root through the
    # recentred origin, where the t > eps guard rejects both anyway
    sgn = torch.where(B >= 0.0, 1.0, -1.0)
    q = -0.5 * (B + sgn * sq)
    is_quad = A != 0.0                   # planes/walls hit A == 0 exactly
    t_qa = q / torch.where(is_quad, A, 1.0)
    t_qb = Cq / torch.where(q != 0.0, q, 1.0)
    qvalid = is_quad & (disc >= 0.0) & (q != 0.0)
    # linear case (plane, or a cylinder wall seen axis-parallel): B t + C
    t_lin = -Cq / torch.where(B != 0.0, B, 1.0)
    lvalid = (~is_quad) & (B != 0.0)
    t0 = torch.where(qvalid, t_qa, torch.where(lvalid, t_lin, _INF)) + s0
    t1 = torch.where(qvalid, t_qb, _INF) + s0

    def accept(t):
        p = ol + t[:, None] * dl         # hit point, local frame
        r2 = p[:, 0] ** 2 + p[:, 1] ** 2
        z = p[:, 2]
        ok = ((t > eps) & (t < t_max)
              & (r2 >= rlim2[0] * (1.0 - eps_b))
              & (r2 <= rlim2[1] * (1.0 + eps_b) + eps_b)
              & (z >= zlim[0] - eps_b * (1.0 + torch.abs(zlim[0])))
              & (z <= zlim[1] + eps_b * (1.0 + torch.abs(zlim[1]))))
        return torch.where(ok, t, _INF)

    return torch.minimum(accept(t0), accept(t1))


def intersect_quadrics(scene, o, d, cfg):
    """Nearest hit of C rays over the scene's Q analytic surfaces. Returns
    (t (C,) f32, +inf on miss; tri (C,) i32 attribute-row index, -1 on
    miss; normal (C, 3) f32 outward unit normal at the hit point,
    arbitrary but finite on miss lanes: callers mask on t)."""
    f32 = torch.float32
    dev = o.device
    eps = torch.tensor(cfg.eps, dtype=f32, device=dev)
    # radial/axial boundary slack mirrors the triangle test's barycentric
    # slack (cfg.eps_bary) so rim hits don't flicker between the two paths
    eps_b = torch.tensor(max(cfg.eps_bary, 1e-6), dtype=f32, device=dev)
    t_max = torch.tensor(cfg.max_ray_len, dtype=f32, device=dev)
    abgd = scene.quad_abgd
    rlim2 = scene.quad_rlim ** 2
    zlim = scene.quad_zlim
    vertex = scene.quad_vertex
    frame = scene.quad_frame
    Q = abgd.shape[0]

    bt = torch.full((o.shape[0],), _INF, dtype=f32, device=dev)
    bi = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    for i in range(Q):
        t = _intersect_one(o, d, abgd[i], rlim2[i], zlim[i], vertex[i],
                           frame[i], eps, eps_b, t_max)
        better = t < bt
        bt = torch.where(better, t, bt)
        bi = torch.where(better, i, bi)

    # outward normal = quadric gradient at the hit point (one gather of the
    # winning surface's params; miss lanes get finite placeholder values)
    safe = torch.clamp_min(bi, 0).long()
    fr = frame[safe]                      # (C, 3, 3)
    ab = abgd[safe]                       # (C, 4)
    found = torch.isfinite(bt)
    hit = o + torch.where(found, bt, 0.0)[:, None] * d
    pl = _to_local(hit - vertex[safe], fr)
    grad_l = torch.stack([2.0 * ab[:, 0] * pl[:, 0],
                          2.0 * ab[:, 0] * pl[:, 1],
                          2.0 * ab[:, 1] * pl[:, 2] + ab[:, 2]], dim=1)
    n_w = _to_world(grad_l, fr)
    n_w = n_w / torch.clamp_min(
        torch.sqrt(torch.sum(n_w * n_w, dim=1, keepdim=True)), 1e-20)
    tri = torch.where(found, scene.quad_tri[safe], -1)
    return bt, tri, n_w
