"""Differentiable optical design: end-to-end gradients through the tracer.

Port counterpart of lightpycl_tpu/diff.py, on torch autograd: the same
public names, signatures, defaults and return types. The gradient of a
scalar figure of merit (spot RMS, band reflectance) flows back through
shading (Fresnel powers, Snell directions), intersection (hit distances)
and the parametric meshers here into the lens prescription itself
(curvatures, conics, thickness) or a coating's layer indices and
thicknesses. `torch.autograd.grad` / `loss.backward()` and a torch
optimizer turn the tracer into a lens or coating designer.

Differentiation semantics, as in the reference: the ray -> triangle
assignment (argmin) and every material / visibility mask are locally
constant; smooth parameter changes that slide hit points and bend
refraction angles are differentiated exactly. A tessellated surface carries
O(1/n_seg^2) facet noise in its gradients; the exact-quadric twins below
carry none.

Gradient safety: the production nearest hit (ops/intersect.py and its CUDA
kernel) divides by DW == 0 on padding rows and relies on inf / nan
compares; reverse-mode AD of x / 0 makes nan cotangents even under a
downstream mask (0 * inf). `intersect_diff` is the same unit-transform math
with a guarded denominator and a finite 1e30 sentinel, dense over
(rays, triangles) in plain float32 torch ops; the CUDA kernel stays off this
path and needs no backward pass. `shade` and `compact` are the tracer's own
(tracer/step.py). Every product here is an explicit multiply-add, never a
matrix product, so no TF32 setting can move a hit distance. The meshers,
the scene build and the ray bundle use no device reduction, sin / cos,
cross-product kernel or division by a host scalar (each rounds otherwise
on the card than on the CPU), so the same arguments give the same scene
and rays on both: a faceted loss is ill-conditioned where a ray meets an
edge, and one ulp there can choose the other facet.

Devices: a function given tensors computes on their device; one that builds
its own (the meshers and scene builders from Python numbers,
`collimated_bundle`, the loss factories, `band_reflectance` from numbers,
`design_coating`) builds them on `engine.resolve_device("cuda")`, which
raises without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from lightpycl_tpu_torch import physics
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.ops.quadric import _to_local, _to_world
from lightpycl_tpu_torch.tracer import engine
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene
from lightpycl_tpu_torch.tracer.step import compact, default_hit_attrs, shade

_F32 = torch.float32
_BIG = 1e30    # finite 'no hit' sentinel (inf would poison AD)
_TINY = 1e-20


def _device(*xs) -> torch.device:
    """The device of the first tensor among `xs`, else the port's default
    (CUDA; raises without a card)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return engine.resolve_device("cuda")


def _f32(x, device) -> torch.Tensor:
    """x as a float32 tensor on `device` (differentiable for tensors)."""
    return torch.as_tensor(x, dtype=_F32, device=device)


def _cross(a, b):
    """a x b over the last axis from separate products and differences (a
    device's cross-product kernel may contract them into FMAs)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot3(a, b):
    """Dot product over the last axis (size 3), kept, as explicit adds in
    a fixed order: the same bits on every device (a reduction kernel's
    association is the device's own)."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
            + a[..., 2:3] * b[..., 2:3])


# --------------------------------------------------------------------------
# Differentiable scene construction
# --------------------------------------------------------------------------

def unit_transform_rows(v0, e1, e2):
    """Per-triangle world -> unit-triangle transform rows (T, 4) each.

    For A = [e1 | e2 | n], n = e1 x e2, the adjugate gives the rows of A^-1
    as cross products: row_u = (e2 x n) / |n|^2, row_v = (n x e1) / |n|^2,
    row_w = n / |n|^2, with -A^-1 v0 folded into column 4. Degenerate
    triangles (|n|^2 <= 1e-16) get all-zero rows (never hit) and exactly
    zero gradients.
    """
    n = _cross(e1, e2)
    det = _dot3(n, n)
    # double where, not / max(det, tiny): the division's VJP holds
    # -1 / det^2, tiny^2 underflows float32 to 0, and 0 * inf = nan would
    # reach every degenerate row's cotangent
    good = det > 1e-16
    inv_det = torch.where(good, 1.0 / torch.where(good, det, 1.0), 0.0)
    ru = _cross(e2, n) * inv_det
    rv = _cross(n, e1) * inv_det
    rw = n * inv_det

    def with_offset(r):
        return torch.cat([r, -_dot3(r, v0)], dim=-1)

    return with_offset(ru), with_offset(rv), with_offset(rw)


def scene_from_triangles(tv, mat, ior, *, reflectivity=None, detector_id=None,
                         absorb=None, ior_b=None, pad_to: int = 256) -> Scene:
    """A Scene straight from a differentiable (T, 3, 3) triangle-vertex
    tensor (tracer/scene.build_scene runs in numpy and would cut the
    graph). mat / ior / ...: (T,) arrays or scalars, broadcast. The optics
    columns (polarizer axis, gratings, metals, coatings) are zero: this path
    differentiates geometry. Padded with TERMINATOR rows to `pad_to`."""
    dev = _device(tv)
    tv = _f32(tv, dev)
    T = tv.shape[0]

    def col(x, default, dtype=_F32):
        if x is None:
            x = default
        return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=dev),
                                  (T,))

    mat = col(mat, 0, torch.int32)
    ior = col(ior, 1.0)
    reflectivity = col(reflectivity, 0.0)
    detector_id = col(detector_id, -1, torch.int32)
    absorb = col(absorb, 0.0)
    ior_b = col(ior_b, 0.0)

    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = _cross(e1, e2)
    # not torch.linalg.norm: its VJP n / |n| is 0 / 0 on the zero-area
    # triangles of the mesher's r = 0 ring; the guarded sum of squares
    # keeps the backward pass finite
    n_unit = n / torch.sqrt(torch.clamp_min(_dot3(n, n), _TINY))
    wu, wv, ww = unit_transform_rows(v0, e1, e2)

    T_pad = ((max(T, 1) + pad_to - 1) // pad_to) * pad_to
    pad = T_pad - T

    def p(a, fill=0.0):
        if pad == 0:
            return a
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=dev)])

    zero = torch.zeros((T,), dtype=_F32, device=dev)
    return Scene(
        v0=p(v0), e1=p(e1), e2=p(e2), normal=p(n_unit),
        wu=p(wu), wv=p(wv), ww=p(ww),
        mat=p(mat, fill=int(Material.TERMINATOR)),
        ior=p(ior, fill=1.0), ior_b=p(ior_b), absorb=p(absorb),
        reflectivity=p(reflectivity),
        detector_id=p(detector_id, fill=-1),
        axis=p(torch.zeros((T, 3), dtype=_F32, device=dev)),
        retardance=p(zero), grating_mlp=p(zero), grating_g0=p(zero),
        metal_n=p(zero), metal_k=p(zero),
        coat_ior=p(zero[:, None]), coat_thickness=p(zero[:, None]),
    )


# --------------------------------------------------------------------------
# Gradient-safe intersection
# --------------------------------------------------------------------------

def _rows_dot(x, w, one: bool):
    """(C, 3) x (T, 4) -> (C, T): x . w[:, :3] (+ w[:, 3] for a point),
    as explicit float32 multiply-adds in the order of a 4-term dot."""
    out = (x[:, 0:1] * w[:, 0] + x[:, 1:2] * w[:, 1]
           + x[:, 2:3] * w[:, 2])
    return out + w[:, 3] if one else out


def intersect_diff(scene: Scene, o, d, cfg: TraceConfig):
    """Nearest hit with every intermediate finite (reverse-mode safe).

    Dense (C, T_pad) evaluation: design scenes are small (10^3-10^4
    triangles). Returns (t, tri) with t == max_ray_len and tri == -1 on a
    miss (finite, not +inf); ties go to the lower triangle index.
    """
    OU = _rows_dot(o, scene.wu, True)
    OV = _rows_dot(o, scene.wv, True)
    OW = _rows_dot(o, scene.ww, True)
    DU = _rows_dot(d, scene.wu, False)
    DV = _rows_dot(d, scene.wv, False)
    DW = _rows_dot(d, scene.ww, False)

    ok = torch.abs(DW) > _TINY
    t = -OW / torch.where(ok, DW, _TINY)
    u = OU + t * DU
    v = OV + t * DV
    hit = (ok & (t > cfg.eps) & (t < cfg.max_ray_len)
           & (torch.minimum(u, v) >= -cfg.eps_bary)
           & (u + v <= 1.0 + cfg.eps_bary))
    tt = torch.where(hit, t, _BIG)
    idx = torch.argmin(tt, dim=1).to(torch.int32)
    # amin, not min(dim): a tie shares the cotangent as jnp.min's does
    tbest = torch.amin(tt, dim=1)
    valid = tbest < cfg.max_ray_len
    return (torch.where(valid, tbest, cfg.max_ray_len),
            torch.where(valid, idx, -1))


def trace_diff(scene: Scene, rays: RayBatch, cfg: TraceConfig,
               n_bounces: int, collect_escaped: bool = False):
    """Fixed-depth differentiable trace: an unrolled loop of intersect_diff
    -> shade -> compact (the tracer's own shade and compact). No detector
    scatter, no early exit, no random materials. Returns the surviving
    RayBatch; collect_escaped=True also returns (o, d, power) stacks of
    every ray at the bounce it left the system (missed all geometry)."""
    esc = []
    for _ in range(n_bounces):
        t, tri = intersect_diff(scene, rays.o, rays.d, cfg)
        if collect_escaped:
            miss = rays.alive & (tri < 0)
            esc.append((rays.o, rays.d, torch.where(miss, rays.power, 0.0)))
        sh = shade(scene, rays, t, tri, cfg)
        rays, _ = compact(sh, rays.capacity, cfg)
    if collect_escaped:
        eo, ed, ep = (torch.cat([e[i] for e in esc]) for i in range(3))
        return rays, (eo, ed, ep)
    return rays


# --------------------------------------------------------------------------
# Figures of merit
# --------------------------------------------------------------------------

def spot_rms_at_plane(o, d, power, z_plane, min_dz: float = 0.5,
                      min_power: float = 0.0):
    """Power-weighted RMS transverse spot radius of the forward rays
    (o, d, power) continued to the plane z = z_plane, about their weighted
    centroid. `min_dz` drops backward / grazing rays, `min_power` Fresnel
    ghosts; both cutoffs are locally constant masks."""
    dz = d[:, 2]
    w = torch.where((dz > min_dz) & (power > min_power), power, 0.0)
    t = (z_plane - o[:, 2]) / torch.where(torch.abs(dz) > 1e-6, dz, 1.0)
    x = o[:, 0] + t * d[:, 0]
    y = o[:, 1] + t * d[:, 1]
    wsum = torch.clamp_min(torch.sum(w), _TINY)
    xc = torch.sum(w * x) / wsum
    yc = torch.sum(w * y) / wsum
    r2 = (x - xc) ** 2 + (y - yc) ** 2
    return torch.sqrt(torch.sum(w * r2) / wsum)


# --------------------------------------------------------------------------
# Differentiable parametric meshers
# --------------------------------------------------------------------------

def sag(c, r2, k=0.0):
    """Conic sag z(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) of curvature
    c = 1/R and conic constant k at r^2; differentiable in c and k, the
    root clamped so parameters past the geometric limit stay finite."""
    dev = _device(r2, c, k)
    c = _f32(c, dev)
    k = _f32(k, dev)
    root = torch.sqrt(torch.clamp_min(1.0 - (1.0 + k) * c * c * r2, 1e-4))
    return c * r2 / (1.0 + root)


def singlet_triangles(c1, c2, thickness, aperture_radius,
                      n_seg: int = 48, n_rad: int = 12,
                      k1=0.0, k2=0.0):
    """Differentiable (T, 3, 3) triangle soup of a rotationally symmetric
    singlet: front conic (c1, k1; vertex at z = 0), back conic (c2, k2;
    vertex at z = thickness), cylindrical wall at r = aperture_radius.
    c > 0 bulges toward -z (biconvex: c1 > 0, c2 < 0; rays travel +z);
    winding outward as geometry/primitives.py's lenses. The r = 0 ring
    gives one degenerate triangle per quad (zero rows, never hit)."""
    dev = _device(c1, c2, thickness, aperture_radius, k1, k2)
    thickness = _f32(thickness, dev)
    a = _f32(aperture_radius, dev)
    # the azimuths (constants) as the reference's float32 angles, their
    # cos / sin rounded once from float64 on the host: the same vertices
    # on every device
    th = (np.float32(2.0 * np.pi) * np.arange(n_seg + 1, dtype=np.float32)
          / np.float32(n_seg)).astype(np.float64)
    cth = torch.tensor(np.cos(th), dtype=_F32, device=dev)
    sth = torch.tensor(np.sin(th), dtype=_F32, device=dev)
    # divided by a device tensor: a CPU scalar divisor becomes a multiply
    # by its reciprocal on the card (one ulp off the quotient)
    r = a * torch.arange(n_rad + 1, device=dev) / torch.full(
        (), n_rad, dtype=_F32, device=dev)

    def grid(zfun):   # (K+1, S+1, 3) surface points
        x = r[:, None] * cth[None, :]
        y = r[:, None] * sth[None, :]
        z = torch.broadcast_to(zfun(r * r)[:, None], x.shape)
        return torch.stack([x, y, z], dim=-1)

    F = grid(lambda r2: sag(c1, r2, k1))
    B = grid(lambda r2: thickness + sag(c2, r2, k2))

    def quads(P, order):
        """Triangulate the (K, S) quad grid of P; corners A=(k,j)
        B=(k+1,j) C=(k+1,j+1) D=(k,j+1)."""
        corners = {"A": P[:-1, :-1].reshape(-1, 3),
                   "B": P[1:, :-1].reshape(-1, 3),
                   "C": P[1:, 1:].reshape(-1, 3),
                   "D": P[:-1, 1:].reshape(-1, 3)}
        return torch.cat([torch.stack([corners[i] for i in o], dim=1)
                          for o in order])

    front = quads(F, [("A", "D", "B"), ("D", "C", "B")])   # normal -z
    back = quads(B, [("A", "B", "D"), ("D", "B", "C")])    # normal +z
    W0, W1 = F[-1, :-1], F[-1, 1:]                         # rim rings
    W2, W3 = B[-1, 1:], B[-1, :-1]
    wall = torch.cat([torch.stack([W0, W1, W2], dim=1),
                      torch.stack([W0, W2, W3], dim=1)])
    return torch.cat([front, back, wall])


def singlet_scene(c1, c2, thickness, aperture_radius, ior,
                  n_seg: int = 48, n_rad: int = 12,
                  pad_to: int = 256, k1=0.0, k2=0.0) -> Scene:
    """Scene of one refractive singlet, differentiable in c1, c2,
    thickness, aperture_radius, k1 and k2; pair with spot_rms_at_plane."""
    tv = singlet_triangles(c1, c2, thickness, aperture_radius,
                           n_seg=n_seg, n_rad=n_rad, k1=k1, k2=k2)
    return scene_from_triangles(
        tv, mat=int(Material.REFRACTIVE), ior=ior, pad_to=pad_to)


def collimated_bundle(n_rays: int, beam_radius, z_start: float = -1.0,
                      power: float = 1.0) -> RayBatch:
    """Deterministic +z collimated bundle on concentric (hexapolar-style)
    rings: no sampling noise between optimizer steps. Capacity 4 x n_rays
    absorbs the Fresnel-split children of trace_diff."""
    n_rings = max(int(np.sqrt(n_rays / 3.0)), 1)
    rs, phis = [0.0], [0.0]
    placed = 1
    for k in range(1, n_rings + 1):
        m = 6 * k
        ang = 2.0 * np.pi * (np.arange(m) + 0.5 * (k % 2)) / m
        rs.extend([k / n_rings] * m)
        phis.extend(ang.tolist())
        placed += m
        if placed >= n_rays:
            break
    rs = np.asarray(rs[:max(n_rays, 1)])
    phis = np.asarray(phis[:max(n_rays, 1)])
    n = len(rs)
    dev = _device(beam_radius)
    r = _f32(rs, dev) * beam_radius
    # cos / sin of the float32 angles rounded once on the host: the same
    # origins on every device
    phi = phis.astype(np.float32).astype(np.float64)
    o = torch.stack([r * _f32(np.cos(phi), dev), r * _f32(np.sin(phi), dev),
                     torch.full((n,), z_start, dtype=_F32, device=dev)],
                    dim=1)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=_F32, device=dev).repeat(n, 1)
    p = torch.full((n,), power / n, dtype=_F32, device=dev)
    return RayBatch.from_arrays(o, d, p, capacity=4 * n, device=dev)


def _design_cfg():
    return TraceConfig(backend="jnp", has_gratings=False,
                       has_coatings=False, has_metals=False)


def make_spot_loss(*, ior: float, thickness: float, aperture_radius: float,
                   n_rays: int = 300, beam_fill: float = 0.8,
                   n_seg: int = 48, n_rad: int = 12, n_bounces: int = 4,
                   cfg: TraceConfig | None = None):
    """Loss factory: (c1, c2, z_plane) -> RMS spot radius at z = z_plane of
    a collimated on-axis beam through the meshed singlet; all three
    arguments differentiable (numbers or float32 tensors). The figure of
    merit is evaluated on the escaped forward rays, so n_bounces >= 3:
    enter, exit, and the pass that sees them escape."""
    cfg = cfg or _design_cfg()
    rays0 = collimated_bundle(n_rays, beam_fill * aperture_radius)
    dev = rays0.device
    per_ray = float(torch.max(rays0.power))

    def loss(c1, c2, z_plane):
        c1, c2, z_plane = (_f32(x, dev) for x in (c1, c2, z_plane))
        scene = singlet_scene(c1, c2, thickness, aperture_radius, ior,
                              n_seg=n_seg, n_rad=n_rad)
        _, (eo, ed, ep) = trace_diff(scene, rays0, cfg, n_bounces,
                                     collect_escaped=True)
        # main sequential beam only: a ray that lost > 75% of its source
        # power to Fresnel reflections is a ghost, not the image
        return spot_rms_at_plane(eo, ed, ep, z_plane,
                                 min_power=0.25 * per_ray)

    return loss


# --------------------------------------------------------------------------
# Differentiable exact-surface design (analytic quadrics)
# --------------------------------------------------------------------------

def quadric_intersect_diff(scene: Scene, o, d, cfg: TraceConfig):
    """Gradient-safe twin of ops/quadric.intersect_quadrics: dense (C, Q),
    guarded denominators and square roots, the finite _BIG sentinel on a
    miss. Returns (t (C,), tri (C,) attribute row [-1 on miss], normal
    (C, 3) outward unit normal [zero on miss])."""
    eps = cfg.eps
    eps_b = max(cfg.eps_bary, 1e-6)
    t_max = cfg.max_ray_len
    abgd = scene.quad_abgd          # (Q, 4)
    rlim2 = scene.quad_rlim ** 2    # (Q, 2)
    zlim = scene.quad_zlim          # (Q, 2)
    vertex = scene.quad_vertex      # (Q, 3)
    frame = scene.quad_frame        # (Q, 3, 3)

    # local coordinates (C, Q, 3), explicit multiply-adds
    ol = _to_local(o[:, None, :] - vertex[None, :, :], frame)
    dl = _to_local(d[:, None, :], frame)
    al, be, ga, de = abgd[:, 0], abgd[:, 1], abgd[:, 2], abgd[:, 3]
    # recentre at the closest approach to the local origin (float32
    # conditioning, as the forward path does)
    s0 = -torch.sum(ol * dl, dim=-1)
    oc = ol + s0[..., None] * dl
    A = al * (dl[..., 0] ** 2 + dl[..., 1] ** 2) + be * dl[..., 2] ** 2
    B = (2.0 * al * (oc[..., 0] * dl[..., 0] + oc[..., 1] * dl[..., 1])
         + 2.0 * be * oc[..., 2] * dl[..., 2] + ga * dl[..., 2])
    Cq = (al * (oc[..., 0] ** 2 + oc[..., 1] ** 2) + be * oc[..., 2] ** 2
          + ga * oc[..., 2] + de)
    disc = B * B - 4.0 * A * Cq
    dpos = disc > 0.0
    # sqrt's VJP is 1 / (2 sqrt): keep the argument off 0 on masked lanes
    sq = torch.where(dpos, torch.sqrt(torch.where(dpos, disc, 1.0)), 0.0)
    sgn = torch.where(B >= 0.0, 1.0, -1.0)
    q = -0.5 * (B + sgn * sq)
    is_quad = torch.abs(A) > _TINY
    qok = torch.abs(q) > _TINY
    t_qa = q / torch.where(is_quad, A, 1.0)
    t_qb = Cq / torch.where(qok, q, 1.0)
    qvalid = is_quad & dpos & qok
    lok = torch.abs(B) > _TINY
    t_lin = -Cq / torch.where(lok, B, 1.0)
    lvalid = (~is_quad) & lok
    t0 = torch.where(qvalid, t_qa, torch.where(lvalid, t_lin, _BIG)) + s0
    t1 = torch.where(qvalid, t_qb, _BIG) + s0

    def accept(t):
        p = ol + t[..., None] * dl
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        z = p[..., 2]
        ok = ((t > eps) & (t < t_max)
              & (r2 >= rlim2[:, 0] * (1.0 - eps_b))
              & (r2 <= rlim2[:, 1] * (1.0 + eps_b) + eps_b)
              & (z >= zlim[:, 0] - eps_b * (1.0 + torch.abs(zlim[:, 0])))
              & (z <= zlim[:, 1] + eps_b * (1.0 + torch.abs(zlim[:, 1]))))
        return torch.where(ok, t, _BIG)

    tq = torch.minimum(accept(t0), accept(t1))      # (C, Q)
    qi = torch.argmin(tq, dim=1)
    tbest = torch.amin(tq, dim=1)
    valid = tbest < t_max

    # outward normal = the quadric's gradient at the winning hit point
    fr = frame[qi]
    ab = abgd[qi]
    hit = o + torch.where(valid, tbest, 0.0)[:, None] * d
    pl = _to_local(hit - vertex[qi], fr)
    grad_l = torch.stack([2.0 * ab[:, 0] * pl[:, 0],
                          2.0 * ab[:, 0] * pl[:, 1],
                          2.0 * ab[:, 1] * pl[:, 2] + ab[:, 2]], dim=1)
    n_w = _to_world(grad_l, fr)
    n_w = n_w / torch.sqrt(
        torch.clamp_min(torch.sum(n_w * n_w, dim=1, keepdim=True), _TINY))
    tri = torch.where(valid, scene.quad_tri[qi], -1)
    return (torch.where(valid, tbest, _BIG), tri,
            torch.where(valid[:, None], n_w, 0.0))


def analytic_singlet_scene(c1, c2, thickness, aperture_radius, ior,
                           k1=0.0, k2=0.0, pad_to: int = 256) -> Scene:
    """Scene of one exact-surface singlet (front conic cap, back conic cap,
    cylindrical rim; geometry/analytic.analytic_lens's construction),
    differentiable in c1, c2, k1, k2, thickness and aperture_radius. Each
    surface owns one degenerate placeholder triangle for its attribute
    row (zero transform rows: the triangle pass never hits it)."""
    dev = _device(c1, c2, thickness, aperture_radius, ior, k1, k2)
    c1, c2, th, a, k1, k2 = (_f32(x, dev) for x in
                             (c1, c2, thickness, aperture_radius, k1, k2))
    a2 = a * a
    s1 = sag(c1, a2, k1)                 # front sag at the rim (world z)
    s2 = sag(c2, a2, k2)                 # back sag (negative for biconvex)
    z0 = torch.zeros((), dtype=_F32, device=dev)

    # three coincident vertices: zero area, zero rows
    v_f = torch.stack([z0, z0, z0])
    v_b = torch.stack([z0, z0, th])
    tv = torch.stack([torch.stack([v_f, v_f, v_f]),
                      torch.stack([v_b, v_b, v_b]),
                      torch.stack([v_f, v_f, v_f])])
    scene = scene_from_triangles(tv, mat=int(Material.REFRACTIVE), ior=ior,
                                 pad_to=pad_to)

    one = torch.ones((), dtype=_F32, device=dev)
    eye = torch.eye(3, dtype=_F32, device=dev)
    # right-handed frame with z_local = -z_world (back-cap body on its
    # +z_local side)
    flip = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                         [0.0, 0.0, -1.0]], dtype=_F32, device=dev)
    abgd = torch.stack([
        torch.stack([c1, c1 * (1.0 + k1), -2.0 * one, z0]),
        torch.stack([-c2, -c2 * (1.0 + k2), -2.0 * one, z0]),
        torch.stack([one, z0, z0, -a2]),
    ])
    sb = -s2                              # back sag in the back-cap frame
    rlim = torch.stack([torch.stack([z0, a]), torch.stack([z0, a]),
                        torch.stack([z0, 2.0 * a])])

    def span(s):
        return torch.stack([torch.minimum(z0, s), torch.maximum(z0, s)])

    rim_lo = s1
    rim_hi = th + s2
    zlim = torch.stack([
        span(s1), span(sb),
        torch.stack([torch.minimum(rim_lo, rim_hi),
                     torch.maximum(rim_lo, rim_hi)]),
    ])
    vertex = torch.stack([v_f, v_b, v_f])
    frame = torch.stack([eye, flip, eye])
    return scene._replace(
        quad_abgd=abgd, quad_rlim=rlim, quad_zlim=zlim, quad_vertex=vertex,
        quad_frame=frame,
        quad_tri=torch.arange(3, dtype=torch.int32, device=dev))


def trace_diff_analytic(scene: Scene, rays: RayBatch, cfg: TraceConfig,
                        n_bounces: int, collect_escaped: bool = False):
    """trace_diff with the exact-quadric merge (the differentiable twin of
    trace_step's analytic branch): the triangle and quadric nearest hits
    merge per ray; a winning quadric takes its placeholder triangle's
    attribute row and only the geometric normal is overridden."""
    esc = []
    for _ in range(n_bounces):
        t, tri = intersect_diff(scene, rays.o, rays.d, cfg)
        tq, qtri, nq = quadric_intersect_diff(scene, rays.o, rays.d, cfg)
        use_q = tq < t
        t = torch.where(use_q, tq, t)
        tri = torch.where(use_q, qtri, tri)
        if collect_escaped:
            miss = rays.alive & (tri < 0)
            esc.append((rays.o, rays.d, torch.where(miss, rays.power, 0.0)))
        attrs = default_hit_attrs(scene, torch.clamp_min(tri, 0), cfg)
        attrs["normal"] = torch.where(use_q[:, None], nq, attrs["normal"])
        sh = shade(scene, rays, t, tri, cfg, attrs=attrs)
        rays, _ = compact(sh, rays.capacity, cfg)
    if collect_escaped:
        eo, ed, ep = (torch.cat([e[i] for e in esc]) for i in range(3))
        return rays, (eo, ed, ep)
    return rays


def make_analytic_spot_loss(*, ior: float, thickness: float,
                            aperture_radius: float, n_rays: int = 300,
                            beam_fill: float = 0.8, n_bounces: int = 4,
                            cfg: TraceConfig | None = None):
    """Loss factory on exact surfaces: (c1, c2, k1, k2, z_plane) -> RMS
    spot radius at z = z_plane of a collimated on-axis beam; all five
    arguments differentiable, no tessellation noise. For best-form
    (Coddington) shape, conic (the stigmatic k = -n^2 singlet) and focus
    optimization."""
    cfg = cfg or _design_cfg()
    rays0 = collimated_bundle(n_rays, beam_fill * aperture_radius)
    dev = rays0.device
    per_ray = float(torch.max(rays0.power))

    def loss(c1, c2, k1, k2, z_plane):
        c1, c2, k1, k2, z_plane = (_f32(x, dev)
                                   for x in (c1, c2, k1, k2, z_plane))
        scene = analytic_singlet_scene(c1, c2, thickness, aperture_radius,
                                       ior, k1=k1, k2=k2)
        _, (eo, ed, ep) = trace_diff_analytic(scene, rays0, cfg, n_bounces,
                                              collect_escaped=True)
        return spot_rms_at_plane(eo, ed, ep, z_plane,
                                 min_power=0.25 * per_ray)

    return loss


# --------------------------------------------------------------------------
# Differentiable thin-film coating design
# --------------------------------------------------------------------------

def band_reflectance(layers_n, layers_h, *, n_sub, wavelengths,
                     n_inc=1.0, cos_i=1.0, weights=None):
    """Mean unpolarized power reflectance of a lossless dielectric stack
    over an (incidence angle x wavelength) grid, differentiable in every
    entry of `layers_n` / `layers_h` (physics.multilayer_reflectance, the
    film model the tracer evaluates at every coated hit).

    layers_n / layers_h: sequences of layer indices and thicknesses, layer
        0 next to the incident medium; thickness in the wavelengths' unit
        (um in the engine: GeoObject(coating=[(n, h_um), ...])).
    wavelengths: (W,) vacuum wavelengths spanning the band.
    cos_i: scalar or (A,) incidence cosines; the mean runs over (A, W).
    weights: optional (W,) spectral weights, normalized here.
    """
    dev = _device(*layers_n, *layers_h, wavelengths, cos_i, weights)
    wl = _f32(wavelengths, dev).reshape(1, -1)
    ci = torch.atleast_1d(_f32(cos_i, dev)).reshape(-1, 1)
    ln = [_f32(n, dev) for n in layers_n]
    lh = [_f32(h, dev) for h in layers_h]
    R = physics.multilayer_reflectance(ci, _f32(n_inc, dev), ln, lh,
                                       _f32(n_sub, dev), wl)
    if weights is None:
        return torch.mean(R)
    w = _f32(weights, dev).reshape(1, -1)
    w = w / torch.clamp_min(torch.sum(w), _TINY)
    return torch.mean(torch.sum(R * w, dim=1))


def design_coating(n_layers: int, *, n_sub, wavelengths, n_inc=1.0,
                   cos_i=1.0, fixed_n=None, init_n=None, init_h=None,
                   weights=None, n_min=1.05, n_max=4.0,
                   steps=1500, lr=0.03, seed=0):
    """Gradient-descent anti-reflection design: minimize the band-averaged
    unpolarized reflectance of an `n_layers` stack on substrate `n_sub`
    with Adam (torch.optim.Adam, betas (0.9, 0.999), eps 1e-8).

    fixed_n: optional layer indices to hold fixed (catalog materials, e.g.
        [1.38, 2.10] MgF2/ZrO2 for a V-coat); only thicknesses optimize.
        Otherwise indices co-optimize inside [n_min, n_max] through a
        sigmoid (thicknesses stay positive through softplus).
    init_n / init_h: optional starting stack (defaults: indices alternating
        1.38 / 1.9, quarter-wave thicknesses at the band centre).
    Returns (n, h, R_mean): float64 numpy arrays of the best iterate and
    its mean band reflectance; `list(zip(n, h))` is a ready
    GeoObject(coating=...) argument.
    """
    wl_arr = np.atleast_1d(np.asarray(wavelengths, np.float64))
    wl0 = float(wl_arr.mean())
    if init_n is None:
        init_n = [1.38 if k % 2 == 0 else 1.9 for k in range(n_layers)]
    if init_h is None:
        base = fixed_n if fixed_n is not None else init_n
        init_h = [wl0 / (4.0 * float(n)) for n in base]
    if fixed_n is not None and len(fixed_n) != n_layers:
        raise ValueError("fixed_n must have n_layers entries")
    if len(init_h) != n_layers or (fixed_n is None
                                   and len(init_n) != n_layers):
        raise ValueError("init stack must have n_layers entries")

    dev = engine.resolve_device("cuda")
    h_scale = wl0 / 4.0  # softplus(x) ~ O(1) -> thickness ~ quarter-wave

    def inv_softplus(y):
        y = np.maximum(y, 1e-6)
        return np.where(y > 30.0, y, np.log(np.expm1(y)))

    def inv_sigmoid(p):
        p = np.clip(p, 1e-6, 1.0 - 1e-6)
        return np.log(p / (1.0 - p))

    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev,
                            requires_grad=True)

    params = {"xh": leaf(inv_softplus(np.asarray(init_h) / h_scale))}
    if fixed_n is None:
        frac = (np.asarray(init_n, np.float64) - n_min) / (n_max - n_min)
        params["xn"] = leaf(inv_sigmoid(frac))
    else:
        n_fixed = _f32(np.asarray(fixed_n, np.float32), dev)
    # the band's constants cross to the device once
    band = dict(n_sub=n_sub, n_inc=n_inc,
                wavelengths=_f32(np.asarray(wavelengths, np.float32), dev),
                cos_i=_f32(np.asarray(cos_i, np.float32), dev),
                weights=(None if weights is None else
                         _f32(np.asarray(weights, np.float32), dev)))

    def unpack(p):
        # softplus as log(e^x + 1), jax.nn.softplus's form (F.softplus's
        # threshold would change values)
        h = torch.logaddexp(p["xh"], torch.zeros_like(p["xh"])) * h_scale
        if fixed_n is None:
            n = n_min + (n_max - n_min) * torch.sigmoid(p["xn"])
        else:
            n = n_fixed
        return n, h

    def loss(p):
        n, h = unpack(p)
        return band_reflectance(list(n), list(h), **band)

    opt = torch.optim.Adam(list(params.values()), lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)

    def snapshot():
        return {k: v.detach().clone() for k, v in params.items()}

    with torch.no_grad():
        best_v, best_p = float(loss(params)), snapshot()
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        val = loss(params)    # at the input params: (val, params) pair up
        val.backward()
        v = val.item()
        if v < best_v:
            best_v, best_p = v, snapshot()
        opt.step()
    with torch.no_grad():
        v = float(loss(params))   # the loop never scores the last step
        if v < best_v:
            best_v, best_p = v, snapshot()
        # report the best iterate (Adam can overshoot near convergence)
        n, h = unpack(best_p)
    return (n.cpu().numpy().astype(np.float64),
            h.cpu().numpy().astype(np.float64), best_v)
