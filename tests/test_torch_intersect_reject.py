"""The CUDA nearest-hit kernel's division-free reject test
(lightpycl_tpu_torch/csrc/intersect.cu), mirrored in plain torch.

The kernel forms, per (ray, triangle) pair, U' = OU*DW - OW*DU,
V' = OV*DW - OW*DV and W' = DW - U' - V' from FMA dot products of the
ray's moment o x d with each triangle's Plücker record, and skips the pair
when the three straddle a margin M: min < -M and max > M. M is REJECT_DELTA
(ops/intersect.py) times a bound on the terms' magnitudes, from the
triangle's row scales and the largest ray scales of the ray's CTA. Here `fused_skip` repeats that test operation for
operation, each fmaf emulated in float64 (exact product, one float64
rounding of the sum, then one float32 rounding: the margin's derivation
covers the double rounding), and `exact_hits` repeats the exact sequence
of the plain version. No pair the exact sequence accepts as a hit may ever
be skipped: on random rays, and on rays aimed at vertices, edge midpoints
and centroids, lying in a triangle's plane or starting on it, over a
sphere, a Morton-sorted bowl and two coincident copies of a mesh. The JAX
reference builds the scenes (copied bit for bit into the port) and checks
the mirrored kernel's nearest hits on the rays aimed at centroids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import lightpycl_tpu as L
from edge_rays import EDGE_RAY_KINDS, edge_rays
from lightpycl_tpu.tracer.step import intersect_jnp
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.tracer.scene import Scene as PortScene

torch.set_num_threads(1)
CPU = torch.device("cpu")
EPS, EPS_B, T_MAX = 1e-4, 1e-6, 1e3
ETA = 2.0 ** -60  # the kernel's kEta
RANGE = 2.0 ** 30  # the kernel's kRange: beyond it every pair runs exact
EB_UP = 1.0 + 2.0 ** -10  # the kernel's kEbUp


def f32(x):
    return x.to(torch.float32)


def fma(a, b, c):
    """fmaf(a, b, c) emulated: a*b is exact in float64, the sum rounds
    once to float64 and once more to float32."""
    return f32(a.double() * b.double() + c.double())


def cross_term(p, q, r, s):
    """The kernel's cross_term: fmaf(p, q, -(r*s)), r*s rounded to f32."""
    return fma(p, q, -(r * s))


def records(wu, wv, ww):
    """(T, 15) f32: each triangle's Plücker record as the kernel forms it,
    a x c, a_w c - c_w a, b x c, b_w c - c_w b, c (a, b, c = rows u, v,
    w)."""
    def cross(a, c):
        return [cross_term(a[:, 1], c[:, 2], a[:, 2], c[:, 1]),
                cross_term(a[:, 2], c[:, 0], a[:, 0], c[:, 2]),
                cross_term(a[:, 0], c[:, 1], a[:, 1], c[:, 0])]

    def affine(a, c):
        return [cross_term(a[:, 3], c[:, k], c[:, 3], a[:, k])
                for k in range(3)]

    c = ww
    cols = (cross(wu, c) + affine(wu, c) + cross(wv, c) + affine(wv, c)
            + [c[:, 0], c[:, 1], c[:, 2]])
    return torch.stack(cols, dim=1)


def ray_in_range(o, d):
    """(C, 1) bool: every |o_i|, |d_i| <= the kernel's range (not NaN)."""
    return ((o.abs() <= RANGE).all(dim=1, keepdim=True)
            & (d.abs() <= RANGE).all(dim=1, keepdim=True))


def block_scales(o, d, ray_block=PI.RAY_BLOCK):
    """(C, 1) m_o and m_d as the kernel takes them: the largest over the
    in-range rays of each ray's CTA (`ray_block` rays, the last one padded
    with the kernel's dummy rays o = 0, d = (0, 0, 1))."""
    C, R = o.shape[0], ray_block
    pad = -C % R
    op = torch.cat([o, torch.zeros((pad, 3))])
    dp = torch.cat([d, torch.tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)])
    ok = ray_in_range(op, dp)
    m_o = torch.where(ok, op.abs().amax(dim=1, keepdim=True), 0.0)
    m_d = torch.where(ok, dp.abs().amax(dim=1, keepdim=True), 0.0)

    def per_block(x):
        x = x.reshape(-1, R).amax(dim=1, keepdim=True)
        return x.expand(-1, R).reshape(-1, 1)[:C]

    return per_block(m_o), per_block(m_d)


def fused_values(o, d, wu, wv, ww):
    """(C, T) U', V', W' as the kernel's fused evaluation forms them."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    nan = torch.tensor(float("nan"))
    ok = ray_in_range(o, d)
    lx = torch.where(ok, cross_term(oy, dz, oz, dy), nan)
    ly = torch.where(ok, cross_term(oz, dx, ox, dz), nan)
    lz = torch.where(ok, cross_term(ox, dy, oy, dx), nan)
    r = records(wu, wv, ww)

    def plucker(k):
        return fma(r[:, k], lx, fma(r[:, k + 1], ly, fma(r[:, k + 2], lz,
                   fma(r[:, k + 3], dx, fma(r[:, k + 4], dy,
                                            r[:, k + 5] * dz)))))

    U, V = plucker(0), plucker(6)
    DW = fma(r[:, 12], dx, fma(r[:, 13], dy, r[:, 14] * dz))
    return U, V, (DW - U) - V


def fused_skip(o, d, wu, wv, ww, eps_b=EPS_B, delta=PI.REJECT_DELTA,
               ray_block=PI.RAY_BLOCK):
    """(C, T) bool: the pairs the kernel skips, as the kernel decides (the
    margin from each triangle's row scales and the ray scales of CTAs of
    `ray_block` rays)."""
    _, neg_eps_b, _, _ = PI._thresholds(EPS, eps_b, T_MAX)
    U, V, W = fused_values(o, d, wu, wv, ww)
    # per-triangle coefficients in the kernel's f32 order
    la, lb, lc = ((r[:, 0].abs() + r[:, 1].abs()) + r[:, 2].abs()
                  for r in (wu, wv, ww))
    l_ab = torch.maximum(la, lb)
    b_ab = torch.maximum(wu[:, 3].abs(), wv[:, 3].abs())
    dl = f32(torch.tensor(delta))
    eb = f32(torch.tensor(abs(neg_eps_b))) * f32(torch.tensor(EB_UP))
    alpha = dl * ((l_ab + l_ab) * lc)
    beta = dl * ((b_ab * lc + ww[:, 3].abs() * l_ab) + lc) + eb * lc
    tri_in_range = ((la <= RANGE) & (lb <= RANGE) & (lc <= RANGE)
                    & (torch.stack([wu[:, 3], wv[:, 3], ww[:, 3]]).abs()
                       <= RANGE).all(dim=0))
    m_o, m_d = block_scales(o, d, ray_block)
    M = fma(m_d, fma(m_o, alpha, beta), f32(torch.tensor(ETA)))
    M = torch.where(tri_in_range, M, float("inf"))
    lo = torch.minimum(U, torch.minimum(V, W))
    hi = torch.maximum(U, torch.maximum(V, W))
    return (lo < -M) & (hi > M)


def exact_hits(o, d, wu, wv, ww, eps_b=EPS_B):
    """(C, T) q and hit mask of the exact sequence (nearest_hit_torch's
    operations, in its order)."""
    neg_eps, neg_eps_b, one_eps_b, _ = PI._thresholds(EPS, eps_b, T_MAX)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    a, b, c = wu, wv, ww
    OU = ox * a[:, 0] + oy * a[:, 1] + oz * a[:, 2] + a[:, 3]
    OV = ox * b[:, 0] + oy * b[:, 1] + oz * b[:, 2] + b[:, 3]
    OW = ox * c[:, 0] + oy * c[:, 1] + oz * c[:, 2] + c[:, 3]
    DU = dx * a[:, 0] + dy * a[:, 1] + dz * a[:, 2]
    DV = dx * b[:, 0] + dy * b[:, 1] + dz * b[:, 2]
    DW = dx * c[:, 0] + dy * c[:, 1] + dz * c[:, 2]
    q = OW / DW
    u = OU - q * DU
    v = OV - q * DV
    hit = ((q < neg_eps) & (u >= neg_eps_b) & (v >= neg_eps_b)
           & (u + v <= one_eps_b))
    return q, hit


def mirrored_kernel(o, d, wu, wv, ww):
    """Nearest hit as the kernel forms it: skipped pairs never reach the
    exact test, the rest take the running max of q, lowest index first."""
    q, hit = exact_hits(o, d, wu, wv, ww)
    hit = hit & ~fused_skip(o, d, wu, wv, ww)
    qq = torch.where(hit, q, -float("inf"))
    best = qq.max(dim=1).values
    col = torch.arange(qq.shape[1], dtype=torch.int32)
    idx = torch.where(qq == best[:, None], col,
                      torch.iinfo(torch.int32).max).min(dim=1).values
    t = -best
    valid = torch.isfinite(t) & (t < np.float32(T_MAX))
    return (torch.where(valid, t, float("inf")),
            torch.where(valid, idx, -1))


def sphere_scene():
    rs, _ = L.build_scene([L.optical_elements(16, 8).sphere(
        5.0, material="terminator")])
    return rs, PortScene.from_reference(rs, CPU)


def bowl_scene():
    oe = L.optical_elements(24, 8)
    rs, _ = L.build_scene([oe.parabolic_mirror(focus=1.0, diameter=4.0),
                           L.optical_elements(12, 4).hemisphere(10.0)],
                          spatial_sort=True)
    return rs, PortScene.from_reference(rs, CPU)


def twin_scene():
    oe = L.optical_elements(12, 6)
    rs, _ = L.build_scene([oe.sphere(2.0, material="terminator"),
                           oe.sphere(2.0, material="terminator")])
    return rs, PortScene.from_reference(rs, CPU)


SCENES = {"sphere": sphere_scene, "bowl": bowl_scene, "twin": twin_scene}


def assert_no_hit_skipped(ps, o, d, eps_b=EPS_B):
    _, hit = exact_hits(o, d, ps.wu, ps.wv, ps.ww, eps_b=eps_b)
    skip = fused_skip(o, d, ps.wu, ps.wv, ps.ww, eps_b=eps_b)
    assert not bool((hit & skip).any()), \
        f"{int((hit & skip).sum())} exact hits skipped"
    return hit, skip


@pytest.mark.parametrize("kind", EDGE_RAY_KINDS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_edge_rays_never_skip_a_hit(scene, kind):
    _, ps = SCENES[scene]()
    o, d = edge_rays(ps, 5 * 300, seed=11)
    sel = torch.from_numpy(np.arange(5 * 300) % 5
                           == EDGE_RAY_KINDS.index(kind))
    hit, skip = assert_no_hit_skipped(ps, o[sel], d[sel])
    # not vacuous: the rays do hit, and the test skips most pairs
    assert bool(hit.any())
    assert float(skip.float().mean()) > 0.5


@pytest.mark.parametrize("kind", EDGE_RAY_KINDS)
def test_edge_rays_sit_where_they_say(kind):
    # each kind lies where edge_rays says, to f32 rounding: its line
    # through a vertex, an edge midpoint or a centroid of a real triangle;
    # or in a triangle's plane (grazing), or starting inside a triangle
    _, ps = sphere_scene()
    o, d = edge_rays(ps, 5 * 40, seed=8)
    sel = torch.from_numpy(np.arange(5 * 40) % 5
                           == EDGE_RAY_KINDS.index(kind))
    o, d = o[sel].double(), d[sel].double()
    real = (ps.ww != 0).any(dim=1)
    v0, e1, e2 = (x[real].double() for x in (ps.v0, ps.e1, ps.e2))
    tol = 1e-4  # the sphere's radius is 5
    if kind in ("vertex", "edge_mid", "centroid"):
        pts = {"vertex": torch.cat([v0, v0 + e1, v0 + e2]),
               "edge_mid": torch.cat([v0 + e1 / 2, v0 + e2 / 2,
                                      v0 + (e1 + e2) / 2]),
               "centroid": v0 + (e1 + e2) / 3}[kind]
        off = torch.linalg.cross(pts[None] - o[:, None],
                                 d[:, None].expand(-1, len(pts), -1))
        assert float(off.norm(dim=2).amin(dim=1).max()) < tol
        return
    n = torch.linalg.cross(e1, e2)
    n = n / n.norm(dim=1, keepdim=True)
    p = o[:, None] - v0[None]
    in_plane = (p * n).sum(dim=2).abs() < tol
    if kind == "grazing":
        ok = in_plane & ((d[:, None] * n).sum(dim=2).abs() < 1e-5)
    else:
        g11, g12, g22 = ((e1 * e1).sum(1), (e1 * e2).sum(1),
                         (e2 * e2).sum(1))
        p1, p2 = (p * e1).sum(2), (p * e2).sum(2)
        det = g11 * g22 - g12 * g12
        a = (p1 * g22 - p2 * g12) / det
        b = (p2 * g11 - p1 * g12) / det
        ok = in_plane & (a >= -1e-5) & (b >= -1e-5) & (a + b <= 1 + 1e-5)
    assert bool(ok.any(dim=1).all())


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       span=st.sampled_from([0.5, 3.0, 40.0]),
       scene=st.sampled_from(sorted(SCENES)),
       eps_b=st.sampled_from([EPS_B, 0.0, -1e-4, 0.25, 3.0]))
def test_random_rays_never_skip_a_hit(seed, span, scene, eps_b):
    # also for other barycentric slacks, negative or large: the margin's
    # derivation assumes nothing of eps_b
    _, ps = SCENES[scene]()
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-span, span, (64, 3)).astype(np.float32))
    dn = rng.normal(size=(64, 3))
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    d = torch.from_numpy(dn.astype(np.float32))
    assert_no_hit_skipped(ps, o, d, eps_b)


def test_plucker_form_is_the_cross_of_dots():
    # the fused U', V', W' are OU*DW - OW*DU, OV*DW - OW*DV and
    # DW - U' - V' (in float64, of the same inputs) to f32 rounding
    _, ps = sphere_scene()
    o, d = edge_rays(ps, 200, seed=4)
    U, V, W = (x.double() for x in fused_values(o, d, ps.wu, ps.wv, ps.ww))
    o64, d64 = o.double(), d.double()
    a, b, c = (w.double() for w in (ps.wu, ps.wv, ps.ww))
    OU, OV, OW = (o64 @ r[:, :3].T + r[:, 3] for r in (a, b, c))
    DU, DV, DW = (d64 @ r[:, :3].T for r in (a, b, c))
    Ue, Ve = OU * DW - OW * DU, OV * DW - OW * DV
    scale = (OU.abs() + OW.abs() + OV.abs()) * (DU.abs() + DV.abs()
                                                + DW.abs()) + 1e-30
    for got, want in ((U, Ue), (V, Ve), (W, DW - Ue - Ve)):
        assert float(((got - want).abs() / scale).max()) < 1e-5


def test_margin_is_needed():
    # with no margin (and no eps_b slack), rays aimed at vertices and
    # edges lose exact hits to the fused test; with the margin they keep
    # them: the margin is what keeps the kernel bit-equal
    _, ps = sphere_scene()
    o, d = edge_rays(ps, 3000, seed=5)
    _, hit = exact_hits(o, d, ps.wu, ps.wv, ps.ww, eps_b=0.0)
    lost = hit & fused_skip(o, d, ps.wu, ps.wv, ps.ww, eps_b=0.0, delta=0.0)
    assert bool(lost.any())
    skipped = hit & fused_skip(o, d, ps.wu, ps.wv, ps.ww, eps_b=0.0)
    assert not bool(skipped.any())


def test_padding_and_degenerate_rows_run_the_exact_path(rng):
    # all-zero rows: A = 0 <= guard, never skipped, and never a hit
    _, ps = sphere_scene()
    assert ps.num_triangles_padded > int((ps.ww != 0).any(dim=1).sum())
    pad = ~(ps.ww != 0).any(dim=1)
    o, d = edge_rays(ps, 200, seed=2)
    hit, skip = assert_no_hit_skipped(ps, o, d)
    assert not bool(skip[:, pad].any())
    assert not bool(hit[:, pad].any())


def test_nan_and_inf_rays_run_the_exact_path():
    _, ps = sphere_scene()
    o = torch.tensor([[np.nan, 0, 0], [np.inf, 0, 0], [0, 0, 0.0]],
                     dtype=torch.float32)
    d = torch.tensor([[0, 0, 1.0], [0, 0, 1.0], [np.inf, 0, 0]],
                     dtype=torch.float32)
    skip = fused_skip(o, d, ps.wu, ps.wv, ps.ww)
    assert not bool(skip.any())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_mirrored_kernel_equals_plain_and_reference(scene):
    # the kernel's skip-then-exact nearest hit, bit for bit the plain
    # version's, and on the JAX reference's triangle indices
    rs, ps = SCENES[scene]()
    o, d = edge_rays(ps, 1000, seed=3)
    t_k, i_k = mirrored_kernel(o, d, ps.wu, ps.wv, ps.ww)
    t_p, i_p = PI.nearest_hit_torch(o, d, ps.wu, ps.wv, ps.ww, EPS, EPS_B,
                                    T_MAX)
    assert torch.equal(i_k, i_p.to(i_k.dtype)) and torch.equal(t_k, t_p)
    # the reference rounds in its own order, so a ray aimed at a shared
    # edge or vertex may go to either neighbour there: compare the
    # centroid rays, whose triangle is unambiguous
    cen = np.arange(1000) % 5 == EDGE_RAY_KINDS.index("centroid")
    _, i_ref = intersect_jnp(rs, jnp.asarray(o.numpy()[cen]),
                             jnp.asarray(d.numpy()[cen]), L.TraceConfig())
    assert np.array_equal(np.asarray(i_ref), i_p.numpy()[cen])


def test_twin_mesh_lowest_index_wins():
    _, ps = twin_scene()
    n_one = int((ps.ww != 0).any(dim=1).sum()) // 2
    rng = np.random.default_rng(0)
    o = torch.zeros((400, 3))
    dn = rng.normal(size=(400, 3))
    d = torch.from_numpy((dn / np.linalg.norm(dn, axis=1,
                                              keepdims=True)).astype(
        np.float32))
    t, i = mirrored_kernel(o, d, ps.wu, ps.wv, ps.ww)
    assert bool((i >= 0).all()) and bool((i < n_one).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cull", [False, True])
def test_kernel_on_edge_rays_bit_equal_on_card(cull):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    for make in SCENES.values():
        rs, _ = make()
        ps = PortScene.from_reference(rs, "cuda")
        o, d = edge_rays(ps, 4096, seed=7)
        mask = (PI.block_tile_mask(PI.cull_frame(ps), o, d, T_MAX)
                if cull else None)
        args = (ps.wu, ps.wv, ps.ww, EPS, EPS_B, T_MAX)
        t1, i1 = PI.nearest_hit_cuda(o, d, *args, mask=mask)
        t0, i0 = PI.nearest_hit_torch(o, d, *args, mask=mask)
        torch.cuda.synchronize()
        assert torch.equal(i0, i1) and torch.equal(t0, t1)
