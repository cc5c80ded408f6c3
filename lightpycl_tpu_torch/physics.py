"""Ray-optics primitives on torch tensors.

Port counterpart of lightpycl_tpu/physics.py, function for function with the
reference's names, argument order and operation order: the scalar Snell /
Fresnel set, the Stokes-Mueller split (`fresnel_amplitudes`,
`tir_phase_shift`, `rotate_stokes`, `polarized_split`), complex-index metals
(`metal_rs_rp`, `metal_reflectance`, `mueller_reflect`), the two samplers
(`sample_lambertian`, `sample_henyey_greenstein`), gradient-index
propagation (`grin_index`, `grin_rk4_step`, `grin_selfoc_step`,
`parallel_transport`), thin-film stacks (`multilayer_rs_rp` by the Airy
recursion, `multilayer_amplitudes` by the characteristic matrix,
`polarized_film_split`, the reflectance shorthands) and uniaxial crystals
(`uniaxial_*`, `incidence_s_direction`).

Everything is branchless: every lane computes every outcome and masks
select, so inert lanes hold divisions by clamped values; the clamps
(1e-20, 1e-30, 1e-6) are the reference's. Complex amplitudes are
torch.complex64. The samplers take their unit uniforms `u (C, 2)` as an
argument instead of a key, so a caller decides the stream.

Conventions (as in the reference):
  * direction vectors are unit length, shape (..., 3)
  * `normal` is the geometric unit normal oriented AGAINST the incoming ray
    (i.e. dot(d, n) <= 0); `orient_normal` produces it
  * n1 = IOR of the medium the ray travels in, n2 = IOR beyond the surface
"""

from __future__ import annotations

import math

import torch

# Guard value keeping sqrt/div finite on masked-out lanes; results on those
# lanes are discarded by the caller.
_TINY = 1e-20


def dot(a, b):
    """Batched 3-vector dot product over the last axis."""
    return torch.sum(a * b, dim=-1)


def normalize(v):
    """Unit vector along v (safe for ~zero vectors on masked lanes)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return (v * torch.where(n2 > _TINY, 1.0, 0.0)
            / torch.sqrt(torch.clamp_min(n2, _TINY)))


def orient_normal(d, n_geom):
    """Flip the geometric normal so it faces the incoming ray. Returns
    (n_oriented, entering); `entering` is True on front-face hits."""
    entering = dot(d, n_geom) < 0.0
    n = torch.where(entering[..., None], n_geom, -n_geom)
    return n, entering


def reflect(d, n):
    """Specular reflection of unit direction d about unit normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract_full(d, n, eta):
    """Snell refraction of unit direction d at a surface with normal n,
    eta = n1 / n2. Returns (t_dir, tir, cos_t); t_dir is garbage-but-finite
    where tir, cos_t is 0 there."""
    cos_i = -dot(d, n)  # >= 0 since n faces the ray
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    pos = 1.0 - sin2_t
    cos_t = torch.where(pos > 0.0,
                        torch.sqrt(torch.where(pos > 0.0, pos, 1.0)), 0.0)
    t = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(t), tir, torch.where(tir, 0.0, cos_t)


def refract(d, n, eta):
    """Snell refraction; returns (t_dir, tir). See refract_full."""
    t, tir, _ = refract_full(d, n, eta)
    return t, tir


def fresnel_unpolarized(cos_i, cos_t, n1, n2, tir):
    """Unpolarized Fresnel power reflectance R = (Rs + Rp) / 2; exactly 1.0
    where `tir`."""
    rs_num = n1 * cos_i - n2 * cos_t
    rs_den = n1 * cos_i + n2 * cos_t
    rp_num = n1 * cos_t - n2 * cos_i
    rp_den = n1 * cos_t + n2 * cos_i
    rs = (rs_num / torch.where(torch.abs(rs_den) > _TINY, rs_den, 1.0)) ** 2
    rp = (rp_num / torch.where(torch.abs(rp_den) > _TINY, rp_den, 1.0)) ** 2
    r = 0.5 * (rs + rp)
    return torch.where(tir, 1.0, torch.clamp(r, 0.0, 1.0))


def _f32(x, like):
    """x as a float32 tensor on `like`'s device (tensors pass through)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _c64(x):
    """Real tensor -> complex64 (zero imaginary part)."""
    return x.to(torch.complex64)


def _norm_keep(v):
    """Euclidean length over axis 1, kept: sqrt(sum(v * v))."""
    return torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))


def fresnel_amplitudes(cos_i, cos_t, n1, n2):
    """Signed Fresnel amplitude coefficients (rs, rp, ts, tp); cos_i/cos_t
    >= 0. rp in the Verdet convention (rp = (n2 ci - n1 ct) / ..), so rs and
    rp have opposite sign at normal incidence."""
    den_s = n1 * cos_i + n2 * cos_t
    den_p = n2 * cos_i + n1 * cos_t
    den_s = torch.where(torch.abs(den_s) > _TINY, den_s, 1.0)
    den_p = torch.where(torch.abs(den_p) > _TINY, den_p, 1.0)
    rs = (n1 * cos_i - n2 * cos_t) / den_s
    rp = (n2 * cos_i - n1 * cos_t) / den_p
    ts = 2.0 * n1 * cos_i / den_s
    tp = 2.0 * n1 * cos_i / den_p
    return rs, rp, ts, tp


def tir_phase_shift(cos_i, n_rel):
    """Relative s-p phase shift delta = delta_p - delta_s under total
    internal reflection; n_rel = n2 / n1 (< 1 in the TIR regime).
    tan(d_s / 2) = sqrt(sin^2 - n^2) / cos, tan(d_p / 2) = same / n^2."""
    sin2 = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    root = torch.sqrt(torch.clamp_min(sin2 - n_rel * n_rel, 0.0))
    d_s = 2.0 * torch.atan2(root, torch.clamp_min(cos_i, _TINY))
    d_p = 2.0 * torch.atan2(
        root, torch.clamp_min(n_rel * n_rel * cos_i, _TINY))
    return d_p - d_s


def rotate_stokes(s1, s2, cos_phi, sin_phi):
    """Rotate the polarization reference frame by phi about the ray
    direction: (S1, S2) rotate by 2 phi (S3 invariant)."""
    c2 = cos_phi * cos_phi - sin_phi * sin_phi
    s2r = 2.0 * cos_phi * sin_phi
    return s1 * c2 + s2 * s2r, -s1 * s2r + s2 * c2


def polarized_split(s0, s1, s2, s3, cos_i, cos_t, n1, n2, tir):
    """Mueller-calculus Fresnel split of a Stokes vector (unnormalized,
    s0 = power) expressed in the incidence (s, p) frame. Returns (refl
    Stokes 4-tuple, trans Stokes 4-tuple). Under TIR the reflection applies
    the s-p retardation and transmission carries zero power. Energy:
    s0_r + s0_t == s0 (per-component Rs + Ts = Rp + Tp = 1)."""
    rs, rp, ts, tp = fresnel_amplitudes(cos_i, cos_t, n1, n2)
    Rs, Rp = rs * rs, rp * rp
    cross_r = rs * rp                       # signed: encodes 0/pi phase
    f = (n2 * cos_t) / torch.clamp_min(n1 * cos_i, _TINY)
    Ts, Tp = f * ts * ts, f * tp * tp
    cross_t = f * ts * tp

    # non-TIR reflection
    r0 = 0.5 * (Rs + Rp) * s0 + 0.5 * (Rs - Rp) * s1
    r1 = 0.5 * (Rs - Rp) * s0 + 0.5 * (Rs + Rp) * s1
    r2 = cross_r * s2
    r3 = cross_r * s3
    # TIR reflection: unit reflectance + retardation delta between s and p
    delta = tir_phase_shift(cos_i, n2 / torch.clamp_min(n1, _TINY))
    cd, sd = torch.cos(delta), torch.sin(delta)
    r0 = torch.where(tir, s0, r0)
    r1 = torch.where(tir, s1, r1)
    r2 = torch.where(tir, cd * s2 + sd * s3, r2)
    r3 = torch.where(tir, -sd * s2 + cd * s3, r3)

    t0 = 0.5 * (Ts + Tp) * s0 + 0.5 * (Ts - Tp) * s1
    t1 = 0.5 * (Ts - Tp) * s0 + 0.5 * (Ts + Tp) * s1
    t2 = cross_t * s2
    t3 = cross_t * s3
    t0 = torch.where(tir, 0.0, t0)
    t1 = torch.where(tir, 0.0, t1)
    t2 = torch.where(tir, 0.0, t2)
    t3 = torch.where(tir, 0.0, t3)
    return (r0, r1, r2, r3), (t0, t1, t2, t3)


def _abs2(z):
    """|z|^2 as real^2 + imag^2 (the reference's formulation)."""
    return z.real ** 2 + z.imag ** 2


def _unit_where_tiny(z):
    """z, with 1 in place of entries whose modulus is <= _TINY (the guard
    in front of every complex division)."""
    return torch.where(torch.abs(z) > _TINY, z, torch.ones_like(z))


def _branch_safe_sqrt(z):
    """Complex sqrt with the reference's double-where guard around the
    branch point: lanes within 1e-12 of z = 0 give exactly 0 (cos_t = 0,
    R = 1 at the critical angle); the others the principal branch."""
    zsafe = _abs2(z) > 1e-12
    return torch.where(zsafe,
                       torch.sqrt(torch.where(zsafe, z, torch.ones_like(z))),
                       torch.zeros_like(z))


def metal_rs_rp(cos_i, n1, n_metal, k_metal):
    """Complex Fresnel reflection amplitudes (rs, rp) at a bare metal
    surface: incident dielectric n1 | absorbing medium n_metal - i k_metal.
    Complex Snell on the principal branch, flipped to the physical sheet
    (Re(n ct) >= 0); rs = (n1 ci - n ct) / (n1 ci + n ct), rp Verdet-signed
    like fresnel_amplitudes. k = 0 reduces to the bare dielectric
    amplitudes. |rs|^2, |rp|^2 are the polarized power reflectances; 1 - R
    is absorbed in the metal."""
    cos_i = _f32(cos_i, cos_i)
    ci = _c64(torch.clamp_min(cos_i, 1e-6))
    nc = torch.complex(_f32(n_metal, cos_i), -_f32(k_metal, cos_i))
    nc = _unit_where_tiny(nc)
    n1c = _c64(_f32(n1, cos_i))
    ratio = n1c / nc
    sin2 = (1.0 - ci * ci) * (ratio * ratio)
    ct = _branch_safe_sqrt(1.0 - sin2)
    # the principal-branch sqrt can land on the wrong sheet for absorbing
    # media; the physical branch has Re(n ct) >= 0 (decay into the metal)
    ct = torch.where((nc * ct).real < 0, -ct, ct)

    def _r(a, b):
        return (a - b) / _unit_where_tiny(a + b)

    rs = _r(n1c * ci, nc * ct)
    rp = _r(nc * ci, n1c * ct)
    return rs, rp


def metal_reflectance(cos_i, n1, n_metal, k_metal):
    """Unpolarized power reflectance of a bare metal surface,
    R = (|rs|^2 + |rp|^2) / 2 (see metal_rs_rp). Clipped to [0, 1]."""
    rs, rp = metal_rs_rp(cos_i, n1, n_metal, k_metal)
    r = 0.5 * (_abs2(rs) + _abs2(rp))
    return torch.clamp(r.to(torch.float32), 0.0, 1.0)


def mueller_reflect(s0, s1, s2, s3, rs, rp):
    """Reflection Mueller block for arbitrary complex amplitudes (rs, rp)
    in the incidence (s, p) frame; the cross term X = conj(rs) rp carries
    the retardation in the package's Stokes sign convention."""
    Rs = _abs2(rs)
    Rp = _abs2(rp)
    X = torch.conj(rs) * rp
    r0 = 0.5 * (Rs + Rp) * s0 + 0.5 * (Rs - Rp) * s1
    r1 = 0.5 * (Rs - Rp) * s0 + 0.5 * (Rs + Rp) * s1
    r2 = X.real * s2 - X.imag * s3
    r3 = X.imag * s2 + X.real * s3
    return r0, r1, r2, r3


def orthonormal_basis(n):
    """Branchless orthonormal tangents (t1, t2) for unit normals n (..., 3)
    (Duff et al., "Building an Orthonormal Basis, Revisited")."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t1, t2


def sample_lambertian(u, n):
    """Cosine-weighted hemisphere directions about unit normals n (C, 3)
    from unit uniforms u (C, 2): pdf(theta) = cos(theta) / pi. Concentric
    construction: radius sqrt(u1), height sqrt(1 - u1)."""
    r = torch.sqrt(u[:, 0])
    phi = (2.0 * math.pi) * u[:, 1]
    t1, t2 = orthonormal_basis(n)
    return ((r * torch.cos(phi))[:, None] * t1
            + (r * torch.sin(phi))[:, None] * t2
            + torch.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0))[:, None] * n)


def sample_henyey_greenstein(u, d, g):
    """Henyey-Greenstein phase-function directions about unit incident
    directions d (C, 3) with per-ray anisotropy g (C,) in (-1, 1), from
    unit uniforms u (C, 2): pdf(cos) = (1 - g^2) / (2 (1 + g^2 - 2 g
    cos)^{3/2}), mean cosine = g. |g| < 1e-4 takes the isotropic limit
    1 - 2u. Azimuth uniform about d."""
    small = torch.abs(g) < 1e-4
    g_safe = torch.where(small, 0.5, g)
    frac = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u[:, 0])
    cos_t = torch.where(
        small, 1.0 - 2.0 * u[:, 0],
        (1.0 + g_safe * g_safe - frac * frac) / (2.0 * g_safe))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = (2.0 * math.pi) * u[:, 1]
    t1, t2 = orthonormal_basis(d)
    return ((sin_t * torch.cos(phi))[:, None] * t1
            + (sin_t * torch.sin(phi))[:, None] * t2
            + cos_t[:, None] * d)


def grin_index(r, center, axis, n0, a):
    """Local index of the radial-parabolic (SELFOC) GRIN profile at points
    r (C, 3): n(rho)^2 = n0^2 (1 - a rho^2), rho = distance from the
    profile axis (unit `axis` through `center`), all per-ray. Clamped at
    n >= 0.05 n0."""
    rel = r - center
    rho = rel - torch.sum(rel * axis, dim=1, keepdim=True) * axis
    rho2 = torch.sum(rho * rho, dim=1)
    n2 = n0 * n0 * (1.0 - a * rho2)
    return torch.sqrt(torch.maximum(n2, 2.5e-3 * n0 * n0))


def _grin_grad(r, center, axis, n0, a):
    """grad n of the parabolic profile: -n0^2 a rho_vec / n, (C, 3)."""
    rel = r - center
    rho = rel - torch.sum(rel * axis, dim=1, keepdim=True) * axis
    n = grin_index(r, center, axis, n0, a)
    return -(n0 * n0 * a / n)[:, None] * rho


def _step_length(h, r0):
    """Step length as a (C,) float32 tensor."""
    return _f32(h, r0).expand(r0.shape[0])


def grin_rk4_step(r0, d0, h, center, axis, n0, a):
    """One classic RK4 step of the ray equation through a GRIN medium,
    arc-length parameterized via the optical momentum v = n t_hat:
    dr/ds = v / |v|, dv/ds = grad n(r). Returns (r1, d1 unit, n1 local
    index, opl_inc Simpson-weighted integral of n ds over the step)."""
    h = _step_length(h, r0)
    hc = h[:, None]

    def f(r, v):
        vn = v / torch.clamp_min(_norm_keep(v), 1e-20)
        return vn, _grin_grad(r, center, axis, n0, a)

    n_start = grin_index(r0, center, axis, n0, a)
    v0 = n_start[:, None] * d0
    k1r, k1v = f(r0, v0)
    k2r, k2v = f(r0 + 0.5 * hc * k1r, v0 + 0.5 * hc * k1v)
    k3r, k3v = f(r0 + 0.5 * hc * k2r, v0 + 0.5 * hc * k2v)
    k4r, k4v = f(r0 + hc * k3r, v0 + hc * k3v)
    r1 = r0 + (hc / 6.0) * (k1r + 2.0 * k2r + 2.0 * k3r + k4r)
    v1 = v0 + (hc / 6.0) * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    d1 = v1 / torch.clamp_min(_norm_keep(v1), 1e-20)
    n_end = grin_index(r1, center, axis, n0, a)
    n_mid = grin_index(r0 + 0.5 * hc * k2r, center, axis, n0, a)
    opl_inc = h * (n_start + 4.0 * n_mid + n_end) / 6.0
    return r1, d1, n_end, opl_inc


def grin_selfoc_step(r0, d0, h, center, axis, n0, a):
    """Exact closed-form propagator through the radial-parabolic SELFOC
    profile. In d sigma = ds / n the transverse motion is a harmonic
    oscillator with k = n0^2 a (trigonometric for a > 0, hyperbolic for
    a < 0) and the axial coordinate advances linearly; the step advances
    sigma = h / n(r0). The optical path is closed-form too
    (OPL = int |v|^2 d sigma). Same signature and returns as
    grin_rk4_step; lanes with a == 0 reduce to the straight ray
    r0 + h d0, OPL = n h."""
    h = _step_length(h, r0)
    n_start = grin_index(r0, center, axis, n0, a)
    sig = h / n_start

    rel = r0 - center
    z0 = torch.sum(rel * axis, dim=1)
    u0 = rel - z0[:, None] * axis
    v0 = n_start[:, None] * d0
    vz = torch.sum(v0 * axis, dim=1)
    vu0 = v0 - vz[:, None] * axis

    k = n0 * n0 * a
    w = torch.sqrt(torch.abs(k))
    small = w * sig < 1e-6  # k -> 0 limit: C -> 1, S -> sigma
    ws = torch.where(small, 1.0, w)
    t = w * sig
    trig = k > 0
    # C, S solve x'' = -k x with (C, C')(0) = (1, 0), (S, S')(0) = (0, 1)
    C = torch.where(small, 1.0,
                    torch.where(trig, torch.cos(t), torch.cosh(t)))
    S = torch.where(small, sig,
                    torch.where(trig, torch.sin(t), torch.sinh(t)) / ws)
    u1 = u0 * C[:, None] + vu0 * S[:, None]
    vu1 = vu0 * C[:, None] - (k * S)[:, None] * u0
    r1 = center + (z0 + vz * sig)[:, None] * axis + u1
    v1 = vz[:, None] * axis + vu1
    d1 = v1 / torch.clamp_min(_norm_keep(v1), 1e-20)
    n_end = grin_index(r1, center, axis, n0, a)

    # OPL = vz^2 sigma + |vu0|^2 Icc + k^2 |u0|^2 Iss - 2 k (u0.vu0) Ics
    # with Icc = sig/2 + s2w, k^2 Iss = k (sig/2 - s2w), and the cross
    # term collapsing to -(u0.vu0) sin^2(t) [trig] / +(u0.vu0) sinh^2(t)
    # [hyperbolic]; s2w = sin(2t)/(4w) resp. sinh(2t)/(4w)
    A2 = torch.sum(vu0 * vu0, dim=1)
    B2 = torch.sum(u0 * u0, dim=1)
    p = torch.sum(u0 * vu0, dim=1)
    s2w = torch.where(small, 0.5 * sig,
                      torch.where(trig, torch.sin(2.0 * t),
                                  torch.sinh(2.0 * t)) / (4.0 * ws))
    cross = torch.where(trig, torch.sin(t) ** 2, -torch.sinh(t) ** 2)
    opl_inc = (vz * vz * sig + A2 * (0.5 * sig + s2w)
               + B2 * k * (0.5 * sig - s2w) - p * cross)
    return r1, d1, n_end, opl_inc


def parallel_transport(v, d0, d1):
    """Levi-Civita (minimal-rotation) transport of a frame vector along a
    direction change d0 -> d1 (all (C, 3), directions unit), in the
    trig-free double-reflection form
    v' = v - (v.(d0+d1) / (1 + d0.d1)) (d0+d1) + 2 (v.d0) d1,
    guarded against the antiparallel singularity."""
    s = d0 + d1
    den = torch.clamp_min(1.0 + dot(d0, d1), 1e-6)
    return (v - (dot(v, s) / den)[:, None] * s
            + 2.0 * dot(v, d0)[:, None] * d1)


def _fresnel_interface_c(eta_a, eta_b):
    """Complex interface amplitude (eta_a - eta_b) / (eta_a + eta_b)."""
    return (eta_a - eta_b) / _unit_where_tiny(eta_a + eta_b)


def _stack_cos(n1s2):
    """cos_in(n) of a stack with the invariant n1^2 sin^2 = n1s2: the
    complex cosine of the wave angle inside a layer of index n."""
    def cos_in(n):
        n = torch.clamp_min(n, _TINY)
        return _branch_safe_sqrt(1.0 - _c64(n1s2 / (n * n)))
    return cos_in


def multilayer_rs_rp(cos_i, n1, layers_n, layers_h, n_sub, wl):
    """Complex reflection amplitudes (rs, rp) of a lossless dielectric
    stack: incident medium n1 | layers (n_k, h_k) k = 0..L-1 (layer 0
    adjacent to the incident medium) | substrate n_sub, by the bottom-up
    Airy recursion r_k = (rho_k + r_{k+1} e^{2i delta_k}) / (1 + rho_k
    r_{k+1} e^{2i delta_k}) in complex64. A zero-thickness layer drops out
    exactly, so stacks padded with (n, h = 0) entries are unchanged.
    layers_n / layers_h: sequences of per-ray tensors (or scalars), length
    L >= 1. `multilayer_amplitudes` is the same stack by the
    characteristic-matrix method; the grazing clamp is the same in both."""
    cos_i = torch.clamp_min(_f32(cos_i, cos_i), 1e-6)   # grazing guard
    n1, n_sub, wl = (_f32(x, cos_i) for x in (n1, n_sub, wl))
    sin2 = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    cos_in = _stack_cos((n1 * n1) * sin2)

    def etas(n, c):
        return n * c, n / _unit_where_tiny(c)

    e1s, e1p = etas(n1, _c64(cos_i))
    ess, esp = etas(n_sub, cos_in(n_sub))

    layers_n = [_f32(x, cos_i) for x in layers_n]
    layers_h = [_f32(x, cos_i) for x in layers_h]
    if not layers_n or len(layers_n) != len(layers_h):
        raise ValueError("need >= 1 layer and len(layers_n) == len(layers_h)")

    # walk from the substrate interface upward; after processing layer k,
    # `phase` holds its round-trip factor, consumed by the interface above
    prev_s, prev_p = ess, esp
    r_s = r_p = phase = None
    for nk, hk in zip(reversed(layers_n), reversed(layers_h)):
        ck = cos_in(nk)
        eks, ekp = etas(nk, ck)
        rho_s = _fresnel_interface_c(eks, prev_s)
        rho_p = _fresnel_interface_c(ekp, prev_p)
        if r_s is None:
            r_s, r_p = rho_s, rho_p
        else:
            r_s = _moebius(rho_s, r_s, phase)
            r_p = _moebius(rho_p, r_p, phase)
        phase = torch.exp(
            2.0j * _c64(2.0 * math.pi * nk * hk
                        / torch.clamp_min(wl, _TINY)) * ck)
        prev_s, prev_p = eks, ekp
    r_s = _moebius(_fresnel_interface_c(e1s, prev_s), r_s, phase)
    r_p = _moebius(_fresnel_interface_c(e1p, prev_p), r_p, phase)
    return r_s, r_p


def _moebius(rho, r_below, phase):
    """One Airy recursion step: combine the interface coefficient rho with
    the composite reflection r_below seen across a layer of round-trip
    phase factor `phase`."""
    num = rho + r_below * phase
    den = 1.0 + rho * r_below * phase
    return num / _unit_where_tiny(den)


def thin_film_rs_rp(cos_i, n1, nf, n2, h, wl):
    """Single-film shorthand for multilayer_rs_rp. h = 0 reduces to the
    bare n1 -> n2 Fresnel amplitudes."""
    return multilayer_rs_rp(cos_i, n1, [nf], [h], n2, wl)


def multilayer_amplitudes(cos_i, n1, layers_n, layers_h, n_sub, wl):
    """Polarized complex response of a lossless dielectric stack by the
    characteristic-matrix method (Abeles / Macleod), complex64. Returns
    (rs, rp, Ts, Tp, Xt): complex reflection amplitudes in the Verdet
    convention (the admittance-form rp is negated); real power
    transmittances T = 4 eta_1 Re(eta_sub) / |eta_1 B + C|^2 (0 under
    substrate TIR); and the complex transmission cross term sqrt(Ts Tp)
    e^{i (arg tp - arg ts)} for the Mueller s2/s3 block. h = 0 layers are
    inert (M = I)."""
    ci = torch.clamp_min(_f32(cos_i, cos_i), 1e-6)  # grazing guard
    n1, n_sub, wl = (_f32(x, ci) for x in (n1, n_sub, wl))
    sin2 = torch.clamp_min(1.0 - ci * ci, 0.0)
    cos_in = _stack_cos((n1 * n1) * sin2)

    def tilt(n, c, pol):
        n = _c64(n)
        if pol == "s":
            return n * c
        return n / _unit_where_tiny(c)

    cs = cos_in(n_sub)
    layers = [(_f32(n, ci), _f32(h, ci))
              for n, h in zip(layers_n, layers_h)]

    def one_pol(pol):
        e1 = tilt(n1, _c64(ci), pol)
        em = tilt(n_sub, cs, pol)
        B = torch.ones_like(em)
        C = em
        for nk, hk in reversed(layers):
            ck = cos_in(nk)
            ek = tilt(nk, ck, pol)
            d = _c64(2.0 * math.pi * nk * hk
                     / torch.clamp_min(wl, _TINY)) * ck
            cd, sd = torch.cos(d), torch.sin(d)
            ek_safe = _unit_where_tiny(ek)
            B, C = cd * B + 1j * sd / ek_safe * C, 1j * ek * sd * B + cd * C
        den = _unit_where_tiny(e1 * B + C)
        r = (e1 * B - C) / den
        T = (4.0 * e1.real * em.real
             / torch.clamp_min(torch.abs(den) ** 2, 1e-30))
        return r, torch.clamp(T, 0.0, 1.0), den

    rs, Ts, den_s = one_pol("s")
    rp_adm, Tp, den_p = one_pol("p")
    rp = -rp_adm           # admittance -> Verdet sign convention
    # ts ~ 1/den_s, tp ~ 1/den_p: arg(tp) - arg(ts) = arg(den_s) - arg(den_p)
    dphi = torch.angle(den_s) - torch.angle(den_p)
    Xt = torch.sqrt(torch.clamp_min(Ts * Tp, 0.0)) * torch.exp(
        1j * _c64(dphi))
    return rs, rp, Ts, Tp, Xt


def polarized_film_split(s0, s1, s2, s3, cos_i, n1, layers_n, layers_h,
                         n_sub, wl):
    """Mueller split of a Stokes vector at a coated dielectric interface
    (incidence-frame (s, p) basis, same contract as polarized_split). The
    complex cross terms X_r = conj(rs) rp and X_t carry the bare
    interface's real cross products and the retardation (film or TIR).
    Energy: r0 + t0 == s0 to ~1e-6 (lossless stack)."""
    rs, rp, Ts, Tp, Xt = multilayer_amplitudes(
        cos_i, n1, layers_n, layers_h, n_sub, wl)
    Rs = _abs2(rs)
    Rp = _abs2(rp)
    Xr = torch.conj(rs) * rp
    r0 = 0.5 * (Rs + Rp) * s0 + 0.5 * (Rs - Rp) * s1
    r1 = 0.5 * (Rs - Rp) * s0 + 0.5 * (Rs + Rp) * s1
    r2 = Xr.real * s2 - Xr.imag * s3
    r3 = Xr.imag * s2 + Xr.real * s3
    t0 = 0.5 * (Ts + Tp) * s0 + 0.5 * (Ts - Tp) * s1
    t1 = 0.5 * (Ts - Tp) * s0 + 0.5 * (Ts + Tp) * s1
    t2 = Xt.real * s2 - Xt.imag * s3
    t3 = Xt.imag * s2 + Xt.real * s3
    return (r0, r1, r2, r3), (t0, t1, t2, t3)


def thin_film_reflectance(cos_i, n1, nf, n2, h, wl):
    """Unpolarized power reflectance R = (|rs|^2 + |rp|^2) / 2 of a single
    lossless film (see multilayer_rs_rp). Clipped to [0, 1]."""
    return multilayer_reflectance(cos_i, n1, [nf], [h], n2, wl)


def multilayer_reflectance(cos_i, n1, layers_n, layers_h, n_sub, wl):
    """Unpolarized power reflectance of a lossless dielectric stack (see
    multilayer_rs_rp). Clipped to [0, 1]."""
    rs, rp = multilayer_rs_rp(cos_i, n1, layers_n, layers_h, n_sub, wl)
    r = 0.5 * (torch.abs(rs) ** 2 + torch.abs(rp) ** 2)
    return torch.clamp(r.to(torch.float32), 0.0, 1.0)


# --------------------------------------------------------------------------
# Uniaxial birefringence
# --------------------------------------------------------------------------

def uniaxial_index(cos_k, n_o, n_e):
    """Extraordinary-wave phase index n(theta_k) of a uniaxial crystal:
    1/n^2 = cos^2(theta)/n_o^2 + sin^2(theta)/n_e^2, cos_k the cosine of
    the angle between the wave normal and the optic axis."""
    c2 = torch.clamp(cos_k * cos_k, 0.0, 1.0)
    inv2 = (c2 / torch.clamp_min(n_o * n_o, _TINY)
            + (1.0 - c2) / torch.clamp_min(n_e * n_e, _TINY))
    return 1.0 / torch.sqrt(torch.clamp_min(inv2, _TINY))


def uniaxial_refract_wave(kt, into, c_axis, n_o, n_e):
    """Refract a tangential wavevector kt (vacuum-k0 units) into the
    extraordinary branch of a uniaxial crystal; `into` is the unit normal
    pointing into the crystal, c_axis the unit optic axis. Returns
    (K, prop): K = kt + q into solving the e-wave dispersion relation
    (K.c)^2/n_o^2 + (|K|^2 - (K.c)^2)/n_e^2 = 1 on its forward root, and
    prop False where no forward propagating solution exists. n_e = n_o
    reduces to isotropic Snell refraction."""
    f = (1.0 / torch.clamp_min(n_o * n_o, _TINY)
         - 1.0 / torch.clamp_min(n_e * n_e, _TINY))
    ie = 1.0 / torch.clamp_min(n_e * n_e, _TINY)
    a_c = dot(into, c_axis)
    b_c = dot(kt, c_axis)
    kt2 = dot(kt, kt)
    A = a_c * a_c * f + ie          # > 0 always (a weighted index average)
    B = 2.0 * a_c * b_c * f
    Cq = b_c * b_c * f + kt2 * ie - 1.0
    disc = B * B - 4.0 * A * Cq
    ok = disc > 0.0
    root = torch.where(ok, torch.sqrt(torch.where(ok, disc, 1.0)), 0.0)
    q = (-B + root) / (2.0 * A)     # forward (into-crystal) branch
    K = kt + q[..., None] * into
    return K, ok & (q > 0.0)


def uniaxial_ray_direction(K, c_axis, n_o, n_e):
    """Poynting (ray) direction and OPL-effective ray index of an
    extraordinary wave with wave vector K: S ~ (K - (K.c)c)/n_e^2 +
    ((K.c)/n_o^2) c. Returns (S_unit, n_ray = K . S_unit)."""
    Kc = dot(K, c_axis)
    S = ((K - Kc[..., None] * c_axis)
         / torch.clamp_min(n_e * n_e, _TINY)[..., None]
         + (Kc / torch.clamp_min(n_o * n_o, _TINY))[..., None] * c_axis)
    S = normalize(S)
    return S, dot(K, S)


def uniaxial_wave_from_ray(S, c_axis, n_o, n_e):
    """Recover the e-wave normal and phase index from a ray direction
    (inverse of uniaxial_ray_direction), parameterized so theta_S = 90 deg
    is regular. Returns (k_hat, n_wave)."""
    cs = dot(S, c_axis)
    csn = torch.where(cs[..., None] < 0.0, -c_axis, c_axis)  # headless axis
    cs = torch.abs(cs)
    p = S - cs[..., None] * csn
    sin_s = torch.sqrt(torch.clamp_min(dot(p, p), 0.0))
    p_hat = normalize(p)
    u = ((n_o * n_o * cs)[..., None] * csn
         + (n_e * n_e * sin_s)[..., None] * p_hat)
    k_hat = normalize(u)
    # degenerate S || c: p == 0 -> u = n_o^2 cs * c, k_hat = c (exact)
    n_wave = uniaxial_index(dot(k_hat, csn), n_o, n_e)
    return k_hat, n_wave


def incidence_s_direction(d, n, fallback_basis):
    """Unit s-direction (perpendicular to the incidence plane): d x n
    normalized; at ~normal incidence fall back to the ray's current basis
    re-orthogonalized against d."""
    c = torch.linalg.cross(d, n, dim=-1)
    c2 = torch.sum(c * c, dim=-1, keepdim=True)
    fb = fallback_basis - dot(fallback_basis, d)[..., None] * d
    fb = normalize(fb)
    use_c = c2 > 1e-12
    return torch.where(use_c, c / torch.sqrt(torch.clamp_min(c2, _TINY)), fb)


def snell_interaction(d, n_geom, ray_ior, tri_ior, env_ior: float):
    """Full dielectric interaction at a surface (reference semantics:
    entering a dielectric sets the refracted child's IOR to the element's,
    exiting returns it to env_ior). Returns the reference's dict."""
    n, entering = orient_normal(d, n_geom)
    n1 = ray_ior
    n2 = torch.where(entering, tri_ior, env_ior)
    eta = n1 / torch.clamp_min(n2, _TINY)

    cos_i = -dot(d, n)
    refr_dir, tir, cos_t = refract_full(d, n, eta)
    R = fresnel_unpolarized(cos_i, cos_t, n1, n2, tir)
    refl_dir = reflect(d, n)
    new_ior = torch.where(tir, n1, n2)
    return {
        "refl_dir": refl_dir,
        "refr_dir": refr_dir,
        "R": R,
        "new_ior": new_ior,
        "entering": entering,
        "tir": tir,
        "n": n,
        "n1": n1,
        "n2": n2,
        "cos_i": cos_i,
        "cos_t": cos_t,
    }
