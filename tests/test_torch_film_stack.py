"""The film-stack kernel's module (lightpycl_tpu_torch/ops/film_stack.py)
on the CPU, where its dispatcher runs the plain version.

* The plain version against the JAX package's multilayer_reflectance on
  numpy-seeded stacks of 1-8 layers (edge_rays.film_edge_inputs: grazing,
  normal, critical, evanescent, padded, flipped), against a wavelength row
  (W = 32) and one wavelength a ray.
* A numpy float32 mirror of csrc/film_stack.cu's own schedule (the ray
  terms hoisted, then the recursion per entry; torch's CUDA formulas:
  fused products, numpy's scaled division, libc++'s polar sqrt) against
  the plain version, so an algebra slip in the kernel shows here before
  the card. The mirror follows the kernel's sequences where they differ
  from torch's (the division without its branch, sums with a promoted
  (+-1, 0) in two operations, the modulus test settled without hypot),
  and is held bit for bit to the same schedule on torch's own sequences
  (`torch_formulas`), on the edge stacks and on signed zeros, infinities
  and NaNs, and at the modulus test's band.
* The selects folded into the call (1 under TIR, the bare Fresnel R on
  uncoated rays) against the composition the trace used before; with
  every ray coated and none under TIR (`every_ray`) the call is the
  stack's R itself.
* Dispatch, the refusal of grad tensors, and both trace call sites.
* On a card (marker `cuda`): the kernel bit for bit against the plain
  version.

Tolerance: the film-stack tolerance of test_torch_physics.py (abs 2e-5),
raised entry by entry where the stack is ill-conditioned (near the
critical angle, in tunnelling stacks): there every float32 evaluation
strays from the float64 value, so each package and the mirror are held to
the float64 recursion, and to each other, within 4 times the largest
spread that a relative float32 rounding error at every step gives the
float64 recursion in 8 seeded draws (`tolerance`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_rays import FILM_EDGE_KINDS, film_edge_inputs
from lightpycl_tpu import physics as R
from lightpycl_tpu_torch import physics as T
from lightpycl_tpu_torch.ops import film_stack as FS

torch.set_num_threads(1)
C = 1024
W = 32
CPLX_ATOL = 2e-5        # test_torch_physics.CPLX
EPS32 = 2.0 ** -24


def stack(L, mode):
    """(cos_i, n1, n_sub, layers_n, layers_h, wl) float32 numpy arrays; wl
    a (1, W) row or (C,), one a ray."""
    arrays = film_edge_inputs(C, L, seed=L)
    rng = np.random.default_rng(100 + L)
    wl = (np.linspace(0.40, 0.75, W, dtype=np.float32)[None, :]
          if mode == "row" else
          rng.uniform(0.4, 0.75, C).astype(np.float32))
    return arrays + (wl,)


def reference(ci, n1, ns, ln, lh, wl):
    """The JAX package's multilayer_reflectance on the same columns."""
    col = (lambda a: jnp.asarray(a)[:, None]) if wl.ndim == 2 else jnp.asarray
    L = ln.shape[1]
    return np.asarray(R.multilayer_reflectance(
        col(ci), col(n1), [col(ln[:, k]) for k in range(L)],
        [col(lh[:, k]) for k in range(L)], col(ns), jnp.asarray(wl)))


def recursion_f64(ci, n1, ns, ln, lh, wl, rng=None):
    """The Airy recursion with its guards in float64; with `rng`, every
    intermediate is multiplied by (1 + eps u), u uniform in [-1, 1] (both
    parts of a complex one): float32 rounding as noise."""
    def q(z):
        if rng is None:
            return z
        u = rng.uniform(-1.0, 1.0, np.shape(z))
        if np.iscomplexobj(z):
            u = u + 1j * rng.uniform(-1.0, 1.0, np.shape(z))
        return z * (1.0 + EPS32 * u)

    col = (lambda a: a.astype(np.float64)[:, None]) if wl.ndim == 2 else (
        lambda a: a.astype(np.float64))
    ci = np.maximum(col(ci), 1e-6)
    n1, ns, wl = col(n1), col(ns), wl.astype(np.float64)
    n1s2 = q(n1 * n1 * np.maximum(1.0 - ci * ci, 0.0))

    def cos_in(n):
        z = q(1.0 - q(n1s2 / (n * n)) + 0j)
        return np.where(np.abs(z) ** 2 > 1e-12, q(np.sqrt(z)), 0.0)

    def unit(z):
        return np.where(np.abs(z) > 1e-20, z, 1.0)

    def iface(a, b):
        return q(q(a - b) / unit(q(a + b)))

    def moebius(a, r, ph):
        t = q(r * ph)
        return q(q(a + t) / unit(q(1.0 + q(a * t))))

    cs = cos_in(ns)
    ps, pp = q(ns * cs), q(ns / unit(cs))
    rs = rp = ph = None
    for k in range(ln.shape[1] - 1, -1, -1):
        nk, hk = col(ln[:, k]), col(lh[:, k])
        ck = cos_in(nk)
        es, ep = q(nk * ck), q(nk / unit(ck))
        a, b = iface(es, ps), iface(ep, pp)
        if rs is None:
            rs, rp = a, b
        else:
            rs, rp = moebius(a, rs, ph), moebius(b, rp, ph)
        ph = q(np.exp(q(2j * q(q(2.0 * np.pi * nk * hk) / wl) * ck)))
        ps, pp = es, ep
    a, b = iface(q(n1 * ci), ps), iface(q(n1 / ci), pp)
    rs, rp = moebius(a, rs, ph), moebius(b, rp, ph)
    return np.clip(0.5 * (np.abs(rs) ** 2 + np.abs(rp) ** 2), 0.0, 1.0)


def tolerance(args):
    """(float64 value, per-entry tolerance) of one call: CPLX_ATOL, or 4
    times the spread of 8 noisy float64 recursions, whichever is larger."""
    exact = recursion_f64(*args)
    rng = np.random.default_rng(0)
    spread = np.max([np.abs(recursion_f64(*args, rng=rng) - exact)
                     for _ in range(8)], axis=0)
    return exact, np.maximum(CPLX_ATOL, 4.0 * spread)


# ---------------------------------------------------------------- mirror
# csrc/film_stack.cu's operations in numpy float32, vectorized; a complex
# value is a (re, im) pair of float32 arrays

F32 = np.float32


def fma(a, b, c):
    """float32 a * b + c rounded once (the float32 product is exact in
    float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def cmul(x, y):
    (a, b), (c, d) = x, y
    return fma(a, c, -(b * d)), fma(a, d, b * c)


def real_c(x):
    return x, np.zeros_like(x)


# torch's own sequences (the kernel's first design ran these)

def cadd_torch(x, y, alpha):
    """AddFunctor's x + y * (alpha, 0): a complex product, then a sum."""
    t = cmul(y, (np.full_like(y[0], alpha), np.zeros_like(y[0])))
    return x[0] + t[0], x[1] + t[1]


def cdiv_torch(x, y):
    """numpy's scaled division as c10::complex runs it: a branch on
    |c| >= |d| (both sides computed here, one kept)."""
    (a, b), (c, d) = x, y
    with np.errstate(divide="ignore", invalid="ignore"):
        first = np.abs(c) >= np.abs(d)
        rat1 = d / c
        scl1 = F32(1.0) / fma(d, rat1, c)
        rat2 = c / d
        scl2 = F32(1.0) / fma(c, rat2, d)
        re = np.where(first, fma(b, rat1, a) * scl1, fma(a, rat2, b) * scl2)
        im = np.where(first, fma(-a, rat1, b) * scl1,
                      fma(b, rat2, -a) * scl2)
        zero = (c == 0) & (d == 0)
        re = np.where(zero, a / np.abs(c), re)
        im = np.where(zero, b / np.abs(d), im)
    return re.astype(F32), im.astype(F32)


def exceeds_tiny_torch(x, y):
    """torch.abs(z) > 1e-20 (abs is hypot)."""
    with np.errstate(all="ignore"):
        return np.hypot(x, y) > F32(1e-20)


# the kernel's sequences (csrc/film_stack.cu)

def cadd(x, y, alpha):
    """cadd1 / csub1: (fma(y.y, -0, x.x +- y.x), fma(y.x, 0, x.y +- y.y))."""
    sgn = F32(alpha)
    with np.errstate(invalid="ignore"):
        return (fma(y[1], F32(-0.0), x[0] + sgn * y[0]),
                fma(y[0], F32(0.0), x[1] + sgn * y[1]))


def cdiv(x, y):
    """The division without its branch: where |d| > |c|, the |c| >= |d|
    side on the rotated operands (b, -a) / (d, -c)."""
    first = np.abs(y[0]) >= np.abs(y[1])
    a, b = np.where(first, x[0], x[1]), np.where(first, x[1], -x[0])
    c, d = np.where(first, y[0], y[1]), np.where(first, y[1], -y[0])
    with np.errstate(divide="ignore", invalid="ignore"):
        rat = d / c
        scl = F32(1.0) / fma(d, rat, c)
        return ((fma(b, rat, a) * scl).astype(F32),
                (fma(-a, rat, b) * scl).astype(F32))


def exceeds_tiny(x, y):
    """The kernel's modulus test: |x| + |y| of at least 2.9e-20 is true,
    below 9.9e-21 false, hypot decides the band between (and a NaN)."""
    with np.errstate(all="ignore"):
        s = np.abs(x) + np.abs(y)
        return np.where(s >= F32(2.9e-20), True,
                        np.where(s < F32(9.9e-21), False,
                                 exceeds_tiny_torch(x, y)))


def csqrt_cxx(z):
    """libc++'s sqrt: polar(sqrt(|z|), arg(z) / 2)."""
    rho = np.sqrt(np.hypot(z[0], z[1]))
    theta = np.arctan2(z[1], z[0]) / F32(2.0)
    return rho * np.cos(theta), rho * np.sin(theta)


def cexp_cxx(z):
    e = np.exp(z[0])
    real_arg = z[1] == 0.0
    return (np.where(real_arg, e, e * np.cos(z[1])).astype(F32),
            np.where(real_arg, np.copysign(F32(0.0), z[1]),
                     e * np.sin(z[1])).astype(F32))


def x2i_torch(x):
    """(x, +0) * (0, 2) as torch's product."""
    return cmul(real_c(x), (np.zeros_like(x), np.full_like(x, 2.0)))


def x2i(x):
    """The same in two operations: (fma(x, 0, -0), fma(x, 2, +0)) and
    x 0 + -0 is x 0 for every x."""
    with np.errstate(invalid="ignore"):
        return x * F32(0.0), fma(x, F32(2.0), F32(0.0))


def one_plus_torch(t):
    """1.0 + t: t + (1, 0) * (1, 0) as AddFunctor runs it."""
    return cadd_torch(t, real_c(np.ones_like(t[0])), 1.0)


def one_plus(t):
    """(1, 0) * (1, 0) = (1, +0) folded: (t.x + 1, t.y + 0)."""
    return t[0] + F32(1.0), t[1] + F32(0.0)


# the mirror's primitives: the kernel's sequences, and torch's own
KERNEL = dict(cadd=cadd, cdiv=cdiv, exceeds_tiny=exceeds_tiny, x2i=x2i,
              one_plus=one_plus)
TORCH = dict(cadd=cadd_torch, cdiv=cdiv_torch,
             exceeds_tiny=exceeds_tiny_torch, x2i=x2i_torch,
             one_plus=one_plus_torch)


class Mirror:
    """csrc/film_stack.cu's schedule in numpy float32 on the primitives
    `ops` (KERNEL or TORCH)."""

    def __init__(self, ops):
        self.cadd, self.cdiv = ops["cadd"], ops["cdiv"]
        self.exceeds_tiny, self.x2i = ops["exceeds_tiny"], ops["x2i"]
        self.one_plus = ops["one_plus"]

    def unit_where_tiny(self, z):
        keep = self.exceeds_tiny(z[0], z[1])
        return (np.where(keep, z[0], F32(1.0)).astype(F32),
                np.where(keep, z[1], F32(0.0)).astype(F32))

    def stack_cos(self, n1s2, n):
        nn = np.maximum(n, F32(1e-20))
        z = self.cadd(real_c(np.ones_like(n1s2)), real_c(n1s2 / (nn * nn)),
                      -1.0)
        safe = (z[0] * z[0] + z[1] * z[1]) > F32(1e-12)
        s = csqrt_cxx(z)
        return (np.where(safe, s[0], F32(0.0)).astype(F32),
                np.where(safe, s[1], F32(0.0)).astype(F32))

    def fresnel_iface(self, ea, eb):
        return self.cdiv(self.cadd(ea, eb, -1.0),
                         self.unit_where_tiny(self.cadd(ea, eb, 1.0)))

    def moebius(self, rho, r, phase):
        num = self.cadd(rho, cmul(r, phase), 1.0)
        den = self.one_plus(cmul(cmul(rho, r), phase))
        return self.cdiv(num, self.unit_where_tiny(den))

    def phase_factor(self, x0, wl, ck):
        x = x0 / np.maximum(wl, F32(1e-20))
        return cexp_cxx(cmul(self.x2i(x), ck))

    def __call__(self, ci, n1, ns, ln, lh, wl):
        """Phase 1 on (C,) ray arrays, phase 2 on the (C, W) entries."""
        L = ln.shape[1]
        ci = np.maximum(ci, F32(1e-6))
        n1s2 = (n1 * n1) * np.maximum(F32(1.0) - ci * ci, F32(0.0))
        cs = self.stack_cos(n1s2, ns)
        prev_s = cmul(real_c(ns), cs)
        prev_p = self.cdiv(real_c(ns), self.unit_where_tiny(cs))
        terms = [None] * L
        for k in range(L - 1, -1, -1):
            ck = self.stack_cos(n1s2, ln[:, k])
            eks = cmul(real_c(ln[:, k]), ck)
            ekp = self.cdiv(real_c(ln[:, k]), self.unit_where_tiny(ck))
            terms[k] = (ck, self.fresnel_iface(eks, prev_s),
                        self.fresnel_iface(ekp, prev_p),
                        (F32(2.0 * np.pi) * ln[:, k]) * lh[:, k])
            prev_s, prev_p = eks, ekp
        c1 = real_c(ci)
        top = (self.fresnel_iface(cmul(real_c(n1), c1), prev_s),
               self.fresnel_iface(self.cdiv(real_c(n1),
                                            self.unit_where_tiny(c1)),
                                  prev_p))
        # phase 2: every entry; ray terms broadcast against the wavelengths
        ray = (lambda a: a[:, None]) if wl.ndim == 2 else (lambda a: a)
        rc = lambda z: (ray(z[0]), ray(z[1]))  # noqa: E731
        ck, r_s, r_p, x0 = terms[L - 1]
        r_s, r_p = rc(r_s), rc(r_p)
        phase = self.phase_factor(ray(x0), wl, rc(ck))
        for k in range(L - 2, -1, -1):
            ck, rho_s, rho_p, x0 = terms[k]
            r_s = self.moebius(rc(rho_s), r_s, phase)
            r_p = self.moebius(rc(rho_p), r_p, phase)
            phase = self.phase_factor(ray(x0), wl, rc(ck))
        r_s = self.moebius(rc(top[0]), r_s, phase)
        r_p = self.moebius(rc(top[1]), r_p, phase)
        a_s, a_p = np.hypot(*r_s), np.hypot(*r_p)
        return np.clip(F32(0.5) * (a_s * a_s + a_p * a_p), F32(0.0),
                       F32(1.0))


kernel_mirror = Mirror(KERNEL)
torch_formulas = Mirror(TORCH)


CASES = [(L, mode) for L in range(1, 9) for mode in ("row", "ray")]


def plain(args):
    """The plain version with every ray computed: the stack's own R."""
    return FS.film_stack_torch(*tensors(args), **FS.every_ray(C)).numpy()


@pytest.mark.parametrize("L,mode", CASES)
def test_plain_version_matches_reference(L, mode):
    args = stack(L, mode)
    port, ref = plain(args), reference(*args)
    assert port.dtype == np.float32 and port.shape == ref.shape == (
        (C, W) if mode == "row" else (C,))
    exact, tol = tolerance(args)
    assert np.all(np.abs(port - exact) <= tol), np.max(np.abs(port - exact))
    assert np.all(np.abs(ref - exact) <= tol), np.max(np.abs(ref - exact))
    assert np.all(np.abs(port - ref) <= tol), np.max(np.abs(port - ref))
    # the tolerance is the film-stack one where the stack is well posed
    kind = np.arange(C) % len(FILM_EDGE_KINDS)
    well = np.isin(kind, [FILM_EDGE_KINDS.index(k) for k in
                          ("general", "grazing", "normal", "padded",
                           "flipped")])
    assert np.mean(tol[well] == CPLX_ATOL) > 0.99


@pytest.mark.parametrize("L,mode", CASES)
def test_kernel_schedule_mirror_matches_plain(L, mode):
    args = stack(L, mode)
    mirror, port = kernel_mirror(*args), plain(args)
    assert mirror.dtype == np.float32 and mirror.shape == port.shape
    _, tol = tolerance(args)
    assert np.all(np.abs(mirror - port) <= tol), np.max(np.abs(mirror - port))


def same_bits(a, b):
    """float32 arrays equal bit for bit (any NaN equal to any NaN: numpy's
    NaN signs follow the host's, not the card's)."""
    a, b = np.broadcast_arrays(np.asarray(a, F32), np.asarray(b, F32))
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                     & np.isnan(b))


@pytest.mark.parametrize("L,mode", CASES)
def test_kernel_sequences_match_torch_sequences_bit_for_bit(L, mode):
    """The kernel's schedule on its own sequences (branch-free division,
    two-operation sums, the settled modulus test) against the same
    schedule on torch's: every entry of the edge stacks, bit for bit."""
    args = stack(L, mode)
    mine, theirs = kernel_mirror(*args), torch_formulas(*args)
    assert np.all(same_bits(mine, theirs)), np.sum(~same_bits(mine, theirs))


# signed zeros, subnormals, the 1e-20 guard, infinities and NaN, beside
# ordinary values: every part of every operand runs over them
SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 1e-45, -1e-45, 1e-20, -3e-21,
                    0.7, -2.5, 3.4e38, np.inf, -np.inf, np.nan], F32)


def special_pairs(k):
    """All k-tuples of SPECIAL as k flat float32 arrays."""
    grid = np.meshgrid(*[SPECIAL] * k, indexing="ij")
    return [g.ravel() for g in grid]


@pytest.mark.parametrize("name", ["cadd", "csub", "cdiv", "x2i",
                                  "one_plus"])
def test_kernel_primitive_equals_torch_sequence_on_special_values(name):
    with np.errstate(all="ignore"):
        if name in ("cadd", "csub", "cdiv"):
            a, b, c, d = special_pairs(4)
            x, y = (a, b), (c, d)
            if name == "cdiv":
                # the kernel's divisors have passed unit_where_tiny
                keep = exceeds_tiny_torch(c, d)
                x, y = (a[keep], b[keep]), (c[keep], d[keep])
                mine, theirs = cdiv(x, y), cdiv_torch(x, y)
            else:
                alpha = 1.0 if name == "cadd" else -1.0
                mine, theirs = cadd(x, y, alpha), cadd_torch(x, y, alpha)
        elif name == "x2i":
            x, = special_pairs(1)
            mine, theirs = x2i(x), x2i_torch(x)
        else:
            a, b = special_pairs(2)
            mine, theirs = one_plus((a, b)), one_plus_torch((a, b))
    for m, t in zip(mine, theirs):
        assert np.all(same_bits(m, t)), np.sum(~same_bits(m, t))


def test_modulus_test_settles_as_hypot_at_its_band():
    """|z| > 1e-20 from the sum of the parts' moduli where it settles it:
    the same answer as hypot on pairs spread over the band between
    9.9e-21 and 2.9e-20 and a decade around it, at the band's edges, and
    on the special values."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    mag = 10.0 ** rng.uniform(-21.5, -19.0, (2, n))
    sign = rng.choice([-1.0, 1.0], (2, n))
    x, y = (mag * sign).astype(F32)
    edge = np.array([9.9e-21, 2.9e-20, 1e-20, 7.07e-21, 7.08e-21,
                     1.4142e-20, 1.45e-20, 4.95e-21], F32)
    ex = np.concatenate([edge, np.nextafter(edge, F32(0)),
                         np.nextafter(edge, F32(1))])
    gx, gy = np.meshgrid(ex, np.concatenate([ex, [0.0, 1e-45]]).astype(F32))
    a, b = special_pairs(2)
    for u, v in ((x, y), (gx.ravel(), gy.ravel()), (a, b)):
        assert np.array_equal(exceeds_tiny(u, v), exceeds_tiny_torch(u, v))
    # the band holds pairs on both sides, so hypot decided some of them
    s = np.abs(x) + np.abs(y)
    band = (s >= F32(9.9e-21)) & (s < F32(2.9e-20))
    assert band.sum() > 1000
    assert 0 < exceeds_tiny_torch(x[band], y[band]).mean() < 1


def tensors(args):
    return [torch.from_numpy(a) for a in args]


def multilayer(args):
    """physics.multilayer_reflectance on a call's columns (tensors), each
    against the wavelength row or per ray: R before the selects."""
    ci, n1, ns, ln, lh, wl = args
    col = (lambda x: x[:, None]) if wl.dim() == 2 else (lambda x: x)
    L = ln.shape[1]
    return T.multilayer_reflectance(
        col(ci), col(n1), [col(ln[:, k]) for k in range(L)],
        [col(lh[:, k]) for k in range(L)], col(ns), wl)


def selects(C, seed):
    """(tir, coated, r_fresnel) of C rays as the trace gives them."""
    rng = np.random.default_rng(seed)
    coated = rng.uniform(size=C) < 0.6
    tir = rng.uniform(size=C) < 0.2
    r = rng.uniform(0.0, 1.0, C).astype(F32)
    return torch.from_numpy(tir), torch.from_numpy(coated), \
        torch.from_numpy(r)


@pytest.mark.parametrize("mode", ["row", "ray"])
def test_folded_selects_match_the_old_composition(mode):
    """film_stack_torch with tir, coated and the Fresnel R equals what the
    two call sites composed before (R_film, 1 under TIR, the Fresnel R
    where uncoated), bit for bit, also through the dispatcher."""
    for L in (1, 3, 6):
        args = tensors(stack(L, mode))
        tir, coated, r = selects(C, L)
        R_film = multilayer(args)
        col = (lambda x: x[:, None]) if mode == "row" else (lambda x: x)
        R_film = torch.where(col(tir), 1.0, R_film)
        want = torch.where(col(coated), R_film,
                           col(r).expand_as(R_film))
        got = FS.film_stack_torch(*args, tir=tir, coated=coated, r_fresnel=r)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(FS.film_stack_reflectance(
            *args, tir=tir, coated=coated, r_fresnel=r), got)
        every = FS.every_ray(C)
        assert torch.equal(FS.film_stack_torch(*args, **every).view(
            torch.int32), multilayer(args).view(torch.int32))
    assert FS.computed_rays(tir, coated) == int((coated & ~tir).sum())
    assert FS.computed_rays(every["tir"], every["coated"]) == C
    # the selects are part of every call
    with pytest.raises(TypeError):
        FS.film_stack_torch(*args, coated=coated, r_fresnel=r)
    with pytest.raises(TypeError):
        FS.film_stack_reflectance(*args, tir=tir, coated=coated)


def test_dispatch_runs_the_plain_version_on_the_cpu():
    args = tensors(stack(3, "row")) + list(FS.every_ray(C).values())
    before = FS.film_stack_cuda.launches
    want = FS.film_stack_torch(*args)
    for backend in ("auto", "torch", "jnp"):
        assert torch.equal(FS.film_stack_reflectance(*args, backend=backend),
                           want)
    # the plain version is physics.multilayer_reflectance on the columns
    ci, n1, ns, ln, lh, wl = args[:6]
    cols = T.multilayer_reflectance(
        ci[:, None], n1[:, None], [ln[:, k][:, None] for k in range(3)],
        [lh[:, k][:, None] for k in range(3)], ns[:, None], wl)
    assert torch.equal(cols, want)
    assert FS.film_stack_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        FS.film_stack_reflectance(*args, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        FS.film_stack_cuda(*args)
    with pytest.raises(ValueError, match="backend"):
        FS.film_stack_reflectance(*args, backend="pallas")
    with pytest.raises(ValueError, match="wl must be"):
        FS.film_stack_reflectance(*args[:5], wl[0].repeat(2, 1), *args[6:])


def test_grad_tensors_are_refused_but_by_the_plain_version():
    args = tensors(stack(2, "ray")) + list(FS.every_ray(C).values())
    h = args[4].clone().requires_grad_(True)
    args[4] = h
    for backend in ("auto", "cuda"):
        with pytest.raises(ValueError, match="requires grad"):
            FS.film_stack_reflectance(*args, backend=backend)
    g, = torch.autograd.grad(
        FS.film_stack_reflectance(*args, backend="torch").sum(), h)
    assert torch.isfinite(g).all() and bool((g != 0).any())


def test_both_trace_call_sites_go_through_the_dispatcher(monkeypatch):
    import lightpycl_tpu_torch as P
    from lightpycl_tpu_torch import spectral
    from lightpycl_tpu_torch.tracer import step

    calls = []

    def record(site, fn):
        def wrapped(*args, backend="auto", **sel):
            calls.append((site, tuple(args[5].shape), backend))
            # both sites fold the trace's selects into the call
            assert sorted(sel) == ["coated", "r_fresnel", "tir"]
            return fn(*args, backend=backend, **sel)
        return wrapped

    monkeypatch.setattr(spectral, "film_stack_reflectance",
                        record("spectral", FS.film_stack_reflectance))
    monkeypatch.setattr(step, "film_stack_reflectance",
                        record("shade", FS.film_stack_reflectance))
    oe = P.optical_elements(16, 6)
    win = [oe.cube((1.0, 1.0, 0.25), material="refractive", ior=1.52,
                   coating=[(1.38, 0.1), (2.1, 0.06)]),
           oe.disc(1.5, center=(0, 0, 2.0), material="measure", name="fwd"),
           oe.sphere(radius=8.0, material="terminator")]
    beam = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                              diameter=0.5, ray_count=64, seed=3)
    P.Tracer(device="cpu").trace_spectral(
        beam, [0.45, 0.55, 0.65], elements=win, trace_iterations=3,
        capacity=256, method="shared", backend="torch")
    P.Tracer(device="cpu").trace(beam, win, trace_iterations=3,
                                 capacity=256)
    assert ("spectral", (1, 3), "torch") in calls
    assert ("shade", (256,), "auto") in calls
    assert {site for site, _, _ in calls} == {"spectral", "shade"}


def test_build_flags_and_c_entry_match_the_wrapper():
    import re

    from lightpycl_tpu_torch.ops import _build

    cmd = _build.build_command("film_stack.cu", {}, _build.BUILD_DIR / "x")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert "--use_fast_math" not in cmd
    assert cmd[-1].endswith("csrc/film_stack.cu")
    src = (_build.CSRC_DIR / "film_stack.cu").read_text()
    assert '#include "film_stack_modulus.cuh"' in src
    src += (_build.CSRC_DIR / "film_stack_modulus.cuh").read_text()
    # the C entry takes as many arguments as load_kernel declares (15),
    # and no fast intrinsic stands in for expf / sinf / cosf / sqrtf
    sig = src.split('extern "C" int lpcl_film_stack(', 1)[1].split(")", 1)[0]
    assert len(sig.split(",")) == 15
    assert not re.search(r"__(expf|sinf|cosf|sincosf|fdividef|fsqrt_rn)\b",
                         src)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["row", "ray"])
def test_kernel_bit_equal_to_plain_on_card(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    for L in range(1, 9):
        args = [a.cuda() for a in tensors(stack(L, mode))]
        every = FS.every_ray(C, device="cuda")
        before = FS.film_stack_cuda.launches
        k = FS.film_stack_reflectance(*args, **every)
        assert FS.film_stack_cuda.launches == before + 1
        p = FS.film_stack_reflectance(*args, **every, backend="torch")
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), L
        sel = dict(zip(("tir", "coated", "r_fresnel"),
                       (x.cuda() for x in selects(C, L))))
        k = FS.film_stack_reflectance(*args, **sel)
        p = FS.film_stack_reflectance(*args, **sel, backend="torch")
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), L
