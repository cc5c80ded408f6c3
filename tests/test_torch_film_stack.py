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
  the card.
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


def cadd(x, y, alpha):
    t = cmul(y, (np.full_like(y[0], alpha), np.zeros_like(y[0])))
    return x[0] + t[0], x[1] + t[1]


def real_c(x):
    return x, np.zeros_like(x)


def cdiv(x, y):
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
    return re.astype(F32), im.astype(F32)


def unit_where_tiny(z):
    keep = np.hypot(z[0], z[1]) > F32(1e-20)
    return (np.where(keep, z[0], F32(1.0)).astype(F32),
            np.where(keep, z[1], F32(0.0)).astype(F32))


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


def stack_cos(n1s2, n):
    nn = np.maximum(n, F32(1e-20))
    z = cadd(real_c(np.ones_like(n1s2)), real_c(n1s2 / (nn * nn)), -1.0)
    safe = (z[0] * z[0] + z[1] * z[1]) > F32(1e-12)
    s = csqrt_cxx(z)
    return (np.where(safe, s[0], F32(0.0)).astype(F32),
            np.where(safe, s[1], F32(0.0)).astype(F32))


def fresnel_iface(ea, eb):
    return cdiv(cadd(ea, eb, -1.0), unit_where_tiny(cadd(ea, eb, 1.0)))


def moebius(rho, r, phase):
    num = cadd(rho, cmul(r, phase), 1.0)
    one = real_c(np.ones_like(num[0]))
    den = cadd(cmul(cmul(rho, r), phase), one, 1.0)
    return cdiv(num, unit_where_tiny(den))


def phase_factor(x0, wl, ck):
    x = x0 / np.maximum(wl, F32(1e-20))
    two_i = (np.zeros_like(x), np.full_like(x, 2.0))
    return cexp_cxx(cmul(cmul(real_c(x), two_i), ck))


def kernel_mirror(ci, n1, ns, ln, lh, wl):
    """Phase 1 on (C,) ray arrays, phase 2 on the (C, W) entries."""
    L = ln.shape[1]
    ci = np.maximum(ci, F32(1e-6))
    n1s2 = (n1 * n1) * np.maximum(F32(1.0) - ci * ci, F32(0.0))
    cs = stack_cos(n1s2, ns)
    prev_s, prev_p = cmul(real_c(ns), cs), cdiv(real_c(ns),
                                                unit_where_tiny(cs))
    terms = [None] * L
    for k in range(L - 1, -1, -1):
        ck = stack_cos(n1s2, ln[:, k])
        eks = cmul(real_c(ln[:, k]), ck)
        ekp = cdiv(real_c(ln[:, k]), unit_where_tiny(ck))
        terms[k] = (ck, fresnel_iface(eks, prev_s), fresnel_iface(ekp, prev_p),
                    (F32(2.0 * np.pi) * ln[:, k]) * lh[:, k])
        prev_s, prev_p = eks, ekp
    c1 = real_c(ci)
    top = (fresnel_iface(cmul(real_c(n1), c1), prev_s),
           fresnel_iface(cdiv(real_c(n1), unit_where_tiny(c1)), prev_p))
    # phase 2: every entry; ray terms broadcast against the wavelengths
    ray = (lambda a: a[:, None]) if wl.ndim == 2 else (lambda a: a)
    rc = lambda z: (ray(z[0]), ray(z[1]))  # noqa: E731
    ck, r_s, r_p, x0 = terms[L - 1]
    r_s, r_p = rc(r_s), rc(r_p)
    phase = phase_factor(ray(x0), wl, rc(ck))
    for k in range(L - 2, -1, -1):
        ck, rho_s, rho_p, x0 = terms[k]
        r_s = moebius(rc(rho_s), r_s, phase)
        r_p = moebius(rc(rho_p), r_p, phase)
        phase = phase_factor(ray(x0), wl, rc(ck))
    r_s = moebius(rc(top[0]), r_s, phase)
    r_p = moebius(rc(top[1]), r_p, phase)
    a_s, a_p = np.hypot(*r_s), np.hypot(*r_p)
    return np.clip(F32(0.5) * (a_s * a_s + a_p * a_p), F32(0.0), F32(1.0))


CASES = [(L, mode) for L in range(1, 9) for mode in ("row", "ray")]


def plain(args):
    return FS.film_stack_torch(*(torch.from_numpy(a) for a in args)).numpy()


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


def tensors(args):
    return [torch.from_numpy(a) for a in args]


def test_dispatch_runs_the_plain_version_on_the_cpu():
    args = tensors(stack(3, "row"))
    before = FS.film_stack_cuda.launches
    want = FS.film_stack_torch(*args)
    for backend in ("auto", "torch", "jnp"):
        assert torch.equal(FS.film_stack_reflectance(*args, backend=backend),
                           want)
    # the plain version is physics.multilayer_reflectance on the columns
    ci, n1, ns, ln, lh, wl = args
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
        FS.film_stack_reflectance(*args[:5], wl[0].repeat(2, 1))


def test_grad_tensors_are_refused_but_by_the_plain_version():
    args = tensors(stack(2, "ray"))
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
        def wrapped(*args, backend="auto"):
            calls.append((site, tuple(args[5].shape), backend))
            return fn(*args, backend=backend)
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
    # the C entry takes as many arguments as load_kernel declares (12),
    # and no fast intrinsic stands in for expf / sinf / cosf / sqrtf
    sig = src.split('extern "C" int lpcl_film_stack(', 1)[1].split(")", 1)[0]
    assert len(sig.split(",")) == 12
    assert not re.search(r"__(expf|sinf|cosf|fdividef|fsqrt_rn)\b", src)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["row", "ray"])
def test_kernel_bit_equal_to_plain_on_card(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    for L in range(1, 9):
        args = [a.cuda() for a in tensors(stack(L, mode))]
        before = FS.film_stack_cuda.launches
        k = FS.film_stack_reflectance(*args)
        assert FS.film_stack_cuda.launches == before + 1
        p = FS.film_stack_reflectance(*args, backend="torch")
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), L
