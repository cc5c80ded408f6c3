"""Every function of the port's physics.py (lightpycl_tpu_torch/physics.py)
against its counterpart in the JAX package on the same seeded numpy inputs.

Tolerances: real-arithmetic outputs rel 2e-6 / abs 1e-6; outputs derived
from complex64 amplitudes abs 2e-5; the samplers, fed JAX's own uniforms,
abs 3e-6."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightpycl_tpu import physics as R
from lightpycl_tpu_torch import physics as T

torch.set_num_threads(1)
C = 512
REAL = dict(rtol=2e-6, atol=1e-6)
CPLX = dict(rtol=0.0, atol=2e-5)
SAMPLER = dict(rtol=0.0, atol=3e-6)
# a 3-layer stack met at grazing incidence from inside the glass (evanescent
# in every layer): both packages sit 8e-5 from the float64 amplitudes there,
# so they are held to each other at that accuracy
CPLX_EVANESCENT = dict(rtol=0.0, atol=1e-4)


def rng_for(*words):
    return np.random.default_rng([zlib.crc32(w.encode()) if isinstance(w, str)
                                  else int(w) for w in words] + [7])


def f32(a):
    return np.asarray(a, np.float32)


def unit(rng, n=C):
    v = rng.normal(size=(n, 3))
    return f32(v / np.linalg.norm(v, axis=1, keepdims=True))


def to_jax(x):
    if isinstance(x, (list, tuple)):
        return [to_jax(a) for a in x]
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def to_torch(x):
    if isinstance(x, (list, tuple)):
        return [to_torch(a) for a in x]
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


def flat(out):
    """A function's outputs as a flat list of numpy arrays (complex split
    into real and imaginary parts by the caller's compare)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res += flat(o)
        return res
    return [out]


def as_np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def compare(ref, port, tol):
    ref, port = flat(ref), flat(port)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        a, b = as_np(a), as_np(b)
        assert a.shape == b.shape, i
        if a.dtype == bool:
            assert np.array_equal(a, b), i
        else:
            assert np.all(np.isfinite(b)), i
            assert np.allclose(a, b, equal_nan=True, **tol), (
                i, float(np.max(np.abs(a - b))))


def cosines(rng, regime):
    if regime == "normal":
        return f32(1.0 - rng.uniform(0, 1e-4, C))
    if regime == "grazing":
        return f32(rng.uniform(0.0, 2e-3, C))
    return f32(rng.uniform(0.02, 1.0, C))


def incidence(rng, regime):
    """(d, n) with n facing the ray and the regime's incidence angle."""
    n = unit(rng)
    t1, _ = [np.asarray(x) for x in R.orthonormal_basis(jnp.asarray(n))]
    ci = cosines(rng, regime)[:, None]
    d = -ci * n + np.sqrt(np.maximum(1 - ci * ci, 0)) * t1
    return f32(d / np.linalg.norm(d, axis=1, keepdims=True)), n


def stokes(rng):
    s0 = rng.uniform(0.1, 1.0, C)
    p = unit(rng) * rng.uniform(0, 1, (C, 1))
    return [f32(s0)] + [f32(s0 * p[:, k]) for k in range(3)]


def snell_pair(rng, regime):
    """cos_i, cos_t, n1, n2, tir of a dielectric interface."""
    if regime == "tir":
        n1, n2 = f32(np.full(C, 1.5)), f32(np.full(C, 1.0))
        ci = f32(rng.uniform(0.02, 0.7, C))   # beyond the critical angle
    else:
        n1 = f32(rng.uniform(1.0, 1.8, C))
        n2 = f32(rng.uniform(1.0, 1.8, C))
        ci = cosines(rng, regime)
    s2 = (n1 / n2) ** 2 * (1 - ci * ci)
    tir = s2 > 1.0
    ct = f32(np.where(tir, 0.0, np.sqrt(np.maximum(1 - s2, 0))))
    return ci, ct, n1, n2, tir


def stack(rng, layers, pad_n=1.0):
    """(layers_n, layers_h) of a `layers`-deep stack; 0 layers = one h = 0
    padding layer, 3 layers = two live ones around an h = 0 pad of index
    pad_n (1.0 is what build_scene pads with)."""
    if layers == 0:
        return [f32(np.full(C, 1.38))], [f32(np.zeros(C))]
    if layers == 1:
        return [f32(np.full(C, 1.38))], [f32(rng.uniform(0.05, 0.3, C))]
    return ([f32(np.full(C, 1.38)), f32(np.full(C, pad_n)),
             f32(np.full(C, 2.1))],
            [f32(rng.uniform(0.05, 0.3, C)), f32(np.zeros(C)),
             f32(rng.uniform(0.02, 0.2, C))])


def film_args(rng, regime, layers, entering):
    ci = cosines(rng, regime)
    n_glass = f32(np.full(C, 1.52))
    n_air = f32(np.ones(C))
    n1, n_sub = (n_air, n_glass) if entering else (n_glass, n_air)
    # at grazing incidence from air a pad of index 1.0 puts its wave on the
    # sqrt's branch point, where both packages are 0.4 off the float64
    # value (ill-conditioned, not comparable); the grazing cases pad at 1.2
    ln, lh = stack(rng, layers, pad_n=1.2 if regime == "grazing" else 1.0)
    if not entering:  # an exiting ray sees the stack reversed
        ln, lh = ln[::-1], lh[::-1]
    wl = f32(rng.uniform(0.4, 0.7, C))
    return ci, n1, ln, lh, n_sub, wl


def grin_args(rng, a_sign):
    r0 = f32(rng.uniform(-0.4, 0.4, (C, 3)))
    d0 = unit(rng)
    center = f32(np.tile([0.05, -0.02, 0.0], (C, 1)))
    axis = f32(np.tile([0.0, 0.0, 1.0], (C, 1)))
    n0 = f32(np.full(C, 1.6))
    a = f32(np.full(C, {"pos": 4.0, "neg": -2.0, "zero": 0.0}[a_sign]))
    return r0, d0, center, axis, n0, a


def crystal(rng):
    n_o = f32(np.full(C, 1.658))
    n_e = f32(np.full(C, 1.486))
    return unit(rng), n_o, n_e


CASES = {}


def case(name, regimes, tol=REAL):
    def deco(fn):
        for r in regimes:
            CASES[f"{name}-{r}"] = (name, fn, r, tol)
        return fn
    return deco


@case("normalize", ["unit"])
def _(rng, regime):
    return (f32(rng.normal(size=(C, 3))),)


@case("orient_normal", ["unit"])
def _(rng, regime):
    return unit(rng), unit(rng)


@case("reflect", ["general", "grazing"])
def _(rng, regime):
    return incidence(rng, regime)


@case("refract_full", ["general", "grazing", "normal", "tir"])
def _(rng, regime):
    d, n = incidence(rng, "general" if regime == "tir" else regime)
    eta = f32(np.full(C, 1.5) if regime == "tir"
              else rng.uniform(0.6, 1.6, C))
    return d, n, eta


@case("fresnel_unpolarized", ["general", "grazing", "normal", "tir"])
def _(rng, regime):
    return snell_pair(rng, regime)


@case("fresnel_amplitudes", ["general", "grazing", "normal", "tir"])
def _(rng, regime):
    return snell_pair(rng, regime)[:4]


@case("tir_phase_shift", ["tir", "grazing"])
def _(rng, regime):
    ci = (f32(rng.uniform(0.02, 0.7, C)) if regime == "tir"
          else cosines(rng, regime))
    return ci, f32(np.full(C, 1.0 / 1.5))


@case("rotate_stokes", ["general"])
def _(rng, regime):
    phi = rng.uniform(-np.pi, np.pi, C)
    return (f32(rng.uniform(-1, 1, C)), f32(rng.uniform(-1, 1, C)),
            f32(np.cos(phi)), f32(np.sin(phi)))


@case("polarized_split", ["general", "grazing", "normal", "tir"])
def _(rng, regime):
    return tuple(stokes(rng)) + tuple(snell_pair(rng, regime))


@case("_branch_safe_sqrt", ["general", "branch"], tol=CPLX)
def _(rng, regime):
    z = (rng.normal(size=C) + 1j * rng.normal(size=C)).astype(np.complex64)
    if regime == "branch":
        z[::3] = 0.0                      # exactly at the branch point
        z[1::3] = z[1::3].real * 1e-7     # inside the guard
        z[2::3] = -np.abs(z[2::3].real)   # on the cut
    return (z,)


@case("metal_rs_rp", ["absorbing", "grazing", "normal", "dielectric"],
      tol=CPLX)
def _(rng, regime):
    ci = cosines(rng, "general" if regime in ("absorbing", "dielectric")
                 else regime)
    n1 = f32(rng.uniform(1.0, 1.5, C))
    n_m = f32(rng.uniform(0.05, 2.5, C))
    k_m = f32(np.zeros(C) if regime == "dielectric"
              else rng.uniform(0.5, 7.0, C))
    return ci, n1, n_m, k_m


CASES["metal_reflectance-absorbing"] = (
    "metal_reflectance", CASES["metal_rs_rp-absorbing"][1], "absorbing", CPLX)
CASES["metal_reflectance-grazing"] = (
    "metal_reflectance", CASES["metal_rs_rp-grazing"][1], "grazing", CPLX)


@case("_abs2", ["general"])
def _(rng, regime):
    return ((rng.normal(size=C) + 1j * rng.normal(size=C)
             ).astype(np.complex64),)


@case("mueller_reflect", ["general"], tol=CPLX)
def _(rng, regime):
    rs = (rng.uniform(-1, 1, C) + 1j * rng.uniform(-1, 1, C)) * 0.7
    rp = (rng.uniform(-1, 1, C) + 1j * rng.uniform(-1, 1, C)) * 0.7
    return tuple(stokes(rng)) + (rs.astype(np.complex64),
                                 rp.astype(np.complex64))


@case("orthonormal_basis", ["general", "poles"])
def _(rng, regime):
    n = unit(rng)
    if regime == "poles":
        n[::2] = [0.0, 0.0, 1.0]
        n[1::2] = [0.0, 0.0, -1.0 + 1e-3]
        n = f32(n / np.linalg.norm(n, axis=1, keepdims=True))
    return (n,)


@case("grin_index", ["pos", "neg"])
def _(rng, regime):
    r0, _, center, axis, n0, a = grin_args(rng, regime)
    return r0, center, axis, n0, a


CASES["_grin_grad-pos"] = ("_grin_grad", CASES["grin_index-pos"][1], "pos",
                           REAL)


@case("grin_rk4_step", ["pos", "neg", "zero"])
def _(rng, regime):
    r0, d0, center, axis, n0, a = grin_args(rng, regime)
    return r0, d0, 0.05, center, axis, n0, a


@case("grin_selfoc_step", ["pos", "neg", "zero", "per_ray_h"])
def _(rng, regime):
    r0, d0, center, axis, n0, a = grin_args(
        rng, "pos" if regime == "per_ray_h" else regime)
    h = f32(rng.uniform(1e-3, 0.1, C)) if regime == "per_ray_h" else 0.0628
    return r0, d0, h, center, axis, n0, a


@case("parallel_transport", ["general", "small_turn"])
def _(rng, regime):
    d0 = unit(rng)
    d1 = unit(rng)
    if regime == "small_turn":
        d1 = d0 + 1e-2 * d1
        d1 = f32(d1 / np.linalg.norm(d1, axis=1, keepdims=True))
    v = f32(np.cross(d0, unit(rng)))
    return v, d0, d1


for _fn, _tol in (("multilayer_rs_rp", CPLX), ("multilayer_amplitudes", CPLX),
                  ("multilayer_reflectance", CPLX)):
    for _layers in (0, 1, 3):
        for _side in ("entry", "exit"):
            for _reg in ("general", "grazing"):
                CASES[f"{_fn}-{_layers}layer-{_side}-{_reg}"] = (
                    _fn, (lambda rng, regime, L=_layers, S=_side, G=_reg:
                          film_args(rng, G, L, S == "entry")),
                    f"{_layers}{_side}{_reg}",
                    CPLX_EVANESCENT if (_layers, _side, _reg) == (
                        3, "exit", "grazing") else _tol)


@case("thin_film_rs_rp", ["entry", "exit"], tol=CPLX)
def _(rng, regime):
    ci, n1, ln, lh, n_sub, wl = film_args(rng, "general", 1,
                                          regime == "entry")
    return ci, n1, ln[0], n_sub, lh[0], wl


CASES["thin_film_reflectance-entry"] = (
    "thin_film_reflectance", CASES["thin_film_rs_rp-entry"][1], "entry", CPLX)


@case("polarized_film_split", ["0entry", "1entry", "3entry", "3exit",
                               "1grazing"], tol=CPLX)
def _(rng, regime):
    layers = int(regime[0])
    return tuple(stokes(rng)) + tuple(film_args(
        rng, "grazing" if "grazing" in regime else "general", layers,
        "exit" not in regime))


@case("uniaxial_index", ["general"])
def _(rng, regime):
    _, n_o, n_e = crystal(rng)
    return f32(rng.uniform(-1, 1, C)), n_o, n_e


@case("uniaxial_refract_wave", ["general", "grazing", "isotropic"])
def _(rng, regime):
    c_axis, n_o, n_e = crystal(rng)
    if regime == "isotropic":
        n_e = n_o
    d, n = incidence(rng, "general" if regime == "isotropic" else regime)
    kt = f32(d - np.sum(d * n, axis=1, keepdims=True) * n)
    return kt, f32(-n), c_axis, n_o, n_e


@case("uniaxial_ray_direction", ["general"])
def _(rng, regime):
    c_axis, n_o, n_e = crystal(rng)
    K = f32(unit(rng) * rng.uniform(1.48, 1.66, (C, 1)))
    return K, c_axis, n_o, n_e


@case("uniaxial_wave_from_ray", ["general", "along_axis"])
def _(rng, regime):
    c_axis, n_o, n_e = crystal(rng)
    S = unit(rng)
    if regime == "along_axis":
        S[::2] = c_axis[::2]
        S[1::2] = -c_axis[1::2]
    return S, c_axis, n_o, n_e


@case("incidence_s_direction", ["general", "normal"])
def _(rng, regime):
    d, n = incidence(rng, regime)
    if regime == "normal":
        d[::2] = -n[::2]   # exactly normal: the fallback basis decides
    return d, n, unit(rng)


@case("snell_interaction", ["general", "grazing", "tir"])
def _(rng, regime):
    d, n = incidence(rng, "general" if regime == "tir" else regime)
    flip = rng.uniform(size=(C, 1)) < 0.5
    n_geom = f32(np.where(flip, -n, n))
    ray_ior = f32(np.where(flip[:, 0], 1.5, 1.0))
    tri_ior = f32(np.full(C, 1.5))
    return d, n_geom, ray_ior, tri_ior, 1.0


@pytest.mark.parametrize("key", sorted(CASES))
def test_function_matches_reference(key):
    name, build, regime, tol = CASES[key]
    args = build(rng_for(name, regime), regime)
    ref = getattr(R, name)(*to_jax(list(args)))
    port = getattr(T, name)(*to_torch(list(args)))

    def split(out):
        res = []
        for a in flat(out):
            a = as_np(a)
            res += [a.real, a.imag] if np.iscomplexobj(a) else [a]
        return res

    compare(split(ref), split(port), tol)


@pytest.mark.parametrize("g", [0.0, 0.9, -0.5])
def test_henyey_greenstein_with_reference_uniforms(g):
    rng = rng_for("hg", int(g * 10) + 20)
    key = jax.random.fold_in(jax.random.key(3), 0x5CA8)
    d = unit(rng)
    gg = f32(np.full(C, g))
    ref = R.sample_henyey_greenstein(key, jnp.asarray(d), jnp.asarray(gg))
    u = np.array(jax.random.uniform(key, (C, 2)))  # a writable copy
    port = T.sample_henyey_greenstein(torch.from_numpy(u), torch.from_numpy(d),
                                      torch.from_numpy(gg))
    compare(ref, port, SAMPLER)
    # unit directions with the lobe's mean cosine (C draws: 4 sigma)
    cos = np.sum(port.numpy() * d, axis=1)
    assert np.allclose(np.linalg.norm(port.numpy(), axis=1), 1.0, atol=1e-5)
    assert abs(cos.mean() - g) < 4.0 / np.sqrt(C)


def test_lambertian_with_reference_uniforms():
    rng = rng_for("lambert")
    key = jax.random.fold_in(jax.random.key(5), 0x5D1F)
    n = unit(rng)
    ref = R.sample_lambertian(key, jnp.asarray(n))
    u = np.array(jax.random.uniform(key, (C, 2)))  # a writable copy
    port = T.sample_lambertian(torch.from_numpy(u), torch.from_numpy(n))
    compare(ref, port, SAMPLER)
    assert np.all(np.sum(port.numpy() * n, axis=1) >= -1e-6)


def test_refract_is_refract_full():
    d, n = incidence(rng_for("refract"), "general")
    eta = torch.full((C,), 0.7)
    t, tir = T.refract(torch.from_numpy(d), torch.from_numpy(n), eta)
    t2, tir2, _ = T.refract_full(torch.from_numpy(d), torch.from_numpy(n),
                                 eta)
    assert torch.equal(t, t2) and torch.equal(tir, tir2)
