"""The port's device samplers (rays_on_device / wavelengths_on_device of each
source, the ray-file replay draw) against the JAX package's. torch draws
other random numbers than jax.random, so each random sampler's map is fed
JAX's own unit uniforms (those of the same split keys) and held to JAX's
rays_on_device; the deterministic samplings (halton, hexapolar) are held to
it directly; the categorical draws are checked by their frequencies."""

import jax
import numpy as np
import pytest
import torch

from lightpycl_tpu import sources as RS
from lightpycl_tpu_torch import sources as PS
from lightpycl_tpu_torch.io.rayfile import RayFileData, RayFileSource
from lightpycl_tpu_torch.sources import halton_sequence
from lightpycl_tpu_torch.tracer.step import make_generator

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 4096
TOL = dict(rtol=1e-6, atol=1e-6)


def jax_uniforms(key, n, k):
    """The unit uniforms behind a reference sampler's draws: one per key of
    jax.random.split(key, k), in order."""
    keys = jax.random.split(key, k)
    return [torch.from_numpy(np.array(jax.random.uniform(kk, (n,))))
            for kk in keys]


def assert_rays_close(ref, port, **tol):
    for r, p in zip(ref, port):
        r = np.asarray(r)
        p = p.numpy()
        assert p.dtype == np.float32 and p.shape == r.shape
        assert np.allclose(p, r, **tol), np.abs(p - r).max()


EPS32 = 2.0 ** -24   # float32 unit roundoff


def area_dirs_f64(src, u3, u4):
    """AreaSource's direction formula (_directions_local, then the frame
    sum) in float64 on the float32 values both packages compute alike:
    the frame rows, z = sqrt(u3) (or u3) and the phase 2 pi u4, each one
    correctly rounded float32 operation; and the per-ray bound on either
    package's float32 result. s = sqrt(1 - z z) cancels near the pole:
    the rounding of z z (none where it is fused into the subtraction) is
    at most eps z^2 and that of 1 - z z at most eps s^2, so s^2 carries
    eps (z^2 + s^2) = eps, s carries eps / (2 s) from it and 2 eps from
    its own sqrt (one ulp: some CPU builds of torch round a float32 sqrt
    faithfully, not correctly). The rest is at most 8 eps: cos / sin
    within 2 eps each and one rounding of s cos, s sin (3 sqrt(2) eps
    through a unit frame row), three roundings of the frame sum of terms
    whose magnitudes add up to at most 1."""
    u3 = np.asarray(u3, np.float32)
    u4 = np.asarray(u4, np.float32)
    F = np.asarray(PS._frame(src.direction), np.float32).astype(np.float64)
    z = (np.sqrt(u3) if src.emission == "lambertian" else u3)
    z = z.astype(np.float32).astype(np.float64)
    ph = (np.float32(2.0 * np.pi) * u4).astype(np.float64)
    s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    d = ((s * np.cos(ph))[:, None] * F[0] + (s * np.sin(ph))[:, None] * F[1]
         + z[:, None] * F[2])
    # s = 0 only at z = 1, where 1 - z z is 0 exactly on both sides
    bound = EPS32 * (1.0 / (2.0 * np.maximum(s, 2.0 ** -12)) + 10.0)
    return d, bound[:, None]


def assert_area_dirs(src, u3, u4, ref_d, port_d):
    """Each package's directions within the bound of area_dirs_f64 of the
    float64 value, and the two within the sum of both bounds."""
    d64, bound = area_dirs_f64(src, u3, u4)
    r = np.asarray(ref_d).astype(np.float64)
    p = port_d.numpy().astype(np.float64)
    assert port_d.dtype == torch.float32 and p.shape == r.shape == d64.shape
    assert np.all(np.abs(r - d64) <= bound), np.abs(r - d64).max()
    assert np.all(np.abs(p - d64) <= bound), np.abs(p - d64).max()
    assert np.all(np.abs(p - r) <= 2.0 * bound), np.abs(p - r).max()


SOURCES = {
    # name: (kwargs, split arity of the reference's key)
    "point": (dict(center=(0.1, 0.2, 0.3), direction=(0.3, -0.2, 1.0),
                   polar_max=0.7, power=2.0), 2),
    "point_lambertian": (dict(direction=(1.0, 0.0, 0.2), directivity="lamb"),
                         2),
    "collimated": (dict(center=(0, 0, 5), direction=(0, 0, -1),
                        diameter=3.5), 4),
    "collimated_divergent": (dict(direction=(0.2, 0.9, 0.1), diameter=1.2,
                                  divergence=0.05, power=3.0), 4),
    "collimated_gaussian": (dict(diameter=2.0, profile="gaussian",
                                 waist=0.7, divergence=0.01), 4),
    "area_disc": (dict(center=(1, 0, 0), direction=(1, 1, 0), radius=0.3),
                  4),
    "area_rect_isotropic": (dict(width=(0.4, 0.2), emission="isotropic",
                                 power=0.5), 4),
}


def make(module, name):
    kw = dict(SOURCES[name][0])
    if kw.get("directivity") == "lamb":
        kw["directivity"] = module.lambertian
    cls = (module.LightSource if name.startswith("point")
           else module.CollimatedSource if name.startswith("collimated")
           else module.AreaSource)
    return cls(ray_count=N, **kw)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_map_on_jax_uniforms_matches_reference(name):
    key = jax.random.key(5)
    ref = make(RS, name).rays_on_device(key, N)
    u = jax_uniforms(key, N, SOURCES[name][1])
    port = make(PS, name)._rays_from_uniforms(u, N, CPU)
    assert_rays_close(ref, port, **TOL)
    if name.startswith("area"):
        # the direction's 1 - z z cancels near the pole: each package is
        # also held to the float64 formula there
        assert_area_dirs(make(PS, name), u[2], u[3], ref[1], port[1])
    # the port's own draw: unit directions, the source's power, on the
    # generator's device
    o, d, p = make(PS, name).rays_on_device(make_generator(CPU, 1), N)
    assert o.device == CPU and o.shape == (N, 3)
    assert torch.allclose(d.norm(dim=1), torch.ones(N), atol=1e-6)
    assert float(p.sum()) == pytest.approx(make(PS, name).power, rel=1e-5)


DETERMINISTIC = {
    "halton": dict(sampling="halton", diameter=2.0),
    "halton_divergent": dict(sampling="halton", diameter=2.0,
                             divergence=0.1, direction=(0, 1, 1)),
    "hexapolar": dict(sampling="hexapolar", diameter=1.5),
    "hexapolar_gaussian": dict(sampling="hexapolar", diameter=1.5,
                               profile="gaussian", waist=0.5),
    "halton_gaussian": dict(sampling="halton", diameter=1.5,
                            profile="gaussian", waist=0.5),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC) + ["area_halton"])
def test_deterministic_streams_match_reference(name):
    if name == "area_halton":
        ref_src = RS.AreaSource(sampling="halton", radius=0.4, ray_count=N)
        port_src = PS.AreaSource(sampling="halton", radius=0.4, ray_count=N)
    else:
        ref_src = RS.CollimatedSource(ray_count=N, **DETERMINISTIC[name])
        port_src = PS.CollimatedSource(ray_count=N, **DETERMINISTIC[name])
    ref = ref_src.rays_on_device(jax.random.key(0), N)
    # the same rays from any generator, every time (no draw is made)
    a = port_src.rays_on_device(make_generator(CPU, 1), N)
    b = port_src.rays_on_device(make_generator(CPU, 2), N)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the stream (radii, angles, halton numbers) is the reference's; the
    # f32 cos / sin and the reference's fused multiply-adds leave a few
    # ulps (all coordinates here are below 2 in magnitude)
    assert_rays_close(ref, a, rtol=0, atol=3e-7)
    if name == "area_halton":
        assert_area_dirs(port_src, halton_sequence(N, 5),
                         halton_sequence(N, 7), ref[1], a[1])


def categorical_ok(counts, p, n):
    """Every bin within 5 sigma of its expected count; zero-probability
    bins empty."""
    expect = n * p
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(counts[p == 0] == 0)
    assert np.all(np.abs(counts - expect) <= 5 * sigma + 1e-9), (counts,
                                                                  expect)


@pytest.mark.parametrize("module_src", ["point", "collimated", "area"])
def test_wavelength_draw_frequencies(module_src):
    wls = np.array([0.45, 0.5, 0.55, 0.6, 0.65])
    wts = np.array([1.0, 3.0, 0.0, 0.5, 2.5])
    cls = {"point": PS.LightSource, "collimated": PS.CollimatedSource,
           "area": PS.AreaSource}[module_src]
    n = 1 << 16
    w = cls(wavelength=(wls, wts)).wavelengths_on_device(
        make_generator(CPU, 9), n)
    assert w.dtype == torch.float32 and w.shape == (n,)
    idx = np.argmin(np.abs(w.numpy()[:, None] - wls[None, :]), axis=1)
    categorical_ok(np.bincount(idx, minlength=len(wls)), wts / wts.sum(), n)
    # a scalar wavelength draws nothing
    w0 = cls(wavelength=0.5).wavelengths_on_device(make_generator(CPU, 9), 8)
    assert torch.equal(w0, torch.full((8,), 0.5))
    # the map's edges: u = 0 picks the first line, u -> 1 the last nonzero
    u = torch.tensor([0.0, 1.0 - 2.0 ** -53], dtype=torch.float64)
    assert PS._wavelengths_from_uniforms(u, (wls, wts)).tolist() == \
        pytest.approx([0.45, 0.65])


def test_rayfile_draw_frequencies_and_coherence():
    rng = np.random.default_rng(3)
    m = 9
    powers = rng.uniform(0.1, 1.0, m).astype(np.float32)
    powers[4] = 0.0
    data = RayFileData(
        origins=rng.normal(size=(m, 3)).astype(np.float32),
        directions=np.tile(np.float32([0, 0, 1]), (m, 1)),
        powers=powers,
        wavelengths=np.linspace(0.4, 0.8, m).astype(np.float32),
        stokes=rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32))
    src = RayFileSource(data, ray_count=1 << 16, power=2.0)
    n = 1 << 16
    o, d, p, wl, st = src.batch_on_device(make_generator(CPU, 4), n)
    idx = np.argmin(np.abs(o.numpy()[:, None, :]
                           - data.origins[None]).sum(axis=2), axis=1)
    prob = powers.astype(np.float64) / powers.astype(np.float64).sum()
    categorical_ok(np.bincount(idx, minlength=m), prob, n)
    # one draw: wavelengths and Stokes rows belong to the drawn rays
    assert np.array_equal(wl.numpy(), data.wavelengths[idx])
    assert np.array_equal(np.stack([s.numpy() for s in st], 1),
                          data.stokes[idx])
    assert p.dtype == torch.float32 and float(p.sum()) == pytest.approx(2.0)
    o2, d2, p2 = src.rays_on_device(make_generator(CPU, 4), n)
    assert torch.equal(o2, o) and torch.equal(p2, p)
    # the inverse-CDF map itself
    u = torch.tensor([0.0, prob[0] - 1e-12, prob[0] + 1e-12,
                      1.0 - 2.0 ** -53], dtype=torch.float64)
    assert src.draw_indices(u, CPU).tolist() == [0, 0, 1, m - 1]
