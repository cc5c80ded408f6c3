"""The port's jax-free host layer (lightpycl_tpu_torch: materials, geometry,
sources, TraceConfig, build_scene, RayBatch) against the JAX package's:
same inputs, same bits."""

import dataclasses

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu import sources as ref_sources
from lightpycl_tpu.tracer.config import TraceConfig as RefConfig
from lightpycl_tpu_torch import sources as port_sources
from lightpycl_tpu_torch.tracer.config import TraceConfig as PortConfig
from lightpycl_tpu_torch.tracer.rays import RayBatch as PortRays
from lightpycl_tpu_torch.tracer.scene import Scene as PortScene

torch.set_num_threads(1)
CPU = torch.device("cpu")


def intersect_scene(oe):
    """The tests/test_intersect.py scene."""
    return [
        oe.parabolic_mirror(0.5, 2.0),
        oe.hemisphere(4.0),
        oe.cube(0.4, center=(0.6, 0.1, 0.8), material="refractive", ior=1.5),
        oe.biconvex_lens(1.0, 0.8, 0.2, center=(-0.5, 0, 1.0)),
    ]


def assert_same_scene(ref_scene, port_scene):
    for f in ref_scene._fields:
        a, b = getattr(ref_scene, f), getattr(port_scene, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype, f
        assert a.shape == b.shape, f
        assert np.array_equal(a, b, equal_nan=True), f


@pytest.mark.parametrize("spatial_sort", [False, True])
def test_build_scene_bit_exact(spatial_sort):
    rs, rn = L.build_scene(intersect_scene(L.optical_elements(16, 6)),
                           spatial_sort=spatial_sort)
    ps, pn = P.build_scene(intersect_scene(P.optical_elements(16, 6)),
                           spatial_sort=spatial_sort, device=CPU)
    assert rn == pn
    assert_same_scene(rs, ps)


def test_build_scene_detectors_and_padding():
    oe = P.optical_elements(16, 6)
    els = [oe.rectangle(1, 1, material="measure", name="a"),
           oe.disc(0.5, center=(0, 0, 1), material="measure"),
           oe.cube(0.3, material="terminator")]
    ref = [L.optical_elements(16, 6).rectangle(1, 1, material="measure",
                                               name="a"),
           L.optical_elements(16, 6).disc(0.5, center=(0, 0, 1),
                                          material="measure"),
           L.optical_elements(16, 6).cube(0.3, material="terminator")]
    ps, pn = P.build_scene(els, pad_to=128, device=CPU)
    rs, rn = L.build_scene(ref, pad_to=128)
    assert pn == rn == ["a", "detector_1"]
    assert ps.num_triangles_padded % 128 == 0
    assert_same_scene(rs, ps)
    T = sum(e.num_triangles for e in els)
    assert (ps.ww[T:] == 0).all() and (ps.element_id[T:] == -1).all()


def test_scene_from_reference_copies_every_field():
    rs, _ = L.build_scene(intersect_scene(L.optical_elements(16, 6)))
    ps = PortScene.from_reference(rs, CPU)
    assert_same_scene(rs, ps)
    ps.v0[0, 0] = 123.0  # a private, writable copy
    assert float(np.asarray(rs.v0)[0, 0]) != 123.0


PRIMITIVES = {
    "sphere": lambda oe: oe.sphere(1.3, center=(0.1, 0.2, 0.3)),
    "hemisphere": lambda oe: oe.hemisphere(4.0),
    "cube": lambda oe: oe.cube((0.4, 0.5, 0.6), center=(0.6, 0.1, 0.8)),
    "cylinder": lambda oe: oe.cylinder(0.5, 2.0),
    "disc": lambda oe: oe.disc(1.0, center=(0, 0, 1.1), material="measure"),
    "annulus": lambda oe: oe.annulus(0.3, 1.0),
    "aperture_stop": lambda oe: oe.aperture_stop(0.3, 1.0),
    "rectangle": lambda oe: oe.rectangle(4, 3, center=(0, 0, 2)),
    "prism": lambda oe: oe.prism(1.0, 0.8, 0.5),
    "cylindrical_lens": lambda oe: oe.cylindrical_lens(1.0, 0.8),
    "parabolic_mirror": lambda oe: oe.parabolic_mirror(0.5, 2.0, 0.92),
    "spherical_mirror": lambda oe: oe.spherical_mirror(2.0, 1.0),
    "conic_mirror": lambda oe: oe.conic_mirror(2.0, 1.0, k=-1.0,
                                               hole_diameter=0.2),
    "plano_convex_lens": lambda oe: oe.plano_convex_lens(0.5, 0.6, 0.1),
    "biconvex_lens": lambda oe: oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.7),
    "aspheric_lens": lambda oe: oe.aspheric_lens(1.0, -1.2, 0.8, 0.2,
                                                 k1=-0.5, coeffs1=(1e-3,)),
    "fresnel_lens": lambda oe: oe.fresnel_lens(1.0, 0.8, 0.05),
    "axicon": lambda oe: oe.axicon(1.0, 0.3),
    "corner_cube": lambda oe: oe.corner_cube(0.5),
    "zernike_mirror": lambda oe: oe.zernike_mirror(1.0, {4: 1e-3, 7: 2e-4}),
    "zernike_plate": lambda oe: oe.zernike_plate(1.0, 0.2, {5: 1e-3}),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_meshes_identical(name):
    a = PRIMITIVES[name](L.optical_elements(24, 8))
    b = PRIMITIVES[name](P.optical_elements(24, 8))
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.triangles, b.triangles)
    assert int(a.material) == int(b.material)
    assert (a.ior, a.reflectivity, a.name) == (b.ior, b.reflectivity, b.name)


def test_transforms_identical():
    def chain(oe):
        return (oe.biconvex_lens(1.0, 0.8, 0.2).translate((0.1, -0.2, 0.5))
                .rotate((1, 1, 0), 0.3, pivot=(0, 0, 0.5)).scale(1.7))

    a = chain(L.optical_elements(16, 6))
    b = chain(P.optical_elements(16, 6))
    assert np.array_equal(a.vertices, b.vertices)


def test_materials_identical():
    assert [(m.name, int(m)) for m in L.Material] == \
        [(m.name, int(m)) for m in P.Material]
    assert L.glass(1.5168, 64.17) == P.glass(1.5168, 64.17)
    assert P.Material.from_any("lens") == P.Material.REFRACTIVE


def test_trace_config_fields_and_defaults():
    ref = [(f.name, f.default) for f in dataclasses.fields(RefConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(PortConfig)]
    assert ref == port
    assert PortConfig().replace(cull=True).cull is True
    hash(PortConfig())  # frozen, hashable like the reference


SOURCES = {
    "point_isotropic": lambda m: m.light_source(
        center=(0, 0, 0.5), direction=(0, 0, -1), ray_count=500, seed=21),
    "point_directivity": lambda m: m.LightSource(
        direction=(1, 0, 1), ray_count=400, seed=5, polar_max=1.0,
        directivity=lambda az, pol: np.cos(pol) ** 2),
    "point_sampled": lambda m: m.LightSource(
        ray_count=300, seed=6, mode="sampled",
        directivity=lambda az, pol: 1.0 + np.cos(az)),
    "collimated_random": lambda m: m.CollimatedSource(
        center=(0, 0, -0.5), direction=(0, 0, 1), diameter=0.3,
        ray_count=2000, seed=22),
    "collimated_hexapolar_gauss": lambda m: m.CollimatedSource(
        direction=(0, 1, 1), diameter=1.0, ray_count=300,
        sampling="hexapolar", profile="gaussian", waist=0.4),
    "collimated_halton_divergent": lambda m: m.CollimatedSource(
        diameter=0.5, ray_count=300, sampling="halton", divergence=0.05),
    "collimated_random_divergent": lambda m: m.CollimatedSource(
        diameter=0.5, ray_count=300, seed=3, divergence=0.05,
        profile="gaussian", waist=0.2),
    "area_disc": lambda m: m.AreaSource(radius=0.5, ray_count=300, seed=4),
    "area_rect_halton": lambda m: m.AreaSource(
        width=(1.0, 0.5), ray_count=300, sampling="halton",
        emission="isotropic"),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_source_samples_identical(name):
    a = SOURCES[name](ref_sources).sample()
    b = SOURCES[name](port_sources).sample()
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_source_wavelength_spectrum_identical():
    spec = ([0.45, 0.55, 0.65], [1.0, 2.0, 1.0])
    a = ref_sources.LightSource(ray_count=200, wavelength=spec)
    b = port_sources.LightSource(ray_count=200, wavelength=spec)
    assert np.array_equal(a.sample_wavelengths(), b.sample_wavelengths())
    assert np.array_equal(ref_sources.halton_sequence(50, 3),
                          port_sources.halton_sequence(50, 3))


def test_ray_batch_from_arrays_matches_reference():
    src = port_sources.light_source(ray_count=300, seed=2)
    o, d, p = src.sample()
    wl = np.full(300, 0.55)
    ref = L.RayBatch.from_arrays(o, d, p, ior_env=1.2, capacity=512,
                                 wavelengths=wl, stokes=(0.5, 0.0, 0.1))
    port = PortRays.from_arrays(o, d, p, ior_env=1.2, capacity=512,
                                wavelengths=wl, stokes=(0.5, 0.0, 0.1),
                                device=CPU)
    for f in PortRays._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        # the default basis is a cross product + normalization: allow the
        # last ulp (XLA may contract the cross product into FMAs)
        assert np.allclose(a, b, rtol=0, atol=2e-7), f
    assert np.array_equal(np.asarray(ref.alive), port.alive.numpy())


def test_ray_batch_padding_and_reference_copy():
    ref = L.RayBatch.from_arrays(np.zeros((3, 3)), np.tile([0, 0, 1.0],
                                                           (3, 1)),
                                 np.ones(3))
    port = PortRays.from_reference(ref, CPU)
    grown = port.padded_to(8)
    ref_grown = ref.padded_to(8)
    for f in PortRays._fields:
        assert np.array_equal(np.asarray(getattr(ref_grown, f)),
                              getattr(grown, f).numpy()), f
    with pytest.raises(ValueError):
        port.padded_to(2)
