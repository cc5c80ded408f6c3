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


SPECTRAL_ANALYSIS = ("spectral_power", "cie_xyz_cmf", "cie_xyz",
                     "luminous_flux", "luminous_efficacy", "chromaticity",
                     "srgb")


@pytest.mark.parametrize("name", SPECTRAL_ANALYSIS)
def test_spectral_analysis_identical(name):
    # a white-ish bundle: a blue pump line and a broad phosphor hump
    from lightpycl_tpu import analysis as ref_analysis
    from lightpycl_tpu_torch import analysis as port_analysis

    rng = np.random.default_rng(4)
    wl = np.concatenate([np.full(200, 0.45), rng.normal(0.58, 0.05, 800)])
    pw = rng.uniform(0.5, 1.5, wl.size) / wl.size
    args = {"spectral_power": (wl, pw, np.linspace(0.38, 0.78, 9)),
            "cie_xyz_cmf": (wl,)}.get(name, (wl, pw))
    a = getattr(ref_analysis, name)(*args)
    b = getattr(port_analysis, name)(*args)
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x, np.float64),
                              np.asarray(y, np.float64)), name
    # the corner cases: an empty bundle and a zero-power one
    if name in ("luminous_efficacy", "chromaticity"):
        for w_, p_ in ((wl[:0], pw[:0]), (wl, 0.0 * pw)):
            assert (getattr(ref_analysis, name)(w_, p_)
                    == getattr(port_analysis, name)(w_, p_))


def test_cct_and_gauss_identical():
    from lightpycl_tpu import analysis as ref_analysis
    from lightpycl_tpu_torch import analysis as port_analysis

    xy = np.random.default_rng(5).uniform(0.25, 0.45, (64, 2))
    assert np.array_equal(ref_analysis.cct(xy[:, 0], xy[:, 1]),
                          port_analysis.cct(xy[:, 0], xy[:, 1]))
    lam = np.linspace(350.0, 800.0, 91)
    assert np.array_equal(ref_analysis._pw_gauss(lam, 568.8, 46.9, 40.5),
                          port_analysis._pw_gauss(lam, 568.8, 46.9, 40.5))


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


ANALYTIC = {
    "conic_surface": lambda m: m.conic_surface(
        0.5, -0.3, r_max=0.8, r_min=0.1, vertex=(0.1, 0, 1), axis=(0, 1, 1),
        material="mirror"),
    "cylinder_surface": lambda m: m.cylinder_surface(
        0.4, -0.2, 0.5, vertex=(0, 0.2, 0), axis=(1, 0, 0)),
    "analytic_mirror": lambda m: m.analytic_mirror(
        1.0, 2.0, k=-1.0, reflectivity=0.9, center=(0, 0.1, 0.2)),
    "analytic_disc": lambda m: m.analytic_disc(3.0, vertex=(0, 0, 1.4),
                                               name="det"),
    "analytic_annulus": lambda m: m.analytic_annulus(0.3, 1.0,
                                                     vertex=(0, 0, 0.5)),
    "transformed": lambda m: m.analytic_mirror(2.0, 1.0).translate(
        (0.1, 0.2, 0.3)).rotate((1, 0, 0), 0.4).scale(1.5),
}
ANALYTIC_LENSES = {
    "analytic_lens": lambda m: m.analytic_lens(1.0, -1.5, 0.8, 0.2, ior=1.6,
                                               k1=-0.5, center=(0, 0, 1)),
    "plano_convex": lambda m: m.analytic_plano_convex_lens(0.5, 0.4, 0.05),
    "biconvex": lambda m: m.analytic_biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
    "sphere": lambda m: m.analytic_sphere(5.0, center=(0, 0, 1)),
}
QUAD_FIELDS = ("quad_abgd", "quad_rlim", "quad_zlim", "quad_vertex",
               "quad_frame")


def assert_same_surface(a, b):
    assert type(a).__name__ == type(b).__name__ == "AnalyticSurface"
    for f in QUAD_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.triangles, b.triangles)
    assert int(a.material) == int(b.material)
    assert (a.ior, a.reflectivity, a.name) == (b.ior, b.reflectivity, b.name)


@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_analytic_surfaces_identical(name):
    assert_same_surface(ANALYTIC[name](L), ANALYTIC[name](P))


@pytest.mark.parametrize("name", sorted(ANALYTIC_LENSES))
def test_analytic_lenses_identical(name):
    a, b = ANALYTIC_LENSES[name](L), ANALYTIC_LENSES[name](P)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert_same_surface(x, y)


def test_analytic_to_mesh_identical():
    a = L.analytic_mirror(2.0, 1.0, k=-0.5).to_mesh(16, 6)
    b = P.analytic_mirror(2.0, 1.0, k=-0.5).to_mesh(16, 6)
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.triangles, b.triangles)


@pytest.mark.parametrize("spatial_sort", [False, True])
def test_build_scene_quad_tables_bit_exact(spatial_sort):
    """A mesh lens between analytic surfaces: the quad_* tables, the
    zeroed placeholder rows and quad_tri under both triangle orders."""
    def els(m):
        oe = m.optical_elements(16, 6)
        return [*m.analytic_biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
                oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate(
                    (0, 0, 0.5)),
                m.analytic_mirror(2.0, 1.0, center=(0, 0, 3.0)),
                *m.analytic_sphere(6.0, name="world")]

    rs, rn = L.build_scene(els(L), spatial_sort=spatial_sort)
    ps, pn = P.build_scene(els(P), spatial_sort=spatial_sort, device=CPU)
    assert rn == pn
    assert_same_scene(rs, ps)
    assert ps.quad_abgd.shape == (6, 4) and ps.quad_frame.shape == (6, 3, 3)
    assert not ps.ww[ps.quad_tri.long()].any()


def test_build_scene_optional_tables_bit_exact():
    """Fluorescence and GRIN tables, coating stacks of unequal depth and
    every optional per-triangle column."""
    def els(m):
        oe = m.optical_elements(8, 4)
        return [
            oe.cube((1.2, 1.2, 1.0), center=(0, 0, 1.5),
                    material="refractive", ior=1.6, grin_a=4.0,
                    axis=(0, 0, 1), grin_center=(0, 0, 1.0)),
            oe.cube((2.0, 2.0, 1.0), center=(3, 0, 1.5),
                    material="refractive", ior=1.2, fluorescence=1.5,
                    fluor_yield=0.8, fluor_emission=(0.60, 0.05),
                    fluor_edge=0.5, scattering=0.5, scatter_g=0.7),
            oe.biconvex_lens(1.0, 0.8, 0.3, center=(0, 3, 1),
                             coating=[(1.38, 0.1), (2.1, 0.05)]),
            oe.rectangle(1, 1, center=(0, -3, 1), material="mirror",
                         metal_n=0.2, metal_k=3.4, roughness=0.02),
            oe.rectangle(1, 1, center=(-3, 0, 1), material="grating",
                         axis=(1, 0, 0), grating_period=1.0,
                         order0_fraction=0.1),
            oe.cube(0.5, center=(0, 0, 4), material="birefringent",
                    ior=1.658, ne=1.486, axis=(1, 0, 0)),
            oe.disc(0.5, center=(0, 0, -2), material="waveplate",
                    axis=(1, 1, 0), retardance=1.2),
        ]

    rs, _ = L.build_scene(els(L), spatial_sort=True)
    ps, _ = P.build_scene(els(P), spatial_sort=True, device=CPU)
    assert_same_scene(rs, ps)
    assert ps.grin_wu.shape[0] % 128 == 0 and ps.fluor_icdf.shape[0] == 7
