"""The port's analysis.py against the reference's.

  * Every function is the same numpy code: on the same seeded inputs the
    two must return the same bits (arrays by np.array_equal, floats and
    dicts by ==), one parametrised case per family.
  * The plots (and the compat facade's plots and DXF export) write
    non-empty files; the facade's getters equal the analysis calls.
  * ghost_paths and field_sweep run on a trace of each package: the same
    signatures, labels and counts, and powers / field curves within
    float32 tolerance (TOL below).
"""

import os

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu import analysis as RA
from lightpycl_tpu import paraxial as px
from lightpycl_tpu.sources import CollimatedSource as RefCollimated
from lightpycl_tpu_torch import analysis as PA
from lightpycl_tpu_torch.compat import CL_Tracer
from torch_port_common import assert_same

torch.set_num_threads(1)

# float32 tolerance of two traces of the same rays: per-ray powers and
# positions agree to a few f32 ulps; sums over ~1e3 rays to ~1e-6
TOL = dict(rtol=1e-4, atol=1e-6)


def bundle(n=400, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * [0.1, 0.1, 0.02]
    pos[:, 2] += 1.0
    d = rng.normal(size=(n, 3)) * [0.05, 0.05, 0.0]
    d[:, 2] = 1.0
    # convergent: aim at (0, 0, 1.5) plus a little astigmatism
    d[:, :2] = -pos[:, :2] * [1.8, 2.2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = rng.uniform(0.5, 1.5, n) / n
    stokes = rng.uniform(-0.5, 0.5, (n, 3))
    wl = rng.uniform(0.4, 0.7, n)
    opl = 2.0 + 0.01 * rng.normal(size=n)
    return pos, d, p, stokes, wl, opl


def family_calls(family):
    pos, d, p, stokes, wl, opl = bundle()
    xy = pos[:, :2]
    rng = np.random.default_rng(5)
    field = (rng.normal(size=(16, 16)) + 1j * rng.normal(size=(16, 16)))
    if family == "directivity":
        return [("spherical_angles", (d,), {}),
                ("directivity_histogram", (d, p), {}),
                ("directivity_histogram", (pos, p, 12, 9),
                 dict(solid_angle_normalize=True)),
                ("polar_directivity", (d, p), {}),
                ("polar_directivity", (pos, p, 30),
                 dict(solid_angle_normalize=False)),
                ("spectral_power", (wl, p, np.linspace(0.4, 0.7, 7)), {}),
                ("degree_of_polarization", (stokes, p), {}),
                ("degree_of_polarization", (stokes,), {}),
                ("degree_of_polarization", (stokes[:0], p[:0]), {}),
                ("beam_statistics", (d, p), {}),
                ("beam_statistics", (d[:0], p[:0]), {})]
    if family == "focus":
        return [("spot_diagram", (pos, d, 1.4), {}),
                ("spot_diagram", (pos, d, 1.5, p), {}),
                ("best_focus", (pos, d, p), {}),
                ("best_focus", (pos, d), dict(z_range=(1.2, 1.8), n_scan=31,
                                              refine=4)),
                ("line_foci", (pos, d, p), {}),
                ("line_foci", (pos, d), {}),
                ("encircled_energy", (pos, p), {}),
                ("encircled_energy", (pos, p),
                 dict(center=(0.01, 0.0, 0.0), radii=np.linspace(0, 0.3, 9),
                      plane_normal=(0.1, 0.0, 1.0)))]
    if family == "wavefront":
        return ([("wavefront_error", (opl, p), dict(wavelength=0.55)),
                 ("wavefront_error", (opl,), {}),
                 ("opd_on_reference_sphere", (pos, d, opl, (0, 0, 1.5)), {}),
                 ("opd_on_reference_sphere", (pos, d, opl, (0, 0, 1.5)),
                  dict(radius=0.6, ior_env=1.33))]
                + [("noll_to_nm", (j,), {}) for j in range(1, 23)]
                + [("zernike_value", (j, np.hypot(*xy.T) / 0.4,
                                      np.arctan2(xy[:, 1], xy[:, 0])), {})
                   for j in range(1, 23)]
                + [("zernike_fit", (xy, opl), {}),
                   ("zernike_fit", (xy, opl),
                    dict(n_terms=15, powers=p, radius=0.5))])
    if family == "diffraction":
        return [("geometric_mtf", (xy, p), {}),
                ("geometric_mtf", (xy,), dict(freqs=np.linspace(0, 20, 9),
                                              axis=1)),
                ("pupil_grid", (xy, opl, p), dict(n_grid=16)),
                ("pupil_grid", (xy, opl), dict(n_grid=16, radius=0.2)),
                ("diffraction_psf", (xy, opl - opl.mean(), 0.55, p),
                 dict(n_grid=16, pad=2)),
                ("diffraction_psf", (xy, opl - opl.mean(), 0.55),
                 dict(n_grid=16, pad=2, focal_length=50.0)),
                ("diffraction_mtf", (xy, opl - opl.mean(), 0.55, p),
                 dict(n_grid=16, pad=2, n_freq=12)),
                ("diffraction_mtf", (xy, 0.0 * opl, 0.55),
                 dict(n_grid=16, pad=2, focal_length=50.0, n_freq=12)),
                ("fiber_coupling", (field, 1.0, 0.4), {}),
                ("fiber_coupling", (field, 1.0, 0.4),
                 dict(center=(0.1, -0.05), tilt=(0.01, 0.0),
                      wavelength=0.55))]
    if family == "maps":
        return [("intensity_map", (pos, p), dict(bins=16,
                                                  plane_point=(0, 0, 1.0),
                                                  half_extent=0.4)),
                ("intensity_map", (pos, p),
                 dict(plane_normal=(1.0, 0.0, 0.2), bins=8)),
                ("illuminance_map", (pos, p), dict(bins=8)),
                ("illuminance_map", (pos, p, wl), dict(bins=8,
                                                       half_extent=0.3)),
                ("illuminance_map", (pos, p), dict(lm_per_watt=300.0,
                                                   bins=8)),
                ("decode_path", (float(5 * 7 ** 2 + 2 * 7 + 4), 3), {}),
                ("decode_path", (0.0, 3), {}),
                ("cie_xyz", (wl, p), {}), ("chromaticity", (wl, p), {}),
                ("srgb", (wl, p), {}), ("luminous_efficacy", (wl, p), {}),
                ("cct", (0.31, 0.33), {})]
    raise KeyError(family)


FAMILIES = ["directivity", "focus", "wavefront", "diffraction", "maps"]


@pytest.mark.parametrize("family", FAMILIES)
def test_functions_bit_equal(family):
    calls = family_calls(family)
    for name, args, kw in calls:
        assert_same(getattr(RA, name)(*args, **kw),
                    getattr(PA, name)(*args, **kw), name)
    assert RA.ZERNIKE_NAMES == PA.ZERNIKE_NAMES


def test_every_reference_function_is_ported():
    ref = {n for n in dir(RA) if callable(getattr(RA, n))
           and getattr(getattr(RA, n), "__module__", "") == RA.__name__}
    port = {n for n in dir(PA) if callable(getattr(PA, n))}
    assert ref <= port, sorted(ref - port)


def test_surface_flux_from_each_scene_bit_equal():
    oe_l, oe_p = L.optical_elements(16, 6), P.optical_elements(16, 6)
    els_l = [oe_l.sphere(1.0, material="measure"),
             *L.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5)]
    els_p = [oe_p.sphere(1.0, material="measure"),
             *P.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5)]
    rs, _ = L.build_scene(els_l)
    ps, _ = P.build_scene(els_p, device="cpu")
    T = sum(e.num_triangles for e in els_p)
    flux = np.random.default_rng(2).uniform(0, 1, T)
    assert_same(RA.surface_flux(flux, rs, ["dome", "a", "b"]),
                PA.surface_flux(flux, ps, ["dome", "a", "b"]))
    assert_same(RA.surface_flux(flux, rs), PA.surface_flux(torch.as_tensor(
        flux), ps))


def test_zernike_sag_comes_from_analysis():
    # the primitives' Zernike sag now calls analysis.zernike_value: the
    # mirror's vertices stay the reference's bits
    coeffs = {4: 1e-3, 7: 2e-4, 11: -5e-5}
    a = L.optical_elements(24, 8).zernike_mirror(1.0, coeffs)
    b = P.optical_elements(24, 8).zernike_mirror(1.0, coeffs)
    assert_same(a.vertices, b.vertices)
    from lightpycl_tpu_torch.geometry import primitives

    assert not hasattr(primitives, "zernike_value")


def traced(n=256):
    oe = P.optical_elements(n_segments=24, n_radial=8)
    els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
           oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, center=(0, 0, 1.0),
                            name="lens"),
           oe.hemisphere(radius=6.0, name="dome")]
    tr = CL_Tracer(device="cpu")
    src = P.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                         power=1.0, ray_count=n, seed=3)
    res = tr.iterative_tracer(src, els, trace_iterations=4)
    return tr, res, els


def test_plots_write_files(tmp_path):
    tr, res, els = traced()
    pos, d, p = res.measured_pos, res.measured_dir, res.measured_power
    paths = {}
    for name, call in (
            ("polar", lambda f: PA.plot_measured_directivity(pos, p, path=f)),
            ("d3", lambda f: PA.plot_directivity_3d(pos, p, path=f)),
            ("scene", lambda f: PA.plot_elements_and_rays(
                els + [P.analytic_disc(0.5, vertex=(0, 0, 3.0))],
                res.segments, max_rays=20, path=f)),
            ("cl_polar", lambda f: tr.plot_measured_directivity(path=f)),
            ("cl_d3", lambda f: tr.plot_measured_directivity_3d(path=f)),
            ("cl_scene", lambda f: tr.plot_elements_and_rays(path=f,
                                                            max_rays=10))):
        paths[name] = str(tmp_path / f"{name}.png")
        call(paths[name])
    flux_tr = P.Tracer(P.TraceConfig(flux_map=True), device="cpu")
    flux_tr.trace(P.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                                 ray_count=64, seed=1), els,
                  trace_iterations=3)
    paths["flux"] = str(tmp_path / "flux.png")
    PA.plot_surface_flux(flux_tr.last_result.tri_flux, flux_tr.scene,
                         path=paths["flux"], log_scale=True)
    paths["dxf"] = tr.save_traced_scene(str(tmp_path / "scene.dxf"))
    for name, f in paths.items():
        assert os.path.getsize(f) > 0, name
    assert_same(tr.get_measured_directivity(),
                PA.polar_directivity(pos, p, 45))
    assert_same(tr.get_beam_statistics(), PA.beam_statistics(d, p))


def window(pkg):
    oe = pkg.optical_elements(n_segments=16, n_radial=6)
    win = oe.cube(0.8, material="refractive", ior=1.5)
    win.name = "window"
    return [win, oe.disc(radius=1.2, center=(0, 0, 2.0), material="measure",
                         name="sensor")]


def test_ghost_paths_on_both_traces():
    kw = dict(trace_iterations=8, capacity=32 * 256, track_paths=True,
              dissipation_target=1.0)
    src = dict(center=(0, 0, -2.0), direction=(0, 0, 1), diameter=0.5,
               power=1.0, ray_count=256, seed=4)
    ref = L.Tracer().trace(RefCollimated(**src), window(L), **kw)
    port = P.Tracer(device="cpu").trace(P.CollimatedSource(**src),
                                        window(P), **kw)
    a = RA.ghost_paths(ref, elements=window(L), top=4)
    b = PA.ghost_paths(port, elements=window(P), top=4)
    c = PA.ghost_paths(port, elements=window(P), top=4, detector="sensor")
    assert len(a) == len(b) >= 3 and [r["label"] for r in c] == [
        r["label"] for r in b]
    for x, y in zip(a, b):
        assert (x["signature"], x["path"], x["label"], x["count"]) == (
            y["signature"], y["path"], y["label"], y["count"])
        np.testing.assert_allclose(y["power"], x["power"], **TOL)
        np.testing.assert_allclose(y["fraction"], x["fraction"], **TOL)
    with pytest.raises(ValueError, match="track_paths"):
        PA.ghost_paths(P.Tracer(device="cpu").trace(
            P.CollimatedSource(**src), window(P), trace_iterations=2))


def test_field_sweep_on_both_packages():
    R1, R2, T, N = 0.8, -0.8, 0.2, 1.5
    props = px.system_properties(px.thick_lens(R1, R2, T, N))
    kw = dict(beam_diameter=0.06, z_image=T + props["bfd"], efl=props["efl"],
              source_dist=0.4, ray_count=256, trace_iterations=3, seed=3)
    angles = [0.0, 0.1, -0.1]
    ref = RA.field_sweep(L.analytic_lens(R1, R2, aperture=0.3, thickness=T,
                                         ior=N)
                         + L.analytic_sphere(10.0, material="measure"),
                         angles, **kw)
    port = PA.field_sweep(P.analytic_lens(R1, R2, aperture=0.3, thickness=T,
                                          ior=N)
                          + P.analytic_sphere(10.0, material="measure"),
                          angles, device="cpu", **kw)
    assert list(ref) == list(port)
    assert_same(ref["theta"], port["theta"])
    for k in ref:
        # lengths in units of the 0.06 beam: f32 positions to ~1e-6
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert np.isnan(port["distortion_pct"][0])
