"""The port's float64 oracle (lightpycl_tpu_torch/tracer/oracle.py and its
native core) against the reference's, and the port's traces against it.

  * trace_oracle is the same numpy code in both packages: on the same
    elements and rays it must give the same bits, on the native (g++) path
    and on the numpy path alike, over mesh, quadric and film-coated scenes
    (metals, a grating, a beamsplitter, dispersion and bulk absorption
    ride along).
  * The port's Tracer(device="cpu").trace on BASELINE configs 1-3 lands
    within 0.1% of the port's oracle: tests/test_parity_oracle.py, run
    on the port.
"""

import contextlib

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu.native as ref_native
import lightpycl_tpu_torch as P
import lightpycl_tpu_torch.native as port_native
from lightpycl_tpu.tracer import oracle as ref_oracle
from lightpycl_tpu_torch.tracer import oracle as port_oracle
from lightpycl_tpu_torch.tracer.parity import PARITY, parity_config
from torch_port_common import assert_same

torch.set_num_threads(1)


@contextlib.contextmanager
def numpy_path():
    """Both packages' oracles without their native core (what a machine
    without g++ runs)."""
    saved = [(m, m._lib, m._tried) for m in (ref_native, port_native)]
    for m in (ref_native, port_native):
        m._lib, m._tried = None, True
    try:
        yield
    finally:
        for m, lib, tried in saved:
            m._lib, m._tried = lib, tried


def mesh_scene(pkg):
    oe = pkg.optical_elements(n_segments=24, n_radial=8)
    metal = oe.rectangle(1.2, 1.2, center=(1.5, 0, 1.0), material="mirror",
                         metal_n=0.13, metal_k=3.9)
    grating = oe.rectangle(1.0, 1.0, center=(-1.5, 0, 1.0),
                           material="grating", reflectivity=0.9,
                           axis=(1.0, 0.0, 0.0), grating_period=1.2,
                           grating_order=1, order0_fraction=0.1)
    glass = oe.cube(0.5, center=(0.0, 0.6, 0.8), material="refractive",
                    ior=1.6)
    glass.dispersion_b, glass.absorption = 0.01, 0.3
    return [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.92), metal, grating,
            glass,
            oe.rectangle(1.0, 1.0, center=(0, -0.8, 1.2),
                         material="beamsplitter", reflectivity=0.4),
            oe.hemisphere(radius=6.0, name="dome")]


def quadric_scene(pkg):
    return [*pkg.analytic_plano_convex_lens(0.5, 0.6, 0.1, ior=1.5),
            pkg.analytic_disc(1.0, vertex=(0, 0, 1.1), name="det"),
            pkg.optical_elements(16, 6).sphere(radius=8.0,
                                               material="terminator")]


def coated_scene(pkg):
    oe = pkg.optical_elements(n_segments=24, n_radial=8)
    return [oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, center=(0, 0, 0.5),
                             coating=[(1.38, 0.10), (2.1, 0.05)]),
            oe.cube((0.6, 0.6, 0.2), center=(0, 0, 1.4),
                    material="refractive", ior=1.52, coat_ior=1.38,
                    coat_thickness=0.1),
            oe.sphere(radius=6.0, material="measure", name="enclosure")]


SCENES = {"mesh": mesh_scene, "quadric": quadric_scene,
          "coated": coated_scene}


def seeded_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3))
    o[:, :2] = rng.uniform(-0.4, 0.4, (n, 2))
    o[:, 2] = -0.5 + rng.uniform(-0.05, 0.05, n)
    d = rng.normal(size=(n, 3)) * [0.3, 0.3, 0.0]
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a quarter of the bundle points back down, onto the mirror side
    d[: n // 4, 2] *= -1.0
    o[: n // 4, 2] = 1.5
    p = rng.uniform(0.5, 1.5, n) / n
    wl = rng.uniform(0.45, 0.65, n)
    return o, d, p, wl


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_trace_oracle_bit_equal(scene, path):
    o, d, p, wl = seeded_rays(384, seed=len(scene))
    kw = dict(trace_iterations=6, power_cutoff=1e-7, wavelengths=wl)
    ctx = numpy_path() if path == "numpy" else contextlib.nullcontext()
    with ctx:
        assert port_native.backend() == path
        assert (ref_native.get_lib() is not None) == (path == "native")
        ref = ref_oracle.trace_oracle(SCENES[scene](L), o, d, p, **kw)
        port = port_oracle.trace_oracle(SCENES[scene](P), o, d, p, **kw)
    assert len(port["measured_power"]) > 0 and port["measured"] > 0
    assert_same(ref, port)


def test_native_nearest_hit_bit_equal_and_close_to_numpy():
    els = mesh_scene(P)
    tv = np.concatenate([e.triangle_vertices() for e in els])
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    rng = np.random.default_rng(7)
    o = rng.uniform(-1, 1, (500, 3))
    d = rng.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = (o, d, v0, e1, e2, 1e-4, 1e-6, 1e3)
    assert port_native.backend() == "native"
    t_p, i_p = port_native.mt_nearest_hit_native(*args)
    t_r, i_r = ref_native.mt_nearest_hit_native(*args)
    assert_same((t_r, i_r), (t_p, i_p))
    with numpy_path():
        t_n, i_n = port_oracle._mt_nearest_hit(*args)
    assert (i_n == i_p).all() and (i_p >= 0).sum() > 100
    fin = np.isfinite(t_p)
    assert np.allclose(t_n[fin], t_p[fin], rtol=1e-12, atol=1e-12)
    assert port_native.library_path().parent.name == "build"


def test_film_and_quadric_helpers_bit_equal():
    rng = np.random.default_rng(3)
    n = 64
    cos_i = rng.uniform(0.2, 1.0, n)
    n1 = np.full(n, 1.0)
    stack_n = rng.uniform(1.3, 2.3, (n, 3))
    stack_h = rng.uniform(0.0, 0.2, (n, 3))
    n2 = rng.uniform(1.4, 1.8, n)
    wl = rng.uniform(0.4, 0.7, n)
    assert_same(ref_oracle._film_reflectance_matrix(cos_i, n1, stack_n,
                                                    stack_h, n2, wl),
                port_oracle._film_reflectance_matrix(cos_i, n1, stack_n,
                                                     stack_h, n2, wl))
    lens = P.analytic_plano_convex_lens(0.5, 0.6, 0.1, ior=1.5)
    quads = [(i, np.asarray(e.quad_abgd, np.float64),
              np.asarray(e.quad_rlim, np.float64),
              np.asarray(e.quad_zlim, np.float64),
              np.asarray(e.quad_vertex, np.float64),
              np.asarray(e.quad_frame, np.float64))
             for i, e in enumerate(lens)]
    o, d, _, _ = seeded_rays(256, seed=9)
    assert_same(ref_oracle._quadric_nearest_hit(o, d, quads, 1e-4, 1e-6, 1e3),
                port_oracle._quadric_nearest_hit(o, d, quads, 1e-4, 1e-6,
                                                 1e3))


def test_oracle_refusals_match():
    for mk in (lambda pkg: pkg.optical_elements(8, 4).disc(
                   0.5, material="diffuse"),
               lambda pkg: pkg.optical_elements(8, 4).disc(
                   0.5, material="polarizer", axis=(1.0, 0.0, 0.0))):
        msgs = []
        for pkg, mod in ((L, ref_oracle), (P, port_oracle)):
            with pytest.raises(ValueError) as e:
                mod.trace_oracle([mk(pkg)], np.zeros((1, 3)),
                                 np.array([[0, 0, 1.0]]), np.ones(1))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---- the port's traces against the port's oracle (configs 1-3) -----------

oe = P.optical_elements(n_segments=32, n_radial=12)


def run_both(els, src, iters, capacity=None, power_cutoff=0.0):
    origins, dirs, powers = src.sample()
    res = P.Tracer(device="cpu").trace(
        src, els, trace_iterations=iters, capacity=capacity,
        power_cutoff=power_cutoff,
        rays=P.RayBatch.from_arrays(origins, dirs, powers, capacity=capacity,
                                    device="cpu"))
    ora = port_oracle.trace_oracle(els, origins, dirs, powers,
                                   trace_iterations=iters,
                                   power_cutoff=power_cutoff)
    return res, ora


def run_config(k, ray_count):
    els, src, iters, per_ray = parity_config(k, ray_count)
    return run_both(els, src, iters, capacity=per_ray * ray_count)


def test_config1_parabolic_collimator():
    res, ora = run_config(1, 3000)
    assert res.ledger["measured"] == pytest.approx(ora["measured"], rel=PARITY)
    assert res.ledger["absorbed"] == pytest.approx(ora["absorbed"],
                                                   rel=PARITY, abs=1e-6)


def test_config2_plano_convex():
    res, ora = run_config(2, 2000)
    assert res.ledger["measured"] == pytest.approx(ora["measured"], rel=PARITY)
    assert res.ledger["escaped"] == pytest.approx(ora["escaped"], rel=5e-3,
                                                  abs=1e-5)


def test_config3_lens_stack_with_splitting():
    res, ora = run_config(3, 1000)
    assert res.ledger["measured"] == pytest.approx(ora["measured"], rel=PARITY)
    assert res.per_detector[0] == pytest.approx(ora["measured"], rel=PARITY)


def test_measured_ray_positions_match():
    els = [oe.rectangle(4, 4, center=(0, 0, 2), material="measure")]
    src = P.CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                             diameter=1.0, ray_count=500, seed=24)
    res, ora = run_both(els, src, iters=1)
    a = res.measured_pos[np.lexsort(res.measured_pos.T)]
    b = ora["measured_pos"][np.lexsort(ora["measured_pos"].T)]
    assert np.allclose(a, b, atol=1e-5)
