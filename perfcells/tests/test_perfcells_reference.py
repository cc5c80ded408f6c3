"""The plain reference against the program's plain torch path on the CPU,
at tiny sizes: the frozen meshers and samplers give the program's arrays
and rays, the nearest hit agrees, and a whole trace agrees within the
cell's limits."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfcells.entries import _common  # noqa: E402
from perfcells.harness import catalog, verdict  # noqa: E402
from perfcells.harness.scene import element_arrays, program_elements  # noqa: E402
from perfcells.reference import sampling  # noqa: E402
from perfcells.reference import trace as ref_trace  # noqa: E402
from perfcells.reference.nearest_hit import nearest_hit  # noqa: E402


def _tiny(config_name, sizes):
    c = catalog.load_json("configs", config_name)
    for el, (seg, rad) in zip(c["elements"], sizes):
        el["params"].update(n_segments=seg, n_radial=rad)
    return c


def test_frozen_meshers_equal_the_programs():
    from lightpycl_tpu_torch.geometry.primitives import optical_elements

    arr = element_arrays(_tiny("config1_collimator", [(24, 8), (20, 5)]))
    mirror = optical_elements(24, 8).parabolic_mirror(0.5, 2.0)
    dome = optical_elements(20, 5).hemisphere(50.0)
    for a, ref in zip(arr, (mirror, dome)):
        assert np.array_equal(a["vertices"], ref.vertices)
        assert np.array_equal(a["triangles"], ref.triangles)


def test_point_source_redraw_equals_the_programs():
    light = catalog.load_json("configs", "config1_collimator")["light"]
    o, d, p = _common.program_source(light, 5000, 2**31 + 99).sample()
    ro, rd, rp = sampling.point_source_rays(
        light["center"], light["direction"], light["directivity"],
        light["power"], 5000, 2**31 + 99)
    assert np.array_equal(o, ro) and np.array_equal(d, rd)
    assert np.array_equal(p, rp)


def test_collimated_redraw_follows_the_programs_device_sampler():
    from lightpycl_tpu_torch.tracer.step import make_generator

    light = catalog.load_json("configs", "config4_large_mesh")["light"]
    src = _common.program_source(light, 4096, 0)
    seed, b = 2**33 + 5, 3
    o, d, _ = src.rays_on_device(make_generator("cpu", seed, b, 0), 4096)
    u1, u2 = sampling.collimated_uniforms("cpu", seed, b, 4096)
    ro, rd, _ = sampling.collimated_rays(light["center"], light["direction"],
                                         light["diameter"], light["power"],
                                         u1, u2)
    assert torch.allclose(o.double(), ro, atol=1e-6)
    assert torch.equal(d.double(), rd)


def test_nearest_hit_agrees_with_the_programs_plain_version():
    from lightpycl_tpu_torch.ops.intersect import nearest_hit_torch
    from lightpycl_tpu_torch.tracer.scene import build_scene

    config = _tiny("config1_collimator", [(32, 8), (24, 6)])
    arr = element_arrays(config)
    scene, _ = build_scene(program_elements(arr), device="cpu")
    g = torch.Generator().manual_seed(5)
    o = torch.rand((3000, 3), generator=g) * 2 - 1
    o[:, 2] = o[:, 2] * 0.4 + 0.2
    d = torch.nn.functional.normalize(torch.randn((3000, 3), generator=g),
                                      dim=1)
    opts = _common.opts(config)
    t, tri = nearest_hit_torch(o, d, scene.wu, scene.wv, scene.ww,
                               opts["eps"], opts["eps_bary"],
                               opts["max_ray_len"])
    ref = ref_trace.scene_arrays(arr, "cpu")
    idx = verdict.TriangleIndex(ref).lookup(torch.cat(
        [scene.v0, scene.e1, scene.e2], 1)[tri.clamp_min(0).long()].numpy())
    idx = torch.where(tri >= 0, torch.as_tensor(idx), -1)
    bad, n = verdict.judge_rays(o.double(), d.double(), t.double(), idx,
                                ref, opts)
    assert n == 3000 and bad == 0
    # the bfloat16 control is refuted on most rays
    t_c, i_c = nearest_hit(o.double(), d.double(), ref["v0"], ref["e1"],
                           ref["e2"], opts["eps"], opts["eps_bary"],
                           opts["max_ray_len"], dtype=torch.bfloat16)
    assert verdict.judge_rays(o.double(), d.double(), t_c, i_c, ref,
                              opts)[0] > n // 2


def test_whole_trace_agrees_with_the_programs_plain_path():
    from lightpycl_tpu_torch.tracer.engine import Tracer

    config = _tiny("config1_collimator", [(32, 8), (24, 6)])
    arr = element_arrays(config)
    kw = _common.program_overrides(config)
    src = _common.program_source(config["light"], 4096, 2**31 + 3)
    res = Tracer(device="cpu").trace(src, program_elements(arr),
                                     mode="device", backend="torch", **kw)
    seen = _common.outcome(res.ledger, res.final_live_power,
                           res.per_detector, res.hist, 1.0)
    o, d, p = sampling.point_source_rays(
        config["light"]["center"], config["light"]["direction"],
        config["light"]["directivity"], 1.0, 4096, 2**31 + 3)
    r = ref_trace.trace(*(torch.as_tensor(x) for x in (o, d, p)),
                        ref_trace.scene_arrays(arr, "cpu"),
                        _common.opts(config))
    want = _common.outcome(dict(r, culled=0.0), r["live"], r["per_detector"],
                           r["hist"], 1.0)
    limits = catalog.load_json("workloads",
                               "config1.rays_100k")["check"]["limits"]
    g = verdict.gaps(seen, want)
    assert all(g[k] <= limits[k] for k in g), g
    assert r["bounces"] == res.iterations_run


# -- dielectrics: Snell refraction and the Fresnel split ---------------------

def _quad(corners, material, name, ior=1.0):
    """A flat element of two triangles over four corners in order; its
    outward normal is (c1 - c0) x (c2 - c0)."""
    return {"vertices": np.asarray(corners, np.float64),
            "triangles": np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            "material": material, "reflectivity": 1.0, "ior": ior,
            "name": name}


def _opts(iterations, **kw):
    o = {"eps": 1e-4, "eps_bary": 1e-6, "max_ray_len": 1e3,
         "iterations": iterations, "dissipation_target": 2.0,
         "hist_azimuth_bins": 4, "hist_polar_bins": 2,
         "hist_center": (0.0, 0.0, 0.0), "ior_env": 1.0,
         "power_cutoff": 0.0}
    o.update(kw)
    return o


def _beam(n, z0, seed, x=(-0.4, 0.4), y=(-0.4, 0.4)):
    """n rays along +z from the plane z0, uniform over the box x by y,
    powers summing to 1."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 2), generator=g, dtype=torch.float64)
    lo, hi = torch.tensor([x[0], y[0]]), torch.tensor([x[1], y[1]])
    xy = lo + u * (hi - lo)
    o = torch.cat([xy, torch.full((n, 1), z0, dtype=torch.float64)], 1)
    d = torch.zeros((n, 3), dtype=torch.float64)
    d[:, 2] = 1.0
    return o, d, torch.full((n,), 1.0 / n, dtype=torch.float64)


def test_slab_at_normal_incidence_splits_by_fresnel():
    """A glass slab (n = 1.5, faces at z = 0 and 0.1) between two
    detectors: after 3 bounces the front detector holds the first
    surface's reflectance R = ((n - 1) / (n + 1))^2 and the back one the
    power straight through, (1 - R)^2."""
    n = 1.5
    slab = {"vertices": np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0],
         [-1, -1, .1], [1, -1, .1], [1, 1, .1], [-1, 1, .1]], np.float64),
        "triangles": np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]],
                              np.int32),
        "material": "refractive", "reflectivity": 1.0, "ior": n,
        "name": "slab"}
    front = _quad([[-2, -2, -1], [2, -2, -1], [2, 2, -1], [-2, 2, -1]],
                  "measure", "front")
    back = _quad([[-2, -2, 1], [2, -2, 1], [2, 2, 1], [-2, 2, 1]],
                 "measure", "back")
    scene = ref_trace.scene_arrays([slab, front, back], "cpu")
    r = ref_trace.trace(*_beam(512, -0.5, 1), scene, _opts(3))
    R = ((n - 1) / (n + 1)) ** 2
    assert abs(r["per_detector"][0] - R) < 1e-12
    assert abs(r["per_detector"][1] - (1 - R) ** 2) < 1e-12


def test_total_internal_reflection_has_no_transmitted_child():
    """Rays enter a glass wedge (n = 1.5) head on at z = 0, then meet its
    face x + z = 0.5 from inside at 45 degrees, past the critical angle
    (41.8): all their power reflects and no transmitted child is made
    (a cutoff below 0 keeps zero-power children, so one would show)."""
    n = 1.5
    entry = _quad([[-1, -1, 0], [-1, 1, 0], [.5, 1, 0], [.5, -1, 0]],
                  "refractive", "entry", ior=n)
    slope = _quad([[.5, -1, 0], [.5, 1, 0], [-1, 1, 1.5], [-1, -1, 1.5]],
                  "refractive", "slope", ior=n)
    scene = ref_trace.scene_arrays([entry, slope], "cpu")
    normals = torch.linalg.cross(scene["e1"], scene["e2"])
    assert (normals[:2, 2] < 0).all() and (normals[2:, 0] > 0).all()
    o, d, p = _beam(256, -0.5, 2, x=(-0.5, -0.25), y=(-0.25, 0.25))
    r = ref_trace.trace(o, d, p, scene, _opts(2, power_cutoff=-1.0))
    R0 = ((n - 1) / (n + 1)) ** 2
    assert r["live_rays"] == 256  # one TIR child a ray
    assert abs(r["live"] - (1 - R0)) < 1e-12
    assert abs(r["escaped"] - R0) < 1e-12
    # the split itself, at the slope, for a ray inside the glass
    nrm = torch.nn.functional.normalize(torch.tensor([[1.0, 0, 1.0]],
                                                     dtype=torch.float64))
    R, _, _, tir = ref_trace.dielectric(
        d[:1], -nrm, torch.tensor([False]), torch.tensor([n],
                                                         dtype=torch.float64),
        torch.tensor([n], dtype=torch.float64), 1.0)
    assert bool(tir[0]) and float(R[0]) == 1.0


def _lens_stack(n_segments, n_radial):
    """Config 3's elements (benchmarks/baseline_configs.py, configs[2]):
    two biconvex lenses and a measuring sphere, from the port's meshers,
    as the reference's element dicts and as the port's GeoObjects."""
    from lightpycl_tpu_torch.geometry.primitives import optical_elements

    oe = optical_elements(n_segments, n_radial)
    els = [oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, name="l1"),
           oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7,
                            name="l2").translate((0, 0, 0.5)),
           oe.sphere(radius=6.0, material="measure", name="enclosure")]
    arr = [{"vertices": e.vertices, "triangles": e.triangles,
            "material": m, "reflectivity": 1.0, "ior": float(e.ior),
            "name": e.name}
           for e, m in zip(els, ("refractive", "refractive", "measure"))]
    return arr, els


def _stack_beam(n, seed):
    u1, u2 = sampling.collimated_uniforms("cpu", seed, 0, n)
    return sampling.collimated_rays((0.0, 0.0, -0.5), (0.0, 0.0, 1.0), 0.5,
                                    1.0, u1, u2)


def test_split_trace_conserves_power():
    arr, _ = _lens_stack(12, 4)
    o, d, p = _stack_beam(1024, 2**31 + 41)
    r = ref_trace.trace(o, d, p, ref_trace.scene_arrays(arr, "cpu"),
                        _opts(5, power_cutoff=1e-7))
    assert r["culled"] > 0 and r["live"] > 0 and r["measured"] > 0.5
    total = sum(r[k] for k in ("measured", "absorbed", "escaped", "culled",
                               "live"))
    assert abs(total - r["emitted"]) <= 1e-12 * r["emitted"]


def test_split_trace_agrees_with_the_ports_float64_oracle():
    """Config 3's stack at n_segments 16, n_radial 6, 2,048 collimated
    rays, 5 bounces, no cutoff and no capacity (the oracle keeps every
    child too): every ledger term and detector within 1e-9 of emitted."""
    from lightpycl_tpu_torch.tracer.oracle import trace_oracle

    arr, els = _lens_stack(16, 6)
    o, d, p = _stack_beam(2048, 2**31 + 43)
    opts = _opts(5)
    r = ref_trace.trace(o, d, p, ref_trace.scene_arrays(arr, "cpu"), opts)
    w = trace_oracle(els, o.numpy(), d.numpy(), p.numpy(),
                     trace_iterations=5, max_ray_len=opts["max_ray_len"],
                     ior_env=1.0, eps=opts["eps"], eps_bary=opts["eps_bary"],
                     power_cutoff=0.0)
    e = r["emitted"]
    for k in ("measured", "absorbed", "escaped", "culled", "live"):
        assert abs(r[k] - w[k]) <= 1e-9 * e, (k, r[k], w[k])
    det = np.bincount(w["measured_det"], weights=w["measured_power"],
                      minlength=1)
    assert np.abs(r["per_detector"] - det).max() <= 1e-9 * e
    assert r["live"] > 1e-3  # light is still split inside the glass


def test_capacity_keeps_the_strongest_children_and_culls_the_rest():
    """With a capacity under the children a bounce makes, the reference
    keeps that many, the strongest, books the others' power as culled and
    still accounts for every bit of power; without one it keeps them all."""
    arr, _ = _lens_stack(12, 4)
    o, d, p = _stack_beam(512, 2**31 + 47)
    scene = ref_trace.scene_arrays(arr, "cpu")
    free = ref_trace.trace(o, d, p, scene, _opts(3))
    assert free["live_rays"] > 1024 and free["culled"] == 0
    r = ref_trace.trace(o, d, p, scene, _opts(3), capacity=1024)
    assert r["live_rays"] == 1024 and r["culled"] > 0
    total = sum(r[k] for k in ("measured", "absorbed", "escaped", "culled",
                               "live"))
    assert abs(total - r["emitted"]) <= 1e-12 * r["emitted"]
    # one bounce into the first lens: each ray's transmitted child carries
    # about 96% of its power, its reflected child the rest; a capacity of
    # one child a ray keeps the transmitted ones
    one = ref_trace.trace(o, d, p, scene, _opts(1), capacity=512)
    assert one["live_rays"] == 512 and one["live"] > 0.9
    assert abs(one["live"] + one["culled"] - 1.0) <= 1e-12


def test_reference_refuses_a_material_it_does_not_follow():
    el = _quad([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], "diffuse",
               "screen")
    with pytest.raises(ValueError, match="diffuse"):
        ref_trace.scene_arrays([el], "cpu")
