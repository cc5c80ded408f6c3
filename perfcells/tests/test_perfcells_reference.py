"""The plain reference against the program's plain torch path on the CPU,
at tiny sizes: the frozen meshers and samplers give the program's arrays
and rays, the nearest hit agrees, and a whole trace agrees within the
cell's limits."""

import sys
from pathlib import Path

import numpy as np
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
