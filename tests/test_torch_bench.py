"""The port's bench (lightpycl_tpu_torch.bench, the counterpart of the root
bench.py) on the CPU at bench.py's CPU sizes (4,096 rays, a (48, 24)
sphere, 2 reps, the bowl at (48, 12)), against the JAX package.

Tolerances: the headline's plain nearest hit against `intersect_jnp` with
identical triangle indices and t within 1e-5 (tests/test_intersect.py's
contract); the config-1 trace against the reference's with the ledger at
rel 1e-5 / abs 1e-6 and the histogram at atol 1e-6
(tests/test_torch_trace.py's bounds); parity at most 1e-3 (BASELINE.md's
0.1%) and the port's detected power within 1e-5 relative of the
reference's on the 4,096 parity rays. bench.py itself is read with `ast`,
never run.
"""

import ast
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
from lightpycl_tpu.tracer.step import intersect_jnp
from lightpycl_tpu_torch import bench as B
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.tracer.engine import Tracer
from lightpycl_tpu_torch.tracer.scene import build_scene
from torch_port_common import CPU, port_default_cpu  # noqa: F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPREADS = {"kernel_ms": B.CPU["reps"], "full_trace_rays_per_s": B.CPU["warm"],
           "bowl_brute_wall_s": B.CPU["bowl_warm"],
           "bowl_cull_wall_s": B.CPU["bowl_warm"]}


@pytest.fixture(scope="module")
def line():
    return B.measure("cpu")


def bench_py_keys():
    """The keys of the dict bench.py prints (its `out = {...}`)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["out"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py prints no `out` dict")


def ref_rays(n):
    """bench.py's rays (bench.py:57-60), drawn here."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def ref_config1():
    oe = L.optical_elements(n_segments=128, n_radial=32)
    return [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.98),
            oe.hemisphere(30.0, name="dome")]


def ref_config1_source(n, seed):
    return L.sources.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                                  power=1.0, ray_count=n, seed=seed)


def test_line_holds_every_key_of_bench_py(line):
    keys = bench_py_keys()
    assert tuple(keys) == B.BENCH_PY_KEYS
    assert set(keys) <= set(line)
    n_tris = L.optical_elements(48, 24).sphere(
        radius=5.0, material="terminator").num_triangles
    assert (line["n_rays"], line["n_triangles"]) == (B.CPU["rays"], n_tris)
    assert (line["backend"], line["device"], line["power_limit"]) == (
        "cpu", "cpu", None)
    assert (line["ray_block"], line["tri_tile"], line["tri_sub"]) == (
        PI.RAY_BLOCK, PI.TRI_TILE, PI.TRI_CHUNK)
    assert line["held_rays"] == B.CPU["rays"]
    assert line["kernel_launches"] == line["cull_kernel_launches"] == 0
    for name, n in SPREADS.items():
        q1, med, q3 = (line[f"{name}_{k}"] for k in ("q1", "median", "q3"))
        assert line[f"{name}_n"] == n
        assert 0 < q1 <= med <= q3, name
    assert line["value"] == pytest.approx(
        B.CPU["rays"] * n_tris / line["kernel_ms_median"] * 1e3)
    assert line["rays_per_sec_full_trace"] >= (
        line["full_trace_rays_per_s_median"])
    assert line["cull_speedup_bowl"] == pytest.approx(
        line["bowl_brute_wall_s_q1"] / line["bowl_cull_wall_s_q1"])


def test_tri_sub_is_the_kernels_stage():
    with open(os.path.join(REPO, "lightpycl_tpu_torch", "csrc",
                           "intersect.cu")) as f:
        chunk = re.search(r"constexpr int kChunk = (\d+);", f.read())
    assert int(chunk.group(1)) == PI.TRI_CHUNK


def test_headline_plain_matches_intersect_jnp():
    n = B.CPU["rays"]
    o, d = B.bench_rays(n, device=CPU)
    o_ref, d_ref = ref_rays(n)
    assert np.array_equal(o.numpy(), o_ref) and np.array_equal(d.numpy(),
                                                               d_ref)
    scene, _ = build_scene([B.headline_sphere(*B.CPU["sphere"])],
                           device=CPU)
    cfg = L.TraceConfig()
    t, tri = PI.nearest_hit_torch(o, d, scene.wu, scene.wv, scene.ww,
                                  cfg.eps, cfg.eps_bary, cfg.max_ray_len)
    big = L.optical_elements(*B.CPU["sphere"]).sphere(
        radius=5.0, material="terminator", name="bigmesh")
    ref_scene, _ = L.build_scene([big])
    t_ref, i_ref = map(np.asarray, intersect_jnp(
        ref_scene, jnp.asarray(o_ref), jnp.asarray(d_ref), cfg))
    assert np.array_equal(tri.numpy(), i_ref)
    hit = np.isfinite(t_ref)
    assert np.allclose(t.numpy()[hit], t_ref[hit], rtol=0, atol=1e-5)


def test_config1_trace_matches_reference():
    n = B.CPU["rays"]
    src, ref_src = B.config1_source(n), ref_config1_source(n, 7)
    for a, b in zip(src.sample(), ref_src.sample()):
        assert np.array_equal(a, b)  # the same rays on both sides
    port = Tracer(device=CPU).trace(src, B.config1_elements(),
                                    trace_iterations=8, mode="device")
    ref = L.Tracer().trace(ref_src, ref_config1(), trace_iterations=8,
                           mode="device")
    assert port.iterations_run == ref.iterations_run
    for k, v in ref.ledger.items():
        assert port.ledger[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    assert np.allclose(port.hist, ref.hist, rtol=0, atol=1e-6)


def test_parity_and_detected_power_match_reference(line):
    assert line["detected_power_parity_rel_err"] <= 1e-3
    src = ref_config1_source(B.PARITY_RAYS, 9)
    org, dr, pw = src.sample()
    ref = L.Tracer().trace(src, ref_config1(), trace_iterations=6,
                           rays=L.RayBatch.from_arrays(org, dr, pw))
    assert line["parity_measured"] == pytest.approx(
        ref.ledger["measured"], rel=1e-5)


def test_without_a_card_the_command_exits_nonzero():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "lightpycl_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "needs an NVIDIA GPU" in proc.stderr


def test_a_failed_check_exits_nonzero(monkeypatch, capsys):
    """The plain version with one triangle index flipped: the headline's
    hold to it fails, and the bench exits non-zero with no line."""
    def flipped(*args, **kw):
        t, tri = PI.nearest_hit_torch(*args, **kw)
        tri = tri.clone()
        tri[0] += 1
        return t, tri

    monkeypatch.setattr(B, "nearest_hit_torch", flipped)
    assert B.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "check failed: headline" in out.err
    assert "1 triangle indices" in out.err
