"""The GRIN sub-step path's own-surface check (tracer/step.py
`nearest_t_rows`) on the CPU: it goes through the nearest hit's dispatcher
(`ops.intersect.nearest_hit` on cfg.backend), so on the card it launches
the kernel, and here, where the dispatcher runs the plain version, it
equals `nearest_hit_torch`'s t bit for bit on the rod's own rows.

test_torch_shade_volume.py ("grin-substeps*") and
test_torch_trace_physics.py hold the sub-stepped shade and trace against
the JAX package."""

import numpy as np
import pytest
import torch

import lightpycl_tpu_torch as P
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.tracer import step as S
from lightpycl_tpu_torch.tracer.scene import build_scene

torch.set_num_threads(1)
CPU = torch.device("cpu")
LENGTH = 1.2


def rod_scene():
    oe = P.optical_elements(16, 6)
    rod = oe.cube((1.2, 1.2, LENGTH), center=(0, 0, 1.0 + LENGTH / 2),
                  material="refractive", ior=1.6, grin_a=4.0,
                  axis=(0, 0, 1), grin_center=(0, 0, 1.0))
    screen = oe.rectangle(width=10.0, depth=10.0,
                          center=(0, 0, 1.0 + LENGTH + 5e-3),
                          material="measure", name="exit")
    world = oe.sphere(radius=20.0, material="measure", name="world")
    return [rod, screen, world]


def rays(kind, n=3000, seed=0):
    """Rays as the sub-step loop gives them: inside the rod, along its
    axis and skewed; or outside it, most missing the rod."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.55, 0.55, n), rng.uniform(-0.55, 0.55, n),
                  rng.uniform(1.01, 1.0 + LENGTH - 0.01, n)], 1)
    if kind == "axial":
        d = np.tile([0.0, 0.0, 1.0], (n, 1)) + rng.normal(0, 0.02, (n, 3))
    elif kind == "skew":
        d = rng.normal(0, 1, (n, 3))
    else:  # outside
        o = o + np.array([3.0, 0.0, 0.0])
        d = rng.normal(0, 1, (n, 3)) + np.array([-2.0, 0.0, 0.0])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def scene_cfg(**kw):
    scene, _ = build_scene(rod_scene(), device=CPU)
    return scene, P.TraceConfig(grin_substeps=4, **kw)


@pytest.mark.parametrize("kind", ["axial", "skew", "outside"])
def test_nearest_t_rows_equals_the_plain_nearest_hit(kind):
    scene, cfg = scene_cfg()
    o, d = rays(kind)
    rows = (scene.grin_wu, scene.grin_wv, scene.grin_ww)
    t = S.nearest_t_rows(o, d, *rows, cfg)
    want = PI.nearest_hit_torch(o, d, *rows, cfg.eps, cfg.eps_bary,
                                cfg.max_ray_len)[0]
    assert t.dtype == torch.float32 and t.shape == (o.shape[0],)
    assert torch.equal(t.view(torch.int32), want.view(torch.int32))
    hits = int(torch.isfinite(t).sum())
    if kind == "outside":
        assert 0 < hits < o.shape[0] // 2
    else:
        assert hits == o.shape[0]  # a closed rod: every inside ray exits


def test_nearest_t_rows_dispatches_on_the_backend(monkeypatch):
    scene, cfg = scene_cfg()
    o, d = rays("skew", n=600)
    rows = (scene.grin_wu, scene.grin_wv, scene.grin_ww)
    calls = []

    def recorded(*args, backend="auto", **kw):
        calls.append((backend, kw.get("mask"), kw.get("ray_block")))
        return PI.nearest_hit(*args, backend=backend, **kw)

    monkeypatch.setattr(S, "nearest_hit", recorded)
    out = {b: S.nearest_t_rows(o, d, *rows, cfg.replace(backend=b))
           for b in ("auto", "torch")}
    assert torch.equal(out["auto"], out["torch"])
    assert [c[0] for c in calls] == ["auto", "torch"]
    assert all(m is None for _, m, _ in calls)  # no cull mask
    # the plain version's ray blocks stay wide on the few rows
    T = rows[0].shape[0]
    assert all(b == max(4096, (1 << 23) // T) for _, _, b in calls)
    # 'cuda' asks for the kernel, which takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.nearest_t_rows(o, d, *rows, cfg.replace(backend="cuda"))


@pytest.mark.parametrize("ray_block", [None, 7, 100_000])
def test_dispatcher_passes_the_ray_block_to_the_plain_version(
        ray_block, monkeypatch):
    """nearest_hit's ray_block reaches nearest_hit_torch, and the result
    does not depend on it."""
    scene, cfg = scene_cfg()
    o, d = rays("skew", n=600)
    args = (o, d, scene.grin_wu, scene.grin_wv, scene.grin_ww, cfg.eps,
            cfg.eps_bary, cfg.max_ray_len)
    plain, blocks = PI.nearest_hit_torch, []

    def recorded(*a, **kw):
        blocks.append(kw.get("ray_block"))
        return plain(*a, **kw)

    monkeypatch.setattr(PI, "nearest_hit_torch", recorded)
    t, i = PI.nearest_hit(*args, backend="torch", ray_block=ray_block)
    assert blocks == [ray_block]
    t0, i0 = plain(*args)
    assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
    assert torch.equal(i, i0)


def test_grin_rows_are_contiguous_and_aligned_for_the_kernel():
    scene, _ = scene_cfg()
    for w in (scene.grin_wu, scene.grin_wv, scene.grin_ww):
        assert w.dtype == torch.float32 and w.dim() == 2 and w.shape[1] == 4
        assert w.shape[0] % 128 == 0 and w.shape[0] >= 12
        assert w.is_contiguous() and w.storage_offset() == 0
        assert w.data_ptr() % 16 == 0


def test_substep_trace_runs_its_checks_through_the_dispatcher(monkeypatch):
    """A whole sub-stepped trace calls the dispatcher with the rod's rows
    between curved steps, at most grin_substeps - 1 times a bounce."""
    calls = []

    def recorded(o, d, wu, *args, backend="auto", **kw):
        calls.append((wu.shape[0], backend))
        return PI.nearest_hit(o, d, wu, *args, backend=backend, **kw)

    monkeypatch.setattr(S, "nearest_hit", recorded)
    src = P.CollimatedSource(center=(0.1, 0, 0), direction=(0, 0.05, 1),
                             diameter=0.4, ray_count=200, seed=7)
    res = P.Tracer(P.TraceConfig(grin_substeps=4), device=CPU).trace(
        src, rod_scene(), trace_iterations=12, capacity=1024, mode="host")
    scene, _ = scene_cfg()
    assert calls and {c for c in calls} == {(scene.grin_wu.shape[0],
                                             "auto")}
    assert len(calls) <= 3 * res.iterations_run
    assert res.power_conservation_error() <= 1e-5
