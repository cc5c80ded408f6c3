"""The port's side of the sharded-path tests: scenes, sources and the
scenarios each spawned rank runs (tests/torch_dist_common.run_ranks). Only
the port and numpy are imported here, never jax: a rank is a fresh
interpreter and must stay one. Each scenario function runs every case of
one test module on one process group and returns plain numpy / Python
values, which the test module holds against the JAX package in its own
process.

Scenes and sizes are the reference tests' (tests/test_sharding.py,
test_mesh2d.py, test_tri_sharding.py): 24 x 8 meshes, 1,024-4,096 rays.
The builders take the package module M (lightpycl_tpu or
lightpycl_tpu_torch), so the test modules build the same scenes for the
reference.
"""

import os

import numpy as np
import torch

CPU = torch.device("cpu")


# ---- scenes and sources, for either package --------------------------------

def scene_els(M):
    """tests/test_sharding.py:19: a parabolic mirror, a dome and a lens."""
    oe = M.optical_elements(n_segments=24, n_radial=8)
    return [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
            oe.hemisphere(10.0, name="dome"),
            oe.biconvex_lens(1.0, 0.6, 0.1, ior=1.5, center=(0, 0, 1.0))]


def beam(M, n, seed, power=1.0, diameter=1.5):
    return M.sources.CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                              diameter=diameter, ray_count=n, power=power,
                              seed=seed)


def many_detector_els(M, n_det=10):
    """n_det unit-width measure panels side by side at z = 0 above a
    terminating floor (tests/test_sharding.py:76)."""
    oe = M.optical_elements(n_segments=24, n_radial=8)
    els = [oe.rectangle(1.0, 4.0, center=(x - (n_det - 1) / 2.0, 0, 0),
                        material=M.Material.MEASURE, name=f"panel{x}")
           for x in range(n_det)]
    els.append(oe.rectangle(40.0, 40.0, center=(0, 0, -1.0),
                            material=M.Material.TERMINATOR))
    return els


def coated_window_els(M):
    """Split-heavy: every ray splits at both faces of a coated window
    (tests/test_sharding.py:165)."""
    oe = M.optical_elements(n_segments=24, n_radial=8)
    return [oe.cube(size=(1.0, 1.0, 0.25), material="refractive", ior=1.52,
                    coat_ior=1.38, coat_thickness=0.55 / (4 * 1.38),
                    name="win"),
            oe.disc(radius=1.5, center=(0, 0, 2.0), material="measure",
                    name="fwd"),
            oe.disc(radius=1.5, center=(0, 0, -2.0), material="measure",
                    name="back"),
            oe.sphere(radius=8.0, material="terminator")]


def window_beam(M, n=1024):
    return M.sources.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                              diameter=0.5, ray_count=n, power=1.0, seed=4)


def tri_scene_els(M):
    """tests/test_tri_sharding.py:23."""
    oe = M.optical_elements(n_segments=32, n_radial=12)
    return [oe.parabolic_mirror(0.5, 2.0), oe.hemisphere(5.0, name="dome"),
            oe.cube(0.4, center=(0.5, 0, 0.8), material="refractive",
                    ior=1.5)]


def tri_rays(n=512):
    """tests/test_tri_sharding.py:33's rays (numpy seed 3)."""
    rng = np.random.default_rng(3)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    o[:, 2] += 1.0
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def grating_els(M):
    """A dual-order reflection grating under a measuring sphere
    (tests/test_mesh2d.py:128)."""
    oe = M.optical_elements(n_segments=24, n_radial=8)
    gr = oe.rectangle(4.0, 4.0, material="grating", axis=(1, 0, 0),
                      grating_period=1.2, grating_order=1, reflectivity=0.9)
    gr.order0_fraction = 0.25
    return [gr, oe.sphere(radius=5.0, material="measure", name="dome")]


def grating_rays(n=512):
    return (np.tile([0.0, 0.0, 2.0], (n, 1)), np.tile([0.0, 0.0, -1.0],
                                                      (n, 1)),
            np.full(n, 1.0 / n))


def fixed_rays(n, seed=0):
    """A collimated bundle (diameter 3.5 at z = 5, pointing down) from a
    numpy seed: every batch of a fixed-ray source."""
    rng = np.random.default_rng(seed)
    r = 1.75 * np.sqrt(rng.uniform(size=n))
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    o = np.stack([r * np.cos(phi), r * np.sin(phi), np.full(n, 5.0)], 1)
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    return (o.astype(np.float32), d.astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


class PortFixedSource:
    """The same rays in every batch, for the port's trace_batched."""

    center = (0.0, 0.0, 5.0)

    def rays_on_device(self, gen, n):
        return tuple(torch.from_numpy(a) for a in fixed_rays(n))


def bowl_els(M):
    """A bowl, a refracting slab (splitting) and a dome
    (tests/test_torch_batched.py)."""
    oe = M.optical_elements(24, 12)
    return [oe.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95),
            oe.cube(size=(2.0, 2.0, 0.2), center=(0.6, 0.0, 3.0),
                    material="refractive", ior=1.5),
            M.optical_elements(32, 8).hemisphere(radius=100.0, name="dome")]


def prism_els(M, a, b):
    oe = M.optical_elements(n_segments=24, n_radial=8)
    pr = oe.prism(width=1.04, height=0.3, length=1.0, ior=a)
    pr.dispersion_b = b
    return [pr, oe.sphere(10.0, material="measure", name="dome")]


BATCHED_MAPS = dict(trace_iterations=5, image_bins=16, image_halfwidth=100.0,
                    time_bins=8, opl_min=96.0, opl_max=112.0, flux_map=True)
BATCHED_ARGS = dict(total_rays=3 * 512, batch_size=512, capacity=2048,
                    seed=3, cull=False)
WLS = [0.45, 0.50, 0.55, 0.60, 0.65]
WL3 = [0.40, 0.55, 0.70]
SPECTRAL_MAPS = dict(hist_azimuth_bins=12, hist_polar_bins=10,
                     image_bins=16, image_center=(0, 0, 2.0),
                     image_halfwidth=1.5)
MESH2D_SHAPES = ((2, 2), (4, 1), (1, 4))


# ---- what a rank sends back -----------------------------------------------

def summary(res):
    """A TraceResult as plain values."""
    out = {"ledger": dict(res.ledger), "hist": res.hist,
           "per_detector": res.per_detector, "image": res.image,
           "names": list(res.detector_names),
           "live": res.final_live_power,
           "conservation": res.power_conservation_error(),
           "iterations": res.iterations_run, "rays_traced": res.rays_traced}
    for f in ("tri_flux", "time_hist", "per_batch_detector",
              "per_detector_spectrum", "image_amp"):
        if getattr(res, f) is not None:
            out[f] = getattr(res, f)
    if res.spectral_ledger is not None:
        out["spectral_ledger"] = {k: np.asarray(v)
                                  for k, v in res.spectral_ledger.items()}
    return out


def state(det, led):
    return {"hist": det.hist.numpy(), "per_detector": det.per_detector.numpy(),
            "ledger": led.as_dict()}


def same(a, b):
    """Two summaries equal bit for bit in every value."""
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            if not same(x, y):
                return False
        elif isinstance(x, (list, tuple)):
            if not same(dict(enumerate(x)), dict(enumerate(y))):
                return False
        elif isinstance(x, np.ndarray):
            if x.shape != y.shape or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def error_text(fn):
    try:
        fn()
    except (ValueError, AttributeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# ---- rank scenarios ---------------------------------------------------------

def multichip_scenarios(rank, world):
    """Every case of tests/test_torch_parallel.py on one `world`-rank
    group."""
    import lightpycl_tpu_torch as P
    from lightpycl_tpu_torch.compat import CL_Tracer
    from lightpycl_tpu_torch.parallel import sharding
    from lightpycl_tpu_torch.tracer.rays import RayBatch

    out = {}
    mesh = sharding.make_ray_mesh(world, device=CPU)
    cfg = P.TraceConfig(hist_azimuth_bins=16, hist_polar_bins=8)
    scene, _ = P.build_scene(scene_els(P), device=CPU)

    # trace_multichip itself (tests/test_sharding.py:30, :56)
    o, d, p = beam(P, 2048, 3).sample()
    rays = sharding.shard_rays(RayBatch.from_arrays(o, d, p, device=CPU),
                               mesh)
    rays_out, det, led = sharding.trace_multichip(scene, rays, cfg, 5, mesh)
    out["direct"] = state(det, led)
    whole = sharding.gather_rays(rays_out, mesh)
    out["direct"]["live"] = float(torch.sum(torch.where(
        whole.alive, whole.power, 0.0)))
    out["direct"]["local_capacity"] = rays_out.capacity
    o, d, p = beam(P, 1024, 4, power=2.0).sample()
    rays = sharding.shard_rays(RayBatch.from_arrays(o, d, p, device=CPU),
                               mesh)
    rays_out, det, led = sharding.trace_multichip(
        scene, rays, P.TraceConfig(), 6, mesh)
    whole = sharding.gather_rays(rays_out, mesh)
    out["conservation"] = state(det, led)
    out["conservation"]["live"] = float(torch.sum(torch.where(
        whole.alive, whole.power, 0.0)))

    # the layout: this rank's block of the interleaved batch, and back
    rng = np.random.default_rng(0)
    full = RayBatch.from_arrays(rng.normal(size=(64, 3)),
                                np.tile([0, 0, 1.0], (64, 1)),
                                rng.uniform(0.1, 1.0, 64), capacity=256,
                                device=CPU)
    mine = sharding.shard_rays(full, mesh)
    block = sharding.interleave_rays(full, world).permuted(
        torch.arange(rank * 256 // world, (rank + 1) * 256 // world))
    back = sharding.gather_rays(mine, mesh)
    out["layout"] = {
        "capacity": mine.capacity,
        "is_block": all(torch.equal(a, b) for a, b in zip(mine, block)),
        "gathered": all(torch.equal(a, b) for a, b in zip(back, full)),
        "raw_block": torch.equal(
            sharding.shard_rays(full, mesh, interleave=False).power,
            full.power[rank * 256 // world:(rank + 1) * 256 // world])}

    # the engine (tests/test_sharding.py:93-160)
    tr = P.Tracer(cfg, device=CPU)
    out["engine_device"] = summary(tr.trace(beam(P, 2048, 3), scene_els(P),
                                            trace_iterations=5,
                                            mode="device"))
    out["engine"] = summary(tr.trace(beam(P, 2048, 3), scene_els(P),
                                     trace_iterations=5, mode="multichip"))
    out["engine_repeat"] = summary(tr.trace(beam(P, 2048, 3), scene_els(P),
                                            trace_iterations=5,
                                            mode="multichip"))
    out["engine_mesh"] = summary(tr.trace(beam(P, 2048, 3), scene_els(P),
                                          trace_iterations=5,
                                          mode="multichip", mesh=mesh))
    tr = P.Tracer(P.TraceConfig(), device=CPU)
    out["pads"] = {m: summary(tr.trace(beam(P, 1001, 5), scene_els(P),
                                       trace_iterations=5, mode=m))
                   for m in ("device", "multichip")}
    out["nine"] = {m: summary(tr.trace(
        beam(P, 4096, 6, diameter=9.0), many_detector_els(P),
        trace_iterations=2, mode=m)) for m in ("device", "multichip")}
    roul = P.TraceConfig(roulette_threshold=5e-3)
    out["roulette"] = summary(P.Tracer(roul, device=CPU).trace(
        beam(P, 1024, 7), scene_els(P), trace_iterations=6,
        mode="multichip"))
    o, d, p = beam(P, 512, 8).sample()
    out["missing_key"] = error_text(lambda: sharding.trace_multichip(
        scene, sharding.shard_rays(RayBatch.from_arrays(o, d, p, device=CPU),
                                   mesh), roul, 4, mesh))
    o, d, p = window_beam(P).sample()
    out["headroom"] = {
        "device": summary(P.Tracer(device=CPU).trace(
            None, coated_window_els(P), trace_iterations=8, mode="device",
            rays=RayBatch.from_arrays(o, d, p, capacity=4096, device=CPU),
            dissipation_target=1.0)),
        "multichip": summary(P.Tracer(device=CPU).trace(
            None, coated_window_els(P), trace_iterations=8,
            mode="multichip",
            rays=RayBatch.from_arrays(o, d, p, capacity=4096, device=CPU)))}
    out["cull"] = {c: summary(P.Tracer(P.TraceConfig(cull=c),
                                       device=CPU).trace(
        beam(P, 2048, 9), scene_els(P), trace_iterations=5,
        mode="multichip")) for c in (False, True)}
    out["iterative_tracer"] = summary(CL_Tracer(device=CPU).iterative_tracer(
        beam(P, 2048, 3), scene_els(P), trace_iterations=5,
        mode="multichip"))
    return out


def tri_scenarios(rank, world):
    """Every case of tests/test_torch_parallel_mesh2d.py on one
    `world`-rank group: the triangle-sharded intersect at `world` shards,
    and (world 4) trace_mesh2d and the engine's mesh2d mode on every 2-D
    shape of 4 ranks."""
    import lightpycl_tpu_torch as P
    from lightpycl_tpu_torch.ops.intersect import intersect
    from lightpycl_tpu_torch.parallel import mesh2d, tri_sharding
    from lightpycl_tpu_torch.parallel.tri_sharding import (
        _gather_hit_attributes)
    from lightpycl_tpu_torch.tracer import step
    from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch

    out = {}
    scene, _ = P.build_scene(tri_scene_els(P), device=CPU)
    o, d = (torch.from_numpy(a) for a in tri_rays())
    tmesh = tri_sharding.make_tri_mesh(world, device=CPU)
    shard = tri_sharding.shard_scene(scene, tmesh)
    for cull in (False, True):
        cfg = P.TraceConfig(cull=cull)
        t, tri = tri_sharding.intersect_tri_sharded(shard, o, d, cfg, tmesh)
        t1, i1 = intersect(scene, o, d, cfg)
        out[f"tri_cull{cull}"] = {
            "t": t.numpy(), "tri": tri.numpy(), "t_whole": t1.numpy(),
            "tri_whole": i1.numpy()}
    _, tri = tri_sharding.intersect_tri_sharded(shard, o, d,
                                                P.TraceConfig(), tmesh)
    out["attrs"] = [a.numpy() for a in _gather_hit_attributes(shard, tri,
                                                              tmesh)]
    out["shard_rows"] = shard.num_triangles_padded
    if world != 4:
        return out

    cfg = P.TraceConfig(hist_azimuth_bins=16, hist_polar_bins=8)
    o, d, p = beam(P, 1024, 3).sample()
    whole, names = P.build_scene(scene_els(P), device=CPU)
    for shape in MESH2D_SHAPES:
        m = mesh2d.make_mesh2d(*shape, device=CPU)
        sc, rays = mesh2d.place(whole, RayBatch.from_arrays(o, d, p,
                                                            device=CPU), m)
        rays_out, det, led = mesh2d.trace_mesh2d(sc, rays, cfg, 5, m)
        live = torch.sum(torch.where(rays_out.alive, rays_out.power, 0.0))
        torch.distributed.all_reduce(live, group=m.get_group("rays"))
        out[f"mesh{shape}"] = state(det, led)
        out[f"mesh{shape}"]["live"] = float(live)
    # the device loop on the same (unsorted) scene and rays, to its full
    # depth: what a mesh of one ray rank must equal bit for bit
    full = RayBatch.from_arrays(o, d, p, device=CPU)
    _, det, led, _ = step.trace_loop(
        whole, full, DetectorState.zeros(16, 8, 1, device=CPU),
        Ledger.start(torch.sum(full.power * full.alive), device=CPU),
        cfg.replace(dissipation_target=1.0), 5)
    out["loop"] = state(det, led)
    m = mesh2d.make_mesh2d(2, 2, device=CPU)
    out["device"] = summary(P.Tracer(cfg, device=CPU).trace(
        beam(P, 1024, 3), scene_els(P), trace_iterations=5, mode="device"))
    out["engine"] = summary(P.Tracer(cfg, device=CPU).trace(
        beam(P, 1024, 3), scene_els(P), trace_iterations=5, mode="mesh2d",
        mesh=m))
    out["engine_repeat"] = summary(P.Tracer(cfg, device=CPU).trace(
        beam(P, 1024, 3), scene_els(P), trace_iterations=5, mode="mesh2d",
        mesh=m))
    out["requires_mesh"] = error_text(lambda: P.Tracer(device=CPU).trace(
        beam(P, 1024, 3), scene_els(P), trace_iterations=2, mode="mesh2d"))
    # the dual-order grating: every attribute column rides the gather
    go, gd, gp = grating_rays()
    gscene, _ = P.build_scene(grating_els(P), device=CPU)
    sc, rays = mesh2d.place(gscene, RayBatch.from_arrays(
        go, gd, gp, wavelengths=0.6, capacity=4 * 512, device=CPU), m)
    _, det, led = mesh2d.trace_mesh2d(sc, rays, cfg, 3, m)
    out["grating"] = state(det, led)
    out["grating_device"] = summary(P.Tracer(cfg, device=CPU).trace(
        None, grating_els(P), trace_iterations=3, mode="device",
        rays=RayBatch.from_arrays(go, gd, gp, wavelengths=0.6,
                                  capacity=4 * 512, device=CPU)))
    out["cull"] = {c: summary(P.Tracer(P.TraceConfig(), device=CPU).trace(
        beam(P, 1024, 3), scene_els(P), trace_iterations=5, mode="mesh2d",
        mesh=m, capacity=1024, cull=c)) for c in (False, True, None)}
    roul = P.TraceConfig(roulette_threshold=5e-3)
    sc, rays = mesh2d.place(whole, RayBatch.from_arrays(o, d, p, device=CPU),
                            m)
    rays_out, det, led = mesh2d.trace_mesh2d(sc, rays, roul, 6, m, key=11)
    live = torch.sum(torch.where(rays_out.alive, rays_out.power, 0.0))
    torch.distributed.all_reduce(live, group=m.get_group("rays"))
    out["roulette"] = state(det, led)
    out["roulette"]["live"] = float(live)
    out["missing_key"] = error_text(
        lambda: mesh2d.trace_mesh2d(sc, rays, roul, 4, m))
    dscene, dnames = P.build_scene(many_detector_els(P), device=CPU)
    do, dd, dp = beam(P, 4096, 6, diameter=9.0).sample()
    sc, rays = mesh2d.place(dscene, RayBatch.from_arrays(do, dd, dp,
                                                         device=CPU), m)
    _, det, led = mesh2d.trace_mesh2d(sc, rays, P.TraceConfig(), 2, m,
                                      n_detectors=len(dnames))
    out["nine"] = state(det, led)
    out["nine_device"] = summary(P.Tracer(device=CPU).trace(
        beam(P, 4096, 6, diameter=9.0), many_detector_els(P),
        trace_iterations=2, mode="device"))
    o, d, p = window_beam(P).sample()
    out["headroom"] = summary(P.Tracer(device=CPU).trace(
        None, coated_window_els(P), trace_iterations=8, mode="mesh2d",
        mesh=mesh2d.make_mesh2d(2, 2, device=CPU),
        rays=RayBatch.from_arrays(o, d, p, capacity=4096, device=CPU)))
    return out


def batched_kw(mode, **kw):
    """trace_batched's arguments: the maps, but no flux map under mesh2d
    (the reference refuses it there)."""
    maps = dict(BATCHED_MAPS, flux_map=mode != "mesh2d")
    return {**BATCHED_ARGS, **maps, **kw}


def batched_port(mode, mesh=None, **kw):
    import lightpycl_tpu_torch as P

    return P.Tracer(device=CPU).trace_batched(
        PortFixedSource(), elements=bowl_els(P), mode=mode, mesh=mesh,
        **batched_kw(mode, **kw))


def engine_scenarios(rank, world, ckpt_dir):
    """Every case of tests/test_torch_parallel_engine.py on one
    `world`-rank group: trace_batched (multichip and mesh2d, a resumed
    run), trace_spectral (shared and batched), the compat facade."""
    import lightpycl_tpu_torch as P
    from lightpycl_tpu_torch.compat import CL_Tracer
    from lightpycl_tpu_torch.parallel import mesh2d, sharding
    from lightpycl_tpu_torch.tracer.rays import RayBatch

    out = {}
    ray_mesh = sharding.make_ray_mesh(world, device=CPU)
    out["batched"] = summary(batched_port("multichip", ray_mesh))
    out["batched_default_mesh"] = summary(batched_port("multichip"))
    out["batched_device"] = summary(batched_port("device"))
    m2 = mesh2d.make_mesh2d(2, world // 2, device=CPU)
    out["batched_mesh2d"] = summary(batched_port("mesh2d", m2))
    # roulette on: a run cut after two batches and resumed from its
    # checkpoint equals the uninterrupted run bit for bit
    roul = dict(roulette_threshold=5e-4, cull=None)
    full_res = batched_port("mesh2d", m2, **roul)
    full = summary(full_res)
    ck = os.path.join(ckpt_dir, "mesh2d_run")
    first = batched_port("mesh2d", m2, checkpoint_path=ck, max_batches=2,
                         **roul)
    resumed = summary(batched_port("mesh2d", m2, checkpoint_path=ck, **roul))
    out["resume"] = {"full": full, "first_batches": first.per_batch_detector,
                     "full_ledger_rows": full_res.per_batch_ledger,
                     "resumed": resumed,
                     "checkpoint": os.path.exists(ck + ".npz")}
    out["batched_multichip_roulette"] = summary(batched_port("multichip",
                                                             ray_mesh, **roul))

    beam_src = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                                  diameter=0.5, ray_count=256, power=1.0,
                                  seed=3)
    o, d, p = beam_src.sample()
    rays = RayBatch.from_arrays(o, d, p, capacity=1024, device=CPU)
    out["spectral_shared"] = summary(P.Tracer(device=CPU).trace_spectral(
        None, WLS, elements=coated_window_els(P), rays=rays,
        trace_iterations=8, mode="multichip", mesh=ray_mesh,
        **SPECTRAL_MAPS))
    out["spectral_shared_device"] = summary(
        P.Tracer(device=CPU).trace_spectral(
            None, WLS, elements=coated_window_els(P), rays=rays,
            trace_iterations=8, mode="device", **SPECTRAL_MAPS))
    from lightpycl_tpu_torch.materials import SF10
    po, pd, pp = P.CollimatedSource(
        center=(0.3, -0.5, 0), direction=(0, 1, 0), diameter=0.04,
        ray_count=200, power=1.0, seed=2).sample()
    prays = RayBatch.from_arrays(po, pd, pp, capacity=400, device=CPU)
    out["spectral_batched"] = summary(P.Tracer(device=CPU).trace_spectral(
        None, WL3, elements=prism_els(P, *SF10), rays=prays,
        trace_iterations=4, mode="multichip"))
    out["spectral_batched_device"] = summary(
        P.Tracer(device=CPU).trace_spectral(
            None, WL3, elements=prism_els(P, *SF10), rays=prays,
            trace_iterations=4, mode="device"))
    out["spectral_host_refused"] = error_text(
        lambda: P.Tracer(device=CPU).trace_spectral(
            None, WL3, elements=prism_els(P, *SF10), rays=prays,
            trace_iterations=4, mode="host"))
    out["compat_spectral"] = summary(CL_Tracer(device=CPU).iterative_tracer(
        beam_src, coated_window_els(P), trace_iterations=8,
        wavelengths=WLS, capacity=1024, mode="multichip"))
    return out
