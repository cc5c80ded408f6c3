"""lightpycl_tpu_torch must import and trace where jax does not exist (the
GPU machine has no jax): a subprocess blocks every jax import with a
sys.meta_path finder, imports the port, traces a tiny scene on the CPU,
and checks that neither jax nor the JAX package was ever loaded."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name in ("jax", "jaxlib") or name.startswith(("jax.",
                                                             "jaxlib.")):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, BlockJax())
    try:
        import jax  # noqa: F401
    except ImportError:
        pass
    else:
        raise SystemExit("the jax blocker did not block")

    import torch
    torch.set_num_threads(1)
    import lightpycl_tpu_torch as P
    from lightpycl_tpu_torch.compat import CL_Tracer

    oe = P.optical_elements(16, 6)
    els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
           oe.hemisphere(10.0, name="dome")]
    src = P.light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                         ray_count=256, seed=1)
    for mode in ("device", "host"):
        res = P.Tracer(device="cpu").trace(src, els, trace_iterations=3,
                                           mode=mode)
        assert abs(res.ledger["measured"] - 0.9) < 1e-3, res.ledger
    CL_Tracer(device="cpu").iterative_tracer(src, els, trace_iterations=3)
    # a polarized beam through a coated lens onto a metal mirror, and an
    # analytic (exact quadric) lens, in both modes
    import numpy as np
    coated = [oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, center=(0, 0, 1.0),
                               coating=[(1.38, 0.10), (2.1, 0.05)]),
              oe.rectangle(1.5, 1.5, center=(0, 0, 2.5), material="mirror",
                           metal_n=0.13, metal_k=3.9).rotate(
                               (0, 1, 0), np.pi - 0.6, pivot=(0, 0, 2.5)),
              oe.sphere(radius=8.0, material="measure", name="dome")]
    beam = P.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                              diameter=0.5, ray_count=128, seed=3,
                              stokes=(0.6, 0.8, 0.0))
    exact = [*P.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5),
             P.analytic_disc(3.0, vertex=(0, 0, 2.5), name="det")]
    for mode in ("device", "host"):
        res = P.Tracer(device="cpu").trace(beam, coated, trace_iterations=5,
                                           capacity=1024, mode=mode,
                                           polarization=True)
        assert res.power_conservation_error() < 1e-5, res.ledger
        assert res.ledger["measured"] > 0.8, res.ledger
        res = P.Tracer(device="cpu").trace(
            P.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                               diameter=0.08, ray_count=128, seed=3),
            exact, trace_iterations=6, capacity=1024, mode=mode)
        assert res.power_conservation_error() < 1e-5, res.ledger
        assert res.ledger["measured"] > 0.9, res.ledger
    assert len(res.measured_power) >= 128
    # trace_batched with a checkpoint, and a ray file replayed
    import os, tempfile
    from lightpycl_tpu_torch.io import (RayFileSource, load_state,
                                        save_measured_rayfile)
    bundle = P.CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                                diameter=1.5)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "run")
        res = P.Tracer(device="cpu").trace_batched(
            bundle, 2 * 256, 256, elements=els, checkpoint_path=ck,
            trace_iterations=3, time_bins=4, opl_min=10.0, opl_max=14.0,
            flux_map=True, roulette_threshold=1e-4)
        assert abs(res.ledger["measured"] - 0.9) < 2e-2, res.ledger
        assert int(load_state(ck, device="cpu")["extra"]["next_batch"]) == 2
        host = P.Tracer(device="cpu").trace(src, els, trace_iterations=3)
        path = os.path.join(tmp, "dome.lpr")
        save_measured_rayfile(path, host, detector="dome", flip=True)
        replay = RayFileSource(path)
        o, d, p = replay.sample()
        assert len(p) == len(host.measured_power)
        o, d, p = replay.rays_on_device(
            P.tracer.step.make_generator("cpu", 0), 64)
        assert o.shape == (64, 3)
    # spectral tracing: a 64-ray shared trace (coated window) and a
    # wavelength-batched one (dispersive prism, diffuse floor, roulette)
    from lightpycl_tpu_torch import analysis, spectral
    win = [oe.cube((1.0, 1.0, 0.25), material="refractive", ior=1.52,
                   coat_ior=1.38, coat_thickness=0.1),
           oe.disc(1.5, center=(0, 0, 2.0), material="measure", name="fwd"),
           oe.sphere(radius=8.0, material="terminator")]
    spectral.validate_spectral_scene(win)
    beam64 = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                                diameter=0.5, ray_count=64, seed=3)
    res = P.Tracer(device="cpu").trace_spectral(
        beam64, [0.45, 0.55, 0.65], elements=win, trace_iterations=6,
        capacity=256, method="shared")
    assert res.rays_traced == 256 * 6, res.rays_traced
    assert res.detector_spectrum("fwd").sum() > 0.9, res.ledger
    glass = oe.cube((0.6, 0.6, 0.3), material="refractive", ior=1.7)
    glass.dispersion_b = 0.02
    floor = oe.disc(3.0, center=(0, 0, 2.0), material="diffuse",
                    reflectivity=0.7)
    res = CL_Tracer(device="cpu").iterative_tracer(
        beam64, [glass, floor, oe.sphere(radius=8.0, material="measure",
                                         name="dome")],
        trace_iterations=5, wavelengths=[0.45, 0.55, 0.65], capacity=256,
        roulette_threshold=1e-3)
    assert res.rays_traced == 3 * 256 * 5, res.rays_traced
    led = res.spectral_ledger
    acc = sum(led[k] for k in ("measured", "absorbed", "escaped", "culled"))
    assert abs(acc.sum() + res.final_live_power - 1.0) < 1e-5, led
    assert 0.2 < analysis.chromaticity([0.45, 0.55], [1.0, 1.0])[1] < 0.4
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "lightpycl_tpu"))
    assert not leaked, leaked
    print("NO_JAX_OK")
""")


def test_port_imports_and_traces_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_do_not_import_jax():
    # static guard beside the runtime one: no module of the port, and not
    # the card's smoke run or its ray fixture, names jax or the JAX
    # package in an import statement
    pkg = os.path.join(REPO, "lightpycl_tpu_torch")
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py", "edge_rays.py")]
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "build"]  # kernel build output
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                s = line.strip()
                if s.startswith(("import ", "from ")) and (
                        s.split()[1].split(".")[0]
                        in ("jax", "jaxlib", "lightpycl_tpu")):
                    offenders.append(f"{path}:{n}: {s}")
    assert not offenders, offenders
