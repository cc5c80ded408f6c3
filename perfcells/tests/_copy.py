"""A copy of the benchmark folder with tiny cells of its own, and a way to
run code in it: the harness finds its files relative to itself, so a copy
with files dropped in is driven without editing any file."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent



def _shrink(config: dict, name: str, sizes: list[tuple[int, int]]) -> dict:
    c = json.loads(json.dumps(config))
    c["name"] = name
    for el, (seg, rad) in zip(c["elements"], sizes):
        el["params"].update(n_segments=seg, n_radial=rad)
    return c


def tiny_copy(tmp: Path) -> Path:
    """tmp/bench holding BENCHMARK.json and perfcells/, plus the tiny cells
    tiny.c1 (config 1 at 2,048 rays), tiny.c4 (config 4, a job of one
    batch of 4,096, the check's sample the whole batch) and tiny.c5 (config 5 at 2,048 rays over 2 ranks)."""
    root = tmp / "bench"
    shutil.copytree(HOME, root / "perfcells",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    pc = root / "perfcells"

    def load(kind, name):
        return json.loads((pc / kind / f"{name}.json").read_text())

    def save(kind, name, obj):
        (pc / kind / f"{name}.json").write_text(json.dumps(obj, indent=1))

    save("configs", "tiny_c1", _shrink(load("configs", "config1_collimator"),
                                       "tiny_c1", [(16, 6), (16, 6)]))
    save("configs", "tiny_c4", _shrink(load("configs", "config4_large_mesh"),
                                       "tiny_c4", [(24, 8), (16, 6)]))
    save("configs", "tiny_c5", _shrink(load("configs", "config5_multichip"),
                                       "tiny_c5", [(16, 6), (16, 6)]))
    cells = {
        "tiny.c1": ("config1.rays_100k", "tiny_c1", 1,
                    {"rays": 2048}, {"calls": 2, "within": 3,
                                     "launch_rays": 512}),
        "tiny.c4": ("config4.collimated_100m", "tiny_c4", 1,
                    {"total_rays": 4096, "batch_size": 4096},
                    {"calls": 1, "within": 1, "launch_rays": 512,
                     "sample_rays": 4096}),
        "tiny.c5": ("config5.rays_2m_4chip", "tiny_c5", 2,
                    {"rays": 2048}, {"calls": 1, "within": 1,
                                     "launch_rays": 512}),
    }
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (like, config, chips, load_kw, check_kw) in cells.items():
        w = load("workloads", like)
        w.update(config=config, traffic=cell.split(".")[1], chips=chips)
        w["load"].update(load_kw)
        w["check"].update(check_kw)
        w["profile"] = {"after_s": 0.0, "for_s": 0.2}
        save("workloads", cell, w)
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": w["traffic"], "chips": chips,
                                   "why": w["why"]})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and like in m["workloads"]:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_py(root: Path, code: str, timeout: float = 300):
    """Run `code` in a fresh interpreter that imports `perfcells` from the
    copy (and the program from the repository); returns the completed
    process (stdout and stderr as text)."""
    script = root / "_case.py"
    script.write_text(
        "import sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]\n" + code)
    return subprocess.run([sys.executable, str(script)], cwd=root,
                          capture_output=True, text=True, timeout=timeout)


def last_json(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# a frozen biconvex lens and a sphere: the port's
# `optical_elements(n_segments, n_radial).biconvex_lens(radius, aperture,
# thickness)` and `.sphere(radius)` meshes, as a configuration's scene
# generators (`scenes/<kind>.py`) would copy them
LENS_SCENE = '''import numpy as np

from perfcells.scenes._revolve import revolve


def _cap(R, a, z0, n):
    r = np.linspace(0.0, a, n + 1)
    return np.stack([r, z0 + R - np.sign(R) * np.sqrt(R * R - r * r)], 1)


def build(radius, aperture, thickness, n_segments, n_radial,
          center=(0.0, 0.0, 0.0)):
    a = aperture / 2.0
    prof = np.concatenate([_cap(radius, a, 0.0, n_radial),
                           _cap(-radius, a, thickness, n_radial)[::-1]])
    return revolve(prof, n_segments, center)
'''

SPHERE_SCENE = '''import numpy as np

from perfcells.scenes._revolve import revolve


def build(radius, n_segments, n_radial, center=(0.0, 0.0, 0.0)):
    th = np.linspace(0.0, np.pi, n_radial + 1)
    return revolve(np.stack([radius * np.sin(th), -radius * np.cos(th)], 1),
                   n_segments, center)
'''


def add_refractive_cell(root: Path, power_cutoff: float = 2e-6) -> str:
    """Drop into a copy (files only, and the cell's entry in its
    BENCHMARK.json) the cell tiny.c3: config 3's lens stack shrunk to
    n_segments 16, n_radial 6 (two biconvex lenses of index 1.5 and 1.7 and
    a measuring sphere), a trace_batched job of one batch of 2,048 rays, 5
    bounces, capacity 4x the batch, and `power_cutoff`: at the default,
    top-k drops nothing (the reference's children peak at 6,703 of the
    8,192 slots); at 0, as config 3 states, it drops about 0.4% of the
    power.
    Returns the cell's name."""
    pc = root / "perfcells"
    (pc / "scenes" / "tiny_lens.py").write_text(LENS_SCENE)
    (pc / "scenes" / "tiny_sphere.py").write_text(SPHERE_SCENE)
    config = json.loads((pc / "configs" / "config4_large_mesh.json")
                        .read_text())
    lens = {"n_segments": 16, "n_radial": 6, "aperture": 0.8}
    config.update(
        name="tiny_c3", entry="trace_batched",
        call={"trace_iterations": 5, "capacity_multiple": 4},
        elements=[
            {"name": "l1", "kind": "tiny_lens", "material": "refractive",
             "ior": 1.5, "params": dict(lens, radius=1.0, thickness=0.2)},
            {"name": "l2", "kind": "tiny_lens", "material": "refractive",
             "ior": 1.7, "params": dict(lens, radius=1.5, thickness=0.15,
                                        center=[0.0, 0.0, 0.5])},
            {"name": "enclosure", "kind": "tiny_sphere",
             "material": "measure",
             "params": {"radius": 6.0, "n_segments": 16, "n_radial": 6}}],
        light={"kind": "collimated", "center": [0.0, 0.0, -0.5],
               "direction": [0.0, 0.0, 1.0], "diameter": 0.5, "power": 1.0})
    config["semantics"].update(ior_env=1.0, power_cutoff=power_cutoff)
    (pc / "configs" / "tiny_c3.json").write_text(json.dumps(config, indent=1))
    w = json.loads((pc / "workloads" / "config4.collimated_100m.json")
                   .read_text())
    w.update(config="tiny_c3", traffic="c3", chips=1,
             why="config 3's lens stack, tiny: splitting, top-k, 2C buffer")
    w["load"].update(total_rays=2048, batch_size=2048)
    w["check"].update(calls=1, within=1, launch_rays=512, sample_rays=2048)
    # sound runs read gaps under 1e-7 on the CPU
    w["check"]["limits"].update(ledger_gap=1e-5, detector_gap=1e-5)
    w["profile"] = {"after_s": 0.0, "for_s": 0.2}
    (pc / "workloads" / "tiny.c3.json").write_text(json.dumps(w, indent=1))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.c3", "config": "tiny_c3",
                               "traffic": "c3", "chips": 1, "why": w["why"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return "tiny.c3"
