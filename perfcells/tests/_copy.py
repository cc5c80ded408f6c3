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
