"""The benchmark's files are found by name, agree with BENCHMARK.json, and
a cell, a configuration and a metric dropped into a copy are picked up
without an edit."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfcells.harness import catalog  # noqa: E402
from perfcells.tests._copy import (  # noqa: E402
    add_refractive_cell, last_json, run_py, tiny_copy)

BENCH = catalog.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_match_benchmark(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = catalog.load_json("workloads", cell)
    assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    config = catalog.load_json("configs", w["config"])
    assert hasattr(catalog.load_module("entries", config["entry"]), "Entry")
    for el in config["elements"]:
        assert hasattr(catalog.load_module("scenes", el["kind"]), "build")
    assert set(w["check"]["limits"]) >= {"hit_bad_share", "ledger_gap",
                                          "detector_gap"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_match_benchmark(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"perfcells/configs/{config}.json"
    c = catalog.load_json("configs", config)
    assert c["name"] == config
    assert c["source"] == entry["source"] and c["reduced"] == entry["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(catalog.load_module("metrics", metric).read)


def test_dropped_in_cell_config_and_metric_are_found(tmp_path):
    """A copy with a new configuration, cell and end-to-end metric (files
    only; BENCHMARK.json names them) runs them on the CPU."""
    root = tiny_copy(tmp_path)
    (root / "perfcells" / "metrics" / "calls_n.py").write_text(
        "def read(ctx):\n    return len(ctx['calls'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "calls_n", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.c1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = last_json(run_py(root, (
        "import json\nfrom perfcells.harness import driver\n"
        "print(json.dumps(driver.run_cell('tiny.c1', 2**31 + 7, 0.5, False,"
        " device='cpu')))\n")))
    assert line["metrics"]["calls_n"]["value"] == line["attempted"] >= 1
    assert {"rays_per_s", "setup_s"} <= set(line["metrics"])
    assert line["correct"] is True


def test_dropped_in_refractive_cell_runs_and_its_control_fails(tmp_path):
    """A splitting configuration (two lenses, a measuring sphere, capacity
    4x the batch, 5 bounces, a stated power cutoff), its scene generators
    and a trace_batched cell, dropped into a copy as files only, read
    correct with no source ray dead at the first launch; the same cell with
    the program's lenses at index 1.0 (the reference keeps theirs) reads
    incorrect."""
    from lightpycl_tpu_torch.geometry.primitives import optical_elements

    root = tiny_copy(tmp_path)
    cell = add_refractive_cell(root)
    run = ("import json\nfrom perfcells.harness import driver\n"
           f"print(json.dumps(driver.run_cell({cell!r}, 2**31 + 9, 0.5, "
           "False, device='cpu')))\n")
    mesh = last_json(run_py(root, (
        "import json\nfrom perfcells.harness import catalog\n"
        "from perfcells.harness.scene import element_arrays\n"
        "a = element_arrays(catalog.load_json('configs', 'tiny_c3'))\n"
        "print(json.dumps([[x['vertices'].tolist(), x['triangles'].tolist(),"
        " x['ior']] for x in a]))\n")))
    oe = optical_elements(16, 6)
    for (V, T, ior), ref in zip(mesh, (
            oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
            oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5)),
            oe.sphere(radius=6.0, ior=1.0))):
        assert np.array_equal(V, ref.vertices)
        assert np.array_equal(T, ref.triangles) and ior == ref.ior
    line = last_json(run_py(root, run))
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["first_launch_dead_share"]["value"] == 0
    flat = last_json(run_py(root, (
        "import perfcells.harness.scene as S\n"
        "orig = S.program_elements\n"
        "S.program_elements = lambda arrays: orig([dict(a, ior=1.0) "
        "for a in arrays])\n") + run))
    assert flat["correct"] is False, flat["checks"]
    assert flat["checks"]["ledger_gap"]["value"] > 1e-2


def test_dropped_in_refractive_cell_past_its_capacity_reads_correct(
        tmp_path):
    """tiny.c3 with no cutoff, as config 3 states: its children overflow
    the capacity and top-k drops about 0.4% of the power. The reference
    fits them into the same slots and the cell reads correct; with the
    reference keeping every child instead, the overflow reads as a ledger
    gap."""
    root = tiny_copy(tmp_path)
    cell = add_refractive_cell(root, power_cutoff=0.0)
    run = ("import json\nfrom perfcells.harness import driver\n"
           f"print(json.dumps(driver.run_cell({cell!r}, 2**31 + 19, 0.5, "
           "False, device='cpu')))\n")
    line = last_json(run_py(root, run))
    assert line["correct"] is True, line["checks"]
    free = last_json(run_py(root, (
        "import perfcells.reference.trace as R\n"
        "orig = R.trace\n"
        "R.trace = lambda *a, **kw: orig(*a[:6])\n") + run))
    assert free["correct"] is False, free["checks"]
    assert free["checks"]["ledger_gap"]["value"] > 1e-4
