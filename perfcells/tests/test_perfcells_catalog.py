"""The benchmark's files are found by name, agree with BENCHMARK.json, and
a cell, a configuration and a metric dropped into a copy are picked up
without an edit."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfcells.harness import catalog  # noqa: E402
from perfcells.tests._copy import last_json, run_py, tiny_copy  # noqa: E402

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
