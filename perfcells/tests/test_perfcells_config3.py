"""Config 3's lens stack (`configs/config3_lens_stack.json`, entry
`trace_batched_per_batch`): its frozen meshers give the port's meshes bit
for bit, and its own file, shrunk to n_segments 16 and n_radial 6 and run
as a job of four 2,048-ray batches, reads correct on the CPU, and
incorrect with the program's lenses at index 1, with the reference's
capacity dropped, and with the check against the job's ledger (the entry
'trace_batched') in place of the checked batch's own row."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfcells.harness import catalog  # noqa: E402
from perfcells.harness.scene import element_arrays  # noqa: E402
from perfcells.tests._copy import (  # noqa: E402
    _shrink, last_json, run_py, tiny_copy)

CELL = "config3.lens_stack_split"
CONFIG = "config3_lens_stack"
BATCH = 2048
SEED = 2**31 + 5

FAULTS = {
    "lens_ior_1": (
        "from perfcells.entries import trace_batched as TB\n"
        "orig = TB.program_elements\n"
        "TB.program_elements = lambda arrays: orig(\n"
        "    [dict(a, ior=1.0) for a in arrays])\n"),
    "reference_capacity_dropped": (
        "import torch\nimport perfcells.reference.trace as RT\n"
        "orig = RT.trace\n"
        "RT.trace = lambda o, d, p, scene, opts, dtype=torch.float64, "
        "capacity=None: orig(o, d, p, scene, opts, dtype, None)\n"),
}

RUN_ONE = ("import json\nfrom perfcells.harness import driver\n"
           "print(json.dumps(driver.run_cell({cell!r}, {seed}, 0.5, False, "
           "device='cpu')))\n")


def port_meshes():
    import lightpycl_tpu_torch as P

    oe = P.optical_elements(128, 48)
    return [oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
            oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5)),
            oe.sphere(radius=6.0, material="measure", name="enclosure")]


def test_frozen_meshers_equal_the_ports():
    arrays = element_arrays(catalog.load_json("configs", CONFIG))
    for a, g in zip(arrays, port_meshes(), strict=True):
        assert a["vertices"].dtype == g.vertices.dtype
        assert a["triangles"].dtype == g.triangles.dtype
        assert np.array_equal(a["vertices"], g.vertices), a["name"]
        assert np.array_equal(a["triangles"], g.triangles), a["name"]
        if a["material"] == "refractive":  # a measuring surface has none
            assert a["ior"] == g.ior
    assert sum(len(a["triangles"]) for a in arrays) == 61_184


def add_tiny_cell(root: Path, name: str, entry: str) -> str:
    """Config 3's file shrunk to (16, 6) with `entry`, and a cell of one
    job of four 2,048-ray batches at config 3's check and limits, the
    whole batch checked; returns the cell's name."""
    pc = root / "perfcells"
    config = _shrink(catalog.load_json("configs", CONFIG), name,
                     [(16, 6)] * 3)
    config["entry"] = entry
    (pc / "configs" / f"{name}.json").write_text(json.dumps(config))
    w = catalog.load_json("workloads", CELL)
    cell = f"tiny.{name}"
    w.update(config=name, traffic=name, why="config 3 at (16, 6)")
    w["load"].update(total_rays=4 * BATCH, batch_size=BATCH)
    w["check"].update(calls=1, within=1, launch_rays=512, sample_rays=BATCH)
    w["profile"] = {"after_s": 0.0, "for_s": 0.2}
    (pc / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": name, "chips": 1, "why": w["why"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_copy(tmp_path_factory.mktemp("perfcells"))
    add_tiny_cell(root, "c3pb", "trace_batched_per_batch")
    add_tiny_cell(root, "c3job", "trace_batched")
    return root


@pytest.fixture(scope="module")
def sound(root):
    return last_json(run_py(root, RUN_ONE.format(cell="tiny.c3pb",
                                                 seed=SEED)))


def test_tiny_config3_reads_correct(sound):
    assert sound["correct"] is True, sound["checks"]
    assert sound["checked"]["calls"] == 1 and sound["checked"]["rays"] > 0
    # a job of four batches, each at four times its rays in slots
    assert sound["attempted"] >= 1


@pytest.mark.parametrize("fault", ["lens_ior_1",
                                   "reference_capacity_dropped"])
def test_tiny_config3_refuses_a_fault(root, sound, fault):
    assert sound["correct"] is True
    broken = last_json(run_py(root, FAULTS[fault] + RUN_ONE.format(
        cell="tiny.c3pb", seed=SEED)))
    assert broken["correct"] is False, broken["checks"]


def test_job_ledger_against_one_batch_reads_incorrect(root, sound):
    """The same check against the job's ledger (the entry
    'trace_batched'): the spread between the batches shows."""
    assert sound["correct"] is True
    job = last_json(run_py(root, RUN_ONE.format(cell="tiny.c3job",
                                                seed=SEED)))
    assert job["correct"] is False, job["checks"]
    assert job["checks"]["ledger_gap"]["value"] > (
        10 * sound["checks"]["ledger_gap"]["value"])


def test_checked_rows_are_the_batch_rows(root):
    """call(i) hands the checked batch's rows, scaled by the batches, and
    keeps the job's rays and traced slots."""
    out = run_py(root, (
        "import numpy as np, torch\n"
        "from perfcells.harness import catalog, driver\n"
        "from perfcells.harness.scene import element_arrays\n"
        "wl = catalog.load_json('workloads', 'tiny.c3pb')\n"
        "config = catalog.load_json('configs', wl['config'])\n"
        f"run = driver.Run(config, wl['load'], wl['check'], "
        f"torch.device('cpu'), {SEED}, element_arrays(config))\n"
        "E = catalog.load_module('entries', config['entry']).Entry(run)\n"
        "job = E._job(E.total, run.seed + 0)\n"
        "res = E.call(0)\n"
        "b = E.checked_batch(0)\n"
        "assert 0 <= b < 4\n"
        "assert np.array_equal(res.per_detector, "
        "job.per_batch_detector[b] * 4)\n"
        "assert list(res.ledger.values()) == "
        "(job.per_batch_ledger[b] * 4).tolist()\n"
        "assert res.ledger['emitted'] == __import__('pytest').approx(1.0)\n"
        "assert res.rays_traced == job.rays_traced > 0\n"))
    assert out.returncode == 0, out.stderr[-3000:]
