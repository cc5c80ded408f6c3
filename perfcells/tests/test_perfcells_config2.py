"""Config 2's plano-convex focal map (`configs/config2_plano_convex.json`,
entry `trace_batched_image`): its frozen meshers give the port's meshes
bit for bit, and its own file, shrunk to n_segments 16 and n_radial 6 and
run as a job of four 2,048-ray batches, reads correct on the CPU, and
incorrect with the program's image shifted by a pixel, with the
reference's capacity dropped, and with the image's half-width changed on
one side only. The image reference reads the same bits twice."""

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

CELL = "config2.plano_convex_map"
CONFIG = "config2_plano_convex"
BATCH = 2048
SEED = 2**31 + 7

FAULTS = {
    # every pixel of the program's image one row further along x
    "image_shifted_a_pixel": (
        "import torch\nimport lightpycl_tpu_torch.tracer.step as S\n"
        "orig = S.image_flat_indices\n"
        "def shifted(hit_point, cfg):\n"
        "    flat = orig(hit_point, cfg)\n"
        "    nb = cfg.image_bins\n"
        "    return torch.where(flat < nb * nb - nb, flat + nb, nb * nb)\n"
        "S.image_flat_indices = shifted\n"),
    "reference_capacity_dropped": (
        "import torch\nimport perfcells.reference.image as RI\n"
        "orig = RI.trace\n"
        "RI.trace = lambda o, d, p, scene, opts, dtype=torch.float64, "
        "capacity=None: orig(o, d, p, scene, opts, dtype, None)\n"),
    "program_halfwidth_changed": (
        "from perfcells.harness import catalog\n"
        "E = catalog.load_module('entries', 'trace_batched_image').Entry\n"
        "orig = E.__init__\n"
        "def init(self, run):\n"
        "    orig(self, run)\n"
        "    self.kw['image_halfwidth'] *= 1.1\n"
        "E.__init__ = init\n"),
}

RUN_ONE = ("import json\nfrom perfcells.harness import driver\n"
           "print(json.dumps(driver.run_cell({cell!r}, {seed}, 0.5, False, "
           "device='cpu')))\n")


def port_meshes():
    import lightpycl_tpu_torch as P

    oe = P.optical_elements(128, 48)
    return [oe.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1,
                                 ior=1.5),
            oe.disc(radius=0.5, center=(0, 0, 1.1), material="measure"),
            oe.sphere(radius=10.0, material="terminator")]


def test_frozen_meshers_equal_the_ports():
    arrays = element_arrays(catalog.load_json("configs", CONFIG))
    for a, g in zip(arrays, port_meshes(), strict=True):
        assert a["vertices"].dtype == g.vertices.dtype
        assert a["triangles"].dtype == g.triangles.dtype
        assert np.array_equal(a["vertices"], g.vertices), a["name"]
        assert np.array_equal(a["triangles"], g.triangles), a["name"]
        assert a["material"] == g.material.name.lower(), a["name"]
        if a["material"] == "refractive":
            assert a["ior"] == g.ior
    assert [len(a["triangles"]) for a in arrays] == [24_320, 12_160, 12_032]
    assert sum(len(a["triangles"]) for a in arrays) == 48_512


def add_tiny_cell(root: Path) -> str:
    """Config 2's file shrunk to (16, 6), and a cell of one job of four
    2,048-ray batches at config 2's check and limits, the whole batch
    checked; returns the cell's name."""
    pc = root / "perfcells"
    config = _shrink(catalog.load_json("configs", CONFIG), "c2",
                     [(16, 6)] * 3)
    (pc / "configs" / "c2.json").write_text(json.dumps(config))
    w = catalog.load_json("workloads", CELL)
    cell = "tiny.c2"
    w.update(config="c2", traffic="c2", why="config 2 at (16, 6)")
    w["load"].update(total_rays=4 * BATCH, batch_size=BATCH)
    w["check"].update(calls=1, within=1, launch_rays=512, sample_rays=BATCH)
    w["profile"] = {"after_s": 0.0, "for_s": 0.2}
    (pc / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": "c2",
                               "traffic": "c2", "chips": 1, "why": w["why"]})
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_copy(tmp_path_factory.mktemp("perfcells"))
    add_tiny_cell(root)
    return root


@pytest.fixture(scope="module")
def sound(root):
    return last_json(run_py(root, RUN_ONE.format(cell="tiny.c2",
                                                 seed=SEED)))


def test_tiny_config2_reads_correct(sound):
    assert sound["correct"] is True, sound["checks"]
    assert sound["checked"]["calls"] == 1 and sound["checked"]["rays"] > 0
    assert set(sound["checks"]) >= {"ledger_gap", "detector_gap",
                                    "hist_gap"}
    assert sound["attempted"] >= 1


@pytest.mark.parametrize("fault,shows", [
    ("image_shifted_a_pixel", "hist_gap"),
    ("program_halfwidth_changed", "hist_gap"),
    ("reference_capacity_dropped", "ledger_gap")])
def test_tiny_config2_refuses_a_fault(root, sound, fault, shows):
    assert sound["correct"] is True
    broken = last_json(run_py(root, FAULTS[fault] + RUN_ONE.format(
        cell="tiny.c2", seed=SEED)))
    print(fault, {k: c["value"] for k, c in broken["checks"].items()})
    assert broken["correct"] is False, broken["checks"]
    c = broken["checks"][shows]
    assert c["value"] > c["limit"], broken["checks"]


def test_image_reference_reads_the_same_bits_twice(root):
    out = run_py(root, (
        "import numpy as np, torch\n"
        "from perfcells.harness import catalog, driver\n"
        "from perfcells.harness.scene import element_arrays\n"
        "from perfcells.reference import trace as RT\n"
        "wl = catalog.load_json('workloads', 'tiny.c2')\n"
        "config = catalog.load_json('configs', wl['config'])\n"
        f"run = driver.Run(config, wl['load'], wl['check'], "
        f"torch.device('cpu'), {SEED}, element_arrays(config))\n"
        "E = catalog.load_module('entries', config['entry']).Entry(run)\n"
        "scene = RT.scene_arrays(run.arrays, torch.device('cpu'))\n"
        "a = E.reference_outcome(0, torch.float64, scene)\n"
        "b = E.reference_outcome(0, torch.float64, scene)\n"
        "assert a['ledger'] == b['ledger']\n"
        "assert np.array_equal(a['per_detector'], b['per_detector'])\n"
        "assert np.array_equal(a['hist'], b['hist'])\n"
        "assert a['hist'].shape == (128, 128)\n"
        # the image holds the measured power that lands in its grid
        "assert 0.5 < a['hist'].sum() <= a['ledger']['measured'] + 1e-12\n"
        "print(a['hist'].sum(), a['ledger'])\n"))
    assert out.returncode == 0, out.stderr[-3000:]


def test_checked_rows_are_the_batch_rows(root):
    """call(i) hands the checked batch's image row, scaled by the batches,
    in the histogram's place, beside its ledger and detector rows."""
    out = run_py(root, (
        "import numpy as np, torch\n"
        "from perfcells.harness import catalog, driver\n"
        "from perfcells.harness.scene import element_arrays\n"
        "wl = catalog.load_json('workloads', 'tiny.c2')\n"
        "config = catalog.load_json('configs', wl['config'])\n"
        f"run = driver.Run(config, wl['load'], wl['check'], "
        f"torch.device('cpu'), {SEED}, element_arrays(config))\n"
        "E = catalog.load_module('entries', config['entry']).Entry(run)\n"
        "job = E._job(E.total, run.seed + 0)\n"
        "res = E.call(0)\n"
        "b = E.checked_batch(0)\n"
        "assert job.per_batch_image.shape == (4, 128, 128)\n"
        "assert np.array_equal(res.hist, job.per_batch_image[b] * 4)\n"
        "assert np.array_equal(res.image, job.image)\n"
        "assert np.array_equal(res.per_detector, "
        "job.per_batch_detector[b] * 4)\n"
        "assert res.rays_traced == job.rays_traced > 0\n"))
    assert out.returncode == 0, out.stderr[-3000:]


def test_a_program_without_image_rows_is_refused(root):
    out = run_py(root, (
        "import dataclasses\n"
        "import lightpycl_tpu_torch.tracer.engine as EN\n"
        "fields = [(f.name, f.type, f) for f in dataclasses.fields("
        "EN.TraceResult) if f.name != 'per_batch_image']\n"
        "EN.TraceResult = dataclasses.make_dataclass('TraceResult', "
        "[(n, t, f) for n, t, f in fields])\n"
        + RUN_ONE.format(cell="tiny.c2", seed=SEED)))
    assert out.returncode != 0
    assert "has no per_batch_image" in out.stderr
