"""The check fails what it must, at tiny sizes on the CPU: the control
(the reference computed in bfloat16, put in the program's place), and
whole runs with the timed path broken underneath (the harness's look for
a card skipped): a step that returns its state unchanged, half of the
batch left out with the mean taken over the rest, answers altered where
the nearest hit produces them, and the exchange between ranks left out.
On a card, one short run of a cell reads correct."""

import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfcells.tests._copy import HOME, last_json, run_py, tiny_copy  # noqa: E402

FAULTS = {
    "unchanged_step": (
        "import lightpycl_tpu_torch.tracer.step as S\n"
        "S.trace_step = lambda scene, rays, det, led, cfg, **kw: "
        "(rays, det, led, None)\n"),
    "half_batch": (
        "import torch\nimport lightpycl_tpu_torch.tracer.step as S\n"
        "orig = S.trace_loop\n"
        "def half(scene, rays, det, led, cfg, iterations, rng_words=None):\n"
        "    keep = torch.arange(rays.capacity, device=rays.o.device) "
        "< rays.capacity // 2\n"
        "    rays = rays._replace(alive=rays.alive & keep,\n"
        "                         power=torch.where(keep, 2 * rays.power, 0.0))\n"
        "    return orig(scene, rays, det, led, cfg, iterations, rng_words)\n"
        "S.trace_loop = half\n"),
    "altered_answer": (
        "import lightpycl_tpu_torch.ops.intersect as PI\n"
        "orig = PI.nearest_hit\n"
        "def altered(*a, **kw):\n"
        "    t, tri = orig(*a, **kw)\n"
        "    t = t.clone(); t[::16] = t[::16] * 1.001\n"
        "    return t, tri\n"
        "PI.nearest_hit = altered\n"),
    "no_exchange": (
        "import lightpycl_tpu_torch.parallel.distributed as D\n"
        "import lightpycl_tpu_torch.parallel.sharding as SH\n"
        "D.all_reduce_packed = SH.all_reduce_packed = "
        "lambda tensors, group, op=None: [t.clone() for t in tensors]\n"),
}

RUN_ONE = ("import json\nfrom perfcells.harness import driver\n"
           "print(json.dumps(driver.run_cell({cell!r}, {seed}, 0.5, False, "
           "device='cpu')))\n")

RANK = ("from perfcells.harness import driver\n"
        "r, dp, sp = map(int, sys.argv[1:])\n"
        "driver.run_rank('tiny.c5', {seed}, 0.5, False, r, 2, dp, sp, "
        "device='cpu')\n")

RUN_RANKS = ("import json\nfrom perfcells.harness import driver\n"
             "argv = lambda r, dp, sp: [sys.executable, {rank!r}, str(r), "
             "str(dp), str(sp)]\n"
             "print(json.dumps(driver.run_ranks(argv, 'tiny.c5', {seed}, 0.5, "
             "False, 2, device='cpu')))\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("perfcells"))


def _multi(root, fault, seed):
    rank = root / "_rank.py"
    rank.write_text(f"import sys\nsys.path[:0] = [{str(root)!r}, "
                    f"{str(HOME.parent)!r}]\n" + fault
                    + RANK.format(seed=seed))
    return last_json(run_py(root, fault + RUN_RANKS.format(rank=str(rank),
                                                           seed=seed)))


@pytest.mark.parametrize("cell", ["tiny.c1", "tiny.c4"])
def test_control_fails_where_the_program_passes(root, cell):
    out = run_py(root, (
        "from perfcells.readings import readings\n"
        "from perfcells.harness import catalog, verdict\n"
        f"lim = catalog.load_json('workloads', {cell!r})['check']['limits']\n"
        f"prog, ctrl = readings({cell!r}, [2**31 + 11], {{2**31 + 11}}, "
        "device='cpu')\n"
        "assert verdict.judged(prog, lim)[0], prog\n"
        "assert not verdict.judged(ctrl, lim)[0], ctrl\n"))
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.c1", "unchanged_step"), ("tiny.c1", "half_batch"),
    ("tiny.c1", "altered_answer"), ("tiny.c4", "unchanged_step"),
    ("tiny.c4", "half_batch"), ("tiny.c4", "altered_answer")])
def test_broken_timed_path_reads_incorrect(root, cell, fault):
    sound = last_json(run_py(root, RUN_ONE.format(cell=cell, seed=2**31 + 5)))
    assert sound["correct"] is True, sound["checks"]
    broken = last_json(run_py(root, FAULTS[fault] + RUN_ONE.format(
        cell=cell, seed=2**31 + 5)))
    assert broken["correct"] is False, broken["checks"]


def test_multichip_without_the_exchange_reads_incorrect(root):
    assert _multi(root, "", 2**31 + 21)["correct"] is True
    assert _multi(root, FAULTS["no_exchange"], 2**31 + 21)["correct"] is False


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark runs on the card only)")
    p = subprocess.run([sys.executable, str(HOME / "run.py"), "--workload",
                        "config4.collimated_100m", "--seed",
                        str(2**31 + 1), "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert '"correct": true' in p.stdout.strip().splitlines()[-1]
