"""The metric arithmetic on synthetic inputs: the roofline bound, pairs
kept by a cull mask, the union and idle share, the gap labels, the prep
time and the rates."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfcells.harness import catalog, profile  # noqa: E402
from perfcells.harness.taps import pairs_of  # noqa: E402

R = catalog.load_module("metrics", "_roofline")


def read(name, ctx):
    return catalog.load_module("metrics", name).read(ctx)


def test_bound_is_the_larger_of_flops_and_bytes():
    # compute-bound: 67e12 / 29 pairs take one second
    assert R.bound_s(67e12 / 29, 1, 1) == pytest.approx(1.0)
    # bytes-bound: no pairs, 3.35e12 bytes of rays (32 B each)
    assert R.bound_s(0, 3.35e12 / 32, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 0, 0, mask_words=3.35e12 / 4) == pytest.approx(1.0)


def test_pairs_of_a_launch():
    alive = torch.tensor([True, False, True, True])
    rec = {"n_rays": 4, "alive": alive, "mask": None, "mask_words": 0}
    assert pairs_of(rec, 1000, 256, 256) == 3 * 1000
    # bits 0 and 31 of one word, bit 2 of another: 3 (block, tile) pairs
    mask = torch.tensor([1 | (1 << 31) - (1 << 32), 4], dtype=torch.int64)
    rec = {"n_rays": 512, "alive": None, "mask": mask.to(torch.int32),
           "mask_words": 2}
    assert pairs_of(rec, 10**6, 256, 256) == 3 * 256 * 256


def test_union_merges_overlaps():
    assert profile._union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3],
                                                                [5, 8]]


def test_gap_labels_name_the_span_and_innermost_op():
    cpu = [(0, 100, "perfcells.call"), (10, 40, "aten::add"),
           (12, 20, "cudaLaunchKernel"), (200, 300, "perfcells.call")]
    assert profile._labels([15, 30, 50, 150, 250], cpu) == [
        "perfcells.call > cudaLaunchKernel", "perfcells.call > aten::add",
        "perfcells.call", "host", "perfcells.call"]


def _ctx():
    calls = [{"i": i, "t0": 1.0 + i, "t1": 1.5 + i, "span_s": 0.5,
              "wall_s": 0.2, "rays": 1000, "bounces": 2,
              "profiled": i in (1, 2)} for i in range(4)]
    prof = {"kernel_s": {"nearest_hit_kernel(float const*)": 0.3,
                         "ncclDevKernel_AllReduce": 0.05,
                         "Memcpy HtoD": 0.1},
            "busy_s": 0.45, "window_s": 1.5}
    return {"calls": calls, "window_t0": 1.0, "setup_s": 9.0,
            "profile": prof, "bounds_s": [0.05, 0.1]}


def test_readers_on_a_synthetic_window():
    ctx = _ctx()
    assert read("rays_per_s", ctx) == pytest.approx(4000 / 3.5)
    assert read("trace_p95_ms", ctx) == pytest.approx(500.0)
    assert read("setup_s", ctx) == 9.0
    assert read("engine.prep_ms_per_trace", ctx) == pytest.approx(300.0)
    assert read("step.other_device_ms_per_bounce", ctx) == pytest.approx(25.0)
    assert read("nearest_hit_roofline", ctx) == pytest.approx(50.0)
    assert read("nearest_hit.ms_per_trace", ctx) == pytest.approx(150.0)
    assert read("device.idle_pct", ctx) == pytest.approx(70.0)
    assert read("parallel.allreduce_ms_per_trace", ctx) == pytest.approx(25.0)


def test_readers_leave_out_what_they_cannot_read():
    ctx = dict(_ctx(), profile=None)
    for name in ("step.other_device_ms_per_bounce",
                 "nearest_hit_roofline", "nearest_hit.ms_per_trace",
                 "device.idle_pct", "parallel.allreduce_ms_per_trace"):
        assert read(name, ctx) is None
    ctx = _ctx()
    ctx["profile"]["kernel_s"] = {"Memcpy HtoD": 0.1}
    assert read("nearest_hit_roofline", ctx) is None
    assert read("parallel.allreduce_ms_per_trace", ctx) is None


def test_reduce_leaves_host_ranges_out_of_device_time():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, s, e, dev):
        return NS(name=name, device_type=DeviceType.CUDA if dev
                  else DeviceType.CPU, time_range=NS(start=s, end=e))

    events = [ev("perfcells.window", 0, 1000, False),
              ev("perfcells.call", 0, 900, False),
              ev("nccl:all_reduce", 500, 700, False),
              ev("perfcells.call", 0, 900, True),  # annotations on the device
              ev("nccl:all_reduce", 500, 700, True),
              ev("nearest_hit_kernel(...)", 100, 300, True),
              ev("ncclDevKernel_AllReduce_Sum_f32", 500, 700, True),
              ev("warm_kernel_before_the_window", -300, -100, True)]
    p = profile.reduce(NS(events=lambda: events))
    assert set(p["kernel_s"]) == {"nearest_hit_kernel(...)",
                                  "ncclDevKernel_AllReduce_Sum_f32"}
    assert p["busy_s"] == pytest.approx(400e-6)
    assert p["window_s"] == pytest.approx(1000e-6)
    assert sum(s for _, s in p["idle_gaps"]) == pytest.approx(600e-6)
