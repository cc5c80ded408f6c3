"""The port's own spans and counters (`lightpycl_tpu_torch.utils.profiling`):
off (no profiler) they record nothing, never enter `record_function`,
retain no memory and add no torch op; under torch.profiler a culled
two-batch `trace_batched` records the documented tree, counters that
agree with what the nearest hit is given (`intersect.observer`), and the
same outputs as without the profiler."""

import collections
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import lightpycl_tpu_torch as P
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.utils import profiling as PF

BATCH = 512
TOTAL = 2 * BATCH


def elements():
    return [P.optical_elements(24, 12).parabolic_mirror(
                focus=1.0, diameter=4.0, reflectivity=0.95),
            P.optical_elements(32, 8).hemisphere(radius=100.0, name="dome")]


def source():
    return P.CollimatedSource(center=(0.0, 0.0, 5.0),
                              direction=(0.0, 0.0, -1.0), diameter=3.5,
                              power=1.0, ray_count=BATCH, seed=3)


def batched():
    return P.Tracer(device="cpu").trace_batched(
        source(), total_rays=TOTAL, batch_size=BATCH, elements=elements(),
        seed=5)


def traced():
    return P.Tracer(device="cpu").trace(source(), elements(),
                                        trace_iterations=3, mode="device")


def outputs(r):
    return (r.hist, r.per_detector, r.per_batch_detector,
            np.array(list(r.ledger.values())), r.rays_traced)


@pytest.fixture
def record():
    PF.clear()
    yield
    PF.clear()


@pytest.fixture(scope="module")
def profiled_run():
    """A culled two-batch job under the profiler, with what the nearest
    hit was given: each mask's set bits and each launch's live rays."""
    seen = {"bits": [], "alive": []}

    def observe(scene, o, d, cfg, alive, mask):
        words = mask.to(torch.int64) & 0xFFFFFFFF
        bits = (words[:, None] >> torch.arange(32)) & 1
        seen["bits"].append(int(bits.sum()))
        seen["alive"].append(int(alive.sum()))

    PF.clear()
    PI.intersect.observer = observe
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = batched()
    finally:
        PI.intersect.observer = None
    rec = PF.recorded()
    PF.clear()
    names = {ev.name for ev in prof.events()}
    return res, rec, seen, names


def test_off_records_nothing_and_never_opens_a_range(record, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not PF.enabled()
    traced()
    batched()
    assert PF.recorded() == PF.Record([], [], 0)


def test_off_span_and_count_retain_nothing(record):
    def sites():
        for _ in range(10_000):
            with PF.span("step.bounce"):
                PF.count("step.slots", 1 << 40)

    sites()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        sites()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before
    assert peak - before < 1024  # the interpreter's own, not per call
    assert PF.span("a") is PF.span("b")  # one shared no-op


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_counters_are_the_only_torch_ops_tracing_adds(record):
    """The same job dispatches the same torch ops with the profiler off
    and on, but for each device-valued count's sum, its running sum (one
    copy a call, then one in-place add an increment) and each span's
    range; so the off path adds none, and the on path no host read."""
    with Ops() as off:
        r_off = batched()
    with profile(activities=[ProfilerActivity.CPU]), Ops() as on:
        r_on = batched()
    device_valued = ("step.live_rays", "intersect.tiles_kept")
    assert PF._REC.counts and all(
        (key[2] is not None) == (key[0] in device_valued)
        for key in PF._REC.counts)
    sums = [acc for key, acc in PF._REC.counts.items() if key[2] is not None]
    n_incr = sum(acc[2] for acc in sums)
    n_spans = len(PF._REC.spans)
    assert n_incr > len(sums) > 0
    assert dict(on.n - off.n) == {
        "aten.sum.default": n_incr,
        "aten._to_copy.default": len(sums),
        "aten.add_.Tensor": n_incr - len(sums),
        "profiler._record_function_enter_new.default": n_spans,
        "profiler._record_function_exit._RecordFunction": n_spans}
    assert not off.n - on.n
    for a, b in zip(outputs(r_off), outputs(r_on)):
        np.testing.assert_array_equal(a, b)


def test_span_tree_of_a_batched_job(profiled_run):
    res, rec, _, _ = profiled_run
    spans = rec.spans
    assert rec.dropped == 0 and all(s.t1_ns is not None for s in spans)
    roots = [i for i, s in enumerate(spans) if s.name == "engine.call"]
    assert len(roots) == 1 and spans[roots[0]].parent is None
    call_id = spans[roots[0]].call_id
    assert call_id is not None and all(s.call_id == call_id for s in spans)
    batches = [i for i, s in enumerate(spans) if s.name == "engine.batch"]
    assert len(batches) == TOTAL // BATCH
    assert all(spans[i].parent == roots[0] for i in batches)
    bounces = [s for s in spans if s.name == "step.bounce"]
    assert all(s.parent in batches for s in bounces)
    assert len(bounces) == res.rays_traced // BATCH
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    kids = {s.name for s in spans if s.parent is not None
            and spans[s.parent].name == "step.bounce"}
    assert kids == {"step.reorder", "step.cull_mask", "step.nearest_hit",
                    "step.shade", "step.accumulate", "step.compact"}
    # the detector sums' index reads wait on the device inside the bounce
    assert {spans[s.parent].name for s in spans if s.name == "step.sync"} == {
        "engine.batch", "step.accumulate"}
    assert {s.name for s in spans if s.parent in batches} == {
        "engine.assemble", "engine.readback", "step.bounce", "step.sync"}
    assert {s.name for s in spans if s.parent == roots[0]} >= {
        "scene.build", "engine.resolve_cull", "engine.resolve_ray_len",
        "engine.batch", "engine.readback"}


def test_counters_agree_with_what_the_kernel_is_given(profiled_run):
    _, rec, seen, _ = profiled_run
    total = collections.Counter()
    for c in rec.counts:
        total[c.name] += c.value
    builds = sum(s.name == "scene.build" for s in rec.spans)
    # set_elements builds unsorted, the auto-cull then sorted
    assert total["scene.builds"] == builds == 2
    launches = sum(s.name == "step.nearest_hit" for s in rec.spans)
    assert len(seen["bits"]) == launches > 0
    assert total["intersect.tiles_kept"] == sum(seen["bits"])
    assert total["step.live_rays"] == sum(seen["alive"])
    assert total["step.slots"] == BATCH * len(seen["alive"])
    assert 0 < total["intersect.tiles_kept"] < total["intersect.tiles"]


def test_every_span_is_a_profiler_range(profiled_run):
    _, rec, _, names = profiled_run
    assert {PF.PREFIX + s.name for s in rec.spans} <= names


def test_profiled_outputs_equal_unprofiled(profiled_run, record):
    np.testing.assert_equal(outputs(profiled_run[0]), outputs(batched()))


def test_record_is_bounded(record, monkeypatch):
    monkeypatch.setattr(PF, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with PF.span("engine.call"):
            for _ in range(4):
                with PF.span("step.bounce"):
                    PF.count("step.slots", 2)
    rec = PF.recorded()
    assert [s.name for s in rec.spans] == ["engine.call", "step.bounce",
                                           "step.bounce"]
    assert [(c.call_id, c.n, c.value) for c in rec.counts] == [
        (rec.spans[0].call_id, 4, 8.0)]
    assert rec.dropped == 2
    assert all(s.parent in (None, 0) for s in rec.spans)


def test_counters_keep_one_running_sum_a_call(record):
    """However many increments, a counter keeps one sum for each call (a
    device value on its device until read), so the record grows with the
    calls and not with the bounces."""
    one = torch.ones((), dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with PF.span("engine.call"):
                for _ in range(1000):
                    PF.count("step.live_rays", one)
                    PF.count("step.slots", 3)
        PF.count("step.slots", 5)
    assert len(PF._REC.counts) == 5
    assert all(acc[3] is not one for acc in PF._REC.counts.values())
    assert int(one) == 1  # the caller's tensor is never added to
    rec = PF.recorded()
    a, b = (s.call_id for s in rec.spans)
    got = {(c.name, c.call_id): (c.n, c.value) for c in rec.counts}
    assert got == {("step.live_rays", a): (1000, 1000.0),
                   ("step.slots", a): (1000, 3000.0),
                   ("step.live_rays", b): (1000, 1000.0),
                   ("step.slots", b): (1000, 3000.0),
                   ("step.slots", None): (1, 5.0)}
    assert all(c.t0_ns <= c.t1_ns for c in rec.counts)


def lens_stack():
    oe = P.optical_elements(16, 6)
    return [oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
            oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5)),
            oe.sphere(radius=6.0, material="measure", name="enclosure")]


def split_job(**kw):
    """Two 256-ray batches through a two-lens stack at 1x capacity, so
    that the top-k fit drops children from the second bounce on."""
    src = P.CollimatedSource(center=(0.0, 0.0, -0.5),
                             direction=(0.0, 0.0, 1.0), diameter=0.5,
                             power=1.0)
    return P.Tracer(device="cpu").trace_batched(
        src, total_rays=512, batch_size=256, elements=lens_stack(), seed=7,
        trace_iterations=5, **kw)


def test_fit_counters_equal_the_live_children_of_shade(record, monkeypatch):
    import lightpycl_tpu_torch.tracer.step as S

    fits = []
    orig = S.compact

    def watched(sh, capacity, cfg):
        live = int((sh.child_alive & (sh.child_power > cfg.power_cutoff))
                   .sum())
        fits.append((live, min(live, capacity)))
        return orig(sh, capacity, cfg)

    monkeypatch.setattr(S, "compact", watched)
    with profile(activities=[ProfilerActivity.CPU]):
        res = split_job()
    rec = PF.recorded()
    total = collections.Counter()
    for c in rec.counts:
        total[c.name] += c.value
    assert total["compact.children"] == sum(n for n, _ in fits)
    assert total["compact.kept"] == sum(k for _, k in fits)
    # the fit dropped children, and ran once a bounce
    assert total["compact.kept"] < total["compact.children"]
    topk = [s for s in rec.spans if s.name == "compact.topk"]
    assert len(topk) == len(fits) == res.rays_traced // 256
    assert all(rec.spans[s.parent].name == "step.compact" for s in topk)


@pytest.mark.parametrize("job", ["mirror_only", "stream"])
def test_no_fit_records_no_fit_counters(record, job):
    with profile(activities=[ProfilerActivity.CPU]):
        if job == "mirror_only":
            batched()
        else:
            split_job(compaction="stream")
    rec = PF.recorded()
    assert rec.spans and rec.counts
    assert not {c.name for c in rec.counts} & {"compact.children",
                                                "compact.kept"}
    assert "compact.topk" not in {s.name for s in rec.spans}


def test_split_job_outputs_equal_with_recording_on_and_off(record):
    off = split_job()
    with profile(activities=[ProfilerActivity.CPU]):
        on = split_job()
    assert any(c.name == "compact.kept" for c in PF.recorded().counts)
    np.testing.assert_equal(outputs(on), outputs(off))
    np.testing.assert_array_equal(on.per_batch_ledger, off.per_batch_ledger)
