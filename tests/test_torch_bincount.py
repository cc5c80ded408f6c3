"""The detector maps' bincount (lightpycl_tpu_torch/ops/bincount.py).

* The plain version (the segmented Hillis-Steele scan) against a numpy
  copy of the scan's closed form, bit for bit: a bin's run of L slots in
  the stably sorted order splits by the binary digits of L into balanced
  pairwise trees, the smallest at the run's start, added left to right.
* A numpy mirror of csrc/bincount.cu's schedule (runs numbered from their
  last slot, chunks of 32-lane shuffle trees over groups and warps, the
  partials combined in rounds) against the same closed form, at the
  kernel's chunk and at small chunks that reach the combine's rounds, and
  over a focal map's 128^2 + 1 bins, more than a chunk's slots; and its
  chunk slots' layout (each bin's chunks, an empty bin's zero too, one
  slot each); so a slip in the kernel's node rule shows here before the
  card.
* The trace's host reads: a device-mode trace under the profiler reads the
  device once after each bounce but the last it may run
  (`step.host_reads`), bounce 0's early-exit test with bounce 1's; a loop
  whose first test fails returns what it was given.
* On a card (marker `cuda`): the kernel bit for bit against the plain
  version.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lightpycl_tpu_torch as P
from lightpycl_tpu_torch.ops import bincount as B
from lightpycl_tpu_torch.utils import profiling as PF


def _tree(block):
    """A balanced pairwise tree over 2^k values: left half + right half."""
    while len(block) > 1:
        block = block[0::2] + block[1::2]
    return block[0]


def closed_form(idx, vals, n_bins):
    """The scan's sums in closed form (numpy, vals' own precision)."""
    order = np.argsort(idx, kind="stable")
    k, x = idx[order], vals[order]
    out = np.zeros((n_bins,) + vals.shape[1:], vals.dtype)
    starts = np.searchsorted(k, np.arange(n_bins + 1))
    for b in range(n_bins):
        run = x[starts[b]:starts[b + 1]]
        at, acc = 0, None
        for bit in range(len(run).bit_length()):
            if len(run) >> bit & 1:
                s = _tree(run[at:at + (1 << bit)])
                acc = s if acc is None else acc + s
                at += 1 << bit
        if acc is not None:
            out[b] = acc
    return out


def _shfl_tree(v, valid):
    """The kernel's shuffle tree over the lanes of v: at each offset a lane
    adds the one `off` above it (its left child) where valid(lane + off);
    lane 0 ends with the node. Lanes past the end read their own value, as
    __shfl_down_sync does."""
    v = v.copy()
    lanes = np.arange(len(v))
    off = 1
    while off < len(v):
        src = np.where(lanes + off < len(v), lanes + off, lanes)
        left = v[src]
        v = np.where(valid(lanes + off), left + v, v)
        off *= 2
    return v[0]


def chunk_tree(leaf, length, groups, warps):
    """csrc/bincount.cu's `chunk_tree`: leaves q < length of one chunk of
    32 x groups x warps, leaf(q) the value."""
    wsum = []
    for w in range(warps):
        wbase = w * groups * 32
        mine = np.zeros(groups, leaf(0).dtype)
        for m in range(groups):
            base = wbase + m * 32
            if base >= length:
                break
            q = base + np.arange(32)
            x = np.where(q < length, leaf(np.minimum(q, length - 1)), 0)
            mine[m] = _shfl_tree(x.astype(mine.dtype),
                                 lambda lane: base + lane < length)
        wsum.append(_shfl_tree(mine,
                               lambda lane: wbase + lane * 32 < length))
    return _shfl_tree(np.array(wsum),
                      lambda lane: lane * groups * 32 < length)


def kernel_mirror(idx, vals, n_bins, groups=32, warps=8):
    """csrc/bincount.cu's schedule in numpy, one column at a time."""
    chunk = 32 * groups * warps
    order = np.argsort(idx, kind="stable")
    k = idx[order]
    x = vals[order].reshape(len(idx), -1)
    out = np.zeros((n_bins, x.shape[1]), vals.dtype)
    starts = np.searchsorted(k, np.arange(n_bins + 1))
    for b in range(n_bins):
        a, L = starts[b], starts[b + 1] - starts[b]
        if L == 0:
            continue
        e = a + L - 1
        for w in range(x.shape[1]):
            col = x[:, w]
            part = np.array([
                chunk_tree(lambda q, c=c: col[e - c * chunk - q],
                           min(chunk, L - c * chunk), groups, warps)
                for c in range(-(-L // chunk))])
            while len(part) > chunk:  # the combine's rounds
                part = np.array([
                    chunk_tree(lambda q, u=u: part[u * chunk + q],
                               min(chunk, len(part) - u * chunk), groups,
                               warps)
                    for u in range(-(-len(part) // chunk))])
            out[b, w] = chunk_tree(lambda q: part[q], len(part), groups,
                                   warps)
    return out.reshape((n_bins,) + vals.shape[1:])


def _values(rng, n, cols=()):
    """Float32 values of mixed magnitude, so that association shows."""
    v = rng.uniform(0, 1, (n,) + cols) * 10.0 ** rng.integers(-6, 3,
                                                              (n,) + cols)
    return v.astype(np.float32)


def case(name, rng):
    """(idx, vals, n_bins) of a named input."""
    if name == "run_lengths":
        # runs of 1, 2^k - 1, 2^k and 2^k + 1 slots, shuffled
        lengths = [1] + [n for k in range(1, 8)
                         for n in (2 ** k - 1, 2 ** k, 2 ** k + 1)]
        idx = np.repeat(np.arange(len(lengths)), lengths)
        return rng.permutation(idx), _values(rng, len(idx)), len(lengths)
    if name == "one_run":
        return np.full(3001, 4), _values(rng, 3001), 9
    if name == "empty_bins":
        idx = rng.choice([0, 3, 4, 11], 700)
        return idx, _values(rng, 700), 16
    if name == "n_1":
        return np.array([2]), _values(rng, 1), 5
    if name == "columns":
        idx = rng.integers(0, 7, 900)
        idx[:200] = 6
        return idx, _values(rng, 900, (3,)), 7
    if name == "drop_bin_last_occupied":
        # the last bin's run ends the sorted order, right before the drop bin
        idx = rng.integers(0, 5, 500)
        idx[rng.choice(500, 77, replace=False)] = 5
        return idx, _values(rng, 500), 6
    if name == "out_of_range_keys":
        # keys below 0, more than a kernel chunk of them, and at or above
        # n_bins are left out
        idx = np.concatenate([rng.integers(-3, 0, 9000),
                              rng.integers(0, 6, 600),
                              rng.integers(6, 8, 50)])
        return rng.permutation(idx), _values(rng, len(idx)), 6
    if name == "signed_zeros":
        # bins 0 and 2 sum only -0.0: a run's absent slot, added as +0.0,
        # would turn its sum to +0.0
        idx = rng.permutation(np.repeat([0, 1, 2, 3], [13, 20, 7, 24]))
        vals = np.where((idx % 2 == 0) | (rng.random(64) < 0.5), -0.0, 0.0)
        return idx, vals.astype(np.float32), 5
    if name == "image_map":
        # a 128^2 focal map's nb^2 + 1 bins, more than a kernel chunk has
        # slots: half the slots in the drop bin (three chunks), a caustic
        # pixel of more than a chunk, the rest in a central disc
        nb = 128
        n = 40_000
        r = nb / 4 * np.sqrt(rng.random(n))
        phi = rng.uniform(0, 2 * np.pi, n)
        idx = ((nb // 2 + r * np.cos(phi)).astype(np.int64) * nb
               + (nb // 2 + r * np.sin(phi)).astype(np.int64))
        pick = rng.random(n)
        idx[pick < 0.25] = nb // 2 * nb + nb // 2
        idx[pick >= 0.5] = nb * nb
        vals = _values(rng, n)
        vals[rng.random(n) < 0.6] = 0.0
        return rng.permutation(idx), vals, nb * nb + 1
    raise ValueError(name)


CASES = ["run_lengths", "one_run", "empty_bins", "n_1", "columns",
         "drop_bin_last_occupied", "signed_zeros", "out_of_range_keys",
         "image_map"]


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("name", CASES)
def test_plain_version_is_the_closed_form_bit_for_bit(name):
    idx, vals, n_bins = case(name, np.random.default_rng(25))
    want = closed_form(idx, vals, n_bins)
    for key_dtype in (torch.int32, torch.int64):
        got = B.bincount_sorted_torch(torch.from_numpy(idx).to(key_dtype),
                                      torch.from_numpy(vals), n_bins)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    if vals.ndim == 2:  # each column sums exactly as it would alone
        for j in range(vals.shape[1]):
            alone = B.bincount_sorted_torch(torch.from_numpy(idx),
                                            torch.from_numpy(vals[:, j]),
                                            n_bins)
            np.testing.assert_array_equal(bits(alone.numpy()),
                                          bits(want[:, j]))


@pytest.mark.parametrize("name", CASES)
def test_kernel_schedule_is_the_closed_form_bit_for_bit(name):
    idx, vals, n_bins = case(name, np.random.default_rng(26))
    np.testing.assert_array_equal(bits(kernel_mirror(idx, vals, n_bins)),
                                  bits(closed_form(idx, vals, n_bins)))


def slot_layout(idx, n_bins, chunk=8192):
    """csrc/bincount.cu's `runs_kernel` and the head of `chunks_kernel` in
    numpy: the owner bin each chunk slot g reads, and the (bin, chunk) it
    sums or None where the CTA returns at once."""
    k = np.sort(idx)
    slots = len(idx) // chunk + n_bins
    owner = np.full(slots, -1)
    a = np.searchsorted(k, np.arange(n_bins + 1))
    for b in range(n_bins):
        s0 = 0 if b == 0 else a[b] // chunk + b
        s1 = slots if b + 1 == n_bins else a[b + 1] // chunk + b + 1
        owner[s0:s1] = b
    work = []
    for g, b in enumerate(owner):
        L = a[b + 1] - a[b]
        c = g - (a[b] // chunk + b)
        work.append((b, c) if 0 <= c < max(1, -(-L // chunk)) else None)
    return owner, work, a


@pytest.mark.parametrize("name", CASES)
def test_kernel_slot_layout_gives_each_chunk_one_slot(name):
    idx, _, n_bins = case(name, np.random.default_rng(26))
    owner, work, a = slot_layout(idx, n_bins)
    # every slot has its owner written, and every chunk of every bin (an
    # empty bin's zero too) has exactly one slot
    assert (owner >= 0).all()
    want = [(b, c) for b in range(n_bins)
            for c in range(max(1, -(-(a[b + 1] - a[b]) // 8192)))]
    assert sorted(w for w in work if w is not None) == want


@pytest.mark.parametrize("groups,warps,n", [
    (32, 8, 3 * 8192 + 5),   # the kernel's chunk: partials, no round
    (2, 2, 128 * 131 + 3),   # 132 chunks of 128: one combine round
    (1, 1, 32 * 40),         # chunks of 32, two rounds
])
def test_kernel_schedule_across_chunks(groups, warps, n):
    rng = np.random.default_rng(n)
    idx = np.sort(rng.integers(0, 3, n))
    idx[: n // 2] = 1  # one run of more than half the slots
    vals = _values(rng, n)
    np.testing.assert_array_equal(
        bits(kernel_mirror(idx, vals, 4, groups, warps)),
        bits(closed_form(idx, vals, 4)))


def test_dispatch_runs_the_plain_version_on_the_cpu(monkeypatch):
    def refuse():
        raise AssertionError("the kernel was loaded for CPU tensors")

    monkeypatch.setattr(B, "load_kernel", refuse)
    idx, vals, n_bins = case("empty_bins", np.random.default_rng(27))
    got = B.bincount_sorted(torch.from_numpy(idx), torch.from_numpy(vals),
                            n_bins)
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(closed_form(idx, vals, n_bins)))
    assert not B.bincount_sorted(torch.zeros(0, dtype=torch.int64),
                                 torch.zeros(0), n_bins).any()


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        B.bincount_sorted_cuda(torch.zeros(3, dtype=torch.int64),
                               torch.zeros(3), 2)


def _traced(target):
    """A position-histogram trace (the default `hist_mode`), 4 bounces at
    most, under the profiler: (result, bounces, host reads, step.sync
    spans)."""
    els = [P.optical_elements(24, 12).parabolic_mirror(
               focus=1.0, diameter=4.0, reflectivity=0.95),
           P.optical_elements(32, 8).hemisphere(radius=100.0, name="dome")]
    src = P.CollimatedSource(center=(0.0, 0.0, 5.0),
                             direction=(0.0, 0.0, -1.0), diameter=3.5,
                             power=1.0, ray_count=512, seed=3)
    PF.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            res = P.Tracer(device="cpu").trace(src, els, trace_iterations=4,
                                               mode="device",
                                               dissipation_target=target)
        rec = PF.recorded()
    finally:
        PF.clear()
    return (res, sum(s.name == "step.bounce" for s in rec.spans),
            sum(c.value for c in rec.counts if c.name == "step.host_reads"),
            sum(s.name == "step.sync" for s in rec.spans))


@pytest.mark.parametrize("target,exits_early", [(1.5, False),
                                                (0.5, True)])
def test_a_device_trace_reads_the_device_once_a_bounce(target,
                                                       exits_early):
    """The loop's only host read is the early-exit test, after each bounce
    but the fourth: a loop that runs its 4 bounces reads 3 times, one that
    ends early once a bounce."""
    res, bounces, reads, syncs = _traced(target)
    assert (bounces < 4) == exits_early and bounces > 0
    assert res.iterations_run == bounces
    assert reads == syncs == bounces - (not exits_early)


def test_a_loop_whose_first_test_fails_returns_what_it_was_given():
    """With a target of 0 the reference runs no bounce. The loop runs bounce
    0 before it reads that test, then returns the state it was given: no
    bounce counted, nothing measured, every ray still alive."""
    res, bounces, reads, syncs = _traced(0.0)
    assert bounces == reads == syncs == 1
    assert res.iterations_run == 0 and res.rays_traced == 0
    assert not res.hist.any() and not res.per_detector.any()
    led = res.ledger
    assert led["measured"] == led["absorbed"] == led["escaped"] == 0.0
    assert res.final_live_power == pytest.approx(led["emitted"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + ["config_sizes"])
def test_kernel_bit_equal_to_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(28)
    if name == "config_sizes":
        idx = rng.integers(0, 648, 800_000)
        idx[rng.random(800_000) < 0.6] = 17  # one long run
        inputs = [(idx, _values(rng, 800_000), 648)]
    else:
        inputs = [case(name, rng)]
    for idx, vals, n_bins in inputs:
        for key_dtype in (torch.int32, torch.int64):
            for val_dtype in (torch.float32, torch.float64):
                i = torch.from_numpy(idx).to(key_dtype).cuda()
                v = torch.from_numpy(vals).to(val_dtype).cuda()
                before = B.bincount_sorted_cuda.launches
                k = B.bincount_sorted(i, v, n_bins)
                assert B.bincount_sorted_cuda.launches == before + 1
                p = B.bincount_sorted_torch(i, v, n_bins)
                again = B.bincount_sorted(i, v, n_bins)
                torch.cuda.synchronize()
                assert torch.equal(k, p) and torch.equal(k, again)
                assert torch.equal(torch.signbit(k), torch.signbit(p))
