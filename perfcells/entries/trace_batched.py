"""Entry 'trace_batched': `Tracer.trace_batched(source, total_rays,
batch_size, elements, seed)`, one call a job of `load.total_rays` rays in
batches of `load.batch_size`, sampled on the device from (seed, batch).

A job's outcome is a sum over all its batches, too many rays for a brute
reference to trace again. The check redraws `check.sample_rays` rays of one
batch of the job (drawn from the seed), with the same uniforms the
program's device sampler drew, traces them through the reference and
compares the shares of the emitted power; the job's histogram is left out
(a sample's counts spread more than a change in precision moves them).
A batch books the power still live when it retires as culled, so the
reference's culled and live power are booked together.

`call.capacity_multiple` (default 1) gives each batch that many times its
rays in slots, the headroom a splitting scene's children need; the
reference fits each bounce's children of its sample into the sample's
share of them (all of them where the sample is the whole batch)."""

from __future__ import annotations

import numpy as np
import torch

from perfcells.entries import _common
from perfcells.entries._common import WARM_OFFSET
from perfcells.harness import seeds
from perfcells.harness.scene import program_elements
from perfcells.reference import sampling
from perfcells.reference import trace as ref_trace


class Entry:
    def __init__(self, run):
        from lightpycl_tpu_torch.tracer.engine import Tracer

        self.run = run
        self.light = run.config["light"]
        self.total = int(run.load["total_rays"])
        self.batch = int(run.load["batch_size"])
        self.n_batches = self.total // self.batch
        self.rays_per_call = self.n_batches * self.batch
        self.source_rays = self.batch
        self.capacity = self.batch * _common.capacity_multiple(run.config)
        self.opts = _common.opts(run.config)
        self.kw = _common.program_overrides(run.config)
        self.elements = program_elements(run.arrays)
        self.tracer = Tracer(device=run.device)

    def _job(self, total, seed):
        src = _common.program_source(self.light, self.batch, seed)
        return self.tracer.trace_batched(src, total_rays=total,
                                         batch_size=self.batch,
                                         elements=self.elements, seed=seed,
                                         capacity=self.capacity, **self.kw)

    def warm(self):
        self._job(self.batch, self.run.seed + WARM_OFFSET)

    def call(self, i):
        return self._job(self.total, self.run.seed + i)

    def release(self):
        self.tracer = self.elements = None

    def program_outcome(self, kept):
        return _common.outcome(kept["ledger"], kept["live"],
                               kept["per_detector"], None,
                               self.light["power"])

    def reference_outcome(self, i, dtype, scene):
        seed = self.run.seed + i
        rng = seeds.rng(seed, 0xBA7)
        b = int(rng.integers(self.n_batches))
        n = min(int(self.run.check["sample_rays"]), self.batch)
        idx = np.sort(rng.choice(self.batch, size=n, replace=False))
        dev = scene["v0"].device
        u1, u2 = sampling.collimated_uniforms(dev, seed, b, self.batch)
        idx = torch.as_tensor(idx, device=dev)
        lt = self.light
        o, d, p = sampling.collimated_rays(lt["center"], lt["direction"],
                                           lt["diameter"], lt["power"],
                                           u1[idx], u2[idx])
        r = ref_trace.trace(o, d, p, scene, self.opts, dtype,
                            n * _common.capacity_multiple(self.run.config))
        led = {k: r[k] for k in ("emitted", "measured", "absorbed",
                                 "escaped")}
        # a batch books what is left as culled
        led["culled"] = r["culled"] + r["live"]
        return _common.outcome(led, 0.0, r["per_detector"], None,
                               lt["power"])
