"""Entry 'trace': `Tracer.trace(source, elements, mode=...)`, one call a
trace of `load.rays` source rays, the elements passed on every call as the
reference's scripts do. The check traces the same rays again (redrawn
from the source parameters and the call's seed) through the reference."""

from __future__ import annotations

import torch

from perfcells.entries import _common
from perfcells.entries._common import WARM_OFFSET
from perfcells.harness.scene import program_elements
from perfcells.reference import sampling
from perfcells.reference import trace as ref_trace


class Entry:
    def __init__(self, run):
        from lightpycl_tpu_torch.tracer.engine import Tracer

        self.run = run
        self.light = run.config["light"]
        self.n = int(run.load["rays"])
        self.rays_per_call = self.capacity = self.n
        self.opts = _common.opts(run.config)
        self.kw = _common.program_overrides(run.config)
        self.kw["mode"] = run.config["call"]["mode"]
        self.elements = program_elements(run.arrays)
        self.tracer = Tracer(device=run.device)

    def _trace(self, seed):
        src = _common.program_source(self.light, self.n, seed)
        return self.tracer.trace(src, self.elements, **self.kw)

    def warm(self):
        self._trace(self.run.seed + WARM_OFFSET)

    def call(self, i):
        return self._trace(self.run.seed + i)

    def release(self):
        self.tracer = self.elements = None

    def program_outcome(self, kept):
        return _common.outcome(kept["ledger"], kept["live"],
                               kept["per_detector"], kept["hist"],
                               self.light["power"])

    def reference_outcome(self, i, dtype, scene):
        lt = self.light
        o, d, p = sampling.point_source_rays(
            lt["center"], lt["direction"], lt["directivity"], lt["power"],
            self.n, self.run.seed + i)
        dev = scene["v0"].device
        r = ref_trace.trace(*(torch.as_tensor(x, device=dev)
                              for x in (o, d, p)), scene, self.opts, dtype)
        led = {k: r[k] for k in ("emitted", "measured", "absorbed",
                                 "escaped")}
        led["culled"] = 0.0
        return _common.outcome(led, r["live"], r["per_detector"], r["hist"],
                               lt["power"])
