"""Entry 'trace_batched_image': the job of entry 'trace_batched_per_batch'
(`Tracer.trace_batched`, `load.total_rays` rays in batches of
`load.batch_size`, checked on one whole batch against that batch's own
rows of the result) with the configuration's focal-plane image on
(`semantics`: image_bins, image_center, image_normal, image_halfwidth),
and the checked batch's image compared too.

`call(i)` hands the run loop the job's result with the checked batch's
ledger and detector rows, as that entry does, and its image row
`per_batch_image[b]`, scaled by the number of batches, in the place of
the histogram. `program_outcome` and `reference_outcome` put the two
images there, so `verdict.gaps`' `hist_gap` reads the summed absolute gap
of the two images' pixels, as a share of the power emitted. The
reference (`reference/image.py`) traces every ray of the batch at its
capacity and bins each measured hit as the program does. A program whose
TraceResult has no `per_batch_image` is refused at once."""

from __future__ import annotations

import dataclasses

from perfcells.entries import _common, trace_batched_per_batch
from perfcells.reference import image as ref_image
from perfcells.reference import sampling


class Entry(trace_batched_per_batch.Entry):
    def __init__(self, run):
        from lightpycl_tpu_torch.tracer.engine import TraceResult

        if "per_batch_image" not in {
                f.name for f in dataclasses.fields(TraceResult)}:
            raise RuntimeError(
                "the program's TraceResult has no per_batch_image: this "
                "entry compares one batch with that batch's own image")
        super().__init__(run)
        sem = self.opts
        self.kw.update(image_bins=int(sem["image_bins"]),
                       image_center=tuple(sem["image_center"]),
                       image_normal=tuple(sem["image_normal"]),
                       image_halfwidth=float(sem["image_halfwidth"]))

    def call(self, i):
        res = super().call(i)
        b = self.checked_batch(i)
        return dataclasses.replace(
            res, hist=res.per_batch_image[b] * float(self.n_batches))

    def program_outcome(self, kept):
        return _common.outcome(kept["ledger"], kept["live"],
                               kept["per_detector"], kept["hist"],
                               self.light["power"])

    def reference_outcome(self, i, dtype, scene):
        b = self.checked_batch(i)
        dev = scene["v0"].device
        u1, u2 = sampling.collimated_uniforms(dev, self.run.seed + i, b,
                                              self.batch)
        lt = self.light
        o, d, p = sampling.collimated_rays(lt["center"], lt["direction"],
                                           lt["diameter"], lt["power"],
                                           u1, u2)
        r = ref_image.trace(o, d, p, scene, self.opts, dtype, self.capacity)
        led = {k: r[k] for k in ("emitted", "measured", "absorbed",
                                 "escaped")}
        # a batch books what is left as culled
        led["culled"] = r["culled"] + r["live"]
        return _common.outcome(led, 0.0, r["per_detector"], r["image"],
                               lt["power"])
