"""Entry 'trace_batched_per_batch': the job of entry 'trace_batched'
(`Tracer.trace_batched`, `load.total_rays` rays in batches of
`load.batch_size`, sampled on the device from (seed, batch)), checked on
one whole batch against that batch's own rows of the result.

A splitting scene's top-k fits each bounce's children into the batch's
slots, so the reference models it exactly only where it traces the rays
that top-k saw: all of one batch, at the batch's capacity. A job's ledger
adds the spread between its batches to that comparison, so the check
compares batch b (drawn from the seed as entry 'trace_batched' draws it)
with the job's `per_batch_ledger[b]` and `per_batch_detector[b]`, scaled
by the number of batches so that `emitted` reads as the source's power.
`check.sample_rays` must be the batch size, so that the reference outcome
of entry 'trace_batched' traces every ray of the batch at its capacity. A
batch books the power still live when it retires as culled, as that
reference outcome does.

`call(i)` hands the driver the job's result with those rows standing for
its ledger and detector totals; its rays, `rays_traced` and `wall_time`
stay the job's. A program whose TraceResult has no `per_batch_ledger` is
refused at once."""

from __future__ import annotations

import dataclasses

from perfcells.entries import trace_batched
from perfcells.harness import seeds

LEDGER = ("emitted", "measured", "absorbed", "escaped", "culled")


class Entry(trace_batched.Entry):
    def __init__(self, run):
        from lightpycl_tpu_torch.tracer.engine import TraceResult

        if "per_batch_ledger" not in {
                f.name for f in dataclasses.fields(TraceResult)}:
            raise RuntimeError(
                "the program's TraceResult has no per_batch_ledger: this "
                "entry compares one batch with that batch's own ledger")
        super().__init__(run)
        if int(run.check["sample_rays"]) != self.batch:
            raise ValueError(
                f"check.sample_rays {run.check['sample_rays']} must be the "
                f"batch size {self.batch}: the whole batch is checked")

    def checked_batch(self, i):
        """The batch of call i that the check compares: the first draw of
        entry 'trace_batched''s reference outcome."""
        return int(seeds.rng(self.run.seed + i, 0xBA7).integers(
            self.n_batches))

    def call(self, i):
        res = super().call(i)
        b = self.checked_batch(i)
        scale = float(self.n_batches)
        return dataclasses.replace(
            res, ledger=dict(zip(LEDGER,
                                 (res.per_batch_ledger[b] * scale).tolist())),
            per_detector=res.per_batch_detector[b] * scale,
            final_live_power=0.0)
