"""Taps on the program's nearest-hit launches.

The program's hook `ops.intersect.intersect.observer` is called before
every nearest hit of a trace with the rays as launched, their alive flags
and the cull mask. `Tap` sits on it and, while `capture` is set, also
wraps the dispatcher `ops.intersect.nearest_hit` for the launch that
follows, so that it keeps what the launch returned. Both are restored on
exit; outside a tap the timed path runs untouched.

* capture: a sample of whole ray blocks of each launch (drawn from the
  run's seed), with the program's rows of the triangles it reports, so
  the check can decode the program's triangle index into geometry; and
  the live rays of each captured call's first launch (every source ray
  is live there).
* count: each launch's shape and either its alive flags or its cull mask,
  held by reference and reduced to pairs only after the profiled window,
  so that counting adds no device work inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from perfcells.harness import seeds


class Tap:
    def __init__(self, seed: int, launch_rays: int, ray_block: int = 256):
        self.rng = seeds.rng(seed, 0x7A9)
        self.blocks = max(1, launch_rays // ray_block)
        self.ray_block = ray_block
        self.capture = False
        self.count = False
        self._first = False
        self.captured: list[dict] = []
        self.counted: list[dict] = []
        self.first_live: list[tuple] = []
        self._pending = None
        self._PI = None

    def __enter__(self):
        from lightpycl_tpu_torch.ops import intersect as PI

        self._PI = PI
        self._orig = PI.nearest_hit
        PI.intersect.observer = self._observe
        PI.nearest_hit = self._launch
        return self

    def begin_call(self, capture: bool):
        """The next launches belong to a new call; keep them if `capture`."""
        self.capture = capture
        self._first = True

    def __exit__(self, *exc):
        self._PI.intersect.observer = None
        self._PI.nearest_hit = self._orig

    def _observe(self, scene, o, d, cfg, alive, mask):
        self._pending = (scene, alive, mask)
        if self.capture and self._first:
            n = o.shape[0]
            self.first_live.append((n if alive is None else alive.sum(), n))
        if self.count:
            self.counted.append({
                "n_rays": o.shape[0], "mask": mask,
                "alive": alive if mask is None else None,
                "mask_words": 0 if mask is None else int(mask.numel())})

    def _launch(self, o, d, wu, wv, ww, *args, **kw):
        t, tri = self._orig(o, d, wu, wv, ww, *args, **kw)
        if self.capture and self._pending is not None:
            scene, alive, mask = self._pending
            C = o.shape[0]
            n_blk = -(-C // self.ray_block)
            take = min(self.blocks, n_blk)
            blk = np.sort(self.rng.choice(n_blk, size=take, replace=False))
            idx = (blk[:, None] * self.ray_block
                   + np.arange(self.ray_block)[None, :]).reshape(-1)
            idx = torch.as_tensor(idx[idx < C], device=o.device)
            ti = tri[idx]
            safe = torch.clamp_min(ti, 0).long()
            self.captured.append({
                "o": o[idx].clone(), "d": d[idx].clone(),
                "alive": (torch.ones_like(ti, dtype=torch.bool)
                          if alive is None else alive[idx].clone()),
                "t": t[idx].clone(), "tri": ti.clone(),
                "rows": torch.cat([scene.v0[safe], scene.e1[safe],
                                   scene.e2[safe]], dim=1),
                "masked": mask is not None})
        self._first = False
        self._pending = None
        return t, tri


def pairs_of(rec: dict, n_real_tris: int, ray_block: int,
             tri_tile: int) -> int:
    """The (ray, triangle) pairs a counted launch had to test: live rays x
    real triangles without a mask; with one, the (ray block x triangle
    tile) pairs its set bits keep."""
    if rec["mask"] is None:
        live = (rec["n_rays"] if rec["alive"] is None
                else int(rec["alive"].sum()))
        return live * n_real_tris
    words = rec["mask"].to(torch.int64) & 0xFFFFFFFF
    bits = (words[:, None] >> torch.arange(32, device=words.device)) & 1
    return int(bits.sum()) * ray_block * tri_tile
