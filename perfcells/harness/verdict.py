"""The comparison that decides `correct`.

Numbers (each the worst over what a run checks; each has a limit in the
cell's file, `check.limits`):

* hit_bad_share: of the live rays sampled from the nearest-hit launches of
  the checked calls, the share whose answer the float64 reference refutes.
  An answer stands when both sides miss, or when both hit at distances
  within T_TOL * max(1, t_ref) of each other and the ray, in float64, also
  hits the triangle the answer names (barycentric slack B_SLACK) at such a
  distance: a ray through a shared edge may name either triangle. The
  program names triangles by its own index; the index is decoded into
  geometry by the triangle's float32 rows (v0, e1, e2), which equal the
  float32 rounding of one reference triangle's and of no other.
* first_launch_dead_share: of the source rays of the first launch of each
  checked call (the slots they fill; spare capacity does not count), the
  share the program holds dead. Every ray these sources emit carries
  power, so the reference holds none dead: an exact comparison (a trace
  that drops part of its batch reads above 0).
* ledger_gap: the largest gap between the two sides' ledger terms, as a
  share of the power emitted.
* detector_gap: the same for each detector's measured power.
* hist_gap: the summed absolute gap of the detector histograms' bins, as a
  share of the power emitted.
"""

from __future__ import annotations

import numpy as np
import torch

from perfcells.reference.nearest_hit import nearest_hit

T_TOL = 2.0 ** -14
B_SLACK = 1e-5


def _row_keys(rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    return rows.view(np.dtype((np.void, rows.shape[1] * 4))).ravel()


class TriangleIndex:
    """Decodes a float32 (v0 | e1 | e2) row into the reference's index."""

    def __init__(self, scene):
        rows = torch.cat([scene[k] for k in ("v0", "e1", "e2")], 1)
        self.keys = _row_keys(rows.to(torch.float32).cpu().numpy())
        self.order = np.argsort(self.keys)
        self.sorted = self.keys[self.order]

    def lookup(self, rows: np.ndarray) -> np.ndarray:
        k = _row_keys(rows)
        pos = np.clip(np.searchsorted(self.sorted, k), 0, len(self.sorted) - 1)
        return np.where(self.sorted[pos] == k, self.order[pos], -1)


def _hits_named(o, d, scene, idx, opts):
    """(hit, t) of each ray on the triangle `idx` names, in float64, with
    the slack B_SLACK on the edges."""
    safe = torch.clamp_min(idx, 0)
    v0, e1, e2 = (scene[k][safe] for k in ("v0", "e1", "e2"))
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(1)
    s = o - v0
    u = (s * p).sum(1) / det
    q = torch.linalg.cross(s, e1)
    v = (d * q).sum(1) / det
    t = (e2 * q).sum(1) / det
    ok = ((idx >= 0) & (det != 0) & (u >= -B_SLACK) & (v >= -B_SLACK)
          & (u + v <= 1 + B_SLACK) & (t > opts["eps"])
          & (t < opts["max_ray_len"]))
    return ok, t


def judge_rays(o, d, t_c, idx_c, scene, opts, ref=None):
    """(refuted, judged): of rays (o, d) float64, how many answers (t_c,
    idx_c: reference indices, -1 a miss) the float64 reference refutes.
    `ref` is the reference's own (t, idx) if already known."""
    if ref is None:
        ref = nearest_hit(o, d, scene["v0"], scene["e1"], scene["e2"],
                          opts["eps"], opts["eps_bary"], opts["max_ray_len"])
    t_r, i_r = ref
    hit_r = i_r >= 0
    hit_c = (idx_c >= 0) & torch.isfinite(t_c)
    named, t_n = _hits_named(o, d, scene, idx_c, opts)
    tol = T_TOL * torch.clamp_min(torch.where(hit_r, t_r, 1.0), 1.0)
    both = (hit_r & hit_c & named & ((t_c - t_r).abs() <= tol)
            & ((t_n - t_r).abs() <= tol))
    ok = (~hit_r & ~hit_c) | both
    return int((~ok).sum()), int(ok.numel())


def judge_launches(captured, scene, tri_index, opts, dtype=None):
    """(refuted, judged) over the live sampled rays of captured launches:
    the program's answers, or with `dtype` the reference's own computed in
    that dtype (the control)."""
    bad = total = 0
    dev = scene["v0"].device
    for rec in captured:
        live = rec["alive"].to(dev)
        o = rec["o"].to(dev)[live].double()
        d = rec["d"].to(dev)[live].double()
        if o.shape[0] == 0:
            continue
        ref = nearest_hit(o, d, scene["v0"], scene["e1"], scene["e2"],
                          opts["eps"], opts["eps_bary"], opts["max_ray_len"])
        if dtype is None:
            t_c = rec["t"].to(dev)[live].double()
            rows = rec["rows"][live.to(rec["rows"].device)].cpu().numpy()
            idx = torch.as_tensor(tri_index.lookup(rows), device=dev)
            idx = torch.where(rec["tri"].to(dev)[live] >= 0, idx, -1)
        else:
            t_c, idx = nearest_hit(o, d, scene["v0"], scene["e1"],
                                   scene["e2"], opts["eps"],
                                   opts["eps_bary"], opts["max_ray_len"],
                                   dtype=dtype)
        b, n = judge_rays(o, d, t_c, idx, scene, opts, ref=ref)
        bad, total = bad + b, total + n
    return bad, total


def first_launch_dead(first_live):
    """(dead, all) source rays of the first launch of each captured call,
    from the tap's (live, all) counts."""
    total = sum(n for _, n in first_live)
    return total - sum(int(live) for live, _ in first_live), total


def gaps(seen: dict, want: dict) -> dict:
    """ledger_gap, detector_gap and (where both have one) hist_gap between
    two outcomes, each a dict of fractions of the power emitted: `ledger`
    (term -> share), `per_detector` and `hist` arrays."""
    out = {"ledger_gap": max(abs(seen["ledger"][k] - want["ledger"][k])
                             for k in want["ledger"]),
           "detector_gap": float(np.max(np.abs(
               np.asarray(seen["per_detector"])
               - np.asarray(want["per_detector"]))))}
    if seen.get("hist") is not None and want.get("hist") is not None:
        out["hist_gap"] = float(np.abs(np.asarray(seen["hist"])
                                       - np.asarray(want["hist"])).sum())
    return out


def worst(rows: list[dict]) -> dict:
    """The largest of each number over the checked calls."""
    keys = sorted({k for r in rows for k in r})
    return {k: max(r[k] for r in rows if k in r) for k in keys}


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every limited
    number was read and is within its limit."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k)
        out[k] = {"value": v, "limit": lim}
        ok = ok and v is not None and np.isfinite(v) and v <= lim
    return ok, out
