"""Trace-state checkpoint / resume.

Port counterpart of lightpycl_tpu/io/checkpoint.py: the same npz layout
(`rays_<field>`, `det_<field>`, `led_<field>`, `extra_<key>`) and the same
SCHEMA_VERSION, so either package reads a file the other wrote. Tensors are
saved from wherever they lie; loaded state comes back as tensors on
`device`. Older schemas are forward-filled, newer ones refused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lightpycl_tpu_torch.tracer.rays import (D_LINE_UM, DetectorState, Ledger,
                                             RayBatch, default_basis,
                                             tensor_from_array)

# bump when RayBatch/DetectorState/Ledger fields change meaning; loaders
# may forward-fill fields ADDED since an older version but must never
# guess at incompatible ones
SCHEMA_VERSION = 4  # v3 adds DetectorState.image_amp (coherent imaging);
#   v4 adds DetectorState.tri_flux (per-facet incident-flux maps) and
#   DetectorState.time_hist (time-of-flight histograms) — all forward-fill
#   to zeros when resuming older checkpoints


def normalize_path(path: str) -> str:
    """The on-disk name save_state actually writes (np.savez appends
    '.npz' when the suffix is missing — resume must check the same name)."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path: str, rays: Optional[RayBatch] = None,
               detector: Optional[DetectorState] = None,
               ledger: Optional[Ledger] = None, **extra) -> str:
    """Snapshot trace state to an .npz file. Any of the three state tuples
    may be omitted; `extra` holds scalars like the batch cursor. Returns
    the path actually written (always '.npz'-suffixed)."""
    path = normalize_path(path)
    payload: dict = {f"extra_{k}": _host(v) for k, v in extra.items()}
    payload["extra_schema_version"] = np.asarray(SCHEMA_VERSION)
    for prefix, state in (("rays", rays), ("det", detector),
                          ("led", ledger)):
        if state is not None:
            for f in state._fields:
                payload[f"{prefix}_{f}"] = _host(getattr(state, f))
    np.savez_compressed(path, **payload)
    return path


def load_state(path: str, device: torch.device | str = "cuda"):
    """Returns dict with 'rays' / 'detector' / 'ledger' (None if absent;
    tensors on `device`) and 'extra' (dict of numpy scalars and arrays,
    including 'schema_version').

    Checkpoints newer than this build are refused; fields added since an
    older checkpoint are forward-filled with physically valid defaults
    (unpolarized Stokes, perpendicular basis frame)."""
    path = normalize_path(path)
    with np.load(path) as z:
        version = (int(z["extra_schema_version"])
                   if "extra_schema_version" in z else 1)
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has schema version {version}, newer "
                f"than this build's {SCHEMA_VERSION}; refusing to guess at "
                "its fields")
        out = {"rays": None, "detector": None, "ledger": None, "extra": {}}

        def t(key):
            return tensor_from_array(z[key], device)

        if "rays_o" in z:
            n = z["rays_power"].shape[0]

            def full(v):
                return torch.full((n,), v, dtype=torch.float32,
                                  device=device)

            def ray_field(f):
                if f"rays_{f}" in z:
                    return t(f"rays_{f}")
                # fields added after the checkpoint was written
                if f == "basis":
                    return default_basis(t("rays_d"))
                if f == "wavelength":
                    return full(D_LINE_UM)
                if f == "medium":
                    return full(-1.0)  # ambient, not element 0
                return full(0.0)

            out["rays"] = RayBatch(*[ray_field(f) for f in RayBatch._fields])
        if "det_hist" in z:
            # fields added after the checkpoint was written start from zero
            # at their disabled shapes (v<=2 has no image_amp, v<=3 no
            # tri_flux / time_hist)
            absent = {"tri_flux": (1,), "time_hist": (1, 1)}

            def det_field(f):
                if f"det_{f}" in z:
                    return t(f"det_{f}")
                return torch.zeros(absent.get(f, (2, 1, 1)),
                                   dtype=torch.float32, device=device)

            out["detector"] = DetectorState(
                *[det_field(f) for f in DetectorState._fields])
        if "led_emitted" in z:
            out["ledger"] = Ledger(*[t(f"led_{f}") for f in Ledger._fields])
        for k in z.files:
            if k.startswith("extra_"):
                out["extra"][k[6:]] = z[k]
    return out
