"""Analysis helpers of the traced results.

Port counterpart of lightpycl_tpu/analysis.py, one function so far:
`surface_flux`, which `Tracer.get_surface_flux` needs. The rest of the
reference module (spot diagrams, MTF, ghost paths, plots) waits for a later
slice (ROADMAP A 8).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def surface_flux(tri_flux, scene, element_names=None):
    """Turn a flux-map trace's per-triangle incident power into an
    irradiance map.

    Args:
      tri_flux: (T,) incident power per scene triangle
                (TraceResult.tri_flux of a TraceConfig(flux_map=True) run;
                T = real triangle count in the scene's triangle order).
      scene:    the traced Scene (tracer.scene): facet geometry (v0/e1/e2)
                and the per-triangle element index.
      element_names: optional list naming each element for `per_element`.

    Returns dict:
      'flux'       (T,) incident power per facet (the input, as numpy)
      'area'       (T,) facet areas
      'irradiance' (T,) flux / area  [power per area]
      'centroid'   (T, 3) facet centroids
      'element_id' (T,) owning element per facet
      'per_element' dict element -> total incident power

    A flux map is not a conservation ledger: a ray refracting through both
    faces of a lens deposits its arriving power on both. Analytic (quadric)
    surfaces' placeholder triangles get NaN irradiance (their power lands on
    a ~zero-area facet).
    """
    flux = np.asarray(_host(tri_flux), np.float64)
    T = flux.shape[0]
    v0 = np.asarray(_host(scene.v0), np.float64)[:T]
    e1 = np.asarray(_host(scene.e1), np.float64)[:T]
    e2 = np.asarray(_host(scene.e2), np.float64)[:T]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    centroid = v0 + (e1 + e2) / 3.0
    qt = getattr(scene, "quad_tri", None)
    if qt is not None:
        q = _host(qt).astype(np.int64)
        area[q[(q >= 0) & (q < T)]] = np.nan  # -> NaN irradiance below
    eid = _host(scene.element_id)[:T].astype(np.int64)
    n_el = int(eid.max()) + 1 if T else 0
    totals = np.zeros(max(n_el, 1))
    np.add.at(totals, np.clip(eid, 0, None), flux)
    if element_names is not None:
        per_element = {element_names[i] if i < len(element_names) else i:
                       float(totals[i]) for i in range(n_el)}
    else:
        per_element = {i: float(totals[i]) for i in range(n_el)}
    return {
        "flux": flux,
        "area": area,
        "irradiance": flux / np.maximum(area, 1e-30),
        "centroid": centroid,
        "element_id": eid,
        "per_element": per_element,
    }
