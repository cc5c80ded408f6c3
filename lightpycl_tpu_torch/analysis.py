"""Analysis helpers of the traced results.

Port counterpart of lightpycl_tpu/analysis.py, in part: `surface_flux`,
which `Tracer.get_surface_flux` needs, and what users apply to a spectral
or fluorescent result (`spectral_power` and the CIE 1931 colorimetry:
`cie_xyz_cmf`, `cie_xyz`, `luminous_flux`, `luminous_efficacy`,
`chromaticity`, `cct`, `srgb`), numpy copies of the reference's. The rest
of the reference module (spot diagrams, MTF, ghost paths, plots) waits for
a later slice (ROADMAP A 8).
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


def spectral_power(wavelengths, powers, band_edges):
    """Total measured power per wavelength band (dispersion runs).

    band_edges: (B+1,) ascending wavelengths [um]. Returns ((B,) powers,
    (B,) band centers)."""
    edges = np.asarray(band_edges, np.float64)
    hist, _ = np.histogram(np.asarray(wavelengths, np.float64), bins=edges,
                           weights=np.asarray(powers, np.float64))
    return hist, 0.5 * (edges[:-1] + edges[1:])


# ---- colorimetry ---------------------------------------------------------
# CIE 1931 2-degree color-matching functions as the piecewise-Gaussian
# analytic fits of Wyman, Sloan & Shirley (JCGT 2013): max error < 1% of
# peak, no table to ship. Wavelengths in um. The error bound is absolute
# (a fraction of the peak), so broadband colorimetry (LED / phosphor
# spectra, CCT) is solid, but a monochromatic line deeper than ~650 nm
# drifts off the spectral locus (both CMFs are < 1% of peak there).

def _pw_gauss(lam_nm, mu, s1, s2):
    """exp(-(x-mu)^2 / 2 sigma^2) with sigma = s1 left of mu, s2 right."""
    t = (lam_nm - mu) / np.where(lam_nm < mu, s1, s2)
    return np.exp(-0.5 * t * t)


def cie_xyz_cmf(wavelengths_um):
    """CIE 1931 color-matching functions (x̄, ȳ, z̄) at the given vacuum
    wavelengths [um]. Returns an (N, 3) array."""
    lam = np.asarray(wavelengths_um, np.float64) * 1e3  # nm
    xb = (1.056 * _pw_gauss(lam, 599.8, 37.9, 31.0)
          + 0.362 * _pw_gauss(lam, 442.0, 16.0, 26.7)
          - 0.065 * _pw_gauss(lam, 501.1, 20.4, 26.2))
    yb = (0.821 * _pw_gauss(lam, 568.8, 46.9, 40.5)
          + 0.286 * _pw_gauss(lam, 530.9, 16.3, 31.1))
    zb = (1.217 * _pw_gauss(lam, 437.0, 11.8, 36.0)
          + 0.681 * _pw_gauss(lam, 459.0, 26.0, 13.8))
    return np.stack([xb, yb, zb], axis=-1)


def cie_xyz(wavelengths, powers):
    """Tristimulus (X, Y, Z) of a measured ray bundle: per-ray radiant
    power weighted by the CIE 1931 CMFs (Y is luminous flux up to the 683
    lm/W constant). Feed `result.measured_wavelength` and
    `result.measured_power` of a dispersive or fluorescent trace."""
    cmf = cie_xyz_cmf(wavelengths)
    p = np.asarray(powers, np.float64)
    return tuple((cmf * p[:, None]).sum(axis=0))


def luminous_flux(wavelengths, powers):
    """Photometric flux [lm] of a measured bundle: 683 lm/W x the
    V(lambda)-weighted (CIE ybar) radiant power."""
    _, Y, _ = cie_xyz(wavelengths, powers)
    return 683.002 * Y


def luminous_efficacy(wavelengths, powers):
    """Luminous efficacy of radiation [lm/W]: luminous_flux / radiant
    power (0 for an empty or zero-power bundle)."""
    total = float(np.asarray(powers, np.float64).sum())
    if total <= 0:
        return 0.0
    return luminous_flux(wavelengths, powers) / total


def chromaticity(wavelengths, powers):
    """CIE 1931 (x, y) chromaticity coordinates of a measured bundle."""
    X, Y, Z = cie_xyz(wavelengths, powers)
    s = X + Y + Z
    if s <= 0:
        return 0.0, 0.0
    return X / s, Y / s


def cct(x, y):
    """Correlated color temperature [K] from (x, y) by McCamy's cubic
    (about +-2% for 2000-12500 K near the Planckian locus)."""
    n = (x - 0.3320) / (0.1858 - y)
    return 449.0 * n**3 + 3525.0 * n**2 + 6823.3 * n + 5520.33


def srgb(wavelengths, powers, normalize=True):
    """Gamma-encoded sRGB triple of a measured bundle (D65 linear-sRGB
    matrix, components clipped to [0, 1]; `normalize` scales the largest
    linear channel to 1: color, not absolute level)."""
    X, Y, Z = cie_xyz(wavelengths, powers)
    m = np.array([[3.2406, -1.5372, -0.4986],
                  [-0.9689, 1.8758, 0.0415],
                  [0.0557, -0.2040, 1.0570]])
    rgb = m @ np.array([X, Y, Z], np.float64)
    if normalize and rgb.max() > 0:
        rgb = rgb / rgb.max()
    rgb = np.clip(rgb, 0.0, 1.0)
    return tuple(np.where(rgb <= 0.0031308, 12.92 * rgb,
                          1.055 * rgb ** (1 / 2.4) - 0.055))
