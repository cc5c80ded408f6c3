"""IES LM-63 photometric files: export traced luminaires, import measured
luminaire data as light sources.

Port counterpart of lightpycl_tpu/io/ies.py: a jax-free copy
(tests/test_torch_io_formats.py holds it to the reference). The files it
writes carry the reference's identifiers, byte for byte, so either package
reads the other's.

The reference has no photometric IO (SURVEY.md §3 lists DXF export as the
only file format); this is an additive L5 extension in the same spirit as
`io/dxf.py`: the traced directivity distribution (SURVEY.md §3
'Measurement & directivity analysis') serialized in the lighting
industry's interchange format — IESNA LM-63-2002, Type C goniophotometry —
plus the inverse: an LM-63 file used as a `LightSource` directivity so a
measured luminaire can be dropped into a scene.

Conventions
-----------
* Type C photometry: the luminaire's principal axis is the `axis`
  argument (default +z). The LM-63 *vertical* angle is the polar angle
  from that axis in degrees (0 = along the axis); the *horizontal* angle
  is the azimuth about it. Node layout follows the standard: vertical
  angles run 0..90 (or 0..180) inclusive; horizontal angles are [0] for
  an axially-symmetric web, else 0..360 inclusive (the 360 column
  duplicates 0).
* Candela values are luminous intensity I = dPhi/dOmega [cd = lm/sr].
  Traced ray powers are radiant watts; they are converted with the CIE
  V(lambda) weighting (`analysis.cie_xyz_cmf`) when per-ray wavelengths
  are given, else with a flat `lm_per_watt` factor (default 683.002,
  i.e. powers are treated as photopic watts). Pass `lm_per_watt=1.0` to
  keep radiometric units (W/sr) in the candela slots.
* Zero-dep ASCII, like the DXF writer: no photometric library needed.

Round trip: `save_ies` -> `load_ies` reproduces the grid to float-print
precision, and `IESData.total_lumens` (solid-angle integral of the web)
equals the binned lumens by construction; `ies_source(load_ies(path))`
turns the web back into rays whose traced directivity matches the file
(tests/test_ies.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# photopic peak: lm per watt at 555 nm (CIE); V(lambda) = ybar
LM_PER_W_555 = 683.002


def _lumens_per_ray(powers, wavelengths, lm_per_watt):
    """Per-ray luminous flux [lm] from radiant power [W]."""
    p = np.asarray(powers, np.float64)
    if wavelengths is not None:
        from lightpycl_tpu_torch.analysis import cie_xyz_cmf

        ybar = cie_xyz_cmf(np.asarray(wavelengths, np.float64))[:, 1]
        return LM_PER_W_555 * ybar * p
    return float(LM_PER_W_555 if lm_per_watt is None else lm_per_watt) * p


def _local_angles(directions, axis):
    """(azimuth [0, 2pi), polar [0, pi]) of world-frame directions about
    the luminaire axis."""
    from lightpycl_tpu_torch.sources import _frame

    F = _frame(axis)  # rows u, v, w ; local -> world is d @ F
    d = np.asarray(directions, np.float64) @ F.T  # world -> local
    n = np.linalg.norm(d, axis=1)
    n = np.where(n > 0, n, 1.0)
    az = np.arctan2(d[:, 1], d[:, 0])
    az = np.where(az < 0, az + 2 * np.pi, az)
    pol = np.arccos(np.clip(d[:, 2] / n, -1.0, 1.0))
    return az, pol


def _node_edges_polar(v_rad):
    """Bin edges for polar NODE angles: midpoints between nodes, closed AT
    the grid limits (trapezoid convention — the end nodes own half-width
    bins inside the span; a 0-degree first node owns the half-step polar
    cap). The web's domain ends at its last vertical angle."""
    edges = np.empty(v_rad.size + 1)
    edges[0] = v_rad[0]
    edges[-1] = v_rad[-1]
    if v_rad.size > 1:
        edges[1:-1] = 0.5 * (v_rad[1:] + v_rad[:-1])
    return edges


def luminous_intensity_grid(directions, powers, *, wavelengths=None,
                            lm_per_watt=None, n_vertical: int = 37,
                            n_horizontal: int = 1, axis=(0.0, 0.0, 1.0),
                            vertical_max_deg: float | None = None):
    """Bin traced rays into an LM-63-shaped luminous-intensity web.

    Each node's candela value is its bin's lumens divided by the bin's
    exact solid angle (bins are midpoint-bounded around the nodes; azimuth
    wraps), so integrating the web over solid angle recovers the total
    binned lumens exactly.

    Args:
      directions:   (N, 3) emission directions (e.g. measured-ray dirs).
      powers:       (N,) radiant powers [W].
      wavelengths:  optional (N,) [um] for true V(lambda) weighting.
      lm_per_watt:  flat conversion when no wavelengths (default 683.002).
      n_vertical:   polar nodes (0..vertical_max inclusive).
      n_horizontal: azimuth nodes; 1 = axially symmetric. Else the web gets
                    n_horizontal nodes 0..360 inclusive (360 = wrap of 0).
      axis:         luminaire principal axis in world coordinates.
      vertical_max_deg: grid extent; default 90 if all rays are within the
                    forward hemisphere (+1e-9), else 180.

    Returns (candela (H, V), vertical_deg (V,), horizontal_deg (H,),
    total_lumens).
    """
    az, pol = _local_angles(directions, axis)
    lm = _lumens_per_ray(powers, wavelengths, lm_per_watt)
    if vertical_max_deg is None:
        vertical_max_deg = 90.0 if np.all(pol <= np.pi / 2 + 1e-9) else 180.0
    pol_max = np.radians(float(vertical_max_deg))

    vertical_deg = np.linspace(0.0, float(vertical_max_deg), n_vertical)
    v_rad = np.radians(vertical_deg)
    v_edges = _node_edges_polar(v_rad)
    pol_c = np.minimum(pol, pol_max - 1e-12)

    if n_horizontal <= 1:
        horizontal_deg = np.array([0.0])
        hist, _ = np.histogram(pol_c, bins=v_edges, weights=lm)
        hist = hist[None, :]
        dphi = np.array([2 * np.pi])
    else:
        horizontal_deg = np.linspace(0.0, 360.0, n_horizontal)
        dh = 2 * np.pi / (n_horizontal - 1)
        # azimuth bins centered on the nodes; the shared 0/360 node's bin
        # wraps, so shift by half a step and take modulo
        az_shift = (az + dh / 2) % (2 * np.pi)
        h_edges = np.linspace(0.0, 2 * np.pi, n_horizontal)
        hist, _, _ = np.histogram2d(az_shift, pol_c,
                                    bins=[h_edges, v_edges], weights=lm)
        # duplicate the wrap column: node 360 == node 0 (same intensity;
        # grid_flux's trapezoid half-weights the two duplicates, so the
        # shared bin's lumens are counted exactly once)
        hist = np.concatenate([hist, hist[:1]], axis=0)
        dphi = np.full(n_horizontal, dh)

    domega_v = np.cos(v_edges[:-1]) - np.cos(v_edges[1:])  # (V,)
    omega = dphi[:, None] * domega_v[None, :]
    candela = hist / np.maximum(omega, 1e-300)
    return candela, vertical_deg, horizontal_deg, float(lm.sum())


def grid_flux(candela, vertical_deg, horizontal_deg) -> float:
    """Solid-angle integral of a candela web -> lumens. Inverse of the
    node/bin layout used by `luminous_intensity_grid` (midpoint-bounded
    polar bins; trapezoid in azimuth scaled to the full circle, which
    also expands LM-63 symmetric webs: a 0..90 quadrant or 0..180 half
    web integrates as its mirror copies)."""
    c = np.asarray(candela, np.float64)
    v_rad = np.radians(np.asarray(vertical_deg, np.float64))
    v_edges = _node_edges_polar(v_rad)
    domega_v = np.cos(v_edges[:-1]) - np.cos(v_edges[1:])
    h = np.radians(np.asarray(horizontal_deg, np.float64))
    if h.size == 1:
        w = np.array([2 * np.pi])
    else:
        span = h[-1] - h[0]
        w = np.empty(h.size)
        w[0] = 0.5 * (h[1] - h[0])
        w[-1] = 0.5 * (h[-1] - h[-2])
        if h.size > 2:
            w[1:-1] = 0.5 * (h[2:] - h[:-2])
        w *= 2 * np.pi / max(span, 1e-300)  # symmetry expansion
    return float(np.sum(c * w[:, None] * domega_v[None, :]))


def _fmt_block(values, per_line: int = 10):
    vals = [f"{v:.9g}" for v in np.asarray(values, np.float64).ravel()]
    return "\n".join(" ".join(vals[i:i + per_line])
                     for i in range(0, len(vals), per_line))


def save_ies(path, directions=None, powers=None, *, candela=None,
             vertical_deg=None, horizontal_deg=None, wavelengths=None,
             lm_per_watt=None, n_vertical: int = 37, n_horizontal: int = 1,
             axis=(0.0, 0.0, 1.0), watts: float | None = None,
             keywords: dict | None = None):
    """Write an IESNA LM-63-2002 file.

    Two entry levels:
      * from traced rays — pass `directions` + `powers` (+ optional
        `wavelengths` for V(lambda) weighting); the web comes from
        `luminous_intensity_grid`.
      * from an explicit web — pass `candela` (H, V) with `vertical_deg`
        (V,) and `horizontal_deg` (H,) node angles in degrees.

    `watts` fills the input-watts slot (defaults to the radiant power sum
    when rays are given, else 0). Returns the total lumens written into
    the header (the web's solid-angle integral)."""
    if candela is None:
        if directions is None or powers is None:
            raise ValueError(
                "pass directions+powers or an explicit candela grid")
        candela, vertical_deg, horizontal_deg, total_lm = (
            luminous_intensity_grid(
                directions, powers, wavelengths=wavelengths,
                lm_per_watt=lm_per_watt, n_vertical=n_vertical,
                n_horizontal=n_horizontal, axis=axis))
        if watts is None:
            watts = float(np.asarray(powers, np.float64).sum())
    else:
        candela = np.asarray(candela, np.float64)
        if candela.ndim != 2:
            raise ValueError("candela must be (n_horizontal, n_vertical)")
        vertical_deg = np.asarray(vertical_deg, np.float64)
        horizontal_deg = np.asarray(horizontal_deg, np.float64)
        if candela.shape != (horizontal_deg.size, vertical_deg.size):
            raise ValueError(
                f"candela shape {candela.shape} != "
                f"({horizontal_deg.size}, {vertical_deg.size})")
        total_lm = grid_flux(candela, vertical_deg, horizontal_deg)
    if watts is None:
        watts = 0.0

    kw = {"TEST": "lightpycl_tpu traced luminaire",
          "MANUFAC": "lightpycl_tpu"}
    kw.update(keywords or {})
    lines = ["IESNA:LM-63-2002"]
    lines += [f"[{k}] {v}" for k, v in kw.items()]
    lines.append("TILT=NONE")
    n_v, n_h = vertical_deg.size, horizontal_deg.size
    # n_lamps, lumens/lamp, multiplier, n_v, n_h, photometric type (1 = C),
    # units (2 = meters), width, length, height
    lines.append(f"1 {total_lm:.9g} 1 {n_v} {n_h} 1 2 0 0 0")
    # ballast factor, future use, input watts
    lines.append(f"1 1 {float(watts):.9g}")
    lines.append(_fmt_block(vertical_deg))
    lines.append(_fmt_block(horizontal_deg))
    for h in range(n_h):
        lines.append(_fmt_block(candela[h]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return total_lm


@dataclasses.dataclass
class IESData:
    """Parsed LM-63 photometric web."""

    vertical_deg: np.ndarray      # (V,) polar node angles [deg]
    horizontal_deg: np.ndarray    # (H,) azimuth node angles [deg]
    candela: np.ndarray           # (H, V) luminous intensity [cd]
    lumens_per_lamp: float
    n_lamps: int
    watts: float
    photometric_type: int         # 1 = C, 2 = B, 3 = A
    keywords: dict

    @property
    def total_lumens(self) -> float:
        """Flux from integrating the web (independent of the header)."""
        return grid_flux(self.candela, self.vertical_deg,
                         self.horizontal_deg)


def load_ies(path) -> IESData:
    """Parse an IESNA LM-63 file (1986/1991/1995/2002 numeric layouts all
    share the token stream read here). Only TILT=NONE is supported — tilted
    mounting would need the TILT interpolation table. The candela
    multiplier is applied on load."""
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()
    keywords = {}
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        if ln.upper().startswith("TILT="):
            break
        if ln.startswith("[") and "]" in ln:
            k = ln[1:ln.index("]")].strip()
            keywords[k] = ln[ln.index("]") + 1:].strip()
        i += 1
    else:
        raise ValueError(f"{path}: no TILT= line — not an LM-63 file")
    tilt = lines[i].split("=", 1)[1].strip().upper()
    if tilt != "NONE":
        raise ValueError(f"{path}: TILT={tilt} unsupported (only NONE)")
    toks = " ".join(lines[i + 1:]).replace(",", " ").split()
    if len(toks) < 13:
        raise ValueError(f"{path}: truncated numeric block")
    n_lamps = int(float(toks[0]))
    lumens = float(toks[1])
    mult = float(toks[2])
    n_v = int(float(toks[3]))
    n_h = int(float(toks[4]))
    ptype = int(float(toks[5]))
    # toks[6:10] = units, width, length, height; toks[10:13] = ballast,
    # future, watts
    watts = float(toks[12])
    vals = np.asarray(toks[13:13 + n_v + n_h + n_v * n_h], np.float64)
    if vals.size != n_v + n_h + n_v * n_h:
        raise ValueError(f"{path}: expected {n_v + n_h + n_v * n_h} web "
                         f"values, got {vals.size}")
    vertical = vals[:n_v]
    horizontal = vals[n_v:n_v + n_h]
    candela = vals[n_v + n_h:].reshape(n_h, n_v) * mult
    return IESData(vertical_deg=vertical, horizontal_deg=horizontal,
                   candela=candela, lumens_per_lamp=lumens * mult,
                   n_lamps=n_lamps, watts=watts, photometric_type=ptype,
                   keywords=keywords)


def _require_type_c(data: IESData) -> None:
    """Guard against silently misreading Type B / A goniometry.

    The web consumers here interpret (horizontal, vertical) as LM-63
    Type C spherical coordinates (azimuth around the nadir axis, polar
    from nadir). Types B (floodlights) and A (automotive) aim the same
    numbers along perpendicular axes; loading one as Type C rotates the
    whole distribution 90 degrees without any numeric error (VERDICT r4
    missing #4). `load_ies` still parses them — the raw web and keywords
    are format-faithful — but directivity/source construction refuses."""
    if data.photometric_type != 1:
        kind = {2: "B (floodlight)", 3: "A (automotive)"}.get(
            data.photometric_type, str(data.photometric_type))
        raise ValueError(
            f"IES photometric type {kind} is not Type C: its angle grid "
            "is aimed along a different axis and would be misread as "
            "(azimuth, polar). Convert the web to Type C first (or open "
            "an issue with the file)")


def ies_directivity(data: IESData):
    """Directivity callable (azimuth, polar) -> relative intensity for
    `LightSource`: linear interpolation over the candela web. Axial
    symmetry (H == 1) ignores azimuth; partial-span webs apply the LM-63
    symmetry fold (0..90 quadrant / 0..180 bilateral mirror); full webs
    wrap. Vectorized over numpy arrays; clamps beyond the vertical range.

    Type C only: Types B and A (floodlight/automotive goniometry) aim
    their angle grids along different axes, so reading them as (azimuth,
    polar) would silently rotate the web — they raise instead."""
    _require_type_c(data)
    v = np.radians(data.vertical_deg)
    h = np.radians(data.horizontal_deg)
    c = data.candela

    def directivity(az, pol):
        az_a = np.atleast_1d(np.asarray(az, np.float64))
        pol_a = np.atleast_1d(np.asarray(pol, np.float64))
        az_a, pol_a = np.broadcast_arrays(az_a, pol_a)
        shape = az_a.shape
        az_f, pol_f = az_a.ravel(), np.clip(pol_a.ravel(), v[0], v[-1])
        rows = np.stack([np.interp(pol_f, v, c[k]) for k in range(h.size)])
        if h.size == 1:
            out = rows[0]
        else:
            span = h[-1] - h[0]
            a = (az_f - h[0]) % (2 * np.pi)
            if span < np.pi + 1e-9:          # 0..90 or 0..180: mirror folds
                a = np.minimum(a, 2 * np.pi - a)      # -> [0, pi]
                if span < np.pi / 2 + 1e-9:           # quadrant web
                    a = np.minimum(a, np.pi - a)      # -> [0, pi/2]
                a = np.clip(a, 0.0, span)
            hi = np.clip(np.searchsorted(h - h[0], a, side="right"),
                         1, h.size - 1)
            lo = hi - 1
            wgt = np.clip((a - (h[lo] - h[0]))
                          / np.maximum(h[hi] - h[lo], 1e-300), 0.0, 1.0)
            idx = np.arange(a.size)
            out = (1.0 - wgt) * rows[lo, idx] + wgt * rows[hi, idx]
        out = out.reshape(shape)
        return out if np.ndim(az) or np.ndim(pol) else float(out.ravel()[0])

    return directivity


def ies_source(data_or_path, *, center=(0.0, 0.0, 0.0),
               direction=(0.0, 0.0, 1.0), power: float | None = None,
               ray_count: int = 100000, mode: str = "weighted",
               seed: int = 0, wavelength=None):
    """A `LightSource` emitting an LM-63 web's distribution.

    `power` defaults to the web's integrated flux in LUMENS — the trace
    then carries photometric units end to end (detected 'power' is lm).
    The emission cone extends to the web's last vertical angle."""
    from lightpycl_tpu_torch.sources import D_LINE_UM, LightSource

    data = (data_or_path if isinstance(data_or_path, IESData)
            else load_ies(data_or_path))
    _require_type_c(data)
    if power is None:
        power = data.total_lumens
    return LightSource(center=tuple(center), direction=tuple(direction),
                       directivity=ies_directivity(data), power=float(power),
                       ray_count=int(ray_count),
                       polar_max=float(np.radians(data.vertical_deg[-1])),
                       mode=mode, seed=seed,
                       wavelength=(D_LINE_UM if wavelength is None
                                   else wavelength))
