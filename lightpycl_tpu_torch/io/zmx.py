"""Zemax ``.zmx`` sequential-prescription import.

Port counterpart of lightpycl_tpu/io/zmx.py: a jax-free copy
(tests/test_torch_io_formats.py holds it to the reference).

Extension over the reference (SURVEY.md §3 lists DXF export as the only
file IO; STL/DXF/OBJ/PLY import and IES/ray-file IO were added in earlier
rounds): ``.zmx`` is the de-facto exchange format real optical designs
ship in, so a LightPyCL user migrating a lens system can load the
prescription directly instead of re-typing radii into the primitive
factory.

Scope: MODE SEQ prescriptions with STANDARD and EVENASPH surfaces,
catalog or inline (n_d, V_d) glasses, MIRROR surfaces, the aperture STOP,
and the image plane. Non-sequential files and exotic surface types raise
with the offending line. Both encodings Zemax emits are handled (UTF-16
with BOM — the OpticStudio default — and plain ASCII/latin-1).

Three layers:

- :func:`load_zmx` — parse to a :class:`ZmxPrescription` (pure data,
  no geometry), usable for inspection and unit tests.
- :func:`zmx_paraxial` — fold the prescription into a paraxial ABCD
  matrix (``lightpycl_tpu_torch.paraxial``) and return its cardinal points:
  the independent first-order cross-check for the traced scene.
- :func:`zmx_to_scene` — tessellate into traceable ``GeoObject``
  elements (lenses via ``spherical_lens`` / ``aspheric_lens``, mirrors,
  the stop as an absorbing annulus, the image plane as a ``measure``
  disc) with catalog dispersion attached, ready for
  ``Tracer.trace`` / ``CL_Tracer.iterative_tracer``.

Cemented interfaces (two consecutive glass surfaces) are built as two
elements separated by ``cement_gap`` (default 1e-6 of the total track):
the tracer models one volume per element, so the shared surface becomes
a thin air film. Power error is the extra glass-air Fresnel pair
(~8e-4 per cemented interface at n=1.5 vs the true glass-glass
interface); geometry error is the gap itself. Both are recorded in
``info['warnings']``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from lightpycl_tpu_torch import materials
from lightpycl_tpu_torch import paraxial
from lightpycl_tpu_torch.geometry.primitives import optical_elements

# ---------------------------------------------------------------------------
# parsing

# Zemax catalog names the SELLMEIER table knows, plus bare aliases.
_GLASS_ALIASES = {
    "BK7": "N-BK7",
    "SF10": "N-SF10",
    "SF11": "N-SF11",
    "BAF10": "N-BAF10",
    "SK16": "N-SK16",
    "SF5": "N-SF5",
    "SF6": "N-SF6",
    "BAK4": "N-BAK4",
    "FK51A": "N-FK51A",
    "K5": "N-K5",
    "LAK22": "N-LAK22",
    "SSK5": "N-SSK5",
    "LASF9": "N-LASF9",
    "SILICA": "FUSED-SILICA",
    "F_SILICA": "FUSED-SILICA",
    "FUSED_SILICA": "FUSED-SILICA",
    "SIO2": "FUSED-SILICA",
}

_SUPPORTED_TYPES = {"STANDARD", "EVENASPH"}


@dataclass
class ZmxSurface:
    """One SURF block of a sequential prescription."""
    index: int
    type: str = "STANDARD"
    curv: float = 0.0            # curvature 1/R (R > 0: center toward +z)
    disz: float = 0.0            # thickness to the NEXT surface
    glass: Optional[str] = None  # glass AFTER this surface (None = air)
    nd: float = 0.0              # inline index/Abbe from the GLAS line
    vd: float = 0.0
    semi_diam: float = 0.0       # DIAM records the semi-diameter
    conic: float = 0.0
    parm: dict = field(default_factory=dict)  # EVENASPH: PARM i -> a_{2i}
    is_stop: bool = False
    comment: str = ""
    obsc: float = 0.0            # OBSC central-obscuration radius (0 = none)

    @property
    def radius(self) -> Optional[float]:
        """Signed curvature radius; None = flat."""
        return None if self.curv == 0.0 else 1.0 / self.curv

    @property
    def is_mirror(self) -> bool:
        return self.glass == "MIRROR"


@dataclass
class ZmxPrescription:
    name: str = ""
    unit: str = "MM"
    surfaces: list = field(default_factory=list)   # [ZmxSurface], obj..image
    wavelengths_um: list = field(default_factory=list)
    primary_wl_index: int = 1    # 1-based, as PWAV records it
    enpd: float = 0.0            # entrance pupil diameter, if given

    @property
    def primary_wavelength_um(self) -> float:
        if not self.wavelengths_um:
            return materials.D_LINE
        i = min(max(self.primary_wl_index, 1), len(self.wavelengths_um))
        return self.wavelengths_um[i - 1]


def _read_text(path) -> str:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] in (b"\xff\xfe", b"\xfe\xff"):
        return raw.decode("utf-16")
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        return raw.decode("latin-1")


def _floats(tokens, n):
    out = []
    for t in tokens[:n]:
        if t.upper() == "INFINITY":
            out.append(math.inf)
        else:
            try:
                out.append(float(t))
            except ValueError:
                break
    return out


def _req_float(tokens, path, ln, tag):
    """First numeric token of a record, or ValueError naming the line
    (the load_zmx contract: malformed blocks raise with the offender)."""
    vals = _floats(tokens, 1)
    if not vals:
        raise ValueError(f"{path}:{ln}: {tag} record needs a numeric "
                         f"argument, got {tokens!r}")
    return vals[0]


def load_zmx(path) -> ZmxPrescription:
    """Parse a Zemax ``.zmx`` file into a :class:`ZmxPrescription`.

    Raises ``ValueError`` on non-sequential files, unsupported surface
    types, and malformed surface blocks — always naming the line.
    """
    text = _read_text(path)
    presc = ZmxPrescription()
    surf: Optional[ZmxSurface] = None
    wav: dict = {}

    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line.strip():
            continue
        in_block = line[0] in " \t" and surf is not None
        parts = line.split()
        tag = parts[0].upper()
        args = parts[1:]

        if not in_block:
            surf = None  # column-0 keyword ends any open SURF block
            if tag == "SURF":
                surf = ZmxSurface(index=int(args[0]))
                presc.surfaces.append(surf)
            elif tag == "MODE":
                if args and args[0].upper() != "SEQ":
                    raise ValueError(
                        f"{path}:{ln}: only sequential (MODE SEQ) files are "
                        f"supported, got MODE {args[0]}")
            elif tag == "NAME":
                presc.name = line.split(None, 1)[1] if args else ""
            elif tag == "UNIT":
                presc.unit = args[0].upper() if args else "MM"
            elif tag == "ENPD":
                presc.enpd = _req_float(args, path, ln, "ENPD")
            elif tag == "WAVM" and len(args) >= 2:
                # WAVM index wavelength weight; index is 1-based.
                # OpticStudio writes all 24 slots — unused ones carry
                # weight 0 (trimmed after the parse).
                wav[int(args[0])] = (
                    _req_float(args[1:], path, ln, "WAVM"),
                    _floats(args[2:], 1)[0] if len(args) >= 3 else 1.0)
            elif tag in ("WAVL", "WAVN"):
                # legacy format: a bare list of wavelengths in order
                for k, w in enumerate(_floats(args, len(args)), 1):
                    wav[k] = (w, wav.get(k, (0.0, 1.0))[1])
            elif tag == "WWGT":
                for k, w in enumerate(_floats(args, len(args)), 1):
                    wav[k] = (wav.get(k, (0.0, 1.0))[0], w)
            elif tag == "PWAV" and args:
                presc.primary_wl_index = int(args[0])
            # VERS / FTYP / GCAT / COAT / etc: ignored metadata
            continue

        # inside a SURF block
        if tag == "TYPE":
            surf.type = args[0].upper()
            if surf.type not in _SUPPORTED_TYPES:
                raise ValueError(
                    f"{path}:{ln}: unsupported surface TYPE {surf.type} "
                    f"(supported: {sorted(_SUPPORTED_TYPES)})")
        elif tag == "CURV":
            surf.curv = _req_float(args, path, ln, "CURV")
        elif tag == "DISZ":
            surf.disz = _req_float(args, path, ln, "DISZ")
        elif tag == "CONI":
            surf.conic = _req_float(args, path, ln, "CONI")
        elif tag == "DIAM":
            surf.semi_diam = _req_float(args, path, ln, "DIAM")
        elif tag == "OBSC":
            # circular central obscuration: radius is the second numeric
            # (`OBSC <type> <radius> ...`), or the first if only one given
            vals = _floats(args, 2)
            surf.obsc = vals[1] if len(vals) >= 2 else _req_float(
                args, path, ln, "OBSC")
        elif tag == "PARM" and len(args) >= 2:
            surf.parm[int(args[0])] = float(args[1])
        elif tag == "GLAS":
            surf.glass = args[0].upper()
            vals = _floats(args[1:], 4)
            if len(vals) >= 4:
                surf.nd, surf.vd = vals[2], vals[3]
        elif tag == "STOP":
            surf.is_stop = True
        elif tag == "COMM":
            surf.comment = line.split(None, 1)[1] if args else ""
        # MEMA / MAZH / CLAP / FLAP / other per-surface tags: ignored

    if wav:
        # drop unused placeholder slots (OpticStudio writes all 24 WAVM
        # slots; unused ones carry weight 0) unless every slot has weight
        # 0, and remap the 1-based PWAV index onto the kept slots
        keys = sorted(k for k in wav if wav[k][0] > 0.0)
        used = [k for k in keys if wav[k][1] != 0.0] or keys
        presc.wavelengths_um = [wav[k][0] for k in used]
        presc.primary_wl_index = max(
            1, sum(1 for k in used if k <= presc.primary_wl_index))
    if len(presc.surfaces) < 3:
        raise ValueError(
            f"{path}: {len(presc.surfaces)} surfaces — a sequential file "
            "needs at least object, one surface, image")
    return presc


# ---------------------------------------------------------------------------
# glass resolution


def _resolve_glass(surface: ZmxSurface, wavelength_um: float,
                   overrides: Optional[dict]):
    """Index at `wavelength_um` plus the tracer's extended-Cauchy fields.

    Resolution order: `overrides[name]` (a SELLMEIER-style coeff pair, an
    index float, or a {'ior':, 'dispersion_b':, ...} dict) -> the
    materials.SELLMEIER catalog (with bare-name aliases) -> the GLAS
    line's inline (n_d, V_d) -> error.
    """
    name = surface.glass
    if overrides and name in overrides:
        ov = overrides[name]
        if isinstance(ov, (int, float)):
            return float(ov), {"ior": float(ov)}
        if isinstance(ov, dict):
            n = (ov.get("ior", 0.0)
                 + ov.get("dispersion_b", 0.0) / wavelength_um**2
                 + ov.get("dispersion_c", 0.0) / wavelength_um**4)
            return float(n), dict(ov)
        # a Sellmeier ((B1..B3), (C1..C3)) pair
        n = float(materials.sellmeier_index(wavelength_um, ov))
        return n, materials.glass_from_sellmeier(ov)
    key = name if name in materials.SELLMEIER else _GLASS_ALIASES.get(name)
    if key is not None:
        n = float(materials.sellmeier_index(wavelength_um, key))
        return n, materials.glass_from_sellmeier(key)
    if surface.nd > 0 and surface.vd > 0:
        a, b = materials.glass(surface.nd, surface.vd)
        return a + b / wavelength_um**2, {"ior": a, "dispersion_b": b}
    raise ValueError(
        f"unknown glass {name!r} on surface {surface.index}: not in "
        f"materials.SELLMEIER ({sorted(materials.SELLMEIER)}), no inline "
        "(n_d, V_d) on the GLAS line — pass glass_overrides={name: "
        "((B1,B2,B3),(C1,C2,C3)) | n | {'ior': ...}}")


# ---------------------------------------------------------------------------
# paraxial fold


def zmx_paraxial(presc: ZmxPrescription, wavelength_um: float = None,
                 glass_overrides: dict = None) -> dict:
    """Cardinal points of the prescription from its paraxial ABCD matrix.

    Returns ``paraxial.system_properties`` output (efl/bfd/ffd/pp1/pp2/
    power) plus ``'matrix'`` (front vertex -> back vertex). Mirrors are
    folded straight (the textbook unfolding): after an odd number of
    reflections the Zemax-signed radii and thicknesses flip sign, so all
    distances (and the returned ``bfd``) are measured ALONG the light
    path — for a Cassegrain the bfd is the secondary-to-image distance,
    matching |traced z_image - secondary z|, not a signed lab-frame z.
    A mirror met inside glass (Mangin) gets power 2 n / R.
    """
    wl = wavelength_um or presc.primary_wavelength_um
    mats_: list = []
    n = 1.0
    sign = 1.0  # +1 travelling +z, flipped at every mirror (fold parity)
    inner = presc.surfaces[1:-1]
    for j, s in enumerate(inner):
        if s.is_mirror:
            # Zemax signs R in unfolded coordinates (center of curvature
            # at vertex + R): a converging mirror met travelling +z has
            # R < 0, which is paraxial.mirror's R > 0 concave; after an
            # odd number of folds the sense flips again.
            if s.radius is not None:
                r_eff = -sign * s.radius
                mats_.append(np.array([[1.0, 0.0],
                                       [-2.0 * n / r_eff, 1.0]]))
            sign = -sign
            if j < len(inner) - 1 and s.disz:
                mats_.append(paraxial.propagation(sign * s.disz, n))
            continue
        n2 = (_resolve_glass(s, wl, glass_overrides)[0]
              if s.glass is not None else 1.0)
        if s.curv != 0.0 or n2 != n:
            r_eff = (sign * s.radius) if s.radius is not None else math.inf
            mats_.append(paraxial.refraction(r_eff, n, n2))
        if j < len(inner) - 1 and s.disz:
            mats_.append(paraxial.propagation(sign * s.disz, n2))
        n = n2
    if n != 1.0:
        raise ValueError("prescription ends inside glass (last surface "
                         "before the image still has a GLAS entry)")
    M = paraxial.compose(*mats_) if mats_ else np.eye(2)
    props = paraxial.system_properties(M)
    props["matrix"] = M
    props["wavelength_um"] = wl
    return props


# ---------------------------------------------------------------------------
# scene build


def zmx_to_scene(src, wavelength_um: float = None, glass_overrides=None,
                 n_segments: int = 64, n_radial: int = 16,
                 include_stop: bool = True, detector: bool = True,
                 detector_scale: float = 1.0, cement_gap: float = None,
                 holes: dict = None):
    """Build traceable GeoObjects from a ``.zmx`` path or prescription.

    Each glass run becomes one lens element (``spherical_lens``, or
    ``aspheric_lens`` when a surface carries CONI/PARM terms) with the
    catalog glass's extended-Cauchy dispersion attached, so scalar,
    spectral, and dispersive traces all see the right n(lambda). MIRROR
    surfaces become ``spherical_mirror`` / ``conic_mirror`` elements
    (conic + even-asphere terms honored — Newtonian/Cassegrain/RC
    prescriptions import directly); the STOP becomes an absorbing
    annulus; the image plane becomes a ``measure`` disc of radius
    ``detector_scale`` x its semi-diameter.

    ``holes`` maps surface index -> central hole radius for mirrors.
    Sequential prescriptions don't model the primary's hole (each
    surface is intersected exactly once in Zemax), but a non-sequential
    trace needs it so rays returning from the secondary can pass; an
    OBSC record on a mirror is used as the default hole radius.

    Returns ``(elements, info)``: info carries ``z_image`` (front vertex
    of surface 1 -> image plane, including any cement gaps),
    ``wavelength_um``, per-element z positions, and ``warnings``.
    """
    presc = src if isinstance(src, ZmxPrescription) else load_zmx(src)
    wl = wavelength_um or presc.primary_wavelength_um
    oe = optical_elements(n_segments=n_segments, n_radial=n_radial)
    inner = presc.surfaces[1:-1]
    image = presc.surfaces[-1]
    track = sum(s.disz for s in inner if math.isfinite(s.disz))
    if cement_gap is None:
        # MUST exceed the tracer's self-intersection guard (TraceConfig
        # eps, default 1e-4): with a thinner gap the ray exiting the
        # front element finds the cemented partner's surface at
        # t < eps, the hit is rejected as a self-intersection, and the
        # second refraction is silently skipped — the bundle then
        # focuses at a completely wrong plane (r5 bug, caught by the
        # CODE V achromat example; pinned by the traced-doublet tests)
        cement_gap = max(1e-6 * max(abs(track), 1.0), 5e-4)

    semis = [s.semi_diam for s in presc.surfaces if s.semi_diam > 0]
    fallback_semi = max(semis) if semis else presc.enpd / 2.0

    def semi(s: ZmxSurface) -> float:
        if s.semi_diam > 0:
            return s.semi_diam
        if fallback_semi > 0:
            return fallback_semi
        raise ValueError(
            f"surface {s.index} has no DIAM and the file has no ENPD — "
            "cannot size the element aperture")

    elements, positions, warnings = [], [], []
    z = 0.0
    i = 0
    while i < len(inner):
        s = inner[i]
        if not math.isfinite(s.disz):
            raise ValueError(f"surface {s.index}: infinite thickness inside "
                             "the system")
        if s.is_mirror:
            name = s.comment or f"mirror_s{s.index}"
            hole = float((holes or {}).get(s.index, s.obsc))
            if hole > 0.0 and s.index not in (holes or {}) and s.obsc > 0:
                warnings.append(
                    f"OBSC on mirror surface {s.index} built as a central "
                    f"hole of radius {s.obsc:g} (non-sequential tracing "
                    "needs the real hole; pass holes={...} to override)")
            if s.conic != 0.0 or s.parm or hole > 0.0:
                el = oe.conic_mirror(
                    r=s.radius, diameter=2.0 * semi(s), k=s.conic,
                    coeffs=_even_coeffs(s), hole_diameter=2.0 * hole,
                    center=(0, 0, z), name=name)
            else:
                el = oe.spherical_mirror(
                    r=s.radius if s.radius is not None else 1e9,
                    diameter=2.0 * semi(s), center=(0, 0, z), name=name)
            elements.append(el)
            positions.append((el.name, z))
            z += s.disz  # negative after a mirror: propagation reverses
            i += 1
            continue
        if s.glass is not None:
            if i + 1 >= len(inner):
                raise ValueError(f"surface {s.index}: glass runs into the "
                                 "image plane")
            nxt = inner[i + 1]
            if nxt.is_mirror:
                # a Mangin (second-surface) mirror would build the lens
                # back and the mirror as coincident surfaces — the eps
                # self-intersection guard makes the trace order between
                # them undefined, so the scene would be silently wrong.
                # Refuse loudly instead.
                raise ValueError(
                    f"surface {nxt.index}: MIRROR at the end of a glass "
                    "run (a Mangin / second-surface mirror) is not "
                    "supported by the scene builder — the reflecting "
                    "surface would coincide with the lens back face. "
                    "Model it from primitives: a lens element plus a "
                    "spherical_mirror offset by > TraceConfig.eps")
            n_at_wl, disp = _resolve_glass(s, wl, glass_overrides)
            aperture = 2.0 * max(semi(s), semi(nxt))
            name = s.comment or f"lens_s{s.index}"
            aspheric = (s.conic != 0.0 or s.parm
                        or nxt.conic != 0.0 or nxt.parm)
            if aspheric:
                el = oe.aspheric_lens(
                    s.radius, nxt.radius, aperture=aperture,
                    thickness=s.disz, ior=n_at_wl,
                    k1=s.conic, k2=nxt.conic,
                    coeffs1=_even_coeffs(s), coeffs2=_even_coeffs(nxt),
                    center=(0, 0, z), name=name)
            else:
                el = oe.spherical_lens(
                    s.radius, nxt.radius, aperture=aperture,
                    thickness=s.disz, ior=n_at_wl,
                    center=(0, 0, z), name=name)
            # dispersion so spectral/dispersive traces see n(lambda);
            # recenter A so n(wl) stays exactly the resolved index
            b = disp.get("dispersion_b", 0.0)
            c = disp.get("dispersion_c", 0.0)
            el.ior = n_at_wl - b / wl**2 - c / wl**4
            el.dispersion_b, el.dispersion_c = b, c
            elements.append(el)
            positions.append((el.name, z))
            z += s.disz
            if nxt.glass is not None and not nxt.is_mirror:
                z += cement_gap
                warnings.append(
                    f"cemented interface at surface {nxt.index} built as a "
                    f"{cement_gap:g} air gap (two glass-air Fresnel "
                    "interfaces instead of one glass-glass)")
            i += 1  # the next loop step processes `nxt` (back = its own run)
            continue
        # air surface: stop, or a dummy spacer
        if s.is_stop and include_stop:
            r_open = semi(s)
            el = oe.aperture_stop(r_open, 2.5 * r_open, center=(0, 0, z),
                                  name=s.comment or f"stop_s{s.index}")
            elements.append(el)
            positions.append((el.name, z))
        z += s.disz
        i += 1

    z_image = z
    if detector:
        r_det = detector_scale * (image.semi_diam if image.semi_diam > 0
                                  else fallback_semi)
        el = oe.disc(radius=r_det, center=(0, 0, z_image),
                     material="measure", name="image")
        elements.append(el)
        positions.append(("image", z_image))

    info = {"name": presc.name, "unit": presc.unit, "wavelength_um": wl,
            "z_image": z_image, "positions": positions,
            "enpd": presc.enpd, "warnings": warnings}
    return elements, info


def _even_coeffs(s: ZmxSurface) -> tuple:
    """EVENASPH PARM i is the coefficient of r^(2i); the mesher's even
    series starts at r^4, so PARM 1 (an r^2 term aliasing curvature)
    must be zero."""
    if not s.parm:
        return ()
    if s.parm.get(1, 0.0) != 0.0:
        raise ValueError(
            f"surface {s.index}: nonzero r^2 asphere term (PARM 1) is not "
            "representable — fold it into CURV first")
    top = max(k for k in s.parm if s.parm[k] != 0.0) if any(
        v != 0.0 for v in s.parm.values()) else 1
    return tuple(s.parm.get(k, 0.0) for k in range(2, top + 1))


def save_zmx(path, presc: ZmxPrescription) -> None:
    """Write a prescription back out as an ASCII ``.zmx`` (round-trip
    partner of :func:`load_zmx`; covers every field the loader reads)."""
    lines = ["VERS 130711 25 06800", "MODE SEQ"]
    if presc.name:
        lines.append(f"NAME {presc.name}")
    lines.append(f"UNIT {presc.unit} X W X CM MR CPMM")
    if presc.enpd:
        lines.append(f"ENPD {presc.enpd:.9g}")
    for k, w in enumerate(presc.wavelengths_um, 1):
        lines.append(f"WAVM {k} {w:.9g} 1")
    if presc.wavelengths_um:
        lines.append(f"PWAV {presc.primary_wl_index}")
    for s in presc.surfaces:
        lines.append(f"SURF {s.index}")
        if s.is_stop:
            lines.append("  STOP")
        lines.append(f"  TYPE {s.type}")
        if s.comment:
            lines.append(f"  COMM {s.comment}")
        lines.append(f"  CURV {s.curv:.17g} 0 0 0 0 \"\"")
        if s.conic:
            lines.append(f"  CONI {s.conic:.17g}")
        for k in sorted(s.parm):
            lines.append(f"  PARM {k} {s.parm[k]:.17g}")
        disz = "INFINITY" if not math.isfinite(s.disz) else f"{s.disz:.17g}"
        lines.append(f"  DISZ {disz}")
        if s.glass is not None:
            extra = (f" 0 0 {s.nd:.9g} {s.vd:.9g}"
                     if s.nd > 0 and s.vd > 0 else "")
            lines.append(f"  GLAS {s.glass}{extra}")
        if s.semi_diam > 0:
            lines.append(f"  DIAM {s.semi_diam:.9g} 1 0 0 1 \"\"")
        if s.obsc > 0:
            lines.append(f"  OBSC 0 {s.obsc:.9g}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
