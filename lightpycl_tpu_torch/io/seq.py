"""CODE V ``.seq`` sequence-file import.

Port counterpart of lightpycl_tpu/io/seq.py: a jax-free copy
(tests/test_torch_io_formats.py holds it to the reference).

Round-5 interchange wave (docs/ROADMAP.md §7's last live candidate;
VERDICT r4 next #10): CODE V is the other optical-design package real
prescriptions ship from. Rather than duplicating the import stack, the
parser maps the sequence file onto the SAME format-neutral
:class:`~lightpycl_tpu_torch.io.zmx.ZmxPrescription` the Zemax loader
produces — glass resolution, the paraxial fold (mirrors included), and
the traceable scene build are the zmx layers reused verbatim:

- :func:`load_seq` — parse to a ``ZmxPrescription``.
- :func:`seq_paraxial` / :func:`seq_to_scene` — thin wrappers over
  ``zmx_paraxial`` / ``zmx_to_scene``.

Supported command subset (the lens-data core every exported sequence
contains; case-insensitive, ``;`` splits multiple commands per line,
``!`` comments):

  ``LEN`` ``GO`` ``RDM``        file framing (ignored)
  ``TITLE 'text'``              prescription name
  ``DIM M|C|I``                 units mm/cm/inch
  ``EPD x``                     entrance pupil diameter
  ``WL w1 w2 ...``              wavelengths in NANOMETERS (CODE V
                                convention; converted to um)
  ``REF i``                     1-based primary wavelength index
  ``SO r t`` / ``S r t [glass]`` / ``SI r t``
                                object / intermediate / image surface:
                                RADIUS (0 or INF = flat) + thickness;
                                glass ``REFL`` = mirror
  ``STO``                       marks the current surface as the stop
  ``K x``                       conic constant on the current surface
  ``A|B|C|D x``                 4th/6th/8th/10th-order even-asphere
                                coefficients on the current surface
  ``CIR x``                     clear semi-aperture on the current
                                surface
  ``GLA name``                  glass on the current surface
  ``THI x`` / ``RDY x``         thickness / radius restatements

Anything else raises with the offending line (same contract as
``load_zmx``) unless it is a recognized no-op. Glass names normalize
from CODE V catalog form (``NBK7_SCHOTT``) to the Sellmeier catalog's
Zemax-style keys (``N-BK7``); unknown glasses fall through to
``glass_overrides`` / the inline-error path in the shared resolver.
"""

from __future__ import annotations

import math

from lightpycl_tpu_torch import materials
from lightpycl_tpu_torch.io.zmx import (ZmxPrescription, ZmxSurface,
                                  _GLASS_ALIASES, zmx_paraxial, zmx_to_scene)

# commands that carry no lens data a tracer needs: tolerancing, drawing,
# and analysis directives commonly left in exported sequences
_IGNORED = {
    "LEN", "GO", "RDM", "YAN", "XAN", "WTW", "WTF", "VUY", "VLY", "VUX",
    "VLX", "INI", "PIM", "CA", "CD", "RED", "MAG", "THC", "GLC", "CCY",
    "ADC", "BDC", "CUY", "SLB", "DRAW", "POL", "EPD;", "TEL", "AFC",
    "FNO", "NAO", "WTU",
}


def _norm_glass(tok: str):
    """CODE V glass token -> Sellmeier-catalog key (or the raw name,
    letting the shared resolver's overrides/error path handle it)."""
    t = tok.upper().split("_")[0]  # NBK7_SCHOTT -> NBK7
    if t in materials.SELLMEIER:
        return t
    if t in _GLASS_ALIASES:
        return t
    # NBK7 -> N-BK7, NSF10 -> N-SF10 ... (CODE V drops the dash)
    if len(t) > 1 and t[0] == "N" and t[1] != "-":
        dashed = "N-" + t[1:]
        if dashed in materials.SELLMEIER:
            return dashed
    if t in ("SILICA", "FSILICA", "FUSEDSILICA", "SIO2"):
        return "FUSED-SILICA"
    return tok.upper()


def _radius_to_curv(tok: str, path, ln) -> float:
    t = tok.upper()
    if t in ("INF", "INFINITY"):
        return 0.0
    try:
        r = float(t)
    except ValueError:
        raise ValueError(f"{path}:{ln}: bad radius {tok!r}")
    return 0.0 if r == 0.0 else 1.0 / r


def _f(tok: str, path, ln, what: str) -> float:
    t = tok.upper()
    if t in ("INF", "INFINITY"):
        return math.inf
    try:
        return float(t)
    except ValueError:
        raise ValueError(f"{path}:{ln}: bad {what} {tok!r}")


# even-asphere letters -> ZmxSurface.parm index (PARM i = coeff of r^2i)
_ASPH = {"A": 2, "B": 3, "C": 4, "D": 5}
_UNITS = {"M": "MM", "C": "CM", "I": "IN"}


def load_seq(path) -> ZmxPrescription:
    """Parse a CODE V ``.seq`` file into a
    :class:`~lightpycl_tpu_torch.io.zmx.ZmxPrescription` (surface indices
    renumbered 0..n in file order, object first, image last).

    Raises ``ValueError`` on unrecognized commands or malformed numeric
    fields, naming the line."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    presc = ZmxPrescription()
    surf = None
    wavelengths = []

    def new_surface(args, ln, is_image=False):
        nonlocal surf
        if len(args) < 1:
            raise ValueError(f"{path}:{ln}: surface needs a radius")
        surf = ZmxSurface(index=len(presc.surfaces))
        surf.curv = _radius_to_curv(args[0], path, ln)
        surf.disz = _f(args[1], path, ln, "thickness") if len(args) > 1 \
            else 0.0
        if len(args) > 2 and not is_image:
            g = args[2].upper()
            if g == "REFL":
                surf.glass = "MIRROR"
            else:
                surf.glass = _norm_glass(g)
        presc.surfaces.append(surf)

    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("!", 1)[0].strip()  # ! starts a comment
        if not line:
            continue
        for piece in line.split(";"):
            piece = piece.strip()
            if not piece:
                continue
            parts = piece.split()
            cmd = parts[0].upper()
            args = parts[1:]
            if cmd in _IGNORED:
                continue
            if cmd == "TITLE":
                presc.name = piece.split(None, 1)[1].strip("'\"") \
                    if args else ""
            elif cmd == "DIM":
                presc.unit = _UNITS.get(args[0].upper()[:1], "MM") \
                    if args else "MM"
            elif cmd == "EPD":
                presc.enpd = _f(args[0], path, ln, "EPD") if args else 0.0
            elif cmd == "WL":
                # CODE V wavelengths are nanometers
                wavelengths = [_f(a, path, ln, "wavelength") / 1000.0
                               for a in args]
            elif cmd == "REF":
                presc.primary_wl_index = int(float(args[0]))
            elif cmd in ("SO", "S", "SI"):
                new_surface(args, ln, is_image=(cmd == "SI"))
            elif cmd == "STO":
                if surf is None:
                    raise ValueError(f"{path}:{ln}: STO before any surface")
                surf.is_stop = True
            elif cmd == "K":
                if surf is None:
                    raise ValueError(f"{path}:{ln}: K before any surface")
                surf.conic = _f(args[0], path, ln, "conic")
            elif cmd in _ASPH:
                if surf is None:
                    raise ValueError(f"{path}:{ln}: {cmd} before any surface")
                v = _f(args[0], path, ln, "asphere coefficient")
                if v != 0.0:
                    surf.parm[_ASPH[cmd]] = v
                    surf.type = "EVENASPH"
            elif cmd == "CIR":
                if surf is None:
                    raise ValueError(f"{path}:{ln}: CIR before any surface")
                # CIR [EDG] x — take the last numeric
                surf.semi_diam = _f(args[-1], path, ln, "semi-aperture")
            elif cmd == "GLA":
                if surf is None:
                    raise ValueError(f"{path}:{ln}: GLA before any surface")
                g = args[0].upper()
                surf.glass = "MIRROR" if g == "REFL" else _norm_glass(g)
            elif cmd == "THI":
                if surf is None:
                    raise ValueError(f"{path}:{ln}: THI before any surface")
                surf.disz = _f(args[0], path, ln, "thickness")
            elif cmd == "RDY":
                if surf is None:
                    raise ValueError(f"{path}:{ln}: RDY before any surface")
                surf.curv = _radius_to_curv(args[0], path, ln)
            else:
                raise ValueError(
                    f"{path}:{ln}: unrecognized CODE V command {cmd!r} "
                    "(supported: surface data S/SO/SI/STO/K/A-D/CIR/GLA/"
                    "THI/RDY, system data TITLE/DIM/EPD/WL/REF)")
    if wavelengths:
        presc.wavelengths_um = wavelengths
        presc.primary_wl_index = min(max(presc.primary_wl_index, 1),
                                     len(wavelengths))
    if len(presc.surfaces) < 3:
        raise ValueError(
            f"{path}: {len(presc.surfaces)} surfaces — a sequence needs at "
            "least object (SO), one surface (S), image (SI)")
    return presc


def seq_paraxial(src, wavelength_um: float = None,
                 glass_overrides: dict = None) -> dict:
    """Cardinal points of a ``.seq`` prescription — ``zmx_paraxial`` over
    the parsed sequence (mirror folds included)."""
    presc = src if isinstance(src, ZmxPrescription) else load_seq(src)
    return zmx_paraxial(presc, wavelength_um, glass_overrides)


def seq_to_scene(src, **kw):
    """Traceable GeoObjects from a ``.seq`` path or parsed prescription —
    ``zmx_to_scene`` over the parsed sequence (same kwargs: tessellation,
    detector sizing, glass overrides, mirror holes)."""
    presc = src if isinstance(src, ZmxPrescription) else load_seq(src)
    return zmx_to_scene(presc, **kw)
