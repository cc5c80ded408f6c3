"""Full-fidelity scene serialization: ``save_scene`` / ``load_scene``.

Port counterpart of lightpycl_tpu/io/scene.py: a jax-free copy
(tests/test_torch_io_formats.py holds it to the reference). The files it
writes carry the reference's identifiers, byte for byte, so either package
reads the other's.

Extension over the reference (SURVEY.md §3 'DXF export' row is its only
file IO): the mesh interchange formats this package reads and writes
(DXF/STL/OBJ/PLY) carry geometry but lose the optical state — dispersion
coefficients, coatings, grating parameters, GRIN profiles, fluorescence
spectra. ``save_scene`` writes the COMPLETE ``GeoObject`` list to a
single ``.npz`` (zero third-party deps): large arrays (vertices,
triangles) as native npz entries, everything else through a generic
dataclass-field walk into a JSON header — so fields added to
``GeoObject`` in future rounds serialize automatically, with an explicit
error (rather than silent loss) if a field's value is not representable.

``load_scene`` reconstructs through the ``GeoObject`` constructor, so
every ``__post_init__`` validation re-runs on load: a file edited into
an inconsistent state (e.g. a grating without an axis) fails loudly.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from lightpycl_tpu_torch.geometry.mesh import GeoObject
from lightpycl_tpu_torch.materials import Material

_FORMAT = "lightpycl_tpu-scene"
_VERSION = 1

# fields stored as npz arrays rather than in the JSON header
_ARRAY_FIELDS = ("vertices", "triangles")


def _encode(v):
    """JSON-encode one field value, tagged for exact reconstruction."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, Material):
        return {"__mat__": v.name}
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, np.ndarray):
        return {"__nd__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, (list, tuple)):
        return {"__seq__": [_encode(x) for x in v],
                "tuple": isinstance(v, tuple)}
    raise TypeError(
        f"cannot serialize field value of type {type(v).__name__}: {v!r} "
        "(extend io/scene.py::_encode for the new GeoObject field)")


def _decode(v):
    if isinstance(v, dict):
        if "__mat__" in v:
            return Material.from_any(v["__mat__"])
        if "__nd__" in v:
            return np.asarray(v["__nd__"], dtype=v["dtype"])
        if "__seq__" in v:
            seq = [_decode(x) for x in v["__seq__"]]
            return tuple(seq) if v.get("tuple") else seq
        raise ValueError(f"unknown tagged value in scene file: {v}")
    return v


def save_scene(path, elements) -> None:
    """Write a list of GeoObjects to `path` (.npz) with every optical
    field preserved. Round-trip partner of :func:`load_scene`."""
    arrays, meta = {}, []
    for i, el in enumerate(elements):
        if not isinstance(el, GeoObject):
            raise TypeError(f"elements[{i}] is {type(el).__name__}, "
                            "not GeoObject")
        rec = {}
        for f in dataclasses.fields(el):
            v = getattr(el, f.name)
            if f.name in _ARRAY_FIELDS:
                arrays[f"e{i}_{f.name}"] = v
            else:
                rec[f.name] = _encode(v)
        meta.append(rec)
    header = json.dumps({"format": _FORMAT, "version": _VERSION,
                         "n_elements": len(meta), "elements": meta})
    np.savez_compressed(path, __meta__=np.frombuffer(
        header.encode(), dtype=np.uint8), **arrays)


def load_scene(path) -> list:
    """Read a scene written by :func:`save_scene` back into GeoObjects
    (constructor validation re-runs on every element)."""
    with np.load(path) as z:
        if "__meta__" not in z:
            raise ValueError(f"{path}: not a lightpycl_tpu scene file "
                             "(missing __meta__ header)")
        header = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if header.get("format") != _FORMAT:
            raise ValueError(f"{path}: unknown scene format "
                             f"{header.get('format')!r}")
        if header.get("version", 0) > _VERSION:
            raise ValueError(
                f"{path}: scene format version {header['version']} is newer "
                f"than this reader ({_VERSION}) — upgrade lightpycl_tpu")
        known = {f.name for f in dataclasses.fields(GeoObject)}
        elements = []
        for i, rec in enumerate(header["elements"]):
            unknown = set(rec) - known
            if unknown:
                raise ValueError(
                    f"{path}: element {i} carries unknown GeoObject "
                    f"field(s) {sorted(unknown)} — written by a newer "
                    "lightpycl_tpu?")
            kw = {k: _decode(v) for k, v in rec.items()}
            for name in _ARRAY_FIELDS:
                kw[name] = z[f"e{i}_{name}"]
            elements.append(GeoObject(**kw))
    return elements
