"""Wavefront OBJ and Stanford PLY mesh IO.

Port counterpart of lightpycl_tpu/io/obj.py: a jax-free copy
(tests/test_torch_io_formats.py holds it to the reference). The files it
writes carry the reference's identifiers, byte for byte, so either package
reads the other's.

Extension over the reference (which had DXF export only — SURVEY.md §3
'DXF export' row; STL and DXF import were added earlier): OBJ and PLY are
the other two interchange formats optical CAD and mesh tools emit.
Both loaders fan-triangulate arbitrary polygons and return GeoObjects;
`load_obj_scene` maps OBJ group / usemtl names to per-element optical
properties the same way `load_dxf_scene` maps DXF layers.

Zero third-party dependencies: OBJ is plain text; PLY is parsed directly
in both ``ascii`` and ``binary_little_endian`` flavors.
"""

from __future__ import annotations

import struct

import numpy as np

from lightpycl_tpu_torch.geometry.mesh import GeoObject

# ---------------------------------------------------------------------------
# OBJ


def _fan(idx):
    """Triangulate one polygon index list as a fan around vertex 0."""
    return [(idx[0], idx[i], idx[i + 1]) for i in range(1, len(idx) - 1)]


def _parse_obj(path):
    """Return (verts (V,3) f64, {group_name: [(a,b,c) triangles]})."""
    verts = []
    groups: dict = {}
    current = "default"
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag in ("g", "o", "usemtl"):
                current = parts[1] if len(parts) > 1 else "default"
            elif tag == "f":
                idx = []
                for tok in parts[1:]:
                    # f v, f v/vt, f v//vn, f v/vt/vn — vertex id leads
                    i = int(tok.split("/", 1)[0])
                    # OBJ is 1-based; negatives count back from the end
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                if len(idx) < 3:
                    raise ValueError(f"{path}:{ln}: face with <3 vertices")
                groups.setdefault(current, []).extend(_fan(idx))
    if not verts:
        raise ValueError(f"{path}: no vertices (not an OBJ file?)")
    if not groups:
        raise ValueError(f"{path}: no faces")
    v = np.asarray(verts, np.float64)
    for name, tris in groups.items():
        t = np.asarray(tris, np.int64)
        if t.min() < 0 or t.max() >= len(v):
            raise ValueError(f"{path}: face index out of range in {name!r}")
    return v, groups


def _compact(verts, tris):
    """Drop vertices unused by `tris`, reindexing the triangles."""
    tris = np.asarray(tris, np.int64)
    used, inv = np.unique(tris.ravel(), return_inverse=True)
    return verts[used], inv.reshape(tris.shape).astype(np.int32)


def load_obj(path: str, material="terminator", ior: float = 1.0,
             **kw) -> GeoObject:
    """Read an OBJ file (all groups merged) into one GeoObject."""
    verts, groups = _parse_obj(path)
    tris = [t for ts in groups.values() for t in ts]
    v, t = _compact(verts, tris)
    return GeoObject(v, t, material, ior, **kw)


def load_obj_scene(path: str, group_map: dict, default_material=None):
    """Read an OBJ file into a list of GeoObjects, one per group /
    usemtl name, with per-group optical properties.

    `group_map` maps group name -> GeoObject kwargs (material, ior,
    reflectivity, name, ...), exactly like `load_dxf_scene`'s layer_map.
    Groups absent from the map get `default_material` (or are skipped
    when it is None).
    """
    verts, groups = _parse_obj(path)
    out = []
    for gname, tris in groups.items():
        if gname in group_map:
            kw = dict(group_map[gname])
        elif default_material is not None:
            kw = dict(material=default_material)
        else:
            continue
        kw.setdefault("name", gname)
        material = kw.pop("material")
        ior = kw.pop("ior", 1.0)
        v, t = _compact(verts, tris)
        out.append(GeoObject(v, t, material, ior, **kw))
    if not out:
        raise ValueError(
            f"{path}: no group matched group_map {sorted(group_map)} "
            f"(file has {sorted(groups)})")
    return out


def save_obj(path: str, objs) -> str:
    """Write one GeoObject or a list as an OBJ file (one `o` per object)."""
    if isinstance(objs, GeoObject):
        objs = [objs]
    with open(path, "w") as f:
        f.write("# lightpycl_tpu OBJ export\n")
        base = 1  # OBJ indices are 1-based and global across objects
        for i, obj in enumerate(objs):
            f.write(f"o {obj.name or f'element_{i}'}\n")
            for x, y, z in np.asarray(obj.vertices, np.float64):
                f.write(f"v {x:.9g} {y:.9g} {z:.9g}\n")
            for a, b, c in np.asarray(obj.triangles):
                f.write(f"f {base + a} {base + b} {base + c}\n")
            base += len(obj.vertices)
    return path


# ---------------------------------------------------------------------------
# PLY

_PLY_SIZES = {"char": 1, "uchar": 1, "int8": 1, "uint8": 1,
              "short": 2, "ushort": 2, "int16": 2, "uint16": 2,
              "int": 4, "uint": 4, "int32": 4, "uint32": 4,
              "float": 4, "float32": 4, "double": 8, "float64": 8}
_PLY_NP = {"char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
           "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
           "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
           "float": "f4", "float32": "f4", "double": "f8", "float64": "f8"}


def _parse_ply_header(f):
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []  # [(name, count, [(prop_kind, ...)...])]
    while True:
        line = f.readline()
        if not line:
            raise ValueError("PLY header missing end_header")
        parts = line.decode("ascii", "replace").split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
            if fmt not in ("ascii", "binary_little_endian"):
                raise ValueError(f"unsupported PLY format {fmt!r}")
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise ValueError("PLY property before any element")
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))
        elif parts[0] == "end_header":
            return fmt, elements


def load_ply(path: str, material="terminator", ior: float = 1.0,
             **kw) -> GeoObject:
    """Read a PLY mesh (ascii or binary_little_endian) into a GeoObject."""
    with open(path, "rb") as f:
        fmt, elements = _parse_ply_header(f)
        verts = faces = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    cols = [p[2] for p in props if p[0] == "scalar"]
                    ix = [cols.index(c) for c in ("x", "y", "z")]
                    verts = np.array(
                        [[float(r[i]) for i in ix] for r in rows], np.float64)
                elif name == "face":
                    tris = []
                    for r in rows:
                        k = int(r[0])
                        tris.extend(_fan([int(x) for x in r[1:1 + k]]))
                    faces = np.asarray(tris, np.int64)
                continue
            # binary little endian
            if name == "vertex":
                if any(p[0] == "list" for p in props):
                    raise ValueError("list property on PLY vertex element")
                dt = np.dtype([(p[2], "<" + _PLY_NP[p[1]]) for p in props])
                raw = f.read(dt.itemsize * count)
                if len(raw) != dt.itemsize * count:
                    raise ValueError(f"truncated PLY vertex block in {path}")
                rec = np.frombuffer(raw, dtype=dt)
                verts = np.stack([rec["x"], rec["y"], rec["z"]],
                                 axis=1).astype(np.float64)
            elif name == "face":
                lp = next(p for p in props if p[0] == "list")
                if len(props) != 1:
                    raise ValueError(
                        "PLY face element with extra properties unsupported")
                csz, cnp = _PLY_SIZES[lp[1]], _PLY_NP[lp[1]]
                isz, inp = _PLY_SIZES[lp[2]], _PLY_NP[lp[2]]
                tris = []
                for _ in range(count):
                    raw = f.read(csz)
                    if len(raw) != csz:
                        raise ValueError(f"truncated PLY face block in {path}")
                    (k,) = np.frombuffer(raw, dtype="<" + cnp)
                    raw = f.read(isz * int(k))
                    if len(raw) != isz * int(k):
                        raise ValueError(f"truncated PLY face block in {path}")
                    idx = np.frombuffer(raw, dtype="<" + inp)
                    tris.extend(_fan([int(x) for x in idx]))
                faces = np.asarray(tris, np.int64)
            else:
                # skip an unknown fixed-size element
                row = sum(_PLY_SIZES[p[1]] for p in props
                          if p[0] == "scalar")
                if any(p[0] == "list" for p in props):
                    raise ValueError(
                        f"cannot skip PLY element {name!r} with list props")
                f.seek(row * count, 1)
    if verts is None or faces is None:
        raise ValueError(f"{path}: PLY file lacks vertex or face element")
    if faces.min() < 0 or faces.max() >= len(verts):
        raise ValueError(f"{path}: PLY face index out of range")
    return GeoObject(verts, faces.astype(np.int32), material, ior, **kw)


def save_ply(path: str, obj: GeoObject) -> str:
    """Write a GeoObject as binary_little_endian PLY."""
    v = np.asarray(obj.vertices, np.float32)
    t = np.asarray(obj.triangles, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"comment lightpycl_tpu PLY export\n")
        f.write(f"element vertex {len(v)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(t)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(v.astype("<f4").tobytes())
        for a, b, c in t:
            f.write(struct.pack("<Biii", 3, a, b, c))
    return path
