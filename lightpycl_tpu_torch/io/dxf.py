"""Minimal ASCII DXF (R12) writer: scene triangles as 3DFACE, ray paths as
LINE entities.

Port counterpart of lightpycl_tpu/io/dxf.py: a jax-free copy
(tests/test_torch_io_formats.py holds it to the reference).

Reference parity: the dxfwrite-based `save_traced_scene` export of
iterative_tracer.py (SURVEY.md §3 'DXF export'). dxfwrite isn't available
in this environment (and isn't needed): R12 3DFACE/LINE entities are a
trivial group-code format emitted by hand, so the export has zero deps.
"""

from __future__ import annotations

import numpy as np


class DXFWriter:
    def __init__(self):
        self._entities: list[str] = []

    def add_3dface(self, p0, p1, p2, p3=None, layer: str = "mesh"):
        """Triangle (p3 omitted -> repeated last vertex) or quad face."""
        if p3 is None:
            p3 = p2
        e = ["0", "3DFACE", "8", layer]
        # DXF point group codes: corner i -> x=10+i, y=20+i, z=30+i
        for i, p in enumerate((p0, p1, p2, p3)):
            for axis in range(3):
                e += [str(10 + i + 10 * axis), f"{float(p[axis]):.9g}"]
        self._entities.append("\n".join(e))

    def add_line(self, start, end, layer: str = "rays"):
        e = ["0", "LINE", "8", layer,
             "10", f"{float(start[0]):.9g}", "20", f"{float(start[1]):.9g}",
             "30", f"{float(start[2]):.9g}",
             "11", f"{float(end[0]):.9g}", "21", f"{float(end[1]):.9g}",
             "31", f"{float(end[2]):.9g}"]
        self._entities.append("\n".join(e))

    def add_mesh(self, vertices, triangles, layer: str = "mesh"):
        v = np.asarray(vertices)
        for tri in np.asarray(triangles):
            self.add_3dface(v[tri[0]], v[tri[1]], v[tri[2]], layer=layer)

    def add_polyface(self, vertices, triangles, layer: str = "mesh"):
        """Shared-vertex POLYLINE polyface mesh (R12, flag 64) — ~3x smaller
        on disk than per-triangle 3DFACE for tessellated optics."""
        v = np.asarray(vertices, np.float64)
        t = np.asarray(triangles, np.int64)
        e = ["0", "POLYLINE", "8", layer, "66", "1", "70", "64",
             "71", str(len(v)), "72", str(len(t))]
        for p in v:
            e += ["0", "VERTEX", "8", layer,
                  "10", f"{p[0]:.9g}", "20", f"{p[1]:.9g}", "30", f"{p[2]:.9g}",
                  "70", "192"]  # 64|128 = polyface mesh vertex
        for tri in t:
            e += ["0", "VERTEX", "8", layer,
                  "10", "0", "20", "0", "30", "0", "70", "128",  # face record
                  "71", str(int(tri[0]) + 1), "72", str(int(tri[1]) + 1),
                  "73", str(int(tri[2]) + 1)]
        e += ["0", "SEQEND"]
        self._entities.append("\n".join(e))

    def tostring(self) -> str:
        head = "0\nSECTION\n2\nENTITIES"
        tail = "0\nENDSEC\n0\nEOF"
        return "\n".join([head, *self._entities, tail]) + "\n"

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.tostring())


# $INSUNITS code -> meters per drawing unit (DXF header group 70 values)
_INSUNITS_METERS = {
    0: None,    # unitless
    1: 0.0254,  # inches
    2: 0.3048,  # feet
    3: 1609.344,
    4: 1e-3,    # millimeters
    5: 1e-2,    # centimeters
    6: 1.0,     # meters
    7: 1e3,     # kilometers
    8: 2.54e-8, # microinches
    9: 2.54e-5, # mils
    10: 0.9144, # yards
    11: 1e-10,  # angstroms
    12: 1e-9,   # nanometers
    13: 1e-6,   # microns
    14: 0.1,    # decimeters
}
_UNIT_NAMES = {"m": 1.0, "meter": 1.0, "mm": 1e-3, "cm": 1e-2, "km": 1e3,
               "um": 1e-6, "in": 0.0254, "ft": 0.3048}


def _iter_tags(path: str):
    """Yield (group_code, value) pairs — the actual DXF grammar, instead of
    pattern-matching on stripped lines (which misfires on values that look
    like group codes)."""
    with open(path) as f:
        lines = f.read().splitlines()
    for i in range(0, len(lines) - 1, 2):
        try:
            code = int(lines[i].strip())
        except ValueError:
            continue
        yield code, lines[i + 1].strip()


def _parse_dxf(path: str):
    """Parse HEADER ($INSUNITS) and ENTITIES (3DFACE + POLYLINE meshes).

    Returns (faces, insunits) where faces is a list of
    (layer, verts (N,3) list, tris list) chunks.
    """
    faces: list = []
    insunits = None
    section = None
    header_var = None

    tags = list(_iter_tags(path))
    i = 0

    def entity_body(j):
        """Collect this entity's tags until the next 0 tag; returns
        (dict-of-lists, next_index)."""
        body: dict = {}
        while j < len(tags) and tags[j][0] != 0:
            body.setdefault(tags[j][0], []).append(tags[j][1])
            j += 1
        return body, j

    while i < len(tags):
        code, val = tags[i]
        if code == 0 and val == "SECTION":
            section = tags[i + 1][1] if i + 1 < len(tags) else None
            i += 2
            continue
        if code == 0 and val == "ENDSEC":
            section = None
            i += 1
            continue
        if section == "HEADER":
            if code == 9:
                header_var = val
            elif header_var == "$INSUNITS" and code == 70:
                insunits = int(val)
            i += 1
            continue
        if section != "ENTITIES" or code != 0:
            i += 1
            continue

        if val == "3DFACE":
            body, i = entity_body(i + 1)
            layer = body.get(8, ["0"])[0]
            pts = []
            for c in range(4):
                try:
                    pts.append(tuple(float(body[ax + c][0])
                                     for ax in (10, 20, 30)))
                except (KeyError, ValueError):
                    break
            if len(pts) >= 3:
                tris = [(0, 1, 2)]
                if len(pts) == 4 and pts[3] != pts[2]:
                    tris.append((0, 2, 3))
                faces.append((layer, pts, tris))
        elif val == "POLYLINE":
            body, i = entity_body(i + 1)
            layer = body.get(8, ["0"])[0]
            flags = int(body.get(70, ["0"])[0])
            m_count = int(body.get(71, ["0"])[0])
            n_count = int(body.get(72, ["0"])[0])
            verts: list = []
            face_recs: list = []
            # consume VERTEX entities until SEQEND
            while i < len(tags):
                if tags[i][0] != 0:
                    i += 1
                    continue
                if tags[i][1] == "SEQEND":
                    _, i = entity_body(i + 1)
                    break
                if tags[i][1] != "VERTEX":
                    break  # malformed: bail to outer loop without consuming
                vbody, i = entity_body(i + 1)
                vflags = int(vbody.get(70, ["0"])[0])
                if vflags & 128 and not vflags & 64:
                    # polyface FACE record: 1-based indices in 71..74,
                    # negative = invisible edge (sign stripped)
                    idx = [abs(int(vbody[c][0])) - 1
                           for c in (71, 72, 73, 74) if c in vbody
                           and int(vbody[c][0]) != 0]
                    if len(idx) >= 3:
                        face_recs.append(tuple(idx[:3]))
                        if len(idx) == 4 and idx[3] != idx[2]:
                            face_recs.append((idx[0], idx[2], idx[3]))
                else:
                    verts.append(tuple(float(vbody.get(ax, ["0"])[0])
                                       for ax in (10, 20, 30)))
            if flags & 64 and face_recs:
                faces.append((layer, verts, face_recs))
            elif flags & 16 and m_count >= 2 and n_count >= 2:
                # M x N polygon mesh: triangulate the grid; flags 1 / 32
                # close the mesh in M / N
                tris = []
                closed_m = bool(flags & 1)
                closed_n = bool(flags & 32)
                m_faces = m_count if closed_m else m_count - 1
                n_faces = n_count if closed_n else n_count - 1
                for mi in range(m_faces):
                    for ni in range(n_faces):
                        a = mi * n_count + ni
                        b = mi * n_count + (ni + 1) % n_count
                        c = ((mi + 1) % m_count) * n_count + (ni + 1) % n_count
                        d = ((mi + 1) % m_count) * n_count + ni
                        tris += [(a, b, c), (a, c, d)]
                faces.append((layer, verts, tris))
        else:
            i += 1
    return faces, insunits


def _dxf_scale(insunits, units):
    """Scale factor from the file's drawing units into `units` (a name from
    _UNIT_NAMES or meters-per-unit float). None/unitless -> 1.0."""
    if units is None:
        return 1.0
    target = _UNIT_NAMES[units] if isinstance(units, str) else float(units)
    meters = _INSUNITS_METERS.get(insunits)
    if meters is None:
        return 1.0  # unitless file: take coordinates as-is
    return meters / target


def load_dxf_mesh(path: str, material="terminator", ior: float = 1.0,
                  units=None, layers=None, **kw):
    """Read mesh entities (3DFACE, POLYLINE polyface and MxN polygon
    meshes) from a DXF file into one GeoObject, triangulating quads.

    `units`: target unit for the scene ('mm', 'm', ... or meters-per-unit
    float); coordinates are scaled from the file's $INSUNITS header when
    present (unitless files pass through unchanged). `layers`: optional
    set/list restricting which layers are read.

    Reference survey flagged DXF import as a possible reference capability
    (SURVEY.md §8.5); supported for round-tripping scenes written by
    `save_traced_scene` and for CAD-sourced optics.
    """
    from lightpycl_tpu_torch.geometry.mesh import GeoObject

    chunks, insunits = _parse_dxf(path)
    if layers is not None:
        keep = set(layers)
        chunks = [c for c in chunks if c[0] in keep]
    verts: list = []
    tris: list = []
    for _, v, t in chunks:
        base = len(verts)
        verts.extend(v)
        tris.extend((base + a, base + b, base + c) for a, b, c in t)
    if not tris:
        raise ValueError(f"no mesh entities (3DFACE/POLYLINE) found in {path}")
    V = np.asarray(verts, np.float64) * _dxf_scale(insunits, units)
    return GeoObject(V, np.asarray(tris, np.int32), material, ior, **kw)


def load_dxf_scene(path: str, layer_map: dict, units=None,
                   default_material=None):
    """Read a DXF file into a list of GeoObjects, one per layer, with
    per-layer optical properties.

    `layer_map` maps layer name -> GeoObject kwargs (material, ior,
    reflectivity, name, ...). Layers absent from the map get
    `default_material` (or are skipped when it is None). Example:

        els = load_dxf_scene("bench.dxf", {
            "lens":   dict(material="refractive", ior=1.5),
            "mirror": dict(material="mirror", reflectivity=0.98),
            "dome":   dict(material="measure", name="dome"),
        }, units="mm")
    """
    from lightpycl_tpu_torch.geometry.mesh import GeoObject

    chunks, insunits = _parse_dxf(path)
    scale = _dxf_scale(insunits, units)
    by_layer: dict = {}
    for layer, v, t in chunks:
        verts, tris = by_layer.setdefault(layer, ([], []))
        base = len(verts)
        verts.extend(v)
        tris.extend((base + a, base + b, base + c) for a, b, c in t)
    out = []
    for layer, (verts, tris) in by_layer.items():
        if layer in layer_map:
            kw = dict(layer_map[layer])
        elif default_material is not None:
            kw = dict(material=default_material)
        else:
            continue
        kw.setdefault("name", layer)
        out.append(GeoObject(np.asarray(verts, np.float64) * scale,
                             np.asarray(tris, np.int32), **kw))
    if not out:
        raise ValueError(
            f"no mesh entities matched layer_map/default_material in {path}")
    return out


def save_traced_scene(path: str, elements, segments=(), max_rays_per_iter: int = 1000):
    """Write scene meshes + traced ray segments to a DXF file.

    `segments` is TraceResult.segments (record_paths=True): per iteration
    (starts (C,3), ends (C,3), alive (C,)).
    """
    w = DXFWriter()
    for i, el in enumerate(elements):
        if getattr(el, "quad_abgd", None) is not None:
            # analytic surface: export a tessellation, not the one-triangle
            # placeholder its `vertices` hold (geometry/analytic.py)
            el = el.to_mesh()
        w.add_mesh(el.vertices, el.triangles, layer=el.name or f"element_{i}")
    for starts, ends, alive in segments:
        idx = np.nonzero(alive)[0][:max_rays_per_iter]
        for i in idx:
            w.add_line(starts[i], ends[i])
    w.save(path)
    return path
