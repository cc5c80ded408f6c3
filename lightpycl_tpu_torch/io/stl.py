"""STL mesh import (binary and ASCII).

Port counterpart of lightpycl_tpu/io/stl.py: a jax-free copy
(tests/test_torch_io_formats.py holds it to the reference). The files it
writes carry the reference's identifiers, byte for byte, so either package
reads the other's.

Extension over the reference (which had DXF only): STL is the most common
CAD export for optical mounts/mirrors. Returns a GeoObject.
"""

from __future__ import annotations

import struct

import numpy as np

from lightpycl_tpu_torch.geometry.mesh import GeoObject


def load_stl(path: str, material="terminator", ior: float = 1.0,
             **kw) -> GeoObject:
    """Read an STL file (auto-detects binary vs ASCII) into a GeoObject."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header; try ASCII first
        try:
            return _load_ascii(path, material, ior, **kw)
        except ValueError:
            pass
    return _load_binary(path, material, ior, **kw)


def _load_binary(path, material, ior, **kw):
    with open(path, "rb") as f:
        f.seek(80)
        count = f.read(4)
        if len(count) != 4:
            raise ValueError(f"not a valid STL file: {path}")
        (n,) = struct.unpack("<I", count)
        if n == 0:
            raise ValueError(f"empty STL: {path}")
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8)
    if len(data) != n * 50:
        raise ValueError(f"truncated binary STL: {path}")
    rec = data.reshape(n, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3).astype(np.float64)
    verts = tri.reshape(-1, 3)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return GeoObject(verts, faces, material, ior, **kw)


def _load_ascii(path, material, ior, **kw):
    verts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append([float(x) for x in parts[1:4]])
    if not verts or len(verts) % 3:
        raise ValueError(f"not a valid ASCII STL: {path}")
    v = np.asarray(verts, np.float64)
    faces = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    return GeoObject(v, faces, material, ior, **kw)


def save_stl(path: str, obj: GeoObject) -> str:
    """Write a GeoObject as binary STL."""
    tv = obj.triangle_vertices().astype(np.float32)
    n = len(tv)
    normals = obj.face_normals().astype(np.float32)
    with open(path, "wb") as f:
        f.write(b"lightpycl_tpu".ljust(80, b"\0"))
        f.write(struct.pack("<I", n))
        for i in range(n):
            f.write(normals[i].tobytes())
            f.write(tv[i].tobytes())
            f.write(b"\0\0")
    return path
