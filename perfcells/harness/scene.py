"""A configuration's elements: the frozen generators' arrays, as the
reference takes them and as the program's own `GeoObject`s."""

from __future__ import annotations

from perfcells.harness import catalog

# what an element of a configuration may say; anything else would be a
# property that neither side follows, so it is refused
ELEMENT_KEYS = {"name", "kind", "params", "material", "reflectivity", "ior"}


def element_arrays(config: dict) -> list[dict]:
    """One dict per element: vertices, triangles, material, reflectivity,
    ior (the index inside the volume its outward normals bound), name."""
    out = []
    for el in config["elements"]:
        extra = set(el) - ELEMENT_KEYS
        if extra:
            raise ValueError(f"element {el.get('name')!r}: keys "
                             f"{sorted(extra)} are followed by neither the "
                             "program's elements nor the reference")
        V, T = catalog.load_module("scenes", el["kind"]).build(**el["params"])
        out.append({"vertices": V, "triangles": T,
                    "material": el["material"],
                    "reflectivity": float(el.get("reflectivity", 1.0)),
                    "ior": float(el.get("ior", 1.0)),
                    "name": el["name"]})
    return out


def program_elements(arrays: list[dict]):
    """The same arrays as the program's GeoObjects."""
    from lightpycl_tpu_torch.geometry.mesh import GeoObject
    from lightpycl_tpu_torch.materials import Material

    return [GeoObject(a["vertices"], a["triangles"],
                      Material.from_any(a["material"]), a["ior"],
                      reflectivity=a["reflectivity"], name=a["name"])
            for a in arrays]
