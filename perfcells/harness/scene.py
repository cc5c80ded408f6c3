"""A configuration's elements: the frozen generators' arrays, as the
reference takes them and as the program's own `GeoObject`s."""

from __future__ import annotations

from perfcells.harness import catalog


def element_arrays(config: dict) -> list[dict]:
    """One dict per element: vertices, triangles, material, reflectivity,
    name."""
    out = []
    for el in config["elements"]:
        V, T = catalog.load_module("scenes", el["kind"]).build(**el["params"])
        out.append({"vertices": V, "triangles": T,
                    "material": el["material"],
                    "reflectivity": float(el.get("reflectivity", 1.0)),
                    "name": el["name"]})
    return out


def program_elements(arrays: list[dict]):
    """The same arrays as the program's GeoObjects."""
    from lightpycl_tpu_torch.geometry.mesh import GeoObject
    from lightpycl_tpu_torch.materials import Material

    return [GeoObject(a["vertices"], a["triangles"],
                      Material.from_any(a["material"]), 1.0,
                      reflectivity=a["reflectivity"], name=a["name"])
            for a in arrays]
