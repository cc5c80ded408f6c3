"""The benchmark's frozen mesh generators, one file per element kind.

Each `<kind>.py` defines `build(**params) -> (vertices (V, 3) float64,
triangles (T, 3) int32)`. A configuration names the kind and its
parameters; the program receives the arrays as its own `GeoObject`, and the
plain reference receives the same arrays. They are copies of the port's
numpy meshers (`geometry/primitives.py`), frozen here so that a change to
the program cannot change the scene it is measured on.
"""
