"""Flat disc in the plane z = 0 with its outward normal along +z: the
port's `optical_elements(n_segments, n_radial).disc(radius)` mesh, moved
by `center` as `GeoObject.translate` moves it."""

import numpy as np

from perfcells.scenes._revolve import revolve


def build(radius, n_segments, n_radial, center=(0.0, 0.0, 0.0)):
    prof = np.stack([np.linspace(0.0, radius, n_radial + 1),
                     np.zeros(n_radial + 1)], 1)
    # rim to centre, so that the revolved normals face +z
    return revolve(prof[::-1], n_segments, center)
