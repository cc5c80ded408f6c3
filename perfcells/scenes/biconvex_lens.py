"""Biconvex spherical lens on the z axis, front vertex at z = 0, back
vertex at z = thickness, both surfaces of curvature radius `radius`: the
port's `optical_elements(n_segments, n_radial).biconvex_lens(radius,
aperture, thickness)` mesh, moved by `center` as `GeoObject.translate`
moves it."""

import numpy as np

from perfcells.scenes._revolve import revolve


def _cap(R, a, z0, n):
    """(r, z) profile of a spherical cap of signed radius R (centre of
    curvature at z0 + R), vertex at (0, z0), rim at r = a."""
    r = np.linspace(0.0, a, n + 1)
    return np.stack([r, z0 + R - np.sign(R) * np.sqrt(R * R - r * r)], 1)


def build(radius, aperture, thickness, n_segments, n_radial,
          center=(0.0, 0.0, 0.0)):
    a = aperture / 2.0
    R = abs(radius)
    prof = np.concatenate([_cap(R, a, 0.0, n_radial),
                           _cap(-R, a, thickness, n_radial)[::-1]])
    return revolve(prof, n_segments, center)
