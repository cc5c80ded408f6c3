"""Plano-convex spherical lens on the z axis: flat front at z = 0, convex
back of curvature radius `radius` with its vertex at z = thickness: the
port's `optical_elements(n_segments, n_radial).plano_convex_lens(radius,
aperture, thickness)` mesh (its `spherical_lens` with a flat front), moved
by `center` as `GeoObject.translate` moves it. Where the back surface
meets the front at the rim (a knife edge) the rims weld shut."""

import numpy as np

from perfcells.scenes._revolve import revolve


def build(radius, aperture, thickness, n_segments, n_radial,
          center=(0.0, 0.0, 0.0)):
    a = aperture / 2.0
    R = -abs(radius)  # the back's centre of curvature lies before it
    r = np.linspace(0.0, a, n_radial + 1)
    front = np.stack([r, np.full_like(r, 0.0)], 1)
    back = np.stack([r, thickness + R - np.sign(R) * np.sqrt(R * R - r * r)],
                    1)
    return revolve(np.concatenate([front, back[::-1]]), n_segments, center)
