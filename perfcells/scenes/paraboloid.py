"""Paraboloid dish z = r^2 / (4 focus), opening toward +z: the port's
`optical_elements(n_segments, n_radial).parabolic_mirror(focus, diameter)`
mesh."""

import numpy as np

from perfcells.scenes._revolve import revolve


def build(focus, diameter, n_segments, n_radial, center=(0.0, 0.0, 0.0)):
    r = np.linspace(diameter / 2.0, 0.0, n_radial + 1)
    return revolve(np.stack([r, r * r / (4.0 * focus)], axis=1), n_segments,
                   center)
