"""Dome over z >= 0: the port's `optical_elements(n_segments,
n_radial).hemisphere(radius)` mesh."""

import numpy as np

from perfcells.scenes._revolve import revolve


def build(radius, n_segments, n_radial, center=(0.0, 0.0, 0.0)):
    th = np.linspace(np.pi / 2.0, 0.0, n_radial + 1)
    return revolve(np.stack([radius * np.sin(th), radius * np.cos(th)], 1),
                   n_segments, center)
