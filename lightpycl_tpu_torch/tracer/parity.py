"""The scenes that hold a trace to the float64 oracle (tracer/oracle.py):
BASELINE configs 1-3 in tests/test_parity_oracle.py's scene family, at a
ray count the caller chooses. The CPU tests (tests/test_torch_oracle.py)
and chip_smoke.py's parity phase both build them here.
"""

from __future__ import annotations

from lightpycl_tpu_torch.geometry.primitives import optical_elements
from lightpycl_tpu_torch.sources import CollimatedSource, light_source

PARITY = 1e-3  # 0.1 % of the oracle's detected power
CONFIGS = (1, 2, 3)


def parity_config(k: int, ray_count: int):
    """(elements, source, trace iterations, slots a source ray) of config
    k: 1 a parabolic collimator under a dome, 2 a plano-convex lens onto
    a detector disc, 3 two biconvex lenses in a detecting sphere (ray
    splitting)."""
    oe = optical_elements(n_segments=32, n_radial=12)
    if k == 1:
        return ([oe.parabolic_mirror(focus=0.5, diameter=2.0,
                                     reflectivity=0.92),
                 oe.hemisphere(radius=15.0, name="dome")],
                light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                             power=1.0, ray_count=ray_count, seed=21), 4, 1)
    if k == 2:
        return ([oe.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1,
                                      ior=1.5),
                 oe.disc(radius=1.0, center=(0, 0, 1.1), material="measure"),
                 oe.sphere(radius=8.0, material="terminator",
                           name="enclosure")],
                CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                                 diameter=0.3, ray_count=ray_count, power=1.0,
                                 seed=22), 5, 8)
    if k == 3:
        return ([oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5),
                 oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate(
                     (0, 0, 0.5)),
                 oe.sphere(radius=6.0, material="measure", name="enclosure")],
                CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                                 diameter=0.5, ray_count=ray_count, power=1.0,
                                 seed=23), 5, 32)
    raise ValueError(f"parity configs are {CONFIGS}, not {k}")
