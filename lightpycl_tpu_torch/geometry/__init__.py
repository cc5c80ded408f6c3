from lightpycl_tpu_torch.geometry.mesh import (GeoObject, instance_grid,
                                               instances, merge,
                                               rotation_matrix)
from lightpycl_tpu_torch.geometry.primitives import (OpticalElements,
                                                     optical_elements)
from lightpycl_tpu_torch.geometry.analytic import (
    AnalyticSurface, analytic_annulus, analytic_biconvex_lens, analytic_disc,
    analytic_lens, analytic_mirror, analytic_plano_convex_lens,
    analytic_sphere, conic_surface, cylinder_surface)

__all__ = ["GeoObject", "OpticalElements", "optical_elements", "merge",
           "instances", "instance_grid", "rotation_matrix",
           "AnalyticSurface", "conic_surface", "cylinder_surface",
           "analytic_lens", "analytic_plano_convex_lens",
           "analytic_biconvex_lens", "analytic_mirror", "analytic_disc",
           "analytic_annulus", "analytic_sphere"]
