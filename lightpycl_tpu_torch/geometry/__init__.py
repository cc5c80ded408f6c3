from lightpycl_tpu_torch.geometry.mesh import (GeoObject, instance_grid,
                                               instances, merge,
                                               rotation_matrix)
from lightpycl_tpu_torch.geometry.primitives import (OpticalElements,
                                                     optical_elements)

__all__ = ["GeoObject", "OpticalElements", "optical_elements", "merge",
           "instances", "instance_grid", "rotation_matrix"]
