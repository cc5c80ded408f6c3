"""Reference-named module alias (upstream: geo_optical_elements.py). Port
counterpart of lightpycl_tpu/geo_optical_elements.py.

Lets reference example scripts port by changing only the import root:

    from lightpycl_tpu_torch.geo_optical_elements import (optical_elements,
                                                          GeoObject)
"""

from lightpycl_tpu_torch.geometry.mesh import (GeoObject, instance_grid,
                                               instances, merge,
                                               rotation_matrix)
from lightpycl_tpu_torch.geometry.primitives import (OpticalElements,
                                                     optical_elements)
from lightpycl_tpu_torch.materials import Material

__all__ = ["GeoObject", "OpticalElements", "optical_elements", "merge",
           "instances", "instance_grid", "rotation_matrix", "Material"]
