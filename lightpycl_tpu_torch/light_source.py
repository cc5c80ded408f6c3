"""Reference-named module alias (upstream: light_source.py). Port
counterpart of lightpycl_tpu/light_source.py.

    from lightpycl_tpu_torch.light_source import light_source
"""

from lightpycl_tpu_torch.sources import (
    CollimatedSource,
    LightSource,
    lambertian,
    light_source,
)

__all__ = ["light_source", "LightSource", "CollimatedSource", "lambertian"]
