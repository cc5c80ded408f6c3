"""Reference-named module alias (upstream: iterative_tracer.py). Port
counterpart of lightpycl_tpu/iterative_tracer.py.

    from lightpycl_tpu_torch.iterative_tracer import CL_Tracer
"""

from lightpycl_tpu_torch.compat import CL_Tracer
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.engine import Tracer, TraceResult

__all__ = ["CL_Tracer", "Tracer", "TraceResult", "TraceConfig"]
