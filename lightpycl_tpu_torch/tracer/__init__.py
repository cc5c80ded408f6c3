from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.scene import Scene, build_scene
from lightpycl_tpu_torch.tracer.rays import RayBatch, DetectorState, Ledger
from lightpycl_tpu_torch.tracer.engine import Tracer, TraceResult

__all__ = [
    "TraceConfig",
    "Scene",
    "build_scene",
    "RayBatch",
    "DetectorState",
    "Ledger",
    "Tracer",
    "TraceResult",
]
