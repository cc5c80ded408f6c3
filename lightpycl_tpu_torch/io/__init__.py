"""File formats. Port counterpart of lightpycl_tpu/io: so far the
checkpoint (trace_batched resume) and the LPR1 ray file; the other formats
(dxf, ies, obj, stl, zmx, seq, scene) wait for a later slice."""

from lightpycl_tpu_torch.io.checkpoint import load_state, save_state
from lightpycl_tpu_torch.io.rayfile import (RayFileData, RayFileSource,
                                            load_rayfile,
                                            save_measured_rayfile,
                                            save_rayfile)

__all__ = ["save_state", "load_state", "RayFileData", "RayFileSource",
           "load_rayfile", "save_rayfile", "save_measured_rayfile"]
