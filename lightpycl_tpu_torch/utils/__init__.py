"""Logging and profiling helpers. Port counterpart of lightpycl_tpu/utils."""

from lightpycl_tpu_torch.utils.logging_util import setup_logging
from lightpycl_tpu_torch.utils.profiling import Timer, trace_profile

__all__ = ["setup_logging", "Timer", "trace_profile"]
