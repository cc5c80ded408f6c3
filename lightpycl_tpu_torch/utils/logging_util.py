"""Logging setup.

Port counterpart of lightpycl_tpu/utils/logging_util.py. The reference
reports progress with bare print() (device chosen, iteration progress, ray
counts, timing); here the same information is emitted through the stdlib
logging module at INFO level under the "lightpycl_tpu_torch" logger.
"""

from __future__ import annotations

import logging


def setup_logging(level=logging.INFO):
    logger = logging.getLogger("lightpycl_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s %(name)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger
