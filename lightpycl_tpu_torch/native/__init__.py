"""Native (C++) helpers, loaded via ctypes.

Port counterpart of lightpycl_tpu/native: the float64 Möller–Trumbore core
of the parity oracle (oracle.cpp, a copy of the reference's). It is a CPU
helper, not a device kernel. The shared library is built on first use with
g++ into the git-ignored `lightpycl_tpu_torch/build/`, its file name keyed
by a hash of the source, the command and the host's CPU (as ops/_build.py
names the CUDA kernels' libraries), and exposed through a C ABI. Without a
compiler `get_lib()` is None and the oracle takes its numpy path
(`backend()` says which).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("lightpycl_tpu_torch.native")

_SRC = Path(__file__).resolve().parent / "oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False


def _host_cpu() -> str:
    """The CPU that -march=native compiles for (model and feature flags), so
    a library built on one host is never loaded on another."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + platform.processor()


def library_path() -> Path:
    """Where the library of this source, these flags and this host's CPU
    lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(["g++"] + _FLAGS).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"oracle-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++"] + _FLAGS + ["-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.info("native oracle build failed (numpy fallback): %s", e)
        return False
    os.replace(tmp, lib)  # atomic: concurrent builders never see half
    return True


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.info("native oracle load failed: %s", e)
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.mt_nearest_hit.argtypes = [
            dp, dp, ctypes.c_int64, dp, dp, dp, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, dp, ip,
        ]
        lib.mt_nearest_hit.restype = None
        _lib = lib
        return _lib


def backend() -> str:
    """'native' when the oracle's nearest hit runs the C++ core, else
    'numpy'."""
    return "native" if get_lib() is not None else "numpy"


def mt_nearest_hit_native(o, d, v0, e1, e2, eps, eps_b, t_max):
    """C++ f64 nearest hit; returns (t, idx) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    o = np.ascontiguousarray(o, np.float64)
    d = np.ascontiguousarray(d, np.float64)
    v0 = np.ascontiguousarray(v0, np.float64)
    e1 = np.ascontiguousarray(e1, np.float64)
    e2 = np.ascontiguousarray(e2, np.float64)
    n, m = len(o), len(v0)
    t = np.empty(n, np.float64)
    idx = np.empty(n, np.int64)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.mt_nearest_hit(
        o.ctypes.data_as(dp), d.ctypes.data_as(dp), n,
        v0.ctypes.data_as(dp), e1.ctypes.data_as(dp), e2.ctypes.data_as(dp), m,
        float(eps), float(eps_b), float(t_max),
        t.ctypes.data_as(dp), idx.ctypes.data_as(ip),
    )
    return t, idx
