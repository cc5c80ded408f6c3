"""Build and load the port's CUDA kernels.

Each kernel source in `csrc/` is compiled with nvcc into a shared library
with a plain C interface, loaded with ctypes. The build runs at first use,
from the package's own sources only, into `lightpycl_tpu_torch/build/`
(listed in .gitignore); the library's file name carries a hash of the
source and the flags, so an edited source or flag rebuilds and an unchanged
one is reused. Nothing here runs at import time.

Flags: sm_90a (Hopper), no --use_fast_math (IEEE division), and
-fmad=false, so each * and + stays a separately rounded operation and the
kernel matches its plain torch version bit for bit. -Xptxas -v reports
each kernel's registers, shared memory and spills; the report is kept
beside the library (`ptxas_report`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch itself would build against."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc): the "
                           "port's kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_command(source: str, defines: dict, out: Path,
                  nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that builds csrc/`source` into `out`."""
    defs = [f"-D{k}={v}" for k, v in sorted(defines.items())]
    return ([nvcc] + ARCH_FLAGS + BASE_FLAGS + defs
            + ["-o", str(out), str(CSRC_DIR / source)])


def library_path(source: str, defines: dict) -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    h.update(" ".join(build_command(source, defines, Path("x"))).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def load(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build csrc/`source` (once per source, flags and process) and load
    it. `defines` is a tuple of (name, value) pairs passed as -D flags."""
    defines = dict(defines)
    lib = library_path(source, defines)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = build_command(source, defines, tmp, nvcc=nvcc_path())
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        lib.with_suffix(".ptxas").write_text(proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half
    return ctypes.CDLL(str(lib))


def ptxas_report(source: str, defines: tuple = ()) -> list[str]:
    """The -Xptxas -v report (nvcc's stderr) of csrc/`source`'s build at
    these defines, as lines (builds it first if needed)."""
    load(source, defines)
    path = library_path(source, dict(defines)).with_suffix(".ptxas")
    return path.read_text().splitlines()
