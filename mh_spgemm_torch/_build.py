"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/mh_spgemm_torch/``
at the root of the checkout (a directory git ignores).  The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing is built when
a module is imported: the first call that launches a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

from .errors import DeviceError

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_ROOT, "build", "mh_spgemm_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc by this process, per source (0.0 when loaded)
build_seconds: Dict[str, float] = {}
# nvcc's diagnostics of this process's builds (registers, shared memory
# and spills from -Xptxas -v), per source
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise DeviceError("nvcc not found: the CUDA kernels are built from "
                      "csrc/ at first use and need the CUDA toolkit")


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu``."""
    src = os.path.join(_PKG, "csrc", f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  Raises DeviceError with nvcc's output
    when the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        build_seconds.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(_PKG, "csrc", f"{name}.cu")
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stderr
    if proc.returncode != 0:
        raise DeviceError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                          f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per
    process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _LIBS[name] = lib
    return lib
