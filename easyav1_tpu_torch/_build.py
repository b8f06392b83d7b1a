"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library `_build/<name>.so` with a plain C interface, loaded with
ctypes.  Nothing builds on import: `load(name)` builds its source at
first use and rebuilds a library older than its source.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str) -> Path:
    """`_build/<name>.so`, compiled from `csrc/<name>.cu` unless it is
    newer than its source.  Raises with the compiler's output on
    failure."""
    src, so = CSRC / f"{name}.cu", BUILD / f"{name}.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    BUILD.mkdir(exist_ok=True)
    tmp = BUILD / f"{name}.{os.getpid()}.tmp.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n"
                           f"{r.stdout}{r.stderr}")
    # atomic: a concurrent loader sees the old library or the new
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
