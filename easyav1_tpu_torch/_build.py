"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library `_build/<name>.so` with a plain C interface, loaded with
ctypes.  Nothing builds on import: `load(name)` builds its source at
first use and rebuilds a library older than its source.  The compiler's
output, with ptxas's registers, shared memory and spills per kernel, is
kept in `_build/<name>.log`.

`Kernel` declares one launch function of such a library, once: the
wrappers under `video/av1/recon/` launch their kernels through it, on
the device's current stream, and it counts each launch that succeeds in
`trace.counters()` as "launches.<kernel>".  `on_card` is the wrappers'
dispatch between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

from easyav1_tpu_torch import trace

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

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
    (BUILD / f"{name}.log").write_text(r.stdout + r.stderr)
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


class Kernel:
    """A hand kernel's C launch function: `symbol` of the library of
    `csrc/<lib>.cu`, taking `argtypes` and then the stream, returning a
    cudaError_t.  Its launches count as "launches.<counter>", the
    kernel's name in the profiler."""

    def __init__(self, lib: str, symbol: str, argtypes: Sequence,
                 counter: str):
        self.lib, self.symbol = lib, symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self.counter = f"launches.{counter}"
        self._fn = None
        trace.count(self.counter, 0)

    def launch(self, device, *args) -> None:
        """Calls the function with `args` and `device`'s current stream,
        loading (and building) its library at first use; raises if the
        call returns an error."""
        fn = self._fn
        if fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: cudaError {rc}")
        trace.count(self.counter)


def on_card(t: torch.Tensor, tensors: Sequence[torch.Tensor] = ()) -> bool:
    """A wrapper's dispatch: False for a CPU tensor `t` (the plain version
    runs); True for a CUDA one, with `tensors` all contiguous on its device
    (the kernel launches); others raise."""
    dev = t.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(x.device != dev or not x.is_contiguous() for x in tensors):
        raise ValueError(f"want contiguous tensors on {dev}")
    return True
