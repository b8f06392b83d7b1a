"""The port's C ABI: the counterpart of `easyav1_tpu/capi/`.

`easyav1.h` is the public header, binary-compatible with the JAX
package's; `easyav1_capi.c` implements it by embedding CPython and
calling `bridge.py`, which runs the port's `EasyAV1` (on the card unless
the environment asks otherwise: see `bridge.py`); `capi_smoke.c` is a
client of it.  `build()` compiles them with gcc at first use into
`easyav1_tpu_torch/_build/`: the shared library `libeasyav1_torch.so`,
which a C program links against, and the client `capi_smoke`, linked
against that library.  Nothing builds on import.

A C program builds against the library as the client does:

    gcc -I easyav1_tpu_torch/capi prog.c -L easyav1_tpu_torch/_build \\
        -leasyav1_torch -Wl,-rpath,<the absolute path of _build>
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sysconfig
from pathlib import Path
from typing import Tuple

CAPI = Path(__file__).resolve().parent
BUILD = CAPI.parent / "_build"
LIB = BUILD / "libeasyav1_torch.so"
CLIENT = BUILD / "capi_smoke"


def python_flags():
    """gcc's flags to compile and link against this interpreter's
    libpython (`tests/test_capi.py::_build_smoke`'s)."""
    libdir = sysconfig.get_config_var("LIBDIR")
    return [f"-I{sysconfig.get_paths()['include']}", f"-L{libdir}",
            f"-lpython{sysconfig.get_config_var('LDVERSION')}",
            f"-Wl,-rpath,{libdir}", "-lm", "-lpthread", "-ldl", "-lutil"]


def _stale(target: Path, deps) -> bool:
    return not target.exists() or any(
        target.stat().st_mtime < d.stat().st_mtime for d in deps)


def _gcc(target: Path, args) -> None:
    """Compile to a temporary file, then rename it over `target`: a
    concurrent loader sees the old file or the whole new one."""
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    r = subprocess.run(["gcc", "-O2", "-o", str(tmp), *args],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"gcc failed building {target.name}:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, target)


def build() -> Tuple[Path, Path]:
    """(the shared library, the client), each compiled unless it is newer
    than its sources, under a file lock.  Raises with gcc's output on
    failure."""
    header = CAPI / "easyav1.h"
    shim, client = CAPI / "easyav1_capi.c", CAPI / "capi_smoke.c"
    if not (_stale(LIB, (shim, header))
            or _stale(CLIENT, (client, header, LIB))):
        return LIB, CLIENT
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / "capi.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(LIB, (shim, header)):
            _gcc(LIB, ["-shared", "-fPIC", str(shim), *python_flags()])
        if _stale(CLIENT, (client, header, LIB)):
            _gcc(CLIENT, [str(client), f"-I{CAPI}", f"-L{BUILD}",
                          "-leasyav1_torch", "-Wl,-rpath,$ORIGIN"])
    return LIB, CLIENT
