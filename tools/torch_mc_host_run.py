"""Run the MC kernels' CUDA source on the CPU, against their plain
versions.

    python3 tools/torch_mc_host_run.py

A machine without a CUDA compiler cannot build
easyav1_tpu_torch/csrc/inter_mc.cu, but g++ can: with
tools/cuda_host_shim/cuda_runtime.h in place of the CUDA runtime, every
CUDA thread runs as an OS thread and the barriers are real, so the
kernels' index arithmetic, staging, passes and blends run as written.
Builds the source into
easyav1_tpu_torch/_build/inter_mc_host.so, runs kernels 6a and 6b
through `inter_mc.mc_launch` and `obmc_launch` on CPU tensors for
seeded random MC programs of even and odd sizes, at 8 bits (the uint8
instantiations) and at 10 and 12 bits (the uint16 ones), and holds each
plane against `mc_units_plain` and `obmc_plain`, tolerance 0.  It says nothing
about what nvcc accepts, and nothing about speed.
"""

import ctypes
import functools
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from easyav1_tpu_torch import _build, convert  # noqa: E402
from easyav1_tpu_torch.unit_programs import random_mc_program  # noqa: E402
from easyav1_tpu_torch.video.av1.recon import inter_mc  # noqa: E402

# (seed, width, height, bit depth)
PROGRAMS = [(12, 100, 76, 8), (14, 100, 76, 8), (21, 416, 240, 8),
            (5, 99, 75, 8), (7, 201, 133, 8), (12, 100, 76, 10),
            (21, 416, 240, 10), (5, 99, 75, 10), (14, 100, 76, 12),
            (7, 201, 133, 12)]


def build():
    os.makedirs(_build.BUILD, exist_ok=True)
    out = os.path.join(_build.BUILD, "inter_mc_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-I",
         os.path.join(REPO, "tools", "cuda_host_shim"), "-x", "c++",
         os.path.join(_build.CSRC, "inter_mc.cu"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    for k in inter_mc._MC + inter_mc._OBMC:
        fn = getattr(lib, k.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = k.argtypes
    return lib


def host_launch(lib, kernels, planes, resid, refs, tabs, table, bd):
    """`inter_mc._launch` on the host build, without a device or a
    stream."""
    layout = (ctypes.c_int * len(tabs["layout"]))(*tabs["layout"])
    rc = getattr(lib, kernels[bd > 8].symbol)(
        len(planes), *inter_mc._frame_args(planes, resid, refs, bd),
        tabs["buf"].data_ptr(), layout,
        convert.tables(planes[0].device)[table].data_ptr(), bd, None)
    if rc != 0:
        raise RuntimeError(f"{kernels[bd > 8].symbol} returned {rc}")


def run(prog, kernels, bd):
    """(planes after MC, planes after OBMC) of a program."""
    cpu = torch.device("cpu")
    planes = [torch.zeros(d, dtype=torch.int32) for d in prog["dims"]]
    resid = [torch.from_numpy(r) for r in prog["resid"]]
    refs = [[torch.from_numpy(r) for r in rs] for rs in prog["refs"]]
    plan = prog["plan"]
    if kernels:
        inter_mc.mc_launch(planes, resid, refs,
                           inter_mc.upload(inter_mc.mc_tables(plan), cpu), bd)
    else:
        inter_mc.mc_units_plain(planes, resid, refs, plan, bd)
    after_mc = [p.clone() for p in planes]
    if kernels:
        inter_mc.obmc_launch(planes, resid, refs, inter_mc.upload(
            inter_mc.obmc_tables(plan), cpu), bd)
    else:
        inter_mc.obmc_plain(planes, resid, refs, plan, bd)
    return after_mc, planes


def main():
    inter_mc._launch = functools.partial(host_launch, build())
    worst = 0
    for seed, width, height, bd in PROGRAMS:
        prog = random_mc_program(seed, width, height, bd=bd)
        got, want = run(prog, True, bd), run(prog, False, bd)
        errs = [max(int((a - b).abs().max()) for a, b in zip(g, w))
                for g, w in zip(got, want)]
        print(f"program seed {seed} {width}x{height} {bd}-bit: 6a max_abs_err "
              f"{errs[0]}, 6b max_abs_err {errs[1]}", flush=True)
        worst = max(worst, *errs)
    if worst:
        sys.exit(f"the kernels differ from the plain versions by {worst}")


if __name__ == "__main__":
    main()
