"""Run the device residual composer's CUDA source on the CPU, against
its plain version.

    python3 tools/torch_itx_host_run.py

A machine without a CUDA compiler cannot build
easyav1_tpu_torch/csrc/itx.cu, but g++ can: with
tools/cuda_host_shim/cuda_runtime.h in place of the CUDA runtime, every
CUDA thread runs as an OS thread and __syncwarp is a real barrier, so
the kernel's record checks, staging, row and column passes and cropped
stores run as written.  Builds the source into
easyav1_tpu_torch/_build/itx_host.so and runs it on seeded transform
programs (`unit_programs.random_tx_program`) at 8, 10 and 12 bits, in
4:2:0 and 4:4:4, at even and odd plane sizes, with every legal
(tx_size, tx_type) pair at each bit depth,
and a few malformed records that the kernel must skip; each plane is
held against `itx_torch.compose_residual_plain`, tolerance 0.  It says
nothing about what nvcc accepts, and nothing about speed.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from easyav1_tpu_torch import _build  # noqa: E402
from easyav1_tpu_torch.unit_programs import random_tx_program  # noqa: E402
from easyav1_tpu_torch.video.av1.recon import itx_torch  # noqa: E402

# (seed, plane dims, bit depth): the 4:2:0 ones odd-sized in luma too
PROGRAMS = [(1, [(200, 264), (100, 132), (100, 132)], 8),
            (2, [(135, 203)] * 3, 8),
            (3, [(259, 261), (130, 131), (130, 131)], 10),
            (4, [(131, 197)] * 3, 10),
            (5, [(199, 257), (100, 129), (100, 129)], 12),
            (6, [(136, 200)] * 3, 12),
            (7, [(388, 452), (194, 226), (194, 226)], 8),
            (8, [(132, 452)] * 3, 12)]
# every legal pair once, at the top left of a block of its own (4:4:4,
# odd sizes), at each bit depth
PAIR_PROGRAMS = [(10, [(445, 637)] * 3, 8), (11, [(445, 637)] * 3, 10),
                 (12, [(445, 637)] * 3, 12)]


def build():
    os.makedirs(_build.BUILD, exist_ok=True)
    out = os.path.join(_build.BUILD, "itx_host.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-I",
         os.path.join(REPO, "tools", "cuda_host_shim"), "-x", "c++",
         os.path.join(_build.CSRC, "itx.cu"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.itx_compose_launch.restype = ci
    lib.itx_compose_launch.argtypes = [cl, vp, vp, cl, ci, vp, vp, vp, ci,
                                       vp]
    return lib


def host_compose(lib, txs, coeffs, dims, bd):
    """`itx_torch.compose_residual`'s launch on CPU tensors."""
    planes = [torch.zeros(d, dtype=itx_torch.residual_dtype(bd))
              for d in dims]
    k = len(dims)
    ints = ctypes.c_int * k
    rc = lib.itx_compose_launch(
        txs.shape[0], txs.data_ptr(), coeffs.data_ptr(), coeffs.shape[0], k,
        (ctypes.c_void_p * k)(*(p.data_ptr() for p in planes)),
        ints(*(h for h, _ in dims)), ints(*(w for _, w in dims)), bd, None)
    if rc != 0:
        raise RuntimeError(f"launch returned {rc}")
    return planes


def main():
    lib = build()
    worst, pairs = 0, set()
    for seed, dims, bd in PROGRAMS + PAIR_PROGRAMS:
        prog = random_tx_program(seed, dims, bd,
                                 (seed, dims, bd) in PROGRAMS)
        txs = torch.from_numpy(prog["txs"])
        coeffs = torch.from_numpy(prog["coeffs"])
        got = host_compose(lib, txs, coeffs, dims, bd)
        want = itx_torch.compose_residual_plain(txs, coeffs, dims, bd, "cpu")
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(got, want))
        pairs |= set(map(tuple, prog["txs"][:, 3:5].tolist()))
        print(f"program seed {seed} {dims[0][1]}x{dims[0][0]} x{len(dims)} "
              f"{bd}-bit: {txs.shape[0]} transforms, max_abs_err {err}",
              flush=True)
        worst = max(worst, err)
    print(f"{len(pairs)} of {len(itx_torch.legal_pairs())} legal pairs")
    # malformed records are skipped whole: lossless, an ADST of 32, a
    # plane out of range, coefficients past the end
    prog = random_tx_program(9, [(64, 64)], 8)
    bad = prog["txs"][:4].copy()
    bad[0, itx_torch.R_LOSSLESS] = 1
    bad[1, itx_torch.R_SIZE], bad[1, itx_torch.R_TYPE] = 3, 1
    bad[2, itx_torch.R_PLANE] = 1
    bad[3, itx_torch.R_OFF] = prog["coeffs"].shape[0] - 1
    got = host_compose(lib, torch.from_numpy(bad),
                       torch.from_numpy(prog["coeffs"]), [(64, 64)], 8)
    skipped = not got[0].any()
    print(f"malformed records skipped: {skipped}")
    if worst or not skipped or len(pairs) != len(itx_torch.legal_pairs()):
        sys.exit(f"the kernel differs from the plain version by {worst}")


if __name__ == "__main__":
    main()
