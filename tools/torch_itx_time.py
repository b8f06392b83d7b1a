"""Time the device residual composer on the card on seeded random
transform programs, against its plain version.

    python3 tools/torch_itx_time.py

Builds easyav1_tpu_torch/csrc/itx.cu (printing ptxas's report), then for
each program of PROGRAMS (`unit_programs.random_tx_program`: every legal
(tx_size, tx_type) pair tiled over a block of its own, the rest random)
holds `itx_torch.compose_residual` against `compose_residual_plain` on
the card, tolerance 0, and prints the kernel's mean time over 10 calls
(CUDA events, back to back behind a device hold) and the plain
version's time (host clock, synchronised).  Needs a CUDA device.
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from easyav1_tpu_torch import _build  # noqa: E402
from easyav1_tpu_torch.unit_programs import random_tx_program  # noqa: E402
from easyav1_tpu_torch.video.av1.recon import itx_torch  # noqa: E402

C420 = [(1080, 1920), (540, 960), (540, 960)]
# (seed, plane dims, bit depth)
PROGRAMS = [(1, C420, 8), (2, [(719, 1277)] * 3, 10),
            (3, [(719, 1277)] * 3, 12), (4, C420, 12)]


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_itx_time: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    _build.build("itx")
    print(f"nvcc itx {time.perf_counter() - t0:.1f} s")
    print((_build.BUILD / "itx.log").read_text())
    dev = torch.device("cuda", 0)
    worst = 0
    for seed, dims, bd in PROGRAMS:
        p = random_tx_program(seed, dims, bd)
        txs = torch.from_numpy(p["txs"]).to(dev)
        co = torch.from_numpy(p["coeffs"]).to(dev)
        got = itx_torch.compose_residual(txs, co, dims, bd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = itx_torch.compose_residual_plain(txs, co, dims, bd, dev)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(10):
            itx_torch.compose_residual(txs, co, dims, bd)
        end.record()
        torch.cuda.synchronize()
        pairs = len(set(map(tuple, p["txs"][:, 3:5].tolist())))
        print(f"seed {seed} {dims[0]} x{len(dims)} {bd}-bit: "
              f"{txs.shape[0]} transforms, {pairs} pairs, max_abs_err {err}, "
              f"kernel {start.elapsed_time(end) / 10:.4f} ms, plain "
              f"{plain_ms:.1f} ms", flush=True)
        worst = max(worst, err)
    if worst:
        sys.exit(f"the kernel differs from the plain version by {worst}")


if __name__ == "__main__":
    main()
