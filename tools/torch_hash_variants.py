"""Time the port's frame hash kernel against variants of its design on
one NVIDIA GPU, each variant built and run alone in its own process, in
turns (shipped, variants, variants reversed, shipped, ...).

    python3 tools/torch_hash_variants.py [ROUNDS [VARIANT ...]]

Variants of easyav1_tpu_torch/csrc/frame_hash.cu, by its design
switches: the row segment a warp takes (HASH_SEG_BYTES: 1024 and 4096
bytes in place of 2048, so two or eight 16-byte loads a lane in flight
in place of four) and the fixed grid (HASH_CTAS_PER_SM: 1, 3 and 4 CTAs
an SM in place of 2).

Each run holds the kernel against `frame_hash_plain` on seeded planes
and prints its time (CUDA events, 50 launches back to back behind a
device hold, as `chip_smoke.cuda_ms` times them, each with the
wrapper's 32-byte zero fill) on a 1080p 4:2:0 frame of uint8 samples
(3.11 MB) and a 4K 4:2:0 frame of 10-bit uint16 samples (24.88 MB).
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VARIANTS = {
    "shipped": [],
    "seg_1k": ["-DHASH_SEG_BYTES=1024"],
    "seg_4k": ["-DHASH_SEG_BYTES=4096"],
    "ctas_1": ["-DHASH_CTAS_PER_SM=1"],
    "ctas_3": ["-DHASH_CTAS_PER_SM=3"],
    "ctas_4": ["-DHASH_CTAS_PER_SM=4"],
}
FRAMES = {"1080p uint8": ((1080, 1920), np.uint8, 256),
          "4K 10-bit uint16": ((2160, 3840), np.uint16, 1024)}


def run_variant(name):
    import torch

    from easyav1_tpu_torch import _build
    from easyav1_tpu_torch.video.av1.recon import resident

    flags = VARIANTS[name]
    _build.BUILD.mkdir(exist_ok=True)
    out = _build.BUILD / f"frame_hash_{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                        str(out), str(_build.CSRC / "frame_hash.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in r.stderr.splitlines() if "Used" in ln]
    lib = ctypes.CDLL(str(out))
    lib.frame_hash_launch.restype = ctypes.c_int
    vp = ctypes.c_void_p
    lib.frame_hash_launch.argtypes = [ctypes.c_int, vp, vp, vp, vp,
                                      ctypes.c_int, vp, vp]
    resident._lib = lambda: lib
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    times = []
    for what, ((h, w), dt, top) in FRAMES.items():
        planes = [torch.from_numpy(rng.integers(0, top, d).astype(dt)).to(dev)
                  for d in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        got = resident.hash_value(resident.frame_hash_device(planes))
        want = resident.hash_value(resident.frame_hash_plain(planes))
        if got != want:
            sys.exit(f"{name} {what}: kernel {got:#x}, plain {want:#x}")
        resident.frame_hash_device(planes)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(50):
            resident.frame_hash_device(planes)
        end.record()
        torch.cuda.synchronize()
        times.append(f"{what} {start.elapsed_time(end) / 50:.5f} ms")
    print(f"{name}: " + ", ".join(times) + f" ({'; '.join(regs)})",
          flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] in VARIANTS:
        run_variant(sys.argv[1])
        return
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    chosen = [v for v in sys.argv[2:] or VARIANTS if v != "shipped"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    order = []
    for k in range(rounds):
        order += ["shipped"] + (chosen if k % 2 == 0 else chosen[::-1])
    order.append("shipped")
    for name in order:
        r = subprocess.run([sys.executable, __file__, name])
        if r.returncode:
            sys.exit(f"variant {name} failed")


if __name__ == "__main__":
    main()
