"""Time the port's strip kernel against variants of its own source on
one NVIDIA GPU, each variant built and run alone in its own process, in
turns (shipped, variant, variant, shipped, ...).

    python3 tools/torch_strip_variants.py [ROUNDS]

Variants are text patches of easyav1_tpu_torch/csrc/intra_strip.cu:

- "decode_order" ignores each superblock's level order and runs its
  units one after another by the whole CTA, in decode order, the design
  before the level order (without the pixel tile, which only the level
  order reads): what the level order and the warps' units buy;
- "no_tile" reads a unit's edges from the plane through L2 also where
  they lie in its own superblock: what the shared pixel tile buys;
- "unstaged" turns off the shared-memory staging of each superblock's
  records and residual (RECS = 0, no residual tile), so every unit reads
  both from global memory;
- "scan_always" launches the kernel's instantiation with the intrabc
  copy and the interintra blend compiled in on every frame, where the
  shipped launcher takes it only for frames that may have them: what
  they cost an intra frame.

Each run checks the variant against the plain version on the 1080p
intra stream's key frame and against the shipped kernel on the key
frames of the 4K 8-bit, 4K 10-bit and 1080p grain streams of
tests/data/bench, and prints its time on each (CUDA events, 10
launches).
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "easyav1_tpu_torch", "csrc", "intra_strip.cu")
PATCHES = {
    "shipped": [],
    "decode_order": [("nl = __ldg(sp + 3);\n      const int y0 = r * P.sbh",
                      "nl = 0;\n      const int y0 = r * P.sbh")],
    "no_tile": [("const Tile tl = {mapped ? tile : nullptr,",
                 "const Tile tl = {nullptr,")],
    "unstaged": [("constexpr int RECS = 320;", "constexpr int RECS = 0;"),
                 ("const bool tiled = P.sbh * P.sbw <= RES_MAX;",
                  "const bool tiled = false;")],
    # the kernel with the scan's units (intrabc, interintra) compiled in
    # on every frame
    "scan_always": [("void (*kernel)(Args) = scan ? intra_wavefront_kernel<true>",
                     "void (*kernel)(Args) = true ? intra_wavefront_kernel<true>")],
}
# (tag, path, held against the plain version; else the shipped kernel)
FRAMES = [("1080p", "INTRA_1080", True), ("4K", "KEY_4K", False),
          ("4K 10-bit", "HBD_4K", False), ("1080p grain", "LR_GRAIN_1080",
                                           False)]


def run_variant(name):
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as S
    from easyav1_tpu_torch import _build

    src = open(SOURCE).read()
    for old, new in PATCHES[name]:
        assert old in src, old
        src = src.replace(old, new)
    out = os.path.join(_build.BUILD, f"variant_{name}")
    os.makedirs(_build.BUILD, exist_ok=True)
    with open(out + ".cu", "w") as f:
        f.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        out + ".so", out + ".cu"], capture_output=True,
                       text=True)
    S.check(r.returncode == 0, f"nvcc {name}: {r.stderr}")
    # the library the strip kernel's launches load, in place of the
    # shipped build: both in one process would put two CUDA runtimes in it
    _build._libs["intra_strip"] = ctypes.CDLL(out + ".so")
    dev = torch.device("cuda", 0)
    for tag, path, plain in FRAMES:
        fr = S.Frame.key_frame(getattr(S, path), dev)
        got = [p.cpu().numpy() for p in fr.run(fr.wavefront)]
        if plain:
            want = [p.cpu().numpy() for p in fr.plain()]
        else:
            # the shipped kernel's planes, kept by its first run
            keep = os.path.join(_build.BUILD, f"strip_{path}.npz")
            if name == "shipped":
                np.savez(keep, *got)
            S.check(os.path.exists(keep), "run the shipped variant first")
            want = list(np.load(keep).values())
        err = max(int(np.abs(a.astype(np.int64) - b).max())
                  for a, b in zip(got, want))
        S.check(err == 0, f"{name} {tag} max_abs_err {err}")
        ms = S.cuda_ms(lambda: fr.run(fr.wavefront), 10)
        print(f"{name} {tag} frame 0 wavefront {ms:.4f} ms "
              f"(max_abs_err 0 against the "
              f"{'plain version' if plain else 'shipped kernel'})",
              flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] in PATCHES:
        run_variant(sys.argv[1])
        return
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    others = [n for n in PATCHES if n != "shipped"]
    order = []
    for k in range(rounds):
        pair = ["shipped"] + others
        order += pair if k % 2 == 0 else pair[::-1]
    for name in order:
        r = subprocess.run([sys.executable, __file__, name],
                           capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.exit(f"variant {name} failed:\n{r.stderr[-2000:]}")


if __name__ == "__main__":
    main()
