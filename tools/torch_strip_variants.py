"""Time the port's strip kernel against variants of its own source on
one NVIDIA GPU, each variant built and run alone in its own process, in
turns (shipped, variant, variant, shipped, ...).

    python3 tools/torch_strip_variants.py [ROUNDS]

Variants are text patches of easyav1_tpu_torch/csrc/intra_strip.cu:

- "unstaged" turns off the shared-memory staging of each superblock's
  records and residual (RECS = 0, RES_MAX = 1), so every unit reads both
  from global memory;
- "edge_tile" also keeps the superblock's reconstructed pixels in a
  shared-memory tile (zeroed at its start, written beside the plane)
  and reads a unit's edges from it where they lie in its own superblock;
- "scan_always" launches the kernel's instantiation with the intrabc
  copy and the interintra blend compiled in on every frame, where the
  shipped launcher takes it only for frames that may have them: what
  they cost an intra frame.

Each run checks the variant against the plain version on the 1080p and
4K key frames of tests/data/bench and prints its wavefront time there
(CUDA events, 20 launches).
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "easyav1_tpu_torch", "csrc", "intra_strip.cu")
EDGE_TILE = [
    ("constexpr int DYN_BYTES = 2 * (RECS * NF * 4 + RES_MAX * 2);",
     "constexpr int DYN_BYTES = 2 * (RECS * NF * 4 + RES_MAX * 2)"
     " + RES_MAX * 4;"),
    ("const int* f, const int16_t* res,\n"
     "                                         int y0, int x0, Smem& sm) {",
     "const int* f, const int16_t* res, int* tile,\n"
     "                                         int y0, int x0, Smem& sm) {"),
    ("  const int lw = a.p[0].pw;\n",
     "  const int lw = a.p[0].pw;\n"
     "  auto px = [&](int yy, int xx) {\n"
     "    const unsigned ty = yy - y0, tx = xx - x0;\n"
     "    return tile && ty < unsigned(P.sbh) && tx < unsigned(P.sbw)\n"
     "               ? tile[ty * P.sbw + tx] : __ldcg(buf + yy * pw + xx);\n"
     "  };\n"),
    ("corner = __ldcg(buf + (y - 1) * pw + x - 1);", "corner = px(y - 1, x - 1);"),
    ("corner = __ldcg(buf + (y - 1) * pw + x);", "corner = px(y - 1, x);"),
    ("corner = __ldcg(buf + y * pw + x - 1);", "corner = px(y, x - 1);"),
    ("hl ? __ldcg(buf + y * pw + x - 1) : base - 1", "hl ? px(y, x - 1) : base - 1"),
    ("ha ? __ldcg(buf + (y - 1) * pw + x) : base + 1", "ha ? px(y - 1, x) : base + 1"),
    (": __ldcg(buf + (y - 1) * pw + min(x + min(i - OFF, na - 1), pw - 1));",
     ": px(y - 1, min(x + min(i - OFF, na - 1), pw - 1));"),
    (": __ldcg(buf + min(y + min(i - OFF, nl - 1), ph - 1) * pw + x - 1);",
     ": px(min(y + min(i - OFF, nl - 1), ph - 1), x - 1);"),
    ("    const int rv = res ? res[(y + i - y0) * P.sbw + x + j - x0] : P.resid[o];\n"
     "    buf[o] = clampi(p + rv, 0, mx);",
     "    const int k_t = (y + i - y0) * P.sbw + x + j - x0;\n"
     "    const int v = clampi(p + (res ? res[k_t] : P.resid[o]), 0, mx);\n"
     "    buf[o] = v;\n"
     "    if (tile) tile[k_t] = v;"),
    ("  int16_t* const ress = reinterpret_cast<int16_t*>(recs + 2 * RECS * NF);",
     "  int16_t* const ress = reinterpret_cast<int16_t*>(recs + 2 * RECS * NF);\n"
     "  int* const tiles = reinterpret_cast<int*>(ress + 2 * RES_MAX);"),
    ("      const int16_t* res = tiled ? ress + b * RES_MAX : nullptr;",
     "      const int16_t* res = tiled ? ress + b * RES_MAX : nullptr;\n"
     "      int* const tile = tiled ? tiles : nullptr;\n"
     "      if (tiled) {\n"
     "        for (int k = t; k < P.sbh * P.sbw; k += THREADS) tiles[k] = 0;\n"
     "        __syncthreads();\n"
     "      }"),
    ("                 res, r * P.sbh, c * P.sbw, sm);",
     "                 res, tile, r * P.sbh, c * P.sbw, sm);"),
]
PATCHES = {
    "shipped": [],
    # the kernel with the scan's units (intrabc, interintra) compiled in
    # on every frame
    "scan_always": [("void (*kernel)(Args) = scan ? intra_wavefront_kernel<true>",
                     "void (*kernel)(Args) = true ? intra_wavefront_kernel<true>")],
    "unstaged": [("constexpr int RECS = 64;", "constexpr int RECS = 0;"),
                 ("constexpr int RES_MAX = 128 * 128;",
                  "constexpr int RES_MAX = 1;")],
    "edge_tile": EDGE_TILE,
}


def run_variant(name):
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as S
    from easyav1_tpu_torch import _build
    from easyav1_tpu_torch.video.av1.recon import intra_strip

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
    lib = ctypes.CDLL(out + ".so")
    fn = lib.intra_strip_frame_launch
    # set by hand: loading the shipped build too would put two CUDA
    # runtimes in one process
    fn.argtypes = intra_strip.ARGTYPES
    fn.restype = ctypes.c_int
    intra_strip._lib = lambda: lib
    dev = torch.device("cuda", 0)
    for tag, path in (("1080p", S.INTRA_1080), ("4K", S.KEY_4K)):
        fr = S.Frame.key_frame(path, dev)
        err = S.max_err(fr.run(fr.wavefront), fr.plain())
        S.check(err == 0, f"{name} {tag} max_abs_err {err}")
        ms = S.cuda_ms(lambda: fr.run(fr.wavefront), 20)
        print(f"{name} {tag} frame 0 wavefront {ms:.4f} ms "
              f"(max_abs_err 0)", flush=True)


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
