"""Time the port's MC kernels 6a and 6b against variants of their design
on one NVIDIA GPU, each variant built and run alone in its own process,
in turns (shipped, variants, variants reversed, shipped, ...).

    python3 tools/torch_mc_variants.py [ROUNDS [VARIANT ...]]

Variants of easyav1_tpu_torch/csrc/inter_mc.cu, by its design switches:

- "sync_stage" (MC_ASYNC=0): a warp stages its tile's windows, waits,
  then computes; nothing of the next tile is on its way;
- "byte_loads" (MC_WIDE=0): every window is staged byte by byte through
  the clamped path, none in aligned 4-byte pieces;
- "all_taps" (MC_LIVE=0): the whole (h + 7) x (w + 7) window is staged
  and both passes run all 8 taps, whatever the filter;
- "warp_a_cta" (MC_WARPS=1, MC_CTAS_PER_SM=24): one warp a CTA, so no
  tiles share a CTA's shared memory and set-up;
- "ctas_2", "ctas_4" (MC_CTAS_PER_SM): the grid at two and four CTAs an
  SM in place of three, with 128 and 64 registers a thread in place of
  85;

and "first", the first design of both kernels (tools/torch_mc_first.cu
with the host tile tables it needs, below): one CTA of 256 threads a
16x16 tile from a per-tile table, int windows, phases parted by
barriers, 6b as three launches.

Each run holds 6a against the plain version on a 1080p inter frame of
tests/data/bench and 6a and 6b on a seeded random 1080p MC program
(tolerance 0), and prints the times of 6a on the 1080p and a 4K inter
frame and of 6b on the random program (CUDA events, 20 launches).
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "easyav1_tpu_torch", "csrc", "inter_mc.cu")
FIRST = os.path.join(REPO, "tools", "torch_mc_first.cu")
VARIANTS = {
    "shipped": [],
    "sync_stage": ["-DMC_ASYNC=0"],
    "byte_loads": ["-DMC_WIDE=0"],
    "all_taps": ["-DMC_LIVE=0"],
    "warp_a_cta": ["-DMC_WARPS=1", "-DMC_CTAS_PER_SM=24"],
    "ctas_2": ["-DMC_CTAS_PER_SM=2"],
    "ctas_4": ["-DMC_CTAS_PER_SM=4"],
    "first": None,
}

# ------------------------------------------ the first design's host side
NT = 8           # tile record: kind, plane, unit, w, h, ox, oy, mask offset
TILE = 16


def first_tiles(kind, plane, w, h, n, first, moff=0):
    """Tile records [k n, NT] of n units of one (w, h) bucket whose rows
    start at `first`: each unit cut into TILE x TILE tiles."""
    ny, nx = -(-h // TILE), -(-w // TILE)
    t = np.empty((n * ny * nx, NT), np.int32)
    t[:, 0] = kind
    t[:, 1] = plane
    t[:, 2] = np.repeat(np.arange(first, first + n), ny * nx)
    t[:, 3] = w
    t[:, 4] = h
    t[:, 5] = np.tile(np.arange(nx) * TILE, n * ny)
    t[:, 6] = np.tile(np.repeat(np.arange(ny) * TILE, nx), n)
    t[:, 7] = moff
    return t


def first_table(buckets, kind, width, tiles, stacks=None, masks=None):
    """The units of `buckets`, concatenated in sorted order, their tiles
    appended to `tiles`, a pair bucket's int32 mask stack to `masks`."""
    rows, first = [], 0
    for key in sorted(buckets):
        f = buckets[key]
        p, w, h = key if isinstance(key, tuple) else (key, 8, 8)
        moff = 0
        if masks is not None:
            moff = sum(m.size for m in masks)
            masks.append(np.ascontiguousarray(
                stacks.get(key, np.zeros((1, h, w))), np.int32).ravel())
        tiles.append(first_tiles(kind, p, w, h, f.shape[0], first, moff))
        rows.append(np.asarray(f, np.int32).reshape(-1, width))
        first += f.shape[0]
    return np.concatenate(rows) if rows else np.zeros((0, width), np.int32)


def first_mc_tables(plan, dev):
    import torch
    from easyav1_tpu_torch.video.av1.recon.mc_plan import NPR, NS, NW
    tiles, masks = [], []
    out = {"singles": first_table(plan["singles"], 0, NS, tiles),
           "pairs": first_table(plan["pairs"], 1, NPR, tiles,
                                plan["pair_masks"], masks),
           "warps": first_table(plan["warps"], 2, NW, tiles)}
    out["tiles"] = np.concatenate(tiles)
    out["masks"] = np.concatenate(masks) if masks else np.zeros(1, np.int32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in out.items()}


def first_obmc_tables(plan, dev):
    import torch
    from easyav1_tpu_torch.video.av1.recon.mc_plan import NS
    out = []
    for k, name, width in ((0, "obmc_above", NS), (1, "obmc_left", NS),
                           (2, "obmc_resid", 2)):
        if plan[name]:
            tiles = []
            units = first_table(plan[name], 4 if k == 2 else 3, width, tiles)
            out.append((k, torch.from_numpy(np.concatenate(tiles)).to(dev),
                        torch.from_numpy(units).to(dev)))
    return out


def first_launchers(lib):
    """(mc, obmc) closures over the first design's C interface, with
    `inter_mc.mc_launch`'s and `obmc_launch`'s arguments."""
    import torch
    from easyav1_tpu_torch import convert
    from easyav1_tpu_torch.video.av1.recon import inter_mc

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.inter_mc_launch.restype = lib.obmc_launch.restype = ci
    lib.inter_mc_launch.argtypes = [ci, *[vp] * 7, vp, ci, vp, vp, vp, vp, vp,
                                    ci, vp]
    lib.obmc_launch.argtypes = [ci, ci, *[vp] * 7, vp, ci, vp, vp, ci, vp]

    def stream(dev):
        return torch.cuda.current_stream(dev).cuda_stream

    def mc(planes, resid, refs, tabs, bd):
        dev = planes[0].device
        rc = lib.inter_mc_launch(
            len(planes), *inter_mc._frame_args(planes, resid, refs, 8),
            tabs["tiles"].data_ptr(), tabs["tiles"].shape[0],
            tabs["singles"].data_ptr(), tabs["pairs"].data_ptr(),
            tabs["warps"].data_ptr(), tabs["masks"].data_ptr(),
            convert.tables(dev)["warped_filter"].data_ptr(), bd, stream(dev))
        assert rc == 0, rc
        return planes

    def obmc(planes, resid, refs, passes, bd):
        dev = planes[0].device
        for k, tiles, units in passes:
            rc = lib.obmc_launch(
                k, len(planes), *inter_mc._frame_args(planes, resid, refs, 8),
                tiles.data_ptr(), tiles.shape[0], units.data_ptr(),
                convert.tables(dev)["obmc_masks"].data_ptr(), bd, stream(dev))
            assert rc == 0, rc
        return planes

    return mc, obmc


# ------------------------------------------------------------- one variant

def run_variant(name):
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as S
    from easyav1_tpu_torch import _build
    from easyav1_tpu_torch.unit_programs import random_mc_program
    from easyav1_tpu_torch.video.av1.recon import inter_mc

    flags = VARIANTS[name]
    out = os.path.join(_build.BUILD, f"variant_mc_{name}.so")
    os.makedirs(_build.BUILD, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *(flags or []),
                        "-o", out, FIRST if flags is None else SOURCE],
                       capture_output=True, text=True)
    S.check(r.returncode == 0, f"nvcc {name}: {r.stderr}")
    lib = ctypes.CDLL(out)
    dev = torch.device("cuda", 0)
    if flags is None:
        # the port's own wrappers go through this build too, so that the
        # captures below load no second build of the kernels
        mc, obmc = first_launchers(lib)
        mc_tabs = lambda plan: first_mc_tables(plan, dev)
        obmc_tabs = lambda plan: first_obmc_tables(plan, dev)
        inter_mc.mc_units = lambda planes, resid, refs, plan, bd: (
            mc(planes, resid, refs, mc_tabs(plan), bd)
            if any(plan[k] for k in ("singles", "pairs", "warps"))
            else planes)
        inter_mc.obmc = lambda planes, resid, refs, plan, bd: obmc(
            planes, resid, refs, obmc_tabs(plan), bd)
    else:
        inter_mc._lib = lambda: lib
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in inter_mc.LAUNCHES:
            getattr(lib, name).restype = ci
            getattr(lib, name).argtypes = [ci, *[vp] * 7, vp, vp, vp, ci, vp]
        mc, obmc = inter_mc.mc_launch, inter_mc.obmc_launch
        mc_tabs = lambda plan: inter_mc.upload(inter_mc.mc_tables(plan), dev)
        obmc_tabs = lambda plan: inter_mc.upload(inter_mc.obmc_tables(plan),
                                                 dev)

    caps = {"1080p": S.capture_inter(S.INTER_1080, 2, dev),
            "4K": S.capture_inter(S.KEY_4K, 2, dev)}
    prog = random_mc_program(S.MC_PROGRAMS[2][0], 1920, 1080)
    resid, refs = S.mc_inputs(prog, dev)
    cases = [(tag, c["dims"], c["resid"], c["refs"], c["plan"])
             for tag, c in caps.items()]
    cases.append(("random", prog["dims"], resid, refs, prog["plan"]))
    line = []
    for tag, dims, res, rf, plan in cases:
        tabs = mc_tabs(plan)
        if tag != "4K":
            err = S.max_err(
                mc(S.zero_planes(dims, dev), res, rf, tabs, 8),
                inter_mc.mc_units_plain(S.zero_planes(dims, dev), res, rf,
                                        plan, 8))
            S.check(err == 0, f"{name} 6a {tag} max_abs_err {err}")
        planes = S.zero_planes(dims, dev)
        ms = S.cuda_ms(lambda: mc(planes, res, rf, tabs, 8), 20)
        line.append(f"6a {tag} {ms:.4f} ms")
    base = inter_mc.mc_units_plain(S.zero_planes(prog["dims"], dev), resid,
                                   refs, prog["plan"], 8)
    tabs = obmc_tabs(prog["plan"])
    err = S.max_err(
        obmc([b.clone() for b in base], resid, refs, tabs, 8),
        inter_mc.obmc_plain([b.clone() for b in base], resid, refs,
                            prog["plan"], 8))
    S.check(err == 0, f"{name} 6b max_abs_err {err}")
    ms = S.cuda_ms(lambda: obmc(base, resid, refs, tabs, 8), 20)
    line.append(f"6b random {ms:.4f} ms")
    print(f"{name}: " + ", ".join(line) + " (all max_abs_err 0)", flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] in VARIANTS:
        run_variant(sys.argv[1])
        return
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    chosen = sys.argv[2:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    others = [n for n in chosen if n != "shipped"]
    order = []
    for k in range(rounds):
        turn = ["shipped"] + others
        order += turn if k % 2 == 0 else turn[::-1]
    for name in order:
        r = subprocess.run([sys.executable, __file__, name],
                           capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.exit(f"variant {name} failed:\n{r.stderr[-2000:]}")


if __name__ == "__main__":
    main()
