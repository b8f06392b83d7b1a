"""Seeded random pred-unit programs: inputs that hold the strip executor
against its references (`exec_ref.UnitExecutor`, the Pallas kernel, its
own plain version).  Also seeded transform programs for the residual
composer, MC programs for the MC kernels, deblocking and CDEF inputs
for the postfilter kernels (`random_postfilter_case`), loop
restoration frames (`random_lr_case`) and film grain frames
(`random_fg_case`, `stream_grain`).

A program is one plane's units in the bridge's [N, 24] record layout: a
base layer of 16x16 DC tiles, then random units of every class (DC, V,
H, zones 1-3 with edge filter, upsample and corner filter, the three
Smooths, Paeth, CfL with clipped non-pow2 AC blocks, filter-intra and
palette-zero), each inside one 64-row luma strip (32 for chroma) as the
Pallas strip kernel requires.  `random_sb_program` lays a whole frame
out as a decoder does instead, a partition of each plane's superblocks
in decode order, for the strip kernel's superblock schedule.  Built
with numpy from a seed.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import numpy as np

MI_ROWS, MI_COLS = 30, 26


def _base_layer(plane: int, ph: int, pw: int) -> List[list]:
    out = []
    for y in range(0, ph, 16):
        for x in range(0, pw, 16):
            w = min(16, pw - x) // 4 * 4
            h = min(16, ph - y) // 4 * 4
            out.append([plane, x, y, w, h, 0, 0, int(y > 0), int(x > 0)]
                       + [0] * 15)
    return out


def _rand_units(n: int, plane: int, ph: int, pw: int, rng) -> List[list]:
    sh = 64 >> (1 if plane else 0)
    units = []
    # every class appears once n >= 11
    for cls in rng.permutation(np.arange(n) % 11).tolist():
        cap = 5 if cls == 9 else 6          # filter-intra up to 32x32
        w = min(int(2 ** rng.integers(2, cap)), 32)
        h = min(int(2 ** rng.integers(2, cap)), 32)
        x = int(rng.integers(0, (pw - w) // 4 + 1)) * 4
        strip = int(rng.integers(0, ph // sh))
        y = strip * sh + int(rng.integers(0, (sh - h) // 4 + 1)) * 4
        y = min(y, ph - h)
        ang = 0
        if cls == 3:
            zone = int(rng.integers(0, 3))
            ang = int(rng.choice(list({0: range(36, 88, 3),
                                       1: range(93, 178, 3),
                                       2: range(183, 268, 3)}[zone])))
        elif cls == 9:
            ang = int(rng.integers(0, 5))   # the filter-intra mode
        ha, hl = int(y > 0), int(x > 0)
        htr = int(rng.integers(0, 2)) if ha else 0
        hbl = int(rng.integers(0, 2)) if hl else 0
        if hbl and (y % sh) + 2 * h > sh:
            hbl = 0
        sa = int(rng.integers(0, 4)) if cls == 3 else 0
        sl = int(rng.integers(0, 4)) if cls == 3 else 0
        ua = int(rng.integers(0, 2)) if cls == 3 and w + h <= 16 else 0
        ul = int(rng.integers(0, 2)) if cls == 3 and w + h <= 16 else 0
        cf = int(rng.integers(0, 2)) \
            if cls == 3 and 90 < ang < 180 and ha and hl else 0
        alpha = acx = acy = acw = ach = 0
        if cls == 8 and plane:
            alpha = int(rng.integers(-16, 17))
            offx = 4 * int(rng.integers(0, 2)) if (x >= 4 and w <= 28) else 0
            offy = 4 * int(rng.integers(0, 2)) \
                if (y % sh >= 4 and h <= 28) else 0
            acx, acy = x - offx, y - offy
            acw, ach = offx + w, offy + h
            if rng.integers(0, 2) and ach > 4:
                ach -= 4
            if rng.integers(0, 2) and acw > 4:
                acw -= 4
        units.append([plane, x, y, w, h, cls, ang, ha, hl, htr, hbl, sa,
                      sl, ua, ul, cf, alpha, acx, acy, acw, ach, 0, 0, 0])
    return units


def random_program(seed: int, mi_rows: int = MI_ROWS,
                   mi_cols: int = MI_COLS, n_rand: int = 44,
                   bd: int = 8) -> Dict:
    """One plane's program on a 4:2:0 frame of mi_rows x mi_cols at bit
    depth bd: {"plane", "units" [N, 24] int32 in decode order, "dims"
    per plane, "resid" int16 per plane, "luma" [4 mi_rows, 4 mi_cols]
    int32 (the finished luma that chroma CfL reads)}.  At 8 bits the
    draws are those the generator always made."""
    rng = np.random.default_rng(seed)
    plane = int(rng.integers(0, 3))
    ah, aw = mi_rows * 4, mi_cols * 4
    dims = [(ah, aw), (ah >> 1, aw >> 1), (ah >> 1, aw >> 1)]
    ph, pw = dims[plane]
    sh = 64 >> (1 if plane else 0)
    base = _base_layer(plane, ph, pw)
    rand = _rand_units(n_rand, plane, ph, pw, rng)
    units = []
    for st in range(-(-ph // sh)):
        units += [u for u in base if u[2] // sh == st]
        units += [u for u in rand if u[2] // sh == st]
    lim = 50 << (bd - 8)
    resid = [rng.integers(-lim, lim + 1, d).astype(np.int16) for d in dims]
    luma = rng.integers(0, 1 << bd, dims[0]).astype(np.int32)
    return {"plane": plane, "units": np.array(units, np.int32),
            "dims": dims, "resid": resid, "luma": luma}


def _tiles(n: int) -> List[tuple]:
    """(offset, size) tiling of [0, n), n a multiple of 4, by 16, 8, 4."""
    out, pos = [], 0
    while pos < n:
        s = next(s for s in (16, 8, 4) if n - pos >= s)
        out.append((pos, s))
        pos += s
    return out


def program_frame(prog: Dict) -> Dict:
    """A program as a whole 4:2:0 frame for the frame executor: its
    plane's units; for a chroma program, a luma plane of palette-zero
    tiles whose residual is prog["luma"], so that luma reconstructs to
    exactly that plane, which CfL then reads; no units elsewhere.
    {"units" [N, 24] in bridge layout, "resid" int16 per plane}."""
    units, resid = prog["units"], list(prog["resid"])
    if prog["plane"]:
        ph, pw = prog["dims"][0]
        luma = [[0, x, y, w, h, 10] + [0] * 18
                for y, h in _tiles(ph) for x, w in _tiles(pw)]
        units = np.concatenate([np.array(luma, np.int32), units])
        resid[0] = prog["luma"].astype(np.int16)
    return {"units": units, "resid": resid}


# ------------------------------------------------------- intrabc, interintra

def random_ibc_program(seed: int, mi_rows: int = MI_ROWS,
                       mi_cols: int = MI_COLS, n_rand: int = 44,
                       n_ibc: int = 24) -> Dict:
    """`random_program` with intrabc units (bridge class 11) mixed into
    the second half of its decode order: whole-pel copies of w x h in
    1..32 (not only powers of two, as the plane edge clips them) from a
    source strictly above the unit, through the bilinear taps (128, 0)
    or (64, 64) across and down, as the C exporter emits them.  The keys
    of `random_program`."""
    prog = random_program(seed, mi_rows, mi_cols, n_rand)
    rng = np.random.default_rng(seed + 7919)
    ph, pw = prog["dims"][prog["plane"]]
    units = prog["units"].tolist()
    taps = ((128, 0), (64, 64))
    for _ in range(n_ibc):
        w = int(rng.choice([4, 8, 12, 16, 20, 32]))
        h = int(rng.choice([v for v in (4, 8, 12, 16, 28, 32)
                            if 2 * v + 4 <= ph]))
        x = int(rng.integers(0, (pw - w) // 4 + 1)) * 4
        y = int(rng.integers((h + 4) // 4, (ph - h) // 4 + 1)) * 4
        sx = int(rng.integers(0, pw - w - 1))
        sy = int(rng.integers(0, y - h))
        (h0, h1), (v0, v1) = (taps[int(rng.integers(0, 2))]
                              for _ in range(2))
        u = [prog["plane"], x, y, w, h, 11, sx] + [0] * 17
        u[11:16] = [h0, h1, v0, v1, sy]
        units.insert(int(rng.integers(len(units) // 2, len(units) + 1)), u)
    return prog | {"units": np.array(units, np.int32)}


# interintra modes' intra classes (DC, V, H, Smooth)
_II_CLASSES = (0, 1, 2, 4)


def random_interintra_program(seed: int, mi_rows: int = MI_ROWS,
                              mi_cols: int = MI_COLS,
                              n_rand: int = 44) -> Dict:
    """`random_program` whose DC, V, H and Smooth units of 8..32 pixels
    (chroma: of 8..32 luma pixels) carry an interintra blend pack in
    bridge column 23 (mode 1-4, wedge index and flag, luma block size;
    mc_plan's layout), plus "base": the int32 planes of the MC
    prediction that the pack blends with."""
    from easyav1_tpu_torch.video.av1 import constants as C
    from easyav1_tpu_torch.video.av1.wedge import wedge_allowed

    prog = random_program(seed, mi_rows, mi_cols, n_rand)
    rng = np.random.default_rng(seed + 104729)
    sub = 1 if prog["plane"] else 0
    units = prog["units"].copy()
    for u in units:
        lw, lh = int(u[3]) << sub, int(u[4]) << sub
        bs = [b for b in range(22) if C.BLOCK_W4[b] * 4 == lw
              and C.BLOCK_H4[b] * 4 == lh]
        if int(u[5]) not in _II_CLASSES or not 8 <= min(lw, lh) \
                or max(lw, lh) > 32 or not bs or rng.random() < 0.3:
            continue
        wedge = int(wedge_allowed(bs[0]) and rng.random() < 0.5)
        u[23] = (int(rng.integers(1, 5)) | int(rng.integers(0, 16)) << 4
                 | wedge << 12 | bs[0] << 16)
    base = [rng.integers(0, 256, d).astype(np.int32) for d in prog["dims"]]
    return prog | {"units": units, "base": base}


# ------------------------------------------------- superblock programs

def random_sb_program(seed: int, mi_rows: int = 37, mi_cols: int = 45,
                      bd: int = 8, interintra: bool = False, sb: int = 64,
                      occupied=None) -> Dict:
    """A seeded 4:2:0 frame as a decoder lays it out, for the strip
    kernel's superblock schedule (`intra_strip.sb_schedule`): each plane
    a random partition of its sb x sb luma (sb / 2 chroma) SB grid, sb 64
    or 128 (`_blocks`, blocks of 64x64 at most), in decode order, SB by
    SB, each block a unit of a random class (DC, V, H, zones 1-3 with
    edge filter, upsample and corner filter, the Smooths, Paeth, chroma
    CfL on its own block, filter-intra up to 32x32, palette-zero) or,
    one in eight, an inter block
    with no unit, whose pixels keep the base.  A unit reads only pixels
    decoded before it: above-right and below-left are available where
    every pixel of them in the plane is.  The default size leaves the
    last SBs partial and the chroma width 2 mod 4.  interintra: DC, V, H
    and Smooth units of 8..32 pixels (chroma: of 8..32 luma pixels) carry
    a blend pack, as `random_interintra_program`'s.  occupied: None, or
    for each plane the set of (row, column) of the SBs that hold units;
    every block of another SB is an inter block, as on a sparse inter
    frame.  {"units" [N, 24] bridge layout, "dims", "resid" int16 per
    plane, "base" int32 per plane}."""
    from easyav1_tpu_torch.video.av1 import constants as C
    from easyav1_tpu_torch.video.av1.wedge import wedge_allowed

    rng = np.random.default_rng(seed)
    ah, aw = mi_rows * 4, mi_cols * 4
    dims = [(ah, aw), (ah >> 1, aw >> 1), (ah >> 1, aw >> 1)]
    units = []
    for plane, (ph, pw) in enumerate(dims):
        sbp = sb >> int(plane > 0)
        done = np.zeros((ph, pw), bool)
        for x, y, w, h in _blocks(ph, pw, sbp, rng, 64):
            inside = x + w <= pw and y + h <= ph
            if occupied is not None \
                    and (y // sbp, x // sbp) not in occupied[plane] \
                    or rng.random() < 0.125:
                done[y:y + h, x:x + w] = True
                continue
            ha, hl = int(y > 0), int(x > 0)
            tr = done[y - 1, x + w:min(x + 2 * w, pw)] if ha else done[:0, 0]
            bl = done[y + h:min(y + 2 * h, ph), x - 1] if hl else done[:0, 0]
            htr = int(ha and tr.size > 0 and tr.all() and rng.random() < 0.7)
            hbl = int(hl and bl.size > 0 and bl.all() and rng.random() < 0.7)
            classes = [0, 1, 2, 3, 3, 3, 4, 5, 6, 7, 10]
            if plane and inside:
                classes += [8, 8]
            if w <= 32 and h <= 32:
                classes += [9]
            cls = int(rng.choice(classes))
            ang = sa = sl = ua = ul = cf = 0
            if cls == 3:
                zone = int(rng.integers(0, 3))
                ang = int(rng.choice(list({0: range(36, 88, 3),
                                           1: range(93, 178, 3),
                                           2: range(183, 268, 3)}[zone])))
                sa, sl = (int(v) for v in rng.integers(0, 4, 2))
                if w + h <= 16:
                    ua, ul = (int(v) for v in rng.integers(0, 2, 2))
                if 90 < ang < 180 and ha and hl:
                    cf = int(rng.integers(0, 2))
            elif cls == 9:
                ang = int(rng.integers(0, 5))
            alpha = acx = acy = acw = ach = 0
            if cls == 8:
                alpha = int(rng.integers(-16, 17))
                acx, acy, acw, ach = x, y, w, h
            pack = 0
            sub = 1 if plane else 0
            lw, lh = w << sub, h << sub
            bs = [b for b in range(22) if C.BLOCK_W4[b] * 4 == lw
                  and C.BLOCK_H4[b] * 4 == lh]
            if interintra and cls in _II_CLASSES and 8 <= min(lw, lh) \
                    and max(lw, lh) <= 32 and bs and rng.random() < 0.6:
                wedge = int(wedge_allowed(bs[0]) and rng.random() < 0.5)
                pack = (int(rng.integers(1, 5)) | int(rng.integers(0, 16)) << 4
                        | wedge << 12 | bs[0] << 16)
            units.append([plane, x, y, w, h, cls, ang, ha, hl, htr, hbl, sa,
                          sl, ua, ul, cf, alpha, acx, acy, acw, ach, 0, 0,
                          pack])
            done[y:y + h, x:x + w] = True
    lim = 50 << (bd - 8)
    resid = [rng.integers(-lim, lim + 1, d).astype(np.int16) for d in dims]
    base = [rng.integers(0, 1 << bd, d).astype(np.int32) for d in dims]
    return {"units": np.array(units, np.int32).reshape(-1, 24),
            "dims": dims, "resid": resid, "base": base}


# ----------------------------------------------------------- MC programs

def _blocks(ph: int, pw: int, sb: int, rng, most: int = 128
            ) -> List[tuple]:
    """(x, y, w, h) of a random partition of the SB grid over a plane:
    each SB split recursively (quad, halves, quarters) down to 4 pixels,
    blocks of every size from 4 to sb, none wider or taller than most;
    the last SBs overhang the plane."""
    out = []

    def split(x, y, w, h):
        if x >= pw or y >= ph:
            return
        kinds = [k for k, ok in (("quad", min(w, h) >= 8),
                                 ("horz", h >= 8 and w <= 2 * h),
                                 ("vert", w >= 8 and h <= 2 * w),
                                 ("h4", h >= 16 and w == h),
                                 ("v4", w >= 16 and w == h)) if ok]
        if not kinds or max(w, h) <= most and rng.random() < 0.4:
            out.append((x, y, w, h))
            return
        k = kinds[int(rng.integers(0, len(kinds)))]
        if k == "quad":
            for dy in (0, h // 2):
                for dx in (0, w // 2):
                    split(x + dx, y + dy, w // 2, h // 2)
        elif k in ("horz", "h4"):
            n = 2 if k == "horz" else 4
            for i in range(n):
                split(x, y + i * h // n, w, h // n)
        else:
            n = 2 if k == "vert" else 4
            for i in range(n):
                split(x + i * w // n, y, w // n, h)

    for y in range(0, ph, sb):
        for x in range(0, pw, sb):
            split(x, y, sb, sb)
    return out


def random_mc_program(seed: int, width: int = 100, height: int = 76,
                      n_slots: int = 3, bd: int = 8) -> Dict:
    """A random 4:2:0 frame of MC units of every kind in
    `mc_plan.export_inter_plan`'s layout, over a random partition of each
    plane into blocks of 4 to 128 pixels: single-reference units of the
    8 filter classes with subpel phases, a tenth of them without the
    residual (interintra), and half of the chroma ones that are 4 wide
    or high cut into units of 2 (sub-8x8 chroma); compound pairs with average or distance
    weights, or with the wedge masks of their size or diffwtd masks; 8x8 warp units with valid shears; OBMC
    blocks (bare prediction, above and left overlays with masks of 2 to
    32 lines, the deferred residual rects).  Positions reach well past
    the frame edges, so the windows clamp there.  Returns {"plan",
    "refs": per plane the n_slots logical reference planes of bd-bit
    samples (uint8 at 8 bits, else uint16), "resid": int16 per plane,
    "dims": the mi-aligned plane dims}.  At 8 bits the draws are those
    the generator always made."""
    from easyav1_tpu_torch.video.av1 import constants as C
    from easyav1_tpu_torch.video.av1.recon import mc_plan as M
    from easyav1_tpu_torch.video.av1.wedge import (diffwtd_mask,
                                                   wedge_allowed, wedge_mask)

    rng = np.random.default_rng(seed)
    rng_sub = np.random.default_rng([seed, 8])   # the sub-8x8 chroma cuts
    bank = M._filter_bank()
    aw, ah = -(-width // 4) * 4, -(-height // 4) * 4
    dims = [(ah, aw), (ah >> 1, aw >> 1), (ah >> 1, aw >> 1)]
    logical = [(height, width)] + [((height + 1) >> 1,
                                    (width + 1) >> 1)] * 2
    plan = {"slots": list(range(n_slots)), "singles": {}, "pairs": {},
            "pair_masks": {}, "obmc_above": {}, "obmc_left": {},
            "obmc_resid": {}, "warps": {}}

    def add(d, key, row):
        d.setdefault(key, []).append(row)

    def pred(x, y, rng=rng):
        """slot, ix, iy, fh[8], fv[8] of one prediction at (x, y)."""
        reach = 200 if rng.random() < 0.15 else 24
        ix, iy = (int(v + rng.integers(-reach, reach + 1)) for v in (x, y))
        fh = bank[int(rng.integers(0, 8)), int(rng.integers(0, 16))]
        fv = bank[int(rng.integers(0, 8)), int(rng.integers(0, 16))]
        return [int(rng.integers(0, n_slots)), ix, iy, *fh, *fv]

    def single(x, y, nores, rng=rng):
        s = pred(x, y, rng)
        return [x, y, s[0], s[1], s[2], 1, *s[3:], nores]

    def mask(w, h):
        """A wedge mask where the size has a codebook, else (and half
        the time) a diffwtd mask of two random predictions."""
        bs = [b for b in range(22) if C.BLOCK_W4[b] * 4 == w
              and C.BLOCK_H4[b] * 4 == h and wedge_allowed(b)]
        if bs and rng.random() < 0.5:
            return wedge_mask(bs[0], int(rng.integers(0, 16)),
                              int(rng.integers(0, 2))).astype(np.int32)
        p0, p1 = (rng.integers(0, (1 << bd) << 4, (h, w)) for _ in range(2))
        return diffwtd_mask(p0, p1, int(rng.integers(0, 2)),
                            bd).astype(np.int32)

    for p, (ph, pw) in enumerate(dims):
        for x, y, w, h in _blocks(ph, pw, 128 >> (p > 0), rng):
            kind = rng.random()
            if kind < 0.5:
                unit = single(x, y, int(rng.random() < 0.1))
                if p and min(w, h) == 4 and rng_sub.random() < 0.5:
                    sw, sh = (2 if w == 4 else w), (2 if h == 4 else h)
                    for dy in range(0, h, sh):
                        for dx in range(0, w, sw):
                            add(plan["singles"], (p, sw, sh),
                                single(x + dx, y + dy, 0, rng_sub))
                else:
                    add(plan["singles"], (p, w, h), unit)
            elif kind < 0.7:
                mode, midx = int(rng.random() < 0.5), 0
                w0 = int(rng.choice([8, 9, 7, 11, 5, 12, 4, 13, 3]))
                if mode:
                    stack = plan["pair_masks"].setdefault(
                        (p, w, h), [np.zeros((h, w), np.int32)])
                    midx = len(stack)
                    stack.append(mask(w, h))
                add(plan["pairs"], (p, w, h),
                    [x, y, 1, *pred(x, y), *pred(x, y), w0, 16 - w0, mode,
                     midx])
            elif kind < 0.8 and min(w, h) >= 8:
                for sy in range(0, h, 8):
                    for sx in range(0, w, 8):
                        al, be, ga, de = (int(v) * 64 for v in
                                          rng.integers(-80, 81, 4))
                        be = be * 4 // 7
                        fx, fy = (int(v) for v in rng.integers(0, 1 << 16, 2))
                        ox, oy = (int(v) for v in rng.integers(-40, 41, 2))
                        add(plan["warps"], p, [
                            x + sx, y + sy, 1, int(rng.integers(0, n_slots)),
                            x + sx + ox, y + sy + oy,
                            (fx - 4 * al - 4 * be) & ~63,
                            (fy - 4 * ga - 4 * de) & ~63, al, be, ga, de])
            else:
                add(plan["singles"], (p, w, h), single(x, y, 1))
                ov = min(h, 64) // 2
                for k in range(0, w, max(w // 2, 2)):
                    sw = min(max(w // 2, 2), w - k)
                    add(plan["obmc_above"], (p, sw, ov),
                        single(x + k, y, 0))
                ow = min(w, 64) // 2
                for k in range(0, h, max(h // 2, 2)):
                    sh = min(max(h // 2, 2), h - k)
                    add(plan["obmc_left"], (p, ow, sh),
                        single(x, y + k, 0))
                add(plan["obmc_resid"], (p, w, h), [x, y])
    for name in ("singles", "pairs", "obmc_above", "obmc_left", "warps",
                 "obmc_resid"):
        plan[name] = {k: np.asarray(v, np.int32)
                      for k, v in plan[name].items()}
    plan["pair_masks"] = {k: np.stack(v)
                          for k, v in plan["pair_masks"].items()}
    refs = [[rng.integers(0, 1 << bd, lg).astype(
        np.uint8 if bd == 8 else np.uint16)
             for _ in range(n_slots)] for lg in logical]
    lim = 64 << (bd - 8)
    resid = [rng.integers(-lim, lim + 1, d).astype(np.int16) for d in dims]
    return {"plan": plan, "refs": refs, "resid": resid, "dims": dims}


def _tx_region(x: int, y: int, w: int, h: int, rng, pick):
    """Transforms tiling the region [x, x + w) x [y, y + h) (w, h powers
    of two from 4 to 64): a (size, type) `pick` gives, or a random one
    that fits, or the four quadrants of a square, each alike."""
    from easyav1_tpu_torch.video.av1 import tables as T
    from easyav1_tpu_torch.video.av1.recon.itx_torch import legal
    if pick is None and w == h and w > 4 and rng.random() < 0.4:
        for dy in (0, h // 2):
            for dx in (0, w // 2):
                yield from _tx_region(x + dx, y + dy, w // 2, h // 2, rng,
                                      None)
        return
    if pick is None:
        sizes = [s for s in range(19)
                 if T.TX_WIDTH[s] <= w and T.TX_HEIGHT[s] <= h]
        s = sizes[int(rng.integers(len(sizes)))]
        types = [t for t in range(16) if legal(s, t)]
        pick = (s, types[int(rng.integers(len(types)))])
    s, t = pick
    for ty in range(y, y + h, T.TX_HEIGHT[s]):
        for tx in range(x, x + w, T.TX_WIDTH[s]):
            yield s, t, tx, ty


def _eob_pack(c: np.ndarray, aw: int) -> int:
    """The decoder's rec[5] of a coefficient block (dense, aw wide): an
    eob (1 for a DC-only block, else the block's size) packed with the
    nonzero rows and columns (`av1_tile.c`), which the host C composer
    reads to skip zero rows and DC-only blocks."""
    nz = np.flatnonzero(c)
    eob = 1 if nz.size and nz.max() == 0 else c.size
    maxr = int((nz // aw).max()) if nz.size else 0
    maxc = int((nz % aw).max()) if nz.size else 0
    return eob | ((maxr + 1) << 12) | ((maxc + 1) << 18)


def _tx_coeffs(rng, n: int, lim: int, kind: int) -> np.ndarray:
    """n seeded coefficients in +-lim of one of five kinds: dense (0 and
    4), sparse (1), DC-only (2), at the extremes (3)."""
    c = rng.integers(-lim, lim, n)
    if kind == 1:
        c[rng.random(n) < 0.9] = 0
    elif kind == 2:
        c[1:] = 0
    elif kind == 3:
        c = np.where(rng.random(n) < 0.5, -lim, lim - 1)
    return c


def shaped_tx_program(seed: int, dims, bd: int = 8, sizes=None,
                      dc_share: float = 0.0) -> Dict:
    """Seeded transform records and coefficients as `random_tx_program`
    gives them, each 64x64 block of each plane tiled with one tx size of
    `sizes` (all 19 if None) and each transform of a random legal type;
    a `dc_share` of them DC-only DCT_DCT, the rest dense, sparse, DC-only
    or extreme.  The device composer's shapes: DC-heavy frames, or many
    small transforms a warp."""
    from easyav1_tpu_torch.video.av1 import tables as T
    from easyav1_tpu_torch.video.av1.recon.itx_torch import legal
    rng = np.random.default_rng(seed)
    sizes = list(range(19)) if sizes is None else list(sizes)
    lim = 1 << (bd + 7)
    recs, coeffs, used = [], [], 0
    for p, (ph, pw) in enumerate(dims):
        for by in range(0, ph, 64):
            for bx in range(0, pw, 64):
                s = sizes[int(rng.integers(len(sizes)))]
                types = [t for t in range(16) if legal(s, t)]
                adj = T.ADJUSTED_TX_SIZE[s]
                aw, n = T.TX_WIDTH[adj], T.TX_WIDTH[adj] * T.TX_HEIGHT[adj]
                for y in range(by, min(by + 64, ph), T.TX_HEIGHT[s]):
                    for x in range(bx, min(bx + 64, pw), T.TX_WIDTH[s]):
                        if rng.random() < dc_share:
                            t, c = 0, _tx_coeffs(rng, n, lim, 2)
                        else:
                            t = types[int(rng.integers(len(types)))]
                            c = _tx_coeffs(rng, n, lim, int(rng.integers(5)))
                        recs.append([p, x, y, s, t, _eob_pack(c, aw), used,
                                     0])
                        coeffs.append(c)
                        used += n
    return {"txs": np.asarray(recs, np.int32).reshape(-1, 8),
            "coeffs": (np.concatenate(coeffs) if coeffs
                       else np.zeros(0)).astype(np.int32),
            "dims": [tuple(d) for d in dims], "bd": bd}


def random_tx_program(seed: int, dims, bd: int = 8,
                      tile_pairs: bool = True) -> Dict:
    """Seeded transform records and coefficients over planes of `dims`
    ((h, w) each), in the C decoder's export layout: {"txs": [n, 8]
    int32 (plane, x, y, tx_size, tx_type, packed eob, coefficient
    offset, 0),
    "coeffs": int32, "dims", "bd"}.  Each plane is cut into 64x64 blocks
    from its top left; the first blocks over the planes take each legal
    (size, type) pair in turn, tiled over the block (or, without
    `tile_pairs`, one transform at its top left), the rest random
    sizes, types and quadtree splits.  Blocks overhang the right and
    bottom edges, so transforms there are cropped; a transform that
    would start outside its plane is left out.  Coefficients lie in
    +-2^(bd+7): dense, sparse, DC-only or at the extremes."""
    from easyav1_tpu_torch.video.av1 import tables as T
    from easyav1_tpu_torch.video.av1.recon.itx_torch import legal_pairs
    rng = np.random.default_rng(seed)
    cases = legal_pairs()
    lim = 1 << (bd + 7)
    recs, coeffs, used, k = [], [], 0, int(rng.integers(len(cases)))
    for p, (ph, pw) in enumerate(dims):
        for by in range(0, ph, 64):
            for bx in range(0, pw, 64):
                pick = cases[k % len(cases)] if k < 2 * len(cases) else None
                k += 1
                for s, t, x, y in _tx_region(bx, by, 64, 64, rng, pick):
                    if x >= pw or y >= ph or (
                            pick and not tile_pairs and (x, y) != (bx, by)):
                        continue
                    adj = T.ADJUSTED_TX_SIZE[s]
                    n = T.TX_WIDTH[adj] * T.TX_HEIGHT[adj]
                    c = _tx_coeffs(rng, n, lim, int(rng.integers(5)))
                    recs.append([p, x, y, s, t, _eob_pack(c, T.TX_WIDTH[adj]),
                                 used, 0])
                    coeffs.append(c)
                    used += n
    return {"txs": np.asarray(recs, np.int32).reshape(-1, 8),
            "coeffs": (np.concatenate(coeffs) if coeffs
                       else np.zeros(0)).astype(np.int32),
            "dims": [tuple(d) for d in dims], "bd": bd}


LF_SIZES = (0, 4, 6, 8, 14)


def random_postfilter_case(seed: int, dims, bd: int = 8, streams: int = 0,
                           ss=(1, 1), map_shift: int = 2,
                           clamp: bool = False) -> Dict:
    """Seeded int32 planes of `dims` ((h, w) each, luma first) and their
    deblocking and CDEF maps in `postfilter.host_maps`'s layout (every
    plane's deblocking on), with a leading stream axis of `streams` when
    it is not 0 (CDEF's damping then one a stream, [S, 1, 1]):
    {"planes", "maps"}.  Each 8x8 block of a plane is a level plus noise
    of a random amplitude (0, 1, 3 or 16 steps of 2^(bd-8)) and steps
    between blocks of random heights, so that flat sides, steps and rough
    texture all occur and every filter length (size 4, 6, 8, 14 or 0 at
    random a map cell and edge, so that neighbouring edges' writes
    overlap) filters, with `hev` on and off (thresh at random below 4
    steps).  The deblocking maps have one row a 4x4-cell row of lines
    (`map_shift` 2, as the decoder's) or one a line (0); their levels
    pick (limit, blimit, thresh) from a seeded LUT a plane.

    With `clamp`, a band 4 pixels wide along each plane's border is flat
    at the stream's level but for dips of 2 steps every 5 pixels on its
    second line from the border; the deblocking leaves the band alone
    (the sizes of the first two and the last three edges of each line,
    and of every edge of the band's lines, are 0), and every unit
    filters at primary strength 14, secondary
    strength 4 and the largest damping.  A dip's taps inside the plane
    then pull it up by more than the highest of them, so that the
    filter's upper clamp binds beside the taps that fall past the
    plane."""
    rng = np.random.default_rng(seed)
    lead = (streams,) if streams else ()
    step = 1 << (bd - 8)
    top = (1 << bd) - 1
    planes = []
    for ph, pw in dims:
        bh, bw = (ph + 7) // 8, (pw + 7) // 8

        def up(u):
            return np.repeat(np.repeat(u, 8, -2), 8, -1)[..., :ph, :pw]

        amp = up(rng.choice([0, 1, 3, 16], (*lead, bh, bw)) * step)
        lift = up(rng.choice([0, 0, 2, 6, 40], (*lead, bh, bw)) * step)
        level = rng.integers(32 * step, top - 96 * step, (*lead, 1, 1))
        noise = rng.integers(0, amp + 1)
        plane = np.clip(level + lift + noise, 0, top)
        if clamp:
            band = np.ones((ph, pw), bool)
            band[4:-4, 4:-4] = False
            dip = np.zeros((ph, pw), bool)
            dip[[1, ph - 2], 2::5] = dip[2::5, [1, pw - 2]] = True
            plane = np.where(dip, level - 2 * step,
                             np.where(band, level, plane))
        planes.append(plane.astype(np.int32))

    def lut():
        return np.stack([rng.integers(1, 10 * step, (*lead, 64)),
                         rng.integers(5 * step, 60 * step, (*lead, 64)),
                         rng.integers(0, 4 * step, (*lead, 64))],
                        axis=-2).astype(np.int32)

    def sizes(rows, ne):
        return rng.choice(LF_SIZES, (*lead, rows, ne)).astype(np.uint8)

    def levels(rows, ne):
        return rng.integers(0, 64, (*lead, rows, ne)).astype(np.uint8)

    lf = []
    cells = (1 << map_shift) - 1
    for ph, pw in dims:
        nev, neh = max((pw + 3) // 4 - 1, 0), max((ph + 3) // 4 - 1, 0)
        rv, rh = (ph + cells) >> map_shift, (pw + cells) >> map_shift
        lf.append({"sv": sizes(rv, nev), "lv": levels(rv, nev),
                   "sh": sizes(rh, neh), "lh": levels(rh, neh),
                   "lut": lut()})
    if clamp:
        for (ph, pw), m in zip(dims, lf):
            for k, lines in (("sv", ph), ("sh", pw)):
                first = np.arange(m[k].shape[-2]) << map_shift
                m[k][..., (first < 4)
                     | (first + (1 << map_shift) > lines - 4), :] = 0
                m[k][..., :2] = m[k][..., -3:] = 0
    cs = bd - 8
    u = (*lead, (dims[0][0] + 7) // 8, (dims[0][1] + 7) // 8)
    damping = rng.integers(3, 7, (streams, 1, 1) if streams else ()) + cs
    cdef = {"pri_y": (rng.integers(0, 16, u) << cs).astype(np.int32),
            "sec_y": (rng.choice([0, 1, 2, 4], u) << cs).astype(np.int32),
            "pri_uv": (rng.integers(0, 16, u) << cs).astype(np.int32),
            "sec_uv": (rng.choice([0, 1, 2, 4], u) << cs).astype(np.int32),
            "filt": rng.integers(0, 2, u).astype(np.int32), "cs": cs,
            "damping": (damping.astype(np.int32) if streams
                        else int(damping)),
            "ss": tuple(ss)}
    if clamp:
        for k, v in (("pri_y", 14), ("pri_uv", 14), ("sec_y", 4),
                     ("sec_uv", 4), ("filt", 1)):
            cdef[k][...] = v << cs if k != "filt" else v
        cdef["damping"] = (np.full_like(damping, 6 + cs, dtype=np.int32)
                           if streams else 6 + cs)
    return {"planes": planes, "maps": {"bd": bd, "lf": lf, "cdef": cdef}}


def random_lr_case(seed: int, width: int, height: int, bd: int = 8,
                   ss=(1, 1), kinds=((2, 3, 0), (2,), (3, 0)),
                   unit_sizes=(64, 64, 64), align: int = 8, pad=(0, 0),
                   sgr_set=None):
    """A seeded loop-restoration frame: (hdr, seq, plan, planes,
    deblocked), the planes int32 numpy arrays of `bd`-bit samples whose
    size is the visible one rounded up to `align` (8: mi-aligned; 1: as
    superres leaves them) plus `pad` rows and columns; the snapshot the
    planes give or take 2.  kinds: by plane, the unit types that cycle
    over its units (2 Wiener, 3 SGR, 0 none; no kinds: the plane's frame
    type is NONE); Wiener taps and SGR sets and weights random
    (`sgr_set` fixes the set); ss: (ssx, ssy)."""
    rng = np.random.default_rng(seed)
    ssx, ssy = ss
    plan = SimpleNamespace(lr_type={}, lr_wiener={}, lr_sgr={})
    vis = [(height, width)] + [((height + ssy) >> ssy,
                                (width + ssx) >> ssx)] * 2
    for plane, ((ph, pw), kind, us) in enumerate(zip(vis, kinds,
                                                     unit_sizes)):
        for urow in range(max((ph + us // 2) // us, 1)):
            for ucol in range(max((pw + us // 2) // us, 1)):
                if not kind:
                    continue
                k, key = kind[(urow + ucol) % len(kind)], (plane, urow, ucol)
                plan.lr_type[key] = k
                if k == 2:
                    plan.lr_wiener[key] = [
                        [0 if plane else int(rng.integers(-5, 11)),
                         int(rng.integers(-23, 9)), int(rng.integers(-17, 47))]
                        for _ in range(2)]
                elif k == 3:
                    plan.lr_sgr[key] = (
                        int(rng.integers(0, 16)) if sgr_set is None
                        else sgr_set, int(rng.integers(-96, 32)),
                        int(rng.integers(-32, 96)))
    ns = SimpleNamespace
    hdr = ns(upscaled_width=width, frame_height=height, lr=ns(
        uses_lr=True, frame_restoration_type=[
            (plane + 1) if kind else 0 for plane, kind in enumerate(kinds)],
        loop_restoration_size=list(unit_sizes)))
    seq = ns(color=ns(subsampling_x=ssx, subsampling_y=ssy, num_planes=3,
                      mono_chrome=False, bitdepth=bd))
    ah, aw = -(-height // align) * align, -(-width // align) * align
    dims = [(ah, aw)] + [((ah + ssy) >> ssy, (aw + ssx) >> ssx)] * 2
    mx = (1 << bd) - 1
    planes = [rng.integers(0, mx + 1, (h + pad[0], w + pad[1]))
              .astype(np.int32) for h, w in dims]
    debl = [np.clip(p[:h, :w] + rng.integers(-2, 3, (h, w)), 0, mx)
            .astype(np.int32) for p, (h, w) in zip(planes, dims)]
    return hdr, seq, plan, planes, debl


def random_fg_case(seed: int, width: int, height: int, bd: int = 8,
                   ss=(1, 1), mono: bool = False, lag: int = 3,
                   overlap: bool = True, chroma: str = "mult",
                   restricted: bool = False, luma: bool = True):
    """A seeded film grain frame: (fg, seq, planes), fg a
    `headers.FilmGrainParams` with random scaling points, AR coefficients
    of `lag`, shifts and chroma combination, the planes numpy arrays of
    `bd`-bit samples (uint8 at 8 bits, uint16 above), luma [height,
    width] and, unless `mono`, chroma subsampled by ss = (ssx, ssy).
    chroma: "mult" (each chroma plane its own points, mult, luma mult and
    offset), "luma" (chroma scaling from luma) or "none"; luma False
    leaves luma without points."""
    from easyav1_tpu_torch.video.av1.headers import FilmGrainParams
    rng = np.random.default_rng(seed)
    ssx, ssy = ss

    def points(most):
        n = int(rng.integers(1, most + 1))
        val = np.sort(rng.choice(256, n, replace=False)).tolist()
        return n, val, rng.integers(0, 256, n).tolist()

    n_pos = 2 * lag * (lag + 1)
    fg = FilmGrainParams(
        apply_grain=True, grain_seed=int(rng.integers(0, 1 << 16)),
        grain_scaling=int(rng.integers(8, 12)), ar_coeff_lag=lag,
        ar_coeff_shift=int(rng.integers(6, 10)),
        grain_scale_shift=int(rng.integers(0, 4)),
        overlap_flag=overlap, clip_to_restricted_range=restricted,
        ar_coeffs_y=rng.integers(-48, 48, n_pos).tolist(),
        ar_coeffs_cb=rng.integers(-48, 48, n_pos + 1).tolist(),
        ar_coeffs_cr=rng.integers(-48, 48, n_pos + 1).tolist())
    if luma:
        fg.num_y_points, fg.point_y_value, fg.point_y_scaling = points(14)
    if chroma == "luma":
        fg.chroma_scaling_from_luma = True
    elif chroma == "mult":
        fg.num_cb_points, fg.point_cb_value, fg.point_cb_scaling = points(10)
        fg.num_cr_points, fg.point_cr_value, fg.point_cr_scaling = points(10)
        fg.cb_mult, fg.cb_luma_mult, fg.cr_mult, fg.cr_luma_mult = (
            int(v) for v in rng.integers(0, 256, 4))
        fg.cb_offset, fg.cr_offset = (int(v) for v in rng.integers(0, 512, 2))
    seq = SimpleNamespace(color=SimpleNamespace(
        subsampling_x=ssx, subsampling_y=ssy, mono_chrome=mono,
        num_planes=1 if mono else 3, bitdepth=bd))
    dt = np.uint8 if bd == 8 else np.uint16
    dims = [(height, width)] + ([] if mono else [
        ((height + ssy) >> ssy, (width + ssx) >> ssx)] * 2)
    planes = [rng.integers(0, 1 << bd, d).astype(dt) for d in dims]
    return fg, seq, planes


def stream_grain(path: str, shown: bool = False):
    """(film grain parameters, sequence header) of each frame of an AV1
    WebM stream whose header applies grain, read by the port's parser;
    `shown`: of every shown frame instead, (None, None) for one that
    shows an existing frame again."""
    from easyav1_tpu_torch.container.webm import TrackType, WebMDemuxer
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    found = []

    class Headers(AV1Backend):
        def _decode_frame(self, hdr, tile_payloads, ts):
            # later headers are parsed against the references it refreshes
            self.hp.update_refs(hdr)
            fg = hdr.film_grain
            if (hdr.show_frame if shown
                    else fg is not None and fg.apply_grain):
                found.append((fg, self.seq))

        def _show_existing(self, hdr, ts):
            if shown:
                found.append((None, None))

    dmx = WebMDemuxer(path)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = Headers(vt)
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            be.decode(p.frames, 0)
    return found
