"""Seeded random pred-unit programs: inputs that hold the strip executor
against its references (`exec_ref.UnitExecutor`, the Pallas kernel, its
own plain version).

A program is one plane's units in the bridge's [N, 24] record layout: a
base layer of 16x16 DC tiles, then random units of every class (DC, V,
H, zones 1-3 with edge filter, upsample and corner filter, the three
Smooths, Paeth, CfL with clipped non-pow2 AC blocks, filter-intra and
palette-zero), each inside one 64-row luma strip (32 for chroma) as the
Pallas strip kernel requires.  Built with numpy from a seed.
"""

from __future__ import annotations

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
                   mi_cols: int = MI_COLS, n_rand: int = 44) -> Dict:
    """One plane's program on a 4:2:0 frame of mi_rows x mi_cols:
    {"plane", "units" [N, 24] int32 in decode order, "dims" per plane,
    "resid" int16 per plane, "luma" [4 mi_rows, 4 mi_cols] int32 (the
    finished luma that chroma CfL reads)}."""
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
    resid = [rng.integers(-50, 51, d).astype(np.int16) for d in dims]
    luma = rng.integers(0, 256, dims[0]).astype(np.int32)
    return {"plane": plane, "units": np.array(units, np.int32),
            "dims": dims, "resid": resid, "luma": luma}
