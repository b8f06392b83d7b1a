# Copy of easyav1_tpu/video/av1/wedge.py, the JAX package's counterpart.
"""Wedge + difference-weighted compound masks (AV1 spec §7.11.3.11-12).

Reference behavior: dav1d wedge.c (mask construction) and mc_tmpl.c
w_mask/mask (blending) — ext/dav1d submodule, cmake/dav1d.cmake:984,
1006 — plus libaom reconinter.c init_wedge_master_masks /
get_wedge_mask_inplace semantics. The three master border ramps and
the per-shape codebooks were verified byte-for-byte against the
system libaom.so.3 / libdav1d.so.6 binaries.

Masks are 6-bit alpha weights (0..64) applied to the first compound
prediction: out = (p0*m + p1*(64-m) + rnd) >> sh on the compound
intermediate scale. Chroma masks are the Round2-subsampled luma masks
(libaom aom_blend_a64_d16_mask subw/subh handling).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import constants as C

# master border ramps (dav1d wedge.c wedge_master_border)
_ODD = [1, 2, 6, 18, 37, 53, 60, 63]
_EVEN = [1, 4, 11, 27, 46, 58, 62, 63]
_VERT = [0, 2, 7, 21, 43, 57, 62, 64]

WEDGE_HORIZONTAL = 0
WEDGE_VERTICAL = 1
WEDGE_OBLIQUE27 = 2
WEDGE_OBLIQUE63 = 3
WEDGE_OBLIQUE117 = 4
WEDGE_OBLIQUE153 = 5

# 16-entry (direction, x_offset, y_offset) codebooks per aspect class
# (libaom wedge_codebook_16_{heqw,hltw,hgtw})
_CB_HEQW = [(2, 4, 4), (3, 4, 4), (4, 4, 4), (5, 4, 4),
            (0, 4, 2), (0, 4, 6), (1, 2, 4), (1, 6, 4),
            (2, 4, 2), (2, 4, 6), (5, 4, 2), (5, 4, 6),
            (3, 2, 4), (3, 6, 4), (4, 2, 4), (4, 6, 4)]
_CB_HLTW = [(2, 4, 4), (3, 4, 4), (4, 4, 4), (5, 4, 4),
            (1, 2, 4), (1, 4, 4), (1, 6, 4), (0, 4, 4),
            (2, 4, 2), (2, 4, 6), (5, 4, 2), (5, 4, 6),
            (3, 2, 4), (3, 6, 4), (4, 2, 4), (4, 6, 4)]
_CB_HGTW = [(2, 4, 4), (3, 4, 4), (4, 4, 4), (5, 4, 4),
            (0, 4, 2), (0, 4, 4), (0, 4, 6), (1, 4, 4),
            (2, 4, 2), (2, 4, 6), (5, 4, 2), (5, 4, 6),
            (3, 2, 4), (3, 6, 4), (4, 2, 4), (4, 6, 4)]

# wedge-capable block sizes -> codebook by aspect (av1_wedge_params_lookup)
_CODEBOOK = {
    C.BLOCK_8X8: _CB_HEQW,
    C.BLOCK_8X16: _CB_HGTW,
    C.BLOCK_16X8: _CB_HLTW,
    C.BLOCK_16X16: _CB_HEQW,
    C.BLOCK_16X32: _CB_HGTW,
    C.BLOCK_32X16: _CB_HLTW,
    C.BLOCK_32X32: _CB_HEQW,
    C.BLOCK_8X32: _CB_HGTW,
    C.BLOCK_32X8: _CB_HLTW,
}


def wedge_allowed(bsize: int) -> bool:
    """av1_is_wedge_used: sizes with a wedge codebook."""
    return bsize in _CODEBOOK


@lru_cache(maxsize=1)
def _master_masks() -> np.ndarray:
    """(6, 64, 64) int64 master masks (libaom init_wedge_master_masks)."""
    m = np.zeros((6, 64, 64), np.int64)
    even = np.array([0] * 28 + _EVEN + [64] * 28, np.int64)
    odd = np.array([0] * 28 + _ODD + [64] * 28, np.int64)
    vert = np.array([0] * 28 + _VERT + [64] * 28, np.int64)
    idx = np.arange(64)
    shift = 16
    for j in range(0, 64, 2):
        m[WEDGE_OBLIQUE63, j] = even[np.clip(idx - shift, 0, 63)]
        shift -= 1
        m[WEDGE_OBLIQUE63, j + 1] = odd[np.clip(idx - shift, 0, 63)]
        m[WEDGE_VERTICAL, j] = vert
        m[WEDGE_VERTICAL, j + 1] = vert
    ob63 = m[WEDGE_OBLIQUE63]
    m[WEDGE_OBLIQUE27] = ob63.T
    m[WEDGE_OBLIQUE117] = 64 - ob63[:, ::-1]
    m[WEDGE_OBLIQUE153] = m[WEDGE_OBLIQUE117].T
    m[WEDGE_HORIZONTAL] = m[WEDGE_VERTICAL].T
    return m


@lru_cache(maxsize=None)
def wedge_mask(bsize: int, wedge_idx: int, wedge_sign: int) -> np.ndarray:
    """(bh, bw) luma-resolution wedge mask, sign-flip normalized so that
    sign 0 always averages >= 32 over the first row+column (libaom
    init_wedge_signs)."""
    cb = _CODEBOOK[bsize]
    direction, xoff, yoff = cb[wedge_idx]
    bw = C.BLOCK_W4[bsize] * 4
    bh = C.BLOCK_H4[bsize] * 4
    woff = (xoff * bw) >> 3
    hoff = (yoff * bh) >> 3
    master = _master_masks()[direction]
    base = master[32 - hoff:32 - hoff + bh, 32 - woff:32 - woff + bw]
    s = int(base[0, :].sum() + base[1:, 0].sum())
    avg = (s + (bw + bh - 1) // 2) // (bw + bh - 1)
    flip = 1 if avg < 32 else 0
    out = (64 - base) if (wedge_sign ^ flip) else base
    out = np.ascontiguousarray(out)
    out.setflags(write=False)
    return out


def round0(bd: int) -> int:
    """InterRound0: 5 at 12 bits, else 3.  A single prediction rounds at
    14 - round0, and the compound blends at InterPostRound = 7 - round0
    beyond the 8-bit shifts' 4."""
    return 5 if bd == 12 else 3


def diffwtd_mask(p0: np.ndarray, p1: np.ndarray, mask_type: int,
                 bd: int) -> np.ndarray:
    """DIFFWTD_38 / DIFFWTD_38_INV mask from compound-intermediate
    luma predictions (libaom av1_build_compound_diffwtd_mask_d16).
    Intermediates are on the (pixel << InterPostRound) compound scale
    (4, or 2 at 12 bits), so the pixel-scale Round2(diff, bd - 8 +
    InterPostRound) / 16 collapses to one shift."""
    sh = bd + 3 - round0(bd)  # (bd - 8) + InterPostRound + 4
    rnd = 1 << (sh - 5)
    m = np.minimum(38 + ((np.abs(p0 - p1) + rnd) >> sh), 64)
    if mask_type:  # DIFFWTD_38_INV
        m = 64 - m
    return m


def subsample_mask(mask: np.ndarray, ssx: int, ssy: int) -> np.ndarray:
    """Chroma mask via Round2 subsampling of the luma-resolution mask
    (libaom aom_blend_a64_d16_mask subw/subh arms)."""
    if not ssx and not ssy:
        return mask
    if ssx and ssy:
        return (mask[0::2, 0::2] + mask[0::2, 1::2]
                + mask[1::2, 0::2] + mask[1::2, 1::2] + 2) >> 2
    if ssx:
        return (mask[:, 0::2] + mask[:, 1::2] + 1) >> 1
    return (mask[0::2, :] + mask[1::2, :] + 1) >> 1
