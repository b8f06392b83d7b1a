# Copy of easyav1_tpu/video/av1/warp.py (get_shear_params), the JAX
# package's counterpart.
"""AV1 warped motion: shear setup and validation (spec §7.11.3.6-7),
which the MC planner needs for global warps.

Integer semantics recovered from the system libdav1d disassembly
(dav1d_find_affine_int / dav1d_get_shear_params) and verified bit-exact
against dav1d end-to-end; the Warp_Filter coefficient table and Div_Lut
come from libaom .rodata (tools/extract_warp_tables.py).  Reference
parity target: easyav1 delegates all AV1 decode to dav1d
(`src/easyav1.c` via dav1d_send_data/get_picture); this module is part
of our from-scratch replacement for that decoder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import tables as T

WARPEDMODEL_PREC_BITS = 16
WARP_PARAM_REDUCE_BITS = 6
DIV_LUT_PREC_BITS = 8
DIV_LUT_BITS = 14


def _div_lut():
    return T.data()["div_lut"].astype(np.int64)


def _iclip(v: int, lo: int, hi: int) -> int:
    return lo if v < lo else hi if v > hi else v


def _apply_sign(v: int, s: int) -> int:
    return -v if s < 0 else v


def _resolve_divisor(d: int) -> Tuple[int, int]:
    """|d| -> (1/d in Q14-ish, shift).  d > 0."""
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    if shift > DIV_LUT_PREC_BITS:
        f = (e + (1 << (shift - DIV_LUT_PREC_BITS - 1))) \
            >> (shift - DIV_LUT_PREC_BITS)
    else:
        f = e << (DIV_LUT_PREC_BITS - shift)
    return int(_div_lut()[f]), shift + DIV_LUT_BITS



def get_shear_params(mat: list) -> Optional[Tuple[int, int, int, int]]:
    """-> (alpha, beta, gamma, delta) or None if the warp is invalid
    (spec setup_shear; dav1d_get_shear_params exact)."""
    if mat[2] <= 0:
        return None
    alpha = _iclip(mat[2] - (1 << 16), -32768, 32767)
    beta = _iclip(mat[3], -32768, 32767)
    idet, shift = _resolve_divisor(mat[2])
    shift -= WARPEDMODEL_PREC_BITS
    v = (mat[4] << WARPEDMODEL_PREC_BITS) * idet
    gamma = _iclip(_round2_signed(v, shift + WARPEDMODEL_PREC_BITS),
                   -32768, 32767)
    w = (mat[3] * mat[4]) * idet
    delta = _iclip(mat[5] - _round2_signed(w, shift + WARPEDMODEL_PREC_BITS)
                   - (1 << 16), -32768, 32767)

    def reduce(v: int) -> int:
        return _apply_sign(
            (abs(v) + (1 << (WARP_PARAM_REDUCE_BITS - 1)))
            >> WARP_PARAM_REDUCE_BITS, v) * (1 << WARP_PARAM_REDUCE_BITS)

    alpha = reduce(alpha)
    beta = reduce(beta)
    gamma = reduce(gamma)
    delta = reduce(delta)
    if 4 * abs(alpha) + 7 * abs(beta) >= (1 << 16):
        return None
    if 4 * abs(gamma) + 4 * abs(delta) >= (1 << 16):
        return None
    return alpha, beta, gamma, delta


def _round2_signed(v: int, s: int) -> int:
    return _apply_sign((abs(v) + (1 << (s - 1))) >> s, v)

