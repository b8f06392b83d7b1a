"""Pred-unit records and the host residual of intra recon: the port's
copies of the JAX package's host planners in `jax_exec.py` (the field
layout `NF`/`F_*`/`K_*`, `preprocess_units`, `compose_residual_host`,
`apply_literals`; `jax_exec.py:38-46`, `:61`, `:383`, `:417`), for the
unpadded planes the port uses (the reference's pad = 0).
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from easyav1_tpu_torch import native as nat
from easyav1_tpu_torch.video.av1 import tables as T

NF = 30          # fields per preprocessed unit record

(F_X, F_Y, F_W, F_H, F_CLS, F_ANGLE, F_HA, F_HL, F_HTR, F_HBL,
 F_SA, F_SL, F_UA, F_UL, F_CF, F_ALPHA, F_ACX, F_ACY, F_ACW, F_ACH,
 F_DX, F_DY, F_MAXXR, F_MAXYR, F_NPXA, F_NPXL, F_NA, F_NL, F_VALID,
 F_RES) = range(NF)

K_DC, K_V, K_H, K_Z1, K_Z2, K_Z3, K_SM, K_SMV, K_SMH, K_PAETH, \
    K_CFL, K_ZERO, K_FILT, K_IBC = range(14)


def preprocess_units(units: np.ndarray, dims) -> List[np.ndarray]:
    """Bridge records [N,24] → per-plane field arrays [Np, NF] int32
    (decode order preserved within each plane; the reference's pad=0).  Class-9 records are filter-intra units whose `ang` column
    carries the filter mode (export_tx)."""
    dr = T.data()["dr_intra_derivative"]
    out = []
    for plane in range(len(dims)):
        sel = units[units[:, 0] == plane]
        n = sel.shape[0]
        f = np.zeros((n, NF), np.int32)
        (x, y, w, h, cls, ang, ha, hl, htr, hbl, sa, sl, ua, ul, cf,
         alpha, acx, acy, acw, ach) = (sel[:, i] for i in range(1, 21))
        ph, pw = dims[plane]
        k = np.select(
            [cls == 0, cls == 1, cls == 2,
             (cls == 3) & (ang < 90), (cls == 3) & (ang > 180),
             cls == 3, cls == 4, cls == 5, cls == 6, cls == 7,
             cls == 8, cls == 10, cls == 9, cls == 11],
            [K_DC, K_V, K_H, K_Z1, K_Z3, K_Z2, K_SM, K_SMV, K_SMH,
             K_PAETH, K_CFL, K_ZERO, K_FILT, K_IBC])
        dx = np.zeros(n, np.int32)
        dy = np.zeros(n, np.int32)
        z1 = k == K_Z1
        z2 = k == K_Z2
        z3 = k == K_Z3
        dx[z1] = dr[ang[z1]]
        dx[z2] = dr[180 - ang[z2]]
        dy[z2] = dr[ang[z2] - 90]
        dy[z3] = dr[270 - ang[z3]]
        # intrabc (cls 11): src coords of the dynamic-slice window
        # (col in `ang`, row in `cf`; taps ride sa/sl/ua/ul)
        ibc = k == K_IBC
        dx[ibc] = ang[ibc] - 3
        dy[ibc] = cf[ibc] - 3
        f[:, F_X] = x
        f[:, F_Y] = y
        f[:, F_W] = w
        f[:, F_H] = h
        f[:, F_CLS] = k
        f[:, F_ANGLE] = ang
        f[:, F_HA] = ha
        f[:, F_HL] = hl
        f[:, F_HTR] = htr
        f[:, F_HBL] = hbl
        f[:, F_SA] = sa
        f[:, F_SL] = sl
        f[:, F_UA] = ua
        f[:, F_UL] = ul
        f[:, F_CF] = cf
        f[:, F_ALPHA] = alpha
        f[:, F_ACX] = acx
        f[:, F_ACY] = acy
        f[:, F_ACW] = acw
        f[:, F_ACH] = ach
        f[:, F_DX] = dx
        f[:, F_DY] = dy
        f[:, F_MAXXR] = (pw - 1) - x
        f[:, F_MAXYR] = (ph - 1) - y
        is_dir = z1 | z2 | z3
        f[:, F_NPXA] = np.where(
            is_dir,
            np.minimum(w, pw - x) + np.where(ang < 90, h, 0) + 1, 0)
        f[:, F_NPXL] = np.where(
            is_dir,
            np.minimum(h, ph - y) + np.where(ang > 180, w, 0) + 1, 0)
        f[:, F_NA] = w + np.where(htr != 0, w, 0)
        f[:, F_NL] = h + np.where(hbl != 0, h, 0)
        f[:, F_VALID] = 1
        # interintra blend pack (u[23]; 0 = plain unit) rides in F_RES
        f[:, F_RES] = sel[:, 23]
        out.append(f)
    return out


def compose_residual_host(txs, coeffs, shapes, bd):
    """Host-C itx into fresh planes (av1_compose_residual): int16 for
    bit depths up to 10, else int32."""
    lib = nat._load()
    use_i16 = bd <= 10
    dt = np.int16 if use_i16 else np.int32
    planes = [np.zeros(s, dt) for s in shapes]
    if txs.shape[0]:
        ptrs = (ctypes.c_void_p * len(planes))(
            *[p.ctypes.data for p in planes])
        strides = np.asarray([p.shape[1] for p in planes], np.int32)
        hs = np.asarray([p.shape[0] for p in planes], np.int32)
        txs_c = np.ascontiguousarray(txs, np.int32)
        co_c = np.ascontiguousarray(coeffs, np.int32)
        lib.av1_compose_residual(nat._vp(txs_c), ctypes.c_int64(
            txs.shape[0]), nat._vp(co_c), ptrs, nat._vp(strides),
            nat._vp(hs), 0, 0, bd, int(use_i16))
    return planes


def narrow_residual(planes):
    """The composed residual planes as int16, which the kernels take:
    int16 planes as they are (bit depths up to 10); int32 planes (12
    bits, |residual| <= 2^15) cast when every value fits, else None."""
    if all(p.dtype == np.int16 for p in planes):
        return planes
    if any(p.size and (int(p.min()) < -32768 or int(p.max()) > 32767)
           for p in planes):
        return None
    return [p.astype(np.int16) for p in planes]


def apply_literals(planes, literals):
    """Fold palette-prediction patches (av1_export_literal_preds) into
    the composed residual planes: cls-10 units then reconstruct as
    clip(0 + (palette + residual)).  Safe in int16: |residual| <=
    2^(bd+3) and palette <= 2^bd-1 stay far from the int16 limits."""
    recs, pix = literals
    for k in range(recs.shape[0]):
        p, x, y, w, h, off = (int(v) for v in recs[k])
        patch = pix[off:off + w * h].reshape(h, w)
        tgt = planes[p][y:y + h, x:x + w]
        tgt += patch.astype(tgt.dtype)


