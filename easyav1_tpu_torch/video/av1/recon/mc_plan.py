# Copy of easyav1_tpu/video/av1/recon/mc_jax.py (:38-628, :752-756), the
# JAX package's counterpart.
"""The host planner of inter recon: block records to MC unit tables.

`export_inter_plan` turns the C entropy decoder's block records into
per-(plane, w, h) buckets of motion-compensation units (single-ref,
compound pairs with their weights or masks, 8x8 warp sub-blocks, OBMC
overlays and the deferred OBMC residual rects), with the subpel taps
resolved on the host.  It declines (returns None) intrabc blocks inside
an inter frame, scaled references, and diffwtd compound without host
reference planes.  `inter_mc` runs the units; `inter_exec.InterRecon`
drives a frame.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from easyav1_tpu_torch.video.av1 import constants as C
from easyav1_tpu_torch.video.av1 import tables as T

# block-record field indices (native/av1_common.h BLK_* enum)
(B_R, B_C, B_BSIZE, B_YMODE, B_UVMODE, B_ANGLE_Y, B_ANGLE_UV, B_SKIP,
 B_TXSZ, B_UVTX, B_HASCHROMA, B_CFL_U, B_CFL_V, B_FI, B_TXOFF, B_NTX,
 B_IS_INTER, B_REF0, B_REF1, B_MV_R, B_MV_C, B_MV2_R, B_MV2_C, B_MODE,
 B_REFMVIDX, B_INTERP0, B_INTERP1, B_MOTION_MODE, B_WARP_VALID) = \
    range(29)
B_WM0 = 29
B_SH_ALPHA = 35
B_COMP_TYPE = 39
B_COMP_IDX = 40
B_WEDGE_IDX = 41
B_WEDGE_SIGN = 42
B_MASK_TYPE = 43
B_II_MODE = 44
B_INTRABC = 50

GLOBALMV = 15
COMP_AVERAGE, COMP_DISTANCE, COMP_WEDGE, COMP_DIFFWTD = range(4)

NS = 23          # single-pred unit fields
NPR = 45         # compound-pred unit fields

# single layout: x, y, slot, ix, iy, valid, fh[8], fv[8], nores
# (nores = 1: write the bare prediction without the residual add —
# OBMC base predictions blend overlays first, residual comes after)
(S_X, S_Y, S_SLOT, S_IX, S_IY, S_VALID) = range(6)
S_FH = 6
S_FV = 14
S_NORES = 22

# raised-cosine overlap masks (av1_tables.h av1_obmc_mask_*)
OBMC_MASKS = {
    2: np.array([45, 64], np.int32),
    4: np.array([39, 50, 59, 64], np.int32),
    8: np.array([36, 42, 48, 53, 57, 61, 64, 64], np.int32),
    16: np.array([34, 37, 40, 43, 46, 49, 52, 54, 56, 58, 60, 61,
                  64, 64, 64, 64], np.int32),
    32: np.array([33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50,
                  51, 52, 53, 55, 56, 57, 58, 59, 60, 60, 61, 62,
                  64, 64, 64, 64, 64, 64, 64, 64], np.int32),
}
OBMC_MAX_NB = (0, 1, 2, 3, 4, 4, 4)
MM_SIMPLE, MM_OBMC, MM_WARPED = 0, 1, 2
# pair layout: x, y, valid, then per-pred (slot, ix, iy, fh[8], fv[8]),
# then w0, w1, blend mode (0 = w0/w1 weights, 1 = mask stack), mask idx
(P_X, P_Y, P_VALID) = range(3)
P_PRED0 = 3
P_PRED1 = 22
P_W0 = 41
P_W1 = 42
P_MODE = 43
P_MIDX = 44

# warp unit layout: x, y, valid, slot, ix4, iy4, sx4, sy4,
# alpha, beta, gamma, delta (one unit per 8x8 output sub-block)
(W_X, W_Y, W_VALID, W_SLOT, W_IX4, W_IY4, W_SX4, W_SY4,
 W_ALPHA, W_BETA, W_GAMMA, W_DELTA) = range(12)
NW = 12


@functools.lru_cache(maxsize=None)
def _filter_bank() -> np.ndarray:
    """[8 classes][16 fracs][8 taps] int32; class = interp + (dim<=4)*4.
    Same tables the C decoder uses (recon_ref._mc_filter source)."""
    d = T.data()
    b = np.zeros((8, 16, 8), np.int64)
    b[0] = d["mc_filter_regular8"]
    b[1] = d["mc_filter_smooth8"]
    b[2] = d["mc_filter_sharp8"]
    b[3] = d["mc_filter_bilinear"]
    b[4] = d["mc_filter_regular4"]
    b[5] = d["mc_filter_smooth4"]
    b[6] = d["mc_filter_regular4"]      # sharp remaps to regular4
    b[7] = d["mc_filter_bilinear"]      # bilinear keeps its 2-tap
    return b.astype(np.int32)


def _fclass(interp: np.ndarray, dim: np.ndarray) -> np.ndarray:
    return np.where(dim <= 4, interp + 4, interp)


def _dist_weights_np(seq, hdr, ref0: np.ndarray, ref1: np.ndarray):
    """(w0, w1) arrays for COMP_DISTANCE blocks (av1_mc.h
    dist_weights)."""
    QW = np.array([[2, 3], [2, 5], [2, 7]], np.int64)
    QL = np.array([[9, 7], [11, 5], [12, 4], [13, 3]], np.int64)
    hints = np.asarray(hdr.order_hints, np.int64)
    cur = int(hdr.order_hint)

    def rel(a, b):
        if not getattr(seq, "enable_order_hint", False):
            return np.zeros_like(np.asarray(a))
        d = a - b
        m = 1 << (seq.order_hint_bits - 1)
        return (d & (m - 1)) - (d & m)

    bck = np.abs(rel(cur, hints[ref0]))
    fwd = np.abs(rel(hints[ref1], cur))
    bck = np.minimum(bck, 31)
    fwd = np.minimum(fwd, 31)
    order = (fwd <= bck).astype(np.int64)
    n = ref0.shape[0]
    w0 = np.empty(n, np.int64)
    w1 = np.empty(n, np.int64)
    for k in range(n):                 # few compound-distance blocks
        near, far = ((fwd[k], bck[k]) if order[k]
                     else (bck[k], fwd[k]))
        for i in range(3):
            if far * 2 < near * QW[i][1]:
                break
        else:
            i = 3
        wn, wf = QL[i][0], QL[i][1]
        w0[k], w1[k] = ((wf, wn) if order[k] else (wn, wf))
    return w0, w1


def _host_comp_pred(ref, rw, rh, x, y, w, h, mvr, mvc, interp0,
                    interp1, sx, sy):
    """Numpy mirror of the compound-intermediate prediction
    ((accH+4)>>3 then (accV+64)>>7; av1_mc.h predict_inter comp=1) for
    host-side diffwtd mask generation."""
    bank = _filter_bank()
    start_x = (x << 4) + mvc * (1 if sx else 2)
    start_y = (y << 4) + mvr * (1 if sy else 2)
    ix, fx = start_x >> 4, start_x & 15
    iy, fy = start_y >> 4, start_y & 15
    fh8 = bank[int(_fclass(np.asarray([interp1]),
                           np.asarray([w]))[0]), fx].astype(np.int64)
    fv8 = bank[int(_fclass(np.asarray([interp0]),
                           np.asarray([h]))[0]), fy].astype(np.int64)
    rows = np.clip(iy - 3 + np.arange(h + 7), 0, rh - 1)
    cols = np.clip(ix - 3 + np.arange(w + 7), 0, rw - 1)
    win = ref[np.ix_(rows, cols)].astype(np.int64)
    acc = sum(win[:, t:t + w] * fh8[t] for t in range(8))
    m = (acc + 4) >> 3
    acc2 = sum(m[t:t + h, :] * fv8[t] for t in range(8))
    return (acc2 + 64) >> 7


def export_inter_plan(seq, hdr, blocks: np.ndarray,
                      ref0_g: np.ndarray, mvs_g: np.ndarray,
                      interp_g: np.ndarray,
                      ref_dims, ref_planes=None,
                      bsize_g=None) -> Optional[dict]:
    """Block records -> per-(plane, w, h) MC unit tensors.

    ref_dims: per-slot (lw, lh) or None.  ref_planes: per-slot list of
    host numpy planes (or None), used to build diffwtd masks.  Returns
    {"slots": [...], "singles": {...}, "pairs": {...},
    "pair_masks": {...}} or None when an unsupported feature is
    present (caller falls back to C)."""
    if getattr(hdr, "allow_intrabc", False):
        return None
    inter = blocks[blocks[:, B_IS_INTER] != 0]
    if inter.shape[0] == 0:
        return {"slots": [], "singles": {}, "pairs": {},
                "pair_masks": {}, "obmc_above": {}, "obmc_left": {},
                "obmc_resid": {}, "warps": {}}
    # warped motion (local + global) is handled by the warp kernel;
    # only interintra / intrabc / palette still fall back
    if np.any(inter[:, B_INTRABC] != 0):
        return None
    comp = inter[:, B_COMP_TYPE]
    is_comp = inter[:, B_REF1] > 0
    # masked compound: wedge masks come from the static tables,
    # diffwtd masks need the luma compound intermediates (host numpy
    # replica); both are chroma-subsampled host-side exactly like
    # av1_mc.h recon_compound
    diffwtd_rows = np.flatnonzero(is_comp & (comp == COMP_DIFFWTD))
    if diffwtd_rows.size and ref_planes is None:
        return None                      # resident refs: no host planes
    # warp selection (av1_mc.h recon_block_inter): local warp (coded
    # shear, BLK_WARP_VALID) beats global; GLOBALMV + gm_type >
    # TRANSLATION + valid shear + >=8x8 takes the global warp path;
    # anything else is translation
    gm_t = np.asarray(getattr(hdr, "gm_type", [0] * 8), np.int32)
    gm_inv = np.asarray(getattr(hdr, "gm_invalid", [False] * 8),
                        np.bool_)
    _bw4 = np.asarray(C.BLOCK_W4, np.int32)
    _bh4 = np.asarray(C.BLOCK_H4, np.int32)
    w4 = _bw4[inter[:, B_BSIZE]]
    h4 = _bh4[inter[:, B_BSIZE]]
    local_warp = (inter[:, B_MOTION_MODE] == MM_WARPED) \
        & (inter[:, B_WARP_VALID] != 0)
    glob = ~local_warp & ~is_comp & (inter[:, B_MODE] == GLOBALMV) \
        & (np.minimum(w4, h4) * 4 >= 8) \
        & (gm_t[inter[:, B_REF0]] > 1) & ~gm_inv[inter[:, B_REF0]]
    gm_shear = {}
    if np.any(glob):
        from easyav1_tpu_torch.video.av1.warp import get_shear_params
        gm_par = getattr(hdr, "gm_params", None)
        if gm_par is None:
            return None
        for rr in sorted({int(r) for r in inter[glob, B_REF0]}):
            gm_shear[rr] = get_shear_params(list(gm_par[rr]))
        # shear-invalid global warp degrades to translation
        glob &= np.asarray([gm_shear.get(int(r)) is not None
                            for r in inter[:, B_REF0]], np.bool_)
    is_warp = local_warp | glob
    # used reference slots must be unscaled
    rfi = list(getattr(hdr, "ref_frame_idx", [0] * 7))
    fw_l, fh_l = hdr.frame_width, hdr.frame_height
    used_refs = set(int(r) for r in inter[:, B_REF0]) \
        | set(int(r) for r in inter[is_comp, B_REF1])
    used_slots = sorted({rfi[r - 1] for r in used_refs if r >= 1})
    for s in used_slots:
        if ref_dims[s] is None:
            return None
        lw, lh = ref_dims[s]
        if lw != fw_l or lh != fh_l:
            return None                  # scaled reference
    slot_dense = {s: i for i, s in enumerate(used_slots)}
    ref_of = np.full(8, -1, np.int32)
    for r in range(1, 8):
        ref_of[r] = slot_dense.get(rfi[r - 1], -1)

    # luma-resolution masks for every masked-compound block, keyed by
    # row index into `inter` (chroma units subsample these)
    masked_rows = np.flatnonzero(
        is_comp & ((comp == COMP_WEDGE) | (comp == COMP_DIFFWTD)))
    luma_masks: Dict[int, np.ndarray] = {}
    if masked_rows.size:
        from easyav1_tpu_torch.video.av1.wedge import diffwtd_mask, wedge_mask
        bd_ = seq.color.bitdepth
        _bw4a = np.asarray(C.BLOCK_W4, np.int32)
        _bh4a = np.asarray(C.BLOCK_H4, np.int32)
        for k in masked_rows:
            b = inter[k]
            bs = int(b[B_BSIZE])
            bw, bh = int(_bw4a[bs]) * 4, int(_bh4a[bs]) * 4
            if int(b[B_COMP_TYPE]) == COMP_WEDGE:
                mL = np.asarray(
                    wedge_mask(bs, int(b[B_WEDGE_IDX]),
                               int(b[B_WEDGE_SIGN])), np.int32)
            else:
                x0, y0 = int(b[B_C]) * 4, int(b[B_R]) * 4
                ps = []
                for refc, mvrf, mvcf in ((B_REF0, B_MV_R, B_MV_C),
                                         (B_REF1, B_MV2_R, B_MV2_C)):
                    slot = rfi[int(b[refc]) - 1]
                    ref = np.asarray(ref_planes[slot][0])
                    lw, lh = ref_dims[slot]
                    ps.append(_host_comp_pred(
                        ref, lw, lh, x0, y0, bw, bh, int(b[mvrf]),
                        int(b[mvcf]), int(b[B_INTERP0]),
                        int(b[B_INTERP1]), 0, 0))
                mL = np.asarray(
                    diffwtd_mask(ps[0], ps[1], int(b[B_MASK_TYPE]),
                                 bd_), np.int32)
            luma_masks[int(k)] = mL

    bank = _filter_bank()
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    n_pl = seq.color.num_planes

    def emit_single(plane, x, y, w, h, slot, mvr, mvc, f_v, f_h,
                    fdim_w, fdim_h, sx, sy):
        """One single-ref prediction rect (vectorized over arrays)."""
        start_x = (x.astype(np.int64) << 4) + mvc * (1 if sx else 2)
        start_y = (y.astype(np.int64) << 4) + mvr * (1 if sy else 2)
        fx = (start_x & 15).astype(np.int64)
        fy = (start_y & 15).astype(np.int64)
        ix = (start_x >> 4).astype(np.int32)
        iy = (start_y >> 4).astype(np.int32)
        fh8 = bank[_fclass(f_h, fdim_w), fx]
        fv8 = bank[_fclass(f_v, fdim_h), fy]
        n = x.shape[0]
        u = np.empty((n, NS), np.int32)
        u[:, S_X] = x
        u[:, S_Y] = y
        u[:, S_SLOT] = slot
        u[:, S_IX] = ix
        u[:, S_IY] = iy
        u[:, S_VALID] = 1
        u[:, S_FH:S_FH + 8] = fh8
        u[:, S_FV:S_FV + 8] = fv8
        u[:, S_NORES] = 0
        return u

    out_singles: Dict[Tuple[int, int, int], List[np.ndarray]] = {}
    out_pairs: Dict[Tuple[int, int, int], List[np.ndarray]] = {}
    out_pair_masks: Dict[Tuple[int, int, int], List[np.ndarray]] = {}
    out_warps: Dict[int, List[np.ndarray]] = {}

    for plane in range(n_pl):
        sx = ssx if plane else 0
        sy = ssy if plane else 0
        has_c = (inter[:, B_HASCHROMA] != 0) | (plane == 0)
        blks = inter[has_c] if plane else inter
        bidx = (np.flatnonzero(has_c) if plane
                else np.arange(inter.shape[0]))
        if blks.shape[0] == 0:
            continue
        bw4 = _bw4[blks[:, B_BSIZE]]
        bh4 = _bh4[blks[:, B_BSIZE]]
        x = (blks[:, B_C] >> sx) * 4
        y = (blks[:, B_R] >> sy) * 4
        fw = np.maximum(1, bw4 >> sx) * 4
        fh = np.maximum(1, bh4 >> sy) * 4
        sub8 = (plane > 0) & (((bw4 == 1) & (sx == 1))
                              | ((bh4 == 1) & (sy == 1)))
        cmpd = blks[:, B_REF1] > 0

        # --- sub-8x8 chroma (av1_mc.h sub8x8_chroma): per tiny block,
        # the co-located luma 4x4s supply up to 4 (mv, ref, filt) ---
        mi_cols = ref0_g.shape[1]
        sub_rows = []
        normal_mask = np.ones(blks.shape[0], np.bool_)
        for k in np.flatnonzero(sub8):
            b = blks[k]
            w4k, h4k = int(bw4[k]), int(bh4[k])
            cr = (int(b[B_R]) >> sy) << sy
            cc = (int(b[B_C]) >> sx) << sx
            n_rows = 1 + (sy if h4k == 1 else 0)
            n_cols = 1 + (sx if w4k == 1 else 0)
            ok = all(ref0_g[cr + j, cc + i] > 0
                     for j in range(n_rows) for i in range(n_cols))
            if not ok:
                continue                 # falls through to normal path
            normal_mask[k] = False
            pw = (4 >> sx) if w4k == 1 else int(fw[k])
            ph_ = (4 >> sy) if h4k == 1 else int(fh[k])
            for j in range(n_rows):
                for i in range(n_cols):
                    ref = int(ref0_g[cr + j, cc + i])
                    mvr = int(mvs_g[cr + j, cc + i, 0, 0])
                    mvc = int(mvs_g[cr + j, cc + i, 0, 1])
                    fv_ = int(interp_g[cr + j, cc + i, 0])
                    fh_ = int(interp_g[cr + j, cc + i, 1])
                    sub_rows.append((pw, ph_, int(x[k]) + i * pw,
                                     int(y[k]) + j * ph_, ref, mvr,
                                     mvc, fv_, fh_))
        if sub_rows:
            arr = np.asarray(sub_rows, np.int64)
            for (pw, ph_) in {(r[0], r[1]) for r in sub_rows}:
                m = (arr[:, 0] == pw) & (arr[:, 1] == ph_)
                a = arr[m]
                u = emit_single(plane, a[:, 2], a[:, 3], pw, ph_,
                                ref_of[a[:, 4]], a[:, 5], a[:, 6],
                                a[:, 7], a[:, 8],
                                np.full(a.shape[0], pw),
                                np.full(a.shape[0], ph_), sx, sy)
                out_singles.setdefault((plane, pw, ph_), []).append(u)

        # --- warp-predicted sub-blocks (plane dims >= 8; smaller
        # chroma planes of warp blocks translate like C) ---
        is_warp_blk = is_warp[has_c] if plane else is_warp
        warp_here = is_warp_blk & (fw >= 8) & (fh >= 8) \
            & normal_mask & ~cmpd
        if np.any(warp_here):
            gm_par = getattr(hdr, "gm_params", None)
            wu = []
            for kk_ in np.flatnonzero(warp_here):
                b = blks[kk_]
                gi = int(bidx[kk_])
                if bool(local_warp[gi]):
                    mat = [int(v) for v in b[B_WM0:B_WM0 + 6]]
                    sh = [int(v) for v in b[B_SH_ALPHA:B_SH_ALPHA + 4]]
                else:
                    refn = int(b[B_REF0])
                    mat = [int(v) for v in gm_par[refn]]
                    sh = list(gm_shear[refn])
                slot = int(ref_of[int(b[B_REF0])])
                x0, y0 = int(x[kk_]), int(y[kk_])
                fww, fhh = int(fw[kk_]), int(fh[kk_])
                for i_ in range(0, fhh, 8):
                    for j_ in range(0, fww, 8):
                        src_x = (x0 + j_ + 4) << sx
                        src_y = (y0 + i_ + 4) << sy
                        dst_x = mat[2] * src_x + mat[3] * src_y + mat[0]
                        dst_y = mat[4] * src_x + mat[5] * src_y + mat[1]
                        x4 = dst_x >> sx
                        y4 = dst_y >> sy
                        ix4 = x4 >> 16
                        sx4 = (x4 & 0xFFFF) + sh[0] * (-4) \
                            + sh[1] * (-4)
                        iy4 = y4 >> 16
                        sy4 = (y4 & 0xFFFF) + sh[2] * (-4) \
                            + sh[3] * (-4)
                        sx4 &= ~63
                        sy4 &= ~63
                        wu.append((x0 + j_, y0 + i_, 1, slot, ix4, iy4,
                                   sx4, sy4, sh[0], sh[1], sh[2],
                                   sh[3]))
            out_warps.setdefault(plane, []).append(
                np.asarray(wu, np.int32))
            normal_mask = normal_mask & ~warp_here

        # --- normal single-ref blocks ---
        m1 = normal_mask & ~cmpd
        if np.any(m1):
            sel = blks[m1]
            fws, fhs = fw[m1], fh[m1]
            for (wv, hv) in {(int(a), int(b))
                             for a, b in zip(fws, fhs)}:
                mm = (fws == wv) & (fhs == hv)
                s2 = sel[mm]
                u = emit_single(
                    plane, x[m1][mm], y[m1][mm], wv, hv,
                    ref_of[s2[:, B_REF0]], s2[:, B_MV_R].astype(np.int64),
                    s2[:, B_MV_C].astype(np.int64), s2[:, B_INTERP0],
                    s2[:, B_INTERP1], np.full(s2.shape[0], wv),
                    np.full(s2.shape[0], hv), sx, sy)
                # OBMC blocks: bare prediction now, overlays blend it,
                # residual lands in the obmc_resid pass (C order).
                # Interintra blocks likewise: the intra scan blends
                # the staged pred and adds the residual there.
                u[:, S_NORES] = ((s2[:, B_MOTION_MODE] == MM_OBMC)
                                 | (s2[:, B_II_MODE] >= 0)) \
                    .astype(np.int32)
                out_singles.setdefault((plane, wv, hv), []).append(u)

        # --- compound (average / distance) ---
        m2 = normal_mask & cmpd
        if np.any(m2):
            sel = blks[m2]
            sel_idx = bidx[m2]
            xs, ys_ = x[m2], y[m2]
            fws, fhs = fw[m2], fh[m2]
            w0 = np.full(sel.shape[0], 8, np.int64)
            w1 = np.full(sel.shape[0], 8, np.int64)
            dm = sel[:, B_COMP_TYPE] == COMP_DISTANCE
            if np.any(dm):
                dw0, dw1 = _dist_weights_np(seq, hdr, sel[dm, B_REF0],
                                            sel[dm, B_REF1])
                w0[dm] = dw0
                w1[dm] = dw1
            for (wv, hv) in {(int(a), int(b))
                             for a, b in zip(fws, fhs)}:
                mm = (fws == wv) & (fhs == hv)
                s2 = sel[mm]
                s2_idx = sel_idx[mm]
                n = s2.shape[0]
                u = np.empty((n, NPR), np.int32)
                u[:, P_X] = xs[mm]
                u[:, P_Y] = ys_[mm]
                u[:, P_VALID] = 1
                u[:, P_MODE] = 0
                u[:, P_MIDX] = 0
                if luma_masks:
                    from easyav1_tpu_torch.video.av1.wedge import \
                        subsample_mask
                    gkey = (plane, wv, hv)
                    mlist = out_pair_masks.setdefault(
                        gkey, [np.zeros((hv, wv), np.int32)])
                    for j, gi in enumerate(s2_idx):
                        mL = luma_masks.get(int(gi))
                        if mL is None:
                            continue
                        mk = (mL if plane == 0
                              else np.asarray(
                                  subsample_mask(mL, sx, sy), np.int32))
                        u[j, P_MODE] = 1
                        u[j, P_MIDX] = len(mlist)
                        mlist.append(mk)
                for base, refc, mvrc, mvcc in (
                        (P_PRED0, B_REF0, B_MV_R, B_MV_C),
                        (P_PRED1, B_REF1, B_MV2_R, B_MV2_C)):
                    start_x = (xs[mm].astype(np.int64) << 4) \
                        + s2[:, mvcc].astype(np.int64) * (1 if sx else 2)
                    start_y = (ys_[mm].astype(np.int64) << 4) \
                        + s2[:, mvrc].astype(np.int64) * (1 if sy else 2)
                    u[:, base + 0] = ref_of[s2[:, refc]]
                    u[:, base + 1] = (start_x >> 4).astype(np.int32)
                    u[:, base + 2] = (start_y >> 4).astype(np.int32)
                    u[:, base + 3:base + 11] = bank[
                        _fclass(s2[:, B_INTERP1],
                                np.full(n, wv)), start_x & 15]
                    u[:, base + 11:base + 19] = bank[
                        _fclass(s2[:, B_INTERP0],
                                np.full(n, hv)), start_y & 15]
                u[:, P_W0] = w0[mm]
                u[:, P_W1] = w1[mm]
                out_pairs.setdefault((plane, wv, hv), []).append(u)

    # --- OBMC overlays (av1_mc.h apply_obmc, host neighbour scan) ---
    out_oa: Dict[Tuple[int, int, int], List[tuple]] = {}
    out_ol: Dict[Tuple[int, int, int], List[tuple]] = {}
    out_orr: Dict[Tuple[int, int, int], List[tuple]] = {}
    obmc_rows = np.flatnonzero(inter[:, B_MOTION_MODE] == MM_OBMC)
    if obmc_rows.size:
        if bsize_g is None:
            return None
        mi_rows_g, mi_cols_g = ref0_g.shape
        t_ = hdr.tile
        sbsh = 5 if getattr(seq, "use_128x128_superblock", False) else 4
        row_b = np.minimum(
            np.asarray(t_.row_starts[:-1], np.int64) << sbsh, mi_rows_g)
        col_b = np.minimum(
            np.asarray(t_.col_starts[:-1], np.int64) << sbsh, mi_cols_g)

        def queue_overlay(dst, plane, px, py, pw_, ph_, rr_, cc_):
            ref = int(ref0_g[rr_, cc_])
            dst.setdefault((plane, pw_, ph_), []).append(
                (px, py, int(ref_of[ref]),
                 int(mvs_g[rr_, cc_, 0, 0]), int(mvs_g[rr_, cc_, 0, 1]),
                 int(interp_g[rr_, cc_, 0]), int(interp_g[rr_, cc_, 1])))

        for k in obmc_rows:
            b = inter[k]
            r, c, bs = int(b[B_R]), int(b[B_C]), int(b[B_BSIZE])
            w4, h4 = int(_bw4[bs]), int(_bh4[bs])
            bw, bh = w4 * 4, h4 * 4
            w4c = min(w4, mi_cols_g - c)
            h4c = min(h4, mi_rows_g - r)
            t_rs = int(row_b[np.searchsorted(row_b, r, "right") - 1])
            t_cs = int(col_b[np.searchsorted(col_b, c, "right") - 1])
            n_pb = 3 if (int(b[B_HASCHROMA]) and n_pl > 1) else 1
            pw4 = max(1, w4 >> ssx)
            ph4 = max(1, h4 >> ssy)
            tiny = (pw4 * 4 <= 4 and ph4 * 4 <= 8) \
                or (pw4 * 4 <= 8 and ph4 * 4 <= 4)
            if r > t_rs:                      # above pass
                nb_max = OBMC_MAX_NB[bw.bit_length() - 3]
                count = i = 0
                while i < w4c and count < nb_max:
                    nbc = c + i
                    step = min(int(_bw4[bsize_g[r - 1, nbc]]), 16)
                    rel, nbc_eff = i, nbc
                    if step == 1:
                        rel = (nbc & ~1) - c
                        nbc_eff = (nbc & ~1) + 1
                        step = 2
                    if ref0_g[r - 1, nbc_eff] > 0:
                        count += 1
                        op_mi = min(w4, step)
                        overlap = min(bh, 64) >> 1
                        for plane in range(n_pb):
                            if plane and tiny:
                                continue
                            sx_ = ssx if plane else 0
                            sy_ = ssy if plane else 0
                            queue_overlay(
                                out_oa, plane,
                                ((c + rel) * 4) >> sx_, (r * 4) >> sy_,
                                (op_mi * 4) >> sx_, overlap >> sy_,
                                r - 1, nbc_eff)
                    i = rel + step
            if c > t_cs:                      # left pass
                nb_max = OBMC_MAX_NB[bh.bit_length() - 3]
                count = i = 0
                while i < h4c and count < nb_max:
                    nbr = r + i
                    step = min(int(_bh4[bsize_g[nbr, c - 1]]), 16)
                    rel, nbr_eff = i, nbr
                    if step == 1:
                        rel = (nbr & ~1) - r
                        nbr_eff = (nbr & ~1) + 1
                        step = 2
                    if ref0_g[nbr_eff, c - 1] > 0:
                        count += 1
                        op_mi = min(h4, step)
                        overlap = min(bw, 64) >> 1
                        for plane in range(n_pb):
                            sx_ = ssx if plane else 0
                            sy_ = ssy if plane else 0
                            queue_overlay(
                                out_ol, plane,
                                (c * 4) >> sx_, ((r + rel) * 4) >> sy_,
                                overlap >> sx_, (op_mi * 4) >> sy_,
                                nbr_eff, c - 1)
                    i = rel + step
            for plane in range(n_pb):        # deferred residual rect
                sx_ = ssx if plane else 0
                sy_ = ssy if plane else 0
                out_orr.setdefault(
                    (plane, max(1, w4 >> sx_) * 4,
                     max(1, h4 >> sy_) * 4), []).append(
                    ((int(b[B_C]) >> sx_) * 4, (int(b[B_R]) >> sy_) * 4))

    def ov_units(d):
        out = {}
        for (plane, pw_, ph_), rows_ in d.items():
            a = np.asarray(rows_, np.int64)
            sx_ = ssx if plane else 0
            sy_ = ssy if plane else 0
            out[(plane, pw_, ph_)] = emit_single(
                plane, a[:, 0], a[:, 1], pw_, ph_, a[:, 2], a[:, 3],
                a[:, 4], a[:, 5], a[:, 6],
                np.full(a.shape[0], pw_), np.full(a.shape[0], ph_),
                sx_, sy_)
        return out

    return {
        "slots": used_slots,
        "singles": {k: np.concatenate(v) for k, v in out_singles.items()},
        "pairs": {k: np.concatenate(v) for k, v in out_pairs.items()},
        "pair_masks": {k: np.stack(v)
                       for k, v in out_pair_masks.items()},
        "obmc_above": ov_units(out_oa),
        "obmc_left": ov_units(out_ol),
        "obmc_resid": {k: np.asarray(v, np.int32)
                       for k, v in out_orr.items()},
        "warps": {k: np.concatenate(v) for k, v in out_warps.items()},
    }
