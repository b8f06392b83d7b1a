"""Intra strip executor: the counterpart of `intra_pallas.py`.

Replays a frame's pred-unit records, as `records.preprocess_units(
units, dims)` lays them out, with `exec_ref.UnitExecutor._unit`
semantics, into int32 planes of the mi-aligned dims.  It also carries
what the reference's sequential scan (`jax_exec._scan_kernel`) has over
the strip kernel: a base plane to start from (an inter frame's MC
planes) whose pixels outside the units stay as they are, the intrabc
copy (`K_IBC`) from the partly reconstructed plane, and the interintra
blend of a unit's prediction with the base pixels under a mask from a
per-plane stack (the unit's `F_RES`, 1-based; 0 for none).

- `strip_exec_plain`: the plain torch version of one plane, one unit at
  a time in decode order: the specification.
- `sb_schedule`, `sequential_schedule`: the host schedule, each plane's
  units per superblock (SB) as spans of its records, and each SB's
  units in level order (C, `av1_strip_levels`): a unit's level is one
  more than the highest of the units of its SB whose pixels it reads.
  Intrabc frames take the sequential one: a copy's source may lie
  anywhere above.
- `strip_exec_frame`: the wrapper.  For CPU tensors it runs the plain
  version on each plane, luma first; for CUDA tensors it launches
  `csrc/intra_strip.cu` once for all planes, an SB wavefront with the
  units of a level at once inside each SB, or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from easyav1_tpu_torch import _build, convert, trace
from easyav1_tpu_torch import native as nat
from easyav1_tpu_torch.video.av1.recon.records import (
    F_ACH, F_ACW, F_ACX, F_ACY, F_ALPHA, F_ANGLE, F_CF, F_CLS, F_DX, F_DY,
    F_H, F_HA, F_HL, F_NA, F_NL, F_NPXA, F_NPXL, F_RES, F_SA, F_SL,
    F_UA, F_UL, F_W, F_X, F_Y, K_CFL, K_DC, K_FILT, K_H, K_IBC, K_PAETH,
    K_SM, K_SMH, K_SMV, K_V, K_Z1, K_Z2, K_Z3, NF)

OFF = 2                       # edge slot of the first pixel (exec_ref.OFF)
_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
_SIZES = (4, 8, 16, 32, 64)


def check_units(fields: np.ndarray, dims: Tuple[int, int],
                has_luma: bool, n_masks: int = 0, mask_size: int = 0) -> None:
    """Raise ValueError on records the executor cannot take (host-side,
    before upload: the kernel indexes the plane with these numbers).
    n_masks, mask_size: the plane's interintra mask stack [n_masks,
    mask_size, mask_size] that F_RES indexes."""
    ph, pw = dims
    f = fields
    if f.ndim != 2 or f.shape[1] != NF:
        raise ValueError(f"unit fields must be [n, {NF}], got {f.shape}")
    if f.shape[0] == 0:
        return
    x, y, w, h, cls = (f[:, k] for k in (F_X, F_Y, F_W, F_H, F_CLS))
    ibc = cls == K_IBC
    # intrabc copies come clipped to the plane, in sizes of 1 to 64
    bad = np.where(ibc, (w < 1) | (h < 1) | (w > 64) | (h > 64),
                   ~np.isin(w, _SIZES) | ~np.isin(h, _SIZES))
    bad |= (x < 0) | (y < 0) | (x >= pw) | (y >= ph)
    bad |= (cls < K_DC) | (cls > K_IBC)
    sx, sy = f[:, F_DX] + 3, f[:, F_DY] + 3
    bad |= ibc & ((sx < 0) | (sy < 0) | (sx >= pw) | (sy >= ph))
    mi = f[:, F_RES]
    bad |= (mi < 0) | (mi > n_masks)
    bad |= (mi > 0) & ((w > mask_size) | (h > mask_size))
    bad |= (f[:, F_HA] != 0) & (y < 1)
    bad |= (f[:, F_HL] != 0) & (x < 1)
    bad |= (cls == K_FILT) & ((w > 32) | (h > 32))
    cfl = (cls == K_CFL) & (f[:, F_ALPHA] != 0)
    acx, acy, acw, ach = (f[:, k] for k in (F_ACX, F_ACY, F_ACW, F_ACH))
    bad |= cfl & ((acw < 1) | (ach < 1) | (acw * ach > 4096)
                  | (acx < 0) | (acy < 0) | (acx > x) | (acy > y)
                  | (acx + acw > pw) | (acy + ach > ph))
    if np.any(bad):
        raise ValueError(
            f"unit record out of range: {f[np.argmax(bad)].tolist()}")
    if np.any(cfl) and not has_luma:
        raise ValueError("CfL units need the finished luma plane")


# ------------------------------------------------------------- schedule

# (sbh, sbw, spans, order): the luma SB extent; spans [planes, rows *
# cols, 4] int32 holding at r * cols + c, for the rows x cols grid of SBs
# over the luma plane, SB (r, c)'s records [begin, end) and where its
# level order lies in `order`, (offset, levels); order: int32, every
# plane's SBs' level orders (`av1_strip_levels`): an SB's records less
# begin, level by level, then the end of each level in that list.  An SB
# with records and no levels runs them one after another in record
# order (the sequential schedule).  Chroma SB (r, c) covers luma SB (r,
# c): its extent is subsampled.
Schedule = Tuple[int, int, np.ndarray, np.ndarray]


def sb_grid(dims, sbh: int, sbw: int) -> List[Tuple[int, int, int, int]]:
    """(rows, cols, SB height, SB width) of each plane of `dims`."""
    rows, cols = -(-dims[0][0] // sbh), -(-dims[0][1] // sbw)
    return [(rows, cols, sbh >> int(ph < dims[0][0]),
             sbw >> int(pw < dims[0][1])) for ph, pw in dims]


def _levels(fields: Sequence[np.ndarray], dims, grid, spans: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """The planes' level orders (C, `av1_strip_levels`) from their SB
    spans [planes, SBs, 2]: (order, [planes, SBs, 2] each SB's offset into
    order and its levels)."""
    fields = [np.ascontiguousarray(f, np.int32) for f in fields]
    spans = np.ascontiguousarray(spans, np.int32)
    n_pl = len(fields)
    n = np.array([f.shape[0] for f in fields], np.int64)
    # per plane: height, width, SB height, SB width
    ph, pw, sbh, sbw = np.array([(d[0], d[1], g[2], g[3]) for d, g in
                                 zip(dims, grid)], np.int32).T.copy()
    order = np.empty(2 * int(n.sum()), np.int32)
    at = np.empty(spans.shape, np.int32)
    used = nat._load().av1_strip_levels(
        n_pl, (ctypes.c_void_p * n_pl)(*(f.ctypes.data for f in fields)),
        n.ctypes.data, ph.ctypes.data, pw.ctypes.data, sbh.ctypes.data,
        sbw.ctypes.data, grid[0][1], spans.ctypes.data, spans.shape[1],
        order.ctypes.data, at.ctypes.data)
    if used < 0:
        raise MemoryError("av1_strip_levels failed")
    return order[:used], at


def sb_schedule(fields: Sequence[np.ndarray], dims, sb: int) -> Schedule:
    """Each plane's units grouped by the SB that holds their top-left
    pixel, each SB's in level order; sb is 64 or 128 luma pixels.  Raises
    ValueError unless each SB's units are one contiguous run of the
    plane's records (tile columns split SB rows, so a row's SBs need not
    be contiguous with each other) and each unit lies inside its SB, and
    on intrabc units, whose source the wavefront does not order."""
    if any(np.any(f[:, F_CLS] == K_IBC) for f in fields):
        raise ValueError("intrabc units need the sequential schedule")
    grid = sb_grid(dims, sb, sb)
    rows, cols = grid[0][:2]
    spans = np.zeros((len(fields), rows * cols, 4), np.int32)
    for p, (f, (_r, _c, sbh, sbw)) in enumerate(zip(fields, grid)):
        if f.shape[0] == 0:
            continue
        x, y = f[:, F_X], f[:, F_Y]
        out = (x % sbw + f[:, F_W] > sbw) | (y % sbh + f[:, F_H] > sbh)
        if np.any(out):
            raise ValueError(f"plane {p}: unit crosses its SB: "
                             f"{f[np.argmax(out)].tolist()}")
        key = (y // sbh) * cols + x // sbw
        start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        run_keys = key[start]
        if np.unique(run_keys).size != run_keys.size:
            k = np.bincount(run_keys).argmax()
            raise ValueError(f"plane {p}: the units of SB ({k // cols}, "
                             f"{k % cols}) are not contiguous in decode "
                             "order")
        spans[p, run_keys, 0] = start
        spans[p, run_keys, 1] = np.r_[start[1:], key.size]
    order, spans[:, :, 2:] = _levels(fields, dims, grid, spans[:, :, :2])
    return sb, sb, spans, order


def sequential_schedule(fields: Sequence[np.ndarray], dims) -> Schedule:
    """One SB covering each whole plane: every unit in record order."""
    spans = np.array([[[0, f.shape[0], 0, 0]] for f in fields], np.int32)
    return (dims[0][0], dims[0][1], spans.reshape(len(fields), 1, 4),
            np.zeros(0, np.int32))


def schedule_to(schedule: Schedule, device) -> Tuple:
    """A host schedule with its spans and order as tensors on `device`."""
    sbh, sbw, spans, order = schedule
    return (sbh, sbw, torch.from_numpy(spans).to(device),
            torch.from_numpy(order).to(device))


# ---------------------------------------------------------------- plain

def _edge_filter(edge: torch.Tensor, sz: int, strength: int) -> None:
    if strength == 0 or sz <= 1:
        return
    kern = _EDGE_KERNELS[strength - 1]
    start = OFF - 1
    orig = edge[start:start + sz].clone()
    idx = torch.arange(1, sz, device=edge.device)
    acc = torch.zeros(sz - 1, dtype=edge.dtype, device=edge.device)
    for j in range(5):
        acc += kern[j] * orig[torch.clamp(idx - 2 + j, 0, sz - 1)]
    edge[start + 1:start + sz] = (acc + 8) >> 4


def _upsample(edge: torch.Tensor, num: int, mx: int) -> None:
    dup = torch.empty(num + 3, dtype=edge.dtype, device=edge.device)
    dup[0:2] = edge[OFF - 1]
    dup[2:2 + num] = edge[OFF:OFF + num]
    dup[num + 2] = dup[num + 1]
    edge[OFF - 2] = dup[0]
    s = -dup[:num] + 9 * dup[1:num + 1] + 9 * dup[2:num + 2] \
        - dup[3:num + 3]
    edge[OFF - 1:OFF + 2 * num - 1:2] = torch.clamp((s + 8) >> 4, 0, mx)
    edge[OFF:OFF + 2 * num:2] = dup[2:num + 2]


def _interp(edge, b, sh):
    return (edge[OFF + b] * (32 - sh) + edge[OFF + b + 1] * sh + 16) >> 5


def _directional(cls, dx, dy, above, left, w, h, ua, ul):
    dev = above.device
    ii = torch.arange(h, device=dev)[:, None]
    jj = torch.arange(w, device=dev)[None, :]
    if cls == K_Z1:
        max_base = (w + h - 1) << ua
        idx = (ii + 1) * dx
        b = (idx >> (6 - ua)) + jj * (1 << ua)
        sh = (idx * (1 << ua) >> 1) & 0x1F
        v = _interp(above, torch.clamp(b, max=max_base - 1), sh)
        return torch.where(b >= max_base, above[OFF + max_base], v)
    if cls == K_Z3:
        max_base = (w + h - 1) << ul
        idy = (jj + 1) * dy
        b = (idy >> (6 - ul)) + ii * (1 << ul)
        sh = (idy * (1 << ul) >> 1) & 0x1F
        v = _interp(left, torch.clamp(b, max=max_base - 1), sh)
        return torch.where(b >= max_base, left[OFF + max_base], v)
    idx = jj * 64 - (ii + 1) * dx
    b = idx >> (6 - ua)
    va = _interp(above, torch.clamp(b, min=-2),
                 (idx * (1 << ua) >> 1) & 0x1F)
    idy = ii * 64 - (jj + 1) * dy
    vl = _interp(left, torch.clamp(idy >> (6 - ul), min=-2),
                 (idy * (1 << ul) >> 1) & 0x1F)
    return torch.where(b >= -(1 << ua), va, vl)


def _filter_intra(taps, above, left, corner, w, h, mx):
    w9 = torch.zeros((h + 1, w + 1), dtype=above.dtype, device=above.device)
    w9[0, 1:] = above[OFF:OFF + w]
    w9[1:, 0] = left[OFF:OFF + h]
    w9[0, 0] = corner
    for y0 in range(0, h, 2):
        for x0 in range(0, w, 4):
            p = torch.cat([w9[y0, x0:x0 + 5], w9[y0 + 1:y0 + 3, x0]])
            v = ((taps[:, :7] * p[None, :]).sum(1) + 8) >> 4
            w9[y0 + 1:y0 + 3, x0 + 1:x0 + 5] = \
                torch.clamp(v, 0, mx).reshape(2, 4)
    return w9[1:, 1:]


def _ibc(buf, u, w, h, mx):
    """The intrabc copy (jax_exec._scan_kernel p_ibc): a whole-pel
    source at (F_DX + 3, F_DY + 3) through the bilinear taps 3 and 4 of
    the 8-tap window, F_SA/F_SL across and F_UA/F_UL down.  Reads are
    clamped to the plane; a zero tap's pixel weighs nothing."""
    ph, pw = buf.shape
    dev = buf.device
    rows = torch.clamp(u[F_DY] + 3 + torch.arange(h + 1, device=dev), 0,
                       ph - 1)
    cols = torch.clamp(u[F_DX] + 3 + torch.arange(w + 1, device=dev), 0,
                       pw - 1)
    win = buf[rows[:, None], cols[None, :]]
    mid = (u[F_SA] * win[:, :w] + u[F_SL] * win[:, 1:] + 4) >> 3
    return torch.clamp((u[F_UA] * mid[:h] + u[F_UL] * mid[1:] + 1024) >> 11,
                       0, mx)


def _unit(buf, res, luma, u, tabs, bd, masks=None):
    ph, pw = buf.shape
    x, y, w, h, cls, ang = (u[k] for k in (F_X, F_Y, F_W, F_H, F_CLS,
                                           F_ANGLE))
    ha, hl = u[F_HA] != 0, u[F_HL] != 0
    mx = (1 << bd) - 1
    base = 1 << (bd - 1)
    dev = buf.device
    esz = OFF + 2 * (2 * max(w, h) + 1) + 2
    k = torch.arange(esz - OFF, device=dev)

    if ha and hl:
        corner = buf[y - 1, x - 1]
    elif ha:
        corner = buf[y - 1, x]
    elif hl:
        corner = buf[y, x - 1]
    else:
        corner = torch.tensor(base, dtype=buf.dtype, device=dev)
    if ha:
        cols = torch.clamp(x + torch.clamp(k, max=u[F_NA] - 1), max=pw - 1)
        above = torch.cat([torch.zeros(OFF, dtype=buf.dtype, device=dev),
                           buf[y - 1, cols]])
    else:
        fill = buf[y, x - 1] if hl else torch.tensor(base - 1, device=dev)
        above = fill.to(buf.dtype).expand(esz).clone()
    if hl:
        rows = torch.clamp(y + torch.clamp(k, max=u[F_NL] - 1), max=ph - 1)
        left = torch.cat([torch.zeros(OFF, dtype=buf.dtype, device=dev),
                          buf[rows, x - 1]])
    else:
        fill = buf[y - 1, x] if ha else torch.tensor(base + 1, device=dev)
        left = fill.to(buf.dtype).expand(esz).clone()
    above[OFF - 1] = corner
    left[OFF - 1] = corner

    is_dir = cls in (K_Z1, K_Z2, K_Z3)
    ua = int(is_dir and u[F_UA] != 0)
    ul = int(is_dir and u[F_UL] != 0)
    if is_dir:
        if u[F_CF]:
            s = (left[OFF] * 5 + above[OFF - 1] * 6 + above[OFF] * 5
                 + 8) >> 4
            above[OFF - 1] = s
            left[OFF - 1] = s
        if ha:
            _edge_filter(above, u[F_NPXA], u[F_SA])
        if hl:
            _edge_filter(left, u[F_NPXL], u[F_SL])
        if ua:
            _upsample(above, w + (h if ang < 90 else 0), mx)
        if ul:
            _upsample(left, h + (w if ang > 180 else 0), mx)

    A = above[OFF:OFF + w]
    L = left[OFF:OFF + h]
    if cls in (K_DC, K_CFL):
        if ha and hl:
            avg = (A.sum() + L.sum() + ((w + h) >> 1)) // (w + h)
        elif ha:
            avg = (A.sum() + (w >> 1)) // w
        elif hl:
            avg = (L.sum() + (h >> 1)) // h
        else:
            avg = base
        pred = torch.zeros((h, w), dtype=buf.dtype, device=dev) + avg
    elif cls == K_V:
        pred = A[None, :].expand(h, w)
    elif cls == K_H:
        pred = L[:, None].expand(h, w)
    elif is_dir:
        pred = _directional(cls, u[F_DX], u[F_DY], above, left, w, h,
                            ua, ul)
    elif cls in (K_SM, K_SMV, K_SMH):
        sm = tabs["sm_weights"]
        wy = sm[h - 4:2 * h - 4][:, None]
        wx = sm[w - 4:2 * w - 4][None, :]
        below, right = L[h - 1], A[w - 1]
        if cls == K_SM:
            pred = (wy * A[None, :] + (256 - wy) * below
                    + wx * L[:, None] + (256 - wx) * right + 256) >> 9
        elif cls == K_SMV:
            pred = (wy * A[None, :] + (256 - wy) * below + 128) >> 8
        else:
            pred = (wx * L[:, None] + (256 - wx) * right + 128) >> 8
    elif cls == K_PAETH:
        b = A[None, :]
        ll = L[:, None]
        p = b + ll - corner
        pb, pl, pc = (p - b).abs(), (p - ll).abs(), (p - corner).abs()
        pred = torch.where((pl <= pb) & (pl <= pc), ll,
                           torch.where(pb <= pc, b, corner))
    elif cls == K_FILT:
        taps = tabs["filter_intra_taps"][min(max(ang, 0), 4)]
        pred = _filter_intra(taps, above, left, corner, w, h, mx)
    elif cls == K_IBC:
        pred = _ibc(buf, u, w, h, mx)
    else:                       # K_ZERO: palette folded into the residual
        pred = torch.zeros((h, w), dtype=buf.dtype, device=dev)

    alpha = u[F_ALPHA]
    if cls == K_CFL and alpha:
        acx, acy, acw, ach = u[F_ACX], u[F_ACY], u[F_ACW], u[F_ACH]
        blk = luma[2 * acy:2 * acy + 2 * ach, 2 * acx:2 * acx + 2 * acw]
        v = (blk[0::2, 0::2] + blk[0::2, 1::2] + blk[1::2, 0::2]
             + blk[1::2, 1::2]) << 1
        l2 = (acw.bit_length() - 1) + (ach.bit_length() - 1)
        ac = v - ((v.sum() + (1 << max(l2 - 1, 0))) >> l2)
        oy, ox = y - acy, x - acx
        oh, ow = min(h, ach - oy), min(w, acw - ox)
        diff = alpha * ac[oy:oy + oh, ox:ox + ow]
        scaled = torch.sign(diff) * ((diff.abs() + 32) >> 6)
        pred = pred.clone()
        pred[:oh, :ow] = torch.clamp(pred[:oh, :ow] + scaled, 0, mx)

    cw, chh = min(w, pw - x), min(h, ph - y)
    pred = pred[:chh, :cw]
    if u[F_RES] > 0:            # interintra: blend with the base pixels
        mk = masks[u[F_RES] - 1, :chh, :cw]
        pred = (pred * mk + buf[y:y + chh, x:x + cw] * (64 - mk) + 32) >> 6
    buf[y:y + chh, x:x + cw] = torch.clamp(
        pred + res[y:y + chh, x:x + cw], 0, mx)


def strip_exec_plain(fields: torch.Tensor, resid: torch.Tensor,
                     dims: Tuple[int, int], bd: int,
                     luma: Optional[torch.Tensor] = None,
                     base: Optional[torch.Tensor] = None,
                     masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch executor for one plane (any device): fields [n, NF]
    int32, resid [ph, pw] int16, luma [2ph, 2pw] int32 for 4:2:0 CfL,
    base [ph, pw] int32 to reconstruct in place (else a zero plane),
    masks [n, s, s] int32, the interintra stack.  Returns the
    reconstructed [ph, pw] int32 plane."""
    tabs = convert.tables(resid.device)
    buf = base if base is not None else torch.zeros(
        dims, dtype=torch.int32, device=resid.device)
    res = resid.to(torch.int32)
    for u in fields.tolist():
        _unit(buf, res, luma, u, tabs, bd, masks)
    return buf


# -------------------------------------------------------------- wrapper

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_STRIP = _build.Kernel("intra_strip", "intra_strip_frame_launch",
                       [_CI] + [_VP] * 11 + [_CI] * 4 + [_VP] * 3 + [_CI],
                       "intra_wavefront_kernel")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    # the kernel copies 4-byte words asynchronously from each tensor
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device \
            or t.data_ptr() % 4:
        raise ValueError(
            f"{name}: want contiguous, 4-byte aligned {dtype} "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def _is_420(dims) -> bool:
    return len(dims) > 1 and tuple(dims[1]) == (dims[0][0] >> 1,
                                                dims[0][1] >> 1)


def strip_exec_frame_plain(fields: Sequence[torch.Tensor],
                           resid: Sequence[torch.Tensor], dims, bd: int,
                           base: Optional[Sequence[torch.Tensor]] = None,
                           masks: Optional[Sequence] = None
                           ) -> List[torch.Tensor]:
    """The plain version of `strip_exec_frame` (any device): each plane
    in decode order, luma first, chroma CfL reading the finished luma
    when the frame is 4:2:0."""
    outs = []
    for p, (f, r, d) in enumerate(zip(fields, resid, dims)):
        outs.append(strip_exec_plain(
            f, r, d, bd, outs[0] if outs and _is_420(dims) else None,
            base[p] if base is not None else None,
            masks[p] if masks is not None else None))
    return outs


def strip_exec_frame(fields: Sequence[torch.Tensor],
                     resid: Sequence[torch.Tensor], dims, bd: int,
                     schedule: Tuple[int, int, torch.Tensor, torch.Tensor],
                     base: Optional[Sequence[torch.Tensor]] = None,
                     masks: Optional[Sequence] = None
                     ) -> List[torch.Tensor]:
    """Run the executor on all planes of a frame: fields[p] [n_p, NF]
    int32, resid[p] [ph_p, pw_p] int16, dims[p] = (ph_p, pw_p), and a
    schedule (sbh, sbw, spans, order) whose spans and order lie on the
    planes' device.  base[p]: int32 [ph_p, pw_p] planes to reconstruct in
    place (an inter frame's MC planes), else the planes start at zero;
    masks[p]: the plane's interintra stack [n, s, s] int32, or None.
    Chroma CfL reads the finished luma when the frame is 4:2:0.  CPU
    tensors take `strip_exec_frame_plain`, which is sequential and does
    not read the schedule; CUDA tensors launch the kernel once, or raise.
    Each launch counts its units as "strip.units" and its steps as
    "strip.levels" (`trace.counters()`): the levels summed over the SBs,
    a unit each under the sequential schedule."""
    n_pl = len(fields)
    if not 1 <= n_pl == len(resid) == len(dims) <= 3:
        raise ValueError("one to three planes, each with fields, residual "
                         "and dims")
    dims = [tuple(int(v) for v in d) for d in dims]
    dev = resid[0].device
    if not _build.on_card(resid[0]):
        return strip_exec_frame_plain(fields, resid, dims, bd, base, masks)
    sbh, sbw, spans, order = schedule
    grid = sb_grid(dims, sbh, sbw)
    rows, cols = grid[0][:2]
    masks = list(masks) if masks is not None else [None] * n_pl
    for p, (f, r, d) in enumerate(zip(fields, resid, dims)):
        _check(f, f"fields[{p}]", torch.int32, (f.shape[0], NF), dev)
        _check(r, f"resid[{p}]", torch.int16, d, dev)
        if base is not None:
            _check(base[p], f"base[{p}]", torch.int32, d, dev)
        if masks[p] is not None:
            m = masks[p]
            _check(m, f"masks[{p}]", torch.int32,
                   (m.shape[0], m.shape[1], m.shape[1]), dev)
    _check(spans, "spans", torch.int32, (n_pl, rows * cols, 4), dev)
    _check(order, "order", torch.int32, (order.numel(),), dev)
    outs = list(base) if base is not None else [
        torch.zeros(d, dtype=torch.int32, device=dev) for d in dims]
    cfl = _is_420(dims)
    counters = torch.zeros(1 + n_pl * rows, dtype=torch.int32, device=dev)
    tabs = convert.tables(dev)
    ptrs = ctypes.c_void_p * n_pl
    ints = ctypes.c_int * n_pl
    _STRIP.launch(
        dev, n_pl, ptrs(*(f.data_ptr() for f in fields)),
        ptrs(*(r.data_ptr() for r in resid)),
        ptrs(*(o.data_ptr() for o in outs)),
        ptrs(*(spans[p].data_ptr() for p in range(n_pl))),
        order.data_ptr(),
        ints(*(d[0] for d in dims)), ints(*(d[1] for d in dims)),
        ints(*(g[2] for g in grid)), ints(*(g[3] for g in grid)),
        ptrs(*(m.data_ptr() if m is not None else 0 for m in masks)),
        ints(*(m.shape[1] if m is not None else 0 for m in masks)),
        rows, cols, int(cfl),
        # the scan's units need a sequential schedule or masks
        int(rows * cols == 1 or any(m is not None for m in masks)),
        counters.data_ptr(),
        tabs["sm_weights"].data_ptr(),
        tabs["filter_intra_taps"].data_ptr(), bd)
    units = sum(f.shape[0] for f in fields)
    trace.count("strip.units", units)
    # the order holds each SB's units and the end of each of its levels
    trace.count("strip.levels",
                order.numel() - units if order.numel() else units)
    return outs
