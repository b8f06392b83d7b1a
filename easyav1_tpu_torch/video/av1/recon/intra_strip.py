"""Intra strip executor: the counterpart of `intra_pallas.py`.

Replays one plane's pred-unit records, as `jax_exec.preprocess_units(
units, dims, pad=0)` lays them out, in decode order with
`exec_ref.UnitExecutor._unit` semantics, into an int32 plane of the
mi-aligned dims.

- `strip_exec_plain`: the plain torch version, one unit at a time.
- `strip_exec`: the wrapper.  For CPU tensors it runs the plain version;
  for CUDA tensors it launches `csrc/intra_strip.cu` (one CTA per plane,
  luma alone or U and V together) or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from easyav1_tpu.video.av1.recon.jax_exec import (
    F_ACH, F_ACW, F_ACX, F_ACY, F_ALPHA, F_ANGLE, F_CF, F_CLS, F_DX, F_DY,
    F_H, F_HA, F_HL, F_NA, F_NL, F_NPXA, F_NPXL, F_SA, F_SL, F_UA, F_UL,
    F_W, F_X, F_Y, K_CFL, K_DC, K_FILT, K_H, K_PAETH, K_SM, K_SMH, K_SMV,
    K_V, K_Z1, K_Z2, K_Z3, NF)
from easyav1_tpu_torch import convert

OFF = 2                       # edge slot of the first pixel (exec_ref.OFF)
_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
_SIZES = (4, 8, 16, 32, 64)


def check_units(fields: np.ndarray, dims: Tuple[int, int],
                has_luma: bool) -> None:
    """Raise ValueError on records the executor cannot take (host-side,
    before upload: the kernel indexes the plane with these numbers)."""
    ph, pw = dims
    f = fields
    if f.ndim != 2 or f.shape[1] != NF:
        raise ValueError(f"unit fields must be [n, {NF}], got {f.shape}")
    if f.shape[0] == 0:
        return
    x, y, w, h, cls = (f[:, k] for k in (F_X, F_Y, F_W, F_H, F_CLS))
    bad = ~np.isin(w, _SIZES) | ~np.isin(h, _SIZES)
    bad |= (x < 0) | (y < 0) | (x >= pw) | (y >= ph)
    bad |= (cls < K_DC) | (cls > K_FILT)
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


def _unit(buf, res, luma, u, tabs, bd):
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
    buf[y:y + chh, x:x + cw] = torch.clamp(
        pred[:chh, :cw] + res[y:y + chh, x:x + cw], 0, mx)


def strip_exec_plain(fields: torch.Tensor, resid: torch.Tensor,
                     dims: Tuple[int, int], bd: int,
                     luma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch executor for one plane (any device): fields [n, NF]
    int32, resid [ph, pw] int16, luma [2ph, 2pw] int32 for 4:2:0 CfL.
    Returns the reconstructed [ph, pw] int32 plane."""
    tabs = convert.tables(resid.device)
    buf = torch.zeros(dims, dtype=torch.int32, device=resid.device)
    res = resid.to(torch.int32)
    for u in fields.tolist():
        _unit(buf, res, luma, u, tabs, bd)
    return buf


# -------------------------------------------------------------- wrapper

def _lib():
    from easyav1_tpu_torch import _build
    lib = _build.load("intra_strip")
    if lib.intra_strip_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.intra_strip_launch.restype = ci
        lib.intra_strip_launch.argtypes = [
            ci, vp, ci, vp, vp, vp, ci, vp, vp, ci, ci, vp, vp, vp, ci, vp]
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def strip_exec(fields: Sequence[torch.Tensor],
               resid: Sequence[torch.Tensor], dims: Tuple[int, int],
               bd: int, luma: Optional[torch.Tensor] = None
               ) -> List[torch.Tensor]:
    """Run the executor on one or two planes of the same dims (luma
    alone, or U and V with `luma` the finished luma plane for CfL).
    CPU tensors take `strip_exec_plain`; CUDA tensors launch the kernel
    once for all planes given, or raise."""
    if not 1 <= len(fields) == len(resid) <= 2:
        raise ValueError("one or two planes per call")
    dev = resid[0].device
    if dev.type == "cpu":
        return [strip_exec_plain(f, r, dims, bd, luma)
                for f, r in zip(fields, resid)]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ph, pw = dims
    for p, (f, r) in enumerate(zip(fields, resid)):
        _check(f, f"fields[{p}]", torch.int32, (f.shape[0], NF), dev)
        _check(r, f"resid[{p}]", torch.int16, dims, dev)
    if luma is not None:
        _check(luma, "luma", torch.int32, (2 * ph, 2 * pw), dev)
    outs = [torch.zeros(dims, dtype=torch.int32, device=dev)
            for _ in fields]
    tabs = convert.tables(dev)
    args = [(f.data_ptr(), f.shape[0], r.data_ptr(), o.data_ptr())
            for f, r, o in zip(fields, resid, outs)]
    if len(args) == 1:
        args.append((None, 0, None, None))
    with torch.cuda.device(dev):
        rc = _lib().intra_strip_launch(
            len(fields), *args[0], *args[1], ph, pw,
            luma.data_ptr() if luma is not None else None,
            tabs["sm_weights"].data_ptr(),
            tabs["filter_intra_taps"].data_ptr(), bd,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"intra_strip launch failed: cudaError {rc}")
    strip_exec.launches += 1
    return outs


strip_exec.launches = 0
