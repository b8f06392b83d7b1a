"""Deblocking loop filter as exact int32 torch ops: the counterpart of
`lf_jax._pass_body` (`lf_jax.py:27-187`).

Within one pass every edge's read window is disjoint from every other
edge's write window, so all edges of the pass filter at once from the
pre-pass pixels.  Edges sit on the 4 px grid, so each tap is a strided
view of the padded plane.  The horizontal pass runs on the transposed
plane.  Leading dimensions are independent planes (a stream axis): the
pass filters them all with the same operations as one plane.

The maps come as the decoder makes them: uint8 edge sizes and levels,
one map row a 4x4-cell row of lines (or one a line: seeded maps), and a
64-entry (limit, blimit, thresh) LUT over the level.  `expand_maps`
makes the per-line int32 maps `pass_body` takes (what the JAX package's
jit does with its cell maps, `postfilter_fused.py:64-70`).

`lf_launch` is what the postfilter calls: every plane of a frame, both
directions, on CUDA tensors in one launch of the hand-written kernel
`csrc/loopfilter.cu` (built by nvcc at first use), or raises; on CPU
tensors it takes `lf_frame_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

from easyav1_tpu_torch import _build

PAD = 8


def pass_body(buf: torch.Tensor, size_m: torch.Tensor, limit: torch.Tensor,
              blimit: torch.Tensor, thresh: torch.Tensor,
              bd: int) -> torch.Tensor:
    """One vertical-edge pass over [..., H, W] int32 planes.  Edge e sits
    at x = 4(e+1); size_m, limit, blimit, thresh are [..., H, ne] int32
    maps (size 0 = inactive, else the filter length 4, 6, 8 or 14)."""
    *lead, H, W = buf.shape
    ne = (W + 3) // 4 - 1
    if ne <= 0:
        return buf
    F = 1 << (bd - 8)
    half = 1 << (bd - 1)
    mxv = (1 << bd) - 1
    B = torch.zeros((*lead, H, W + 2 * PAD), dtype=torch.int32,
                    device=buf.device)
    B[..., PAD:PAD + W] = buf
    span = 4 * (ne - 1) + 1

    def lanes(off):
        s = PAD + 4 + off
        return B[..., s:s + span:4]

    # taps P[k] at x-1-k, Q[k] at x+k, snapshotted before any write
    P = [lanes(-1 - k).clone() for k in range(7)]
    Q = [lanes(k).clone() for k in range(7)]
    p0, p1, p2, p3 = P[:4]
    q0, q1, q2, q3 = Q[:4]
    a = torch.abs
    sz = size_m

    mask = ((a(p1 - p0) <= limit) & (a(q1 - q0) <= limit)
            & (a(p0 - q0) * 2 + (a(p1 - q1) >> 1) <= blimit))
    mask6 = (a(p2 - p1) <= limit) & (a(q2 - q1) <= limit)
    mask8 = (a(p3 - p2) <= limit) & (a(q3 - q2) <= limit)
    mask = mask & (mask6 | (sz < 6)) & (mask8 | (sz < 8)) & (sz > 0)

    flat = ((a(p1 - p0) <= F) & (a(q1 - q0) <= F)
            & (a(p2 - p0) <= F) & (a(q2 - q0) <= F))
    flat = flat & (((a(p3 - p0) <= F) & (a(q3 - q0) <= F)) | (sz < 8))
    flat2 = ((a(P[4] - p0) <= F) & (a(Q[4] - q0) <= F)
             & (a(P[5] - p0) <= F) & (a(Q[5] - q0) <= F)
             & (a(P[6] - p0) <= F) & (a(Q[6] - q0) <= F))

    use14 = mask & (sz == 14) & flat & flat2
    use8 = mask & (sz >= 8) & flat & ~use14
    use6 = mask & (sz == 6) & flat
    use4 = mask & ~(use14 | use8 | use6)

    pv, qv = P, Q
    f14 = {
        -6: (pv[6] * 7 + pv[5] * 2 + pv[4] * 2 + pv[3] + pv[2] + pv[1]
             + pv[0] + qv[0] + 8) >> 4,
        -5: (pv[6] * 5 + pv[5] * 2 + pv[4] * 2 + pv[3] * 2 + pv[2] + pv[1]
             + pv[0] + qv[0] + qv[1] + 8) >> 4,
        -4: (pv[6] * 4 + pv[5] + pv[4] * 2 + pv[3] * 2 + pv[2] * 2 + pv[1]
             + pv[0] + qv[0] + qv[1] + qv[2] + 8) >> 4,
        -3: (pv[6] * 3 + pv[5] + pv[4] + pv[3] * 2 + pv[2] * 2 + pv[1] * 2
             + pv[0] + qv[0] + qv[1] + qv[2] + qv[3] + 8) >> 4,
        -2: (pv[6] * 2 + pv[5] + pv[4] + pv[3] + pv[2] * 2 + pv[1] * 2
             + pv[0] * 2 + qv[0] + qv[1] + qv[2] + qv[3] + qv[4] + 8) >> 4,
        -1: (pv[6] + pv[5] + pv[4] + pv[3] + pv[2] + pv[1] * 2 + pv[0] * 2
             + qv[0] * 2 + qv[1] + qv[2] + qv[3] + qv[4] + qv[5] + 8) >> 4,
        0: (pv[5] + pv[4] + pv[3] + pv[2] + pv[1] + pv[0] * 2 + qv[0] * 2
            + qv[1] * 2 + qv[2] + qv[3] + qv[4] + qv[5] + qv[6] + 8) >> 4,
        1: (pv[4] + pv[3] + pv[2] + pv[1] + pv[0] + qv[0] * 2 + qv[1] * 2
            + qv[2] * 2 + qv[3] + qv[4] + qv[5] + qv[6] * 2 + 8) >> 4,
        2: (pv[3] + pv[2] + pv[1] + pv[0] + qv[0] + qv[1] * 2 + qv[2] * 2
            + qv[3] * 2 + qv[4] + qv[5] + qv[6] * 3 + 8) >> 4,
        3: (pv[2] + pv[1] + pv[0] + qv[0] + qv[1] + qv[2] * 2 + qv[3] * 2
            + qv[4] * 2 + qv[5] + qv[6] * 4 + 8) >> 4,
        4: (pv[1] + pv[0] + qv[0] + qv[1] + qv[2] + qv[3] * 2 + qv[4] * 2
            + qv[5] * 2 + qv[6] * 5 + 8) >> 4,
        5: (pv[0] + qv[0] + qv[1] + qv[2] + qv[3] + qv[4] * 2 + qv[5] * 2
            + qv[6] * 7 + 8) >> 4,
    }
    f8 = {
        -3: (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
        -2: (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
        -1: (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
        0: (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
        1: (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
        2: (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3,
    }
    f6 = {
        -2: (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3,
        -1: (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3,
        0: (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3,
        1: (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3,
    }

    def cl(v):
        return torch.clamp(v, -half, half - 1)

    ps1, ps0 = p1 - half, p0 - half
    qs0, qs1 = q0 - half, q1 - half
    hev = (a(p1 - p0) > thresh) | (a(q1 - q0) > thresh)
    f = torch.where(hev, cl(ps1 - qs1), torch.zeros_like(ps1))
    f = cl(f + 3 * (qs0 - ps0))
    f1 = cl(f + 4) >> 3
    f2 = cl(f + 3) >> 3
    f3 = (f1 + 1) >> 1
    f4 = {
        0: torch.clamp(cl(qs0 - f1) + half, 0, mxv),
        -1: torch.clamp(cl(ps0 + f2) + half, 0, mxv),
        1: torch.clamp(cl(qs1 - f3) + half, 0, mxv),
        -2: torch.clamp(cl(ps1 + f3) + half, 0, mxv),
    }
    f4w = {0: use4, -1: use4, 1: use4 & ~hev, -2: use4 & ~hev}

    # the lanes of neighbouring edges alias across offsets, so each write
    # is masked to the lanes a filter touches; no lane has two writers
    for off in range(-6, 6):
        v = P[-1 - off] if off < 0 else Q[off]
        wm = use14
        if off in f4:
            v = torch.where(f4w[off], f4[off], v)
            wm = wm | f4w[off]
        if off in f6:
            v = torch.where(use6, f6[off], v)
            wm = wm | use6
        if off in f8:
            v = torch.where(use8, f8[off], v)
            wm = wm | use8
        v = torch.where(use14, f14[off], v)
        cur = lanes(off)
        cur.copy_(torch.where(wm, v, cur))
    return B[..., PAD:PAD + W]


def map_shift(rows: int, lines: int) -> int:
    """The map-row shift of a deblocking map of `rows` rows over `lines`
    pixel lines: 0 for one row a line, 2 for one row a 4x4-cell row."""
    if rows == lines:
        return 0
    if rows == (lines + 3) >> 2:
        return 2
    raise ValueError(f"a map of {rows} rows covers neither the {lines} "
                     f"lines nor their {(lines + 3) >> 2} cell rows")


def expand_maps(size: torch.Tensor, level: torch.Tensor, lut: torch.Tensor,
                lines: int):
    """(size [..., lines, ne], lim [..., 3, lines, ne]) int32, one row a
    pixel line as `pass_body` takes them, from the uint8 size and level
    maps [..., R, ne] (R = lines, or the cell rows (lines + 3) // 4) and
    the int32 (limit, blimit, thresh) LUT [..., 3, 64] over the level."""
    rows, ne = size.shape[-2:]
    rep = 1 << map_shift(rows, lines)
    idx = level.long().flatten(-2).unsqueeze(-2).expand(
        *level.shape[:-2], 3, rows * ne)
    lim = torch.gather(lut, -1, idx).reshape(*level.shape[:-2], 3, rows, ne)
    size = size.to(torch.int32)
    if rep > 1:
        size = size.repeat_interleave(rep, -2)[..., :lines, :]
        lim = lim.repeat_interleave(rep, -2)[..., :lines, :]
    return size, lim


def lf_pass_plain(buf: torch.Tensor, size: torch.Tensor, level: torch.Tensor,
                  lut: torch.Tensor, bd: int,
                  horizontal: bool = False) -> torch.Tensor:
    """One deblocking pass as plain torch ops on any device: `pass_body`
    on the maps `expand_maps` makes, on the transposed plane for the
    horizontal edges."""
    H, W = buf.shape[-2:]
    size_m, lim = expand_maps(size, level, lut, W if horizontal else H)
    if horizontal:
        return pass_body(buf.transpose(-1, -2), size_m, *lim.unbind(-3),
                         bd).transpose(-1, -2)
    return pass_body(buf, size_m, *lim.unbind(-3), bd)


def lf_frame_plain(planes: List[torch.Tensor], maps: List[Optional[Dict]],
                   bd: int) -> List[torch.Tensor]:
    """`lf_launch` as plain torch ops on any device: each plane with maps
    through the vertical pass, then the horizontal one."""
    out = list(planes)
    for p, m in enumerate(maps):
        if m is not None:
            buf = lf_pass_plain(out[p], m["sv"], m["lv"], m["lut"], bd)
            out[p] = lf_pass_plain(buf, m["sh"], m["lh"], m["lut"], bd, True)
    return out


_LF = _build.Kernel("loopfilter", "lf_frame_launch",
                    [ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                     ctypes.c_int, ctypes.c_int], "lf_frame_kernel")


def _check(planes, maps):
    """The shapes and dtypes `lf_launch` takes; returns the map-row
    shifts (vertical, horizontal) of each plane with maps."""
    shifts = {}
    lead = planes[0].shape[:-2] if planes else ()
    for p, (buf, m) in enumerate(zip(planes, maps)):
        if m is None:
            continue
        *ld, H, W = buf.shape
        nev, neh = max((W + 3) // 4 - 1, 0), max((H + 3) // 4 - 1, 0)
        sv, sh = m["sv"].shape[-2:], m["sh"].shape[-2:]
        ok = (buf.dtype == torch.int32 and 2 <= buf.dim() <= 3
              and tuple(ld) == tuple(lead) and len(sv) == len(sh) == 2
              and sv[1] == nev and sh[1] == neh
              and all(m[k].dtype == torch.uint8
                      and tuple(m[k].shape) == (*ld, *(sv if k[1] == "v"
                                                       else sh))
                      for k in ("sv", "lv", "sh", "lh"))
              and m["lut"].dtype == torch.int32
              and tuple(m["lut"].shape) == (*ld, 3, 64))
        if not ok:
            raise ValueError(
                f"plane {p}: want int32 planes [..., H, W] with uint8 maps "
                f"[..., R, {nev}] (sv, lv), [..., R, {neh}] (sh, lh) and an "
                f"int32 LUT [..., 3, 64], got {buf.dtype} "
                f"{tuple(buf.shape)} and " + ", ".join(
                    f"{k} {m[k].dtype} {tuple(m[k].shape)}"
                    for k in ("sv", "lv", "sh", "lh", "lut")))
        shifts[p] = (map_shift(sv[0], H), map_shift(sh[0], W))
    return shifts


def lf_launch(planes: List[torch.Tensor], maps: List[Optional[Dict]],
              bd: int) -> List[torch.Tensor]:
    """Deblocking of a frame's planes ([..., H, W] int32, at most one
    leading stream axis, samples in [0, 2^bd)): the vertical edges, then
    the horizontal ones, of each plane whose `maps` entry is not None:
    {"sv", "lv": uint8 [..., R, nev] edge sizes and levels of the vertical
    edges, R = H or (H + 3) // 4; "sh", "lh": [..., R, neh] of the
    horizontal ones, R = W or (W + 3) // 4, one row a pixel column or a
    cell column; "lut": int32 [..., 3, 64] (limit, blimit, thresh) by
    level}.  CUDA tensors (contiguous) launch `csrc/loopfilter.cu` once
    for all of them into new planes, or raise; CPU tensors take
    `lf_frame_plain`.  A plane without maps is returned as it is; no
    input is written."""
    planes = list(planes)
    shifts = _check(planes, maps)
    if not shifts:
        return planes
    on = sorted(shifts)
    tensors = [t for p in on for t in
               [planes[p]] + [maps[p][k] for k in ("sv", "lv", "sh", "lh",
                                                   "lut")]]
    if not _build.on_card(planes[on[0]], tensors):
        return lf_frame_plain(planes, maps, bd)
    out = list(planes)
    ptrs, dims = [], []
    for p in on:
        out[p] = torch.empty_like(planes[p])
        m = maps[p]
        ptrs += [planes[p].data_ptr(), out[p].data_ptr()] + [
            m[k].data_ptr() for k in ("sv", "lv", "sh", "lh", "lut")]
        dims += [*planes[p].shape[-2:], *shifts[p]]
    lead = planes[on[0]].shape[:-2]
    _LF.launch(planes[on[0]].device, (ctypes.c_void_p * len(ptrs))(*ptrs),
               (ctypes.c_int * len(dims))(*dims), len(on),
               lead[0] if lead else 1, bd)
    return out
