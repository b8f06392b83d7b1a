"""Motion compensation on the device: the counterparts of `mc_jax`'s MC
kernels (`_mc_single_kernel`, `_mc_pair_kernel`, `_mc_warp_kernel`,
`_obmc_overlay_kernel`, `_obmc_resid_kernel`; `mc_jax.py:636-867`).

The units are `mc_plan.export_inter_plan`'s, bucketed by (plane, w, h).
Planes are int32, unpadded and mi-aligned; every write and every
residual read is clipped to the plane, and a unit whose valid field is 0
writes nothing.  Reference windows clamp to the reference's logical
width and height, which are its tensor's: `refs[p]` holds plane p of
each used reference slot, in the plan's dense slot order, as a uint8
[rh, rw] tensor.

- `mc_single`, `mc_pair`, `mc_warp`, `obmc_overlay`, `obmc_resid`: the
  plain torch versions, vectorised over the units of one bucket.
- `mc_units`: every plane's single, pair and warp units of a frame, in
  place.  CPU tensors take `mc_units_plain`; CUDA tensors launch kernel
  6a of `csrc/inter_mc.cu` once (`mc_launch`, on the host's tile tables
  `mc_tables`), or raise.
- `obmc`: the OBMC passes of a frame, in place: above overlays, left
  overlays, then the deferred residual over the OBMC blocks, in the
  reference's order.  CPU tensors take `obmc_plain`; CUDA tensors launch
  kernel 6b once for each pass that has units (`obmc_launch`, on
  `obmc_tables`), or raise.
- `mc_launch.launches`, `obmc_launch.launches`: the kernels' launch
  counts.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np
import torch

from easyav1_tpu_torch import convert
from easyav1_tpu_torch.video.av1.recon.mc_plan import (
    NPR, NS, NW, P_MIDX, P_MODE, P_PRED0, P_PRED1, P_VALID, P_W0, P_W1, P_X,
    P_Y, S_FH, S_FV, S_IX, S_IY, S_NORES, S_SLOT, S_VALID, S_X, S_Y, W_ALPHA,
    W_BETA, W_DELTA, W_GAMMA, W_IX4, W_IY4, W_SLOT, W_SX4, W_SY4, W_VALID,
    W_X, W_Y)

TILE = 16                 # output tile of a CTA (warps: their 8x8)
# tile record: kind, plane, unit row, unit w, unit h, x and y offset of
# the tile in its unit, and for pairs the offset of the bucket's masks
NT = 8
K_SINGLE, K_PAIR, K_WARP, K_OVERLAY, K_RESID = range(5)


# ---------------------------------------------------------------- plain

def _rect(f, xcol, ycol, w, h, shape):
    """Output coordinates [n, h, w] of units at (f[:, xcol], f[:, ycol]),
    and the mask of those inside the plane."""
    dev = f.device
    yy = f[:, ycol, None, None] + torch.arange(h, device=dev)[None, :, None]
    xx = f[:, xcol, None, None] + torch.arange(w, device=dev)[None, None, :]
    yy, xx = torch.broadcast_tensors(yy, xx)
    return yy, xx, (yy < shape[0]) & (xx < shape[1])


def _read(t, yy, xx):
    return t[yy.clamp(max=t.shape[0] - 1), xx.clamp(max=t.shape[1] - 1)] \
        .to(torch.int64)


def _store(plane, yy, xx, keep, out):
    plane[yy[keep], xx[keep]] = out[keep].to(plane.dtype)


def _subpel(refstk, slot, ix, iy, fh8, fv8, w, h):
    """The two 8-tap passes over each unit's (h + 7) x (w + 7) window,
    clamped to the reference: (accH + 4) >> 3, then the vertical sum
    accV [n, h, w] before its final rounding."""
    rh, rw = refstk.shape[1:]
    dev = refstk.device
    rows = torch.clamp(iy[:, None] - 3 + torch.arange(h + 7, device=dev),
                       0, rh - 1)
    cols = torch.clamp(ix[:, None] - 3 + torch.arange(w + 7, device=dev),
                       0, rw - 1)
    win = refstk[slot[:, None, None], rows[:, :, None],
                 cols[:, None, :]].to(torch.int64)
    acc = sum(win[:, :, t:t + w] * fh8[:, t, None, None] for t in range(8))
    m = (acc + 4) >> 3
    return sum(m[:, t:t + h, :] * fv8[:, t, None, None] for t in range(8))


def _single_pred(refstk, f, w, h, mx):
    acc = _subpel(refstk, f[:, S_SLOT], f[:, S_IX], f[:, S_IY],
                  f[:, S_FH:S_FH + 8], f[:, S_FV:S_FV + 8], w, h)
    return torch.clamp((acc + 1024) >> 11, 0, mx)


def mc_single(plane, resid, refstk, f, w, h, bd):
    """Single-reference units f [n, NS] of one (w, h) bucket into plane
    [ph, pw] int32, in place: clip((accV + 1024) >> 11), plus the
    residual unless the unit's nores is set.  refstk [ns, rh, rw]."""
    f = f.to(torch.int64)
    mx = (1 << bd) - 1
    v = _single_pred(refstk, f, w, h, mx)
    yy, xx, keep = _rect(f, S_X, S_Y, w, h, plane.shape)
    out = torch.where((f[:, S_NORES] != 0)[:, None, None], v,
                      torch.clamp(v + _read(resid, yy, xx), 0, mx))
    _store(plane, yy, xx, keep & (f[:, S_VALID] != 0)[:, None, None], out)
    return plane


def mc_pair(plane, resid, refstk, f, masks, w, h, bd):
    """Compound units f [n, NPR] of one bucket, in place: each
    prediction at (accV + 64) >> 7, then the weight blend
    (p0 w0 + p1 w1 + 128) >> 8 or, for blend mode 1, the mask blend
    (p0 m + p1 (64 - m) + 512) >> 10 with m = masks[P_MIDX] [h, w];
    clipped, plus the residual."""
    f = f.to(torch.int64)
    mx = (1 << bd) - 1

    def pred(b):
        acc = _subpel(refstk, f[:, b], f[:, b + 1], f[:, b + 2],
                      f[:, b + 3:b + 11], f[:, b + 11:b + 19], w, h)
        return (acc + 64) >> 7

    p0, p1 = pred(P_PRED0), pred(P_PRED1)
    vw = (p0 * f[:, P_W0, None, None] + p1 * f[:, P_W1, None, None]
          + 128) >> 8
    m = masks.to(torch.int64)[f[:, P_MIDX]]
    vm = (p0 * m + p1 * (64 - m) + 512) >> 10
    v = torch.clamp(torch.where((f[:, P_MODE] == 1)[:, None, None], vm, vw),
                    0, mx)
    yy, xx, keep = _rect(f, P_X, P_Y, w, h, plane.shape)
    out = torch.clamp(v + _read(resid, yy, xx), 0, mx)
    _store(plane, yy, xx, keep & (f[:, P_VALID] != 0)[:, None, None], out)
    return plane


def mc_warp(plane, resid, refstk, f, wf, bd):
    """Affine warp units f [n, NW], one 8x8 output each, in place: the
    15 x 15 window, per-pixel phases of `warped_filter` wf [193, 8],
    (acc + 4) >> 3 across, clip((acc + 1024) >> 11) down, plus the
    residual."""
    f = f.to(torch.int64)
    wf = wf.to(torch.int64)
    mx = (1 << bd) - 1
    rh, rw = refstk.shape[1:]
    dev = refstk.device
    ar15 = torch.arange(15, device=dev)
    rows = torch.clamp(f[:, W_IY4, None] - 7 + ar15, 0, rh - 1)
    cols = torch.clamp(f[:, W_IX4, None] - 7 + ar15, 0, rw - 1)
    win = refstk[f[:, W_SLOT, None, None], rows[:, :, None],
                 cols[:, None, :]].to(torch.int64)
    kk = ar15[None, :, None]
    ll = torch.arange(8, device=dev)[None, None, :]

    def par(c):
        return f[:, c, None, None]

    offs_h = ((par(W_SX4) + par(W_BETA) * (kk - 3) + par(W_ALPHA) * ll
               + 512) >> 10) + 64
    ch = wf[offs_h]                                   # [n, 15, 8, 8]
    tmp = sum(win[:, :, m:m + 8] * ch[..., m] for m in range(8))
    tmp = (tmp + 4) >> 3
    k2 = torch.arange(8, device=dev)[None, :, None]
    offs_v = ((par(W_SY4) + par(W_DELTA) * k2 + par(W_GAMMA) * ll
               + 512) >> 10) + 64
    cv = wf[offs_v]                                   # [n, 8, 8, 8]
    acc = sum(tmp[:, m:m + 8, :] * cv[..., m] for m in range(8))
    v = torch.clamp((acc + 1024) >> 11, 0, mx)
    yy, xx, keep = _rect(f, W_X, W_Y, 8, 8, plane.shape)
    out = torch.clamp(v + _read(resid, yy, xx), 0, mx)
    _store(plane, yy, xx, keep & (f[:, W_VALID] != 0)[:, None, None], out)
    return plane


def obmc_overlay(plane, refstk, f, w, h, bd, left, masks):
    """One OBMC overlay pass over units f [n, NS] of one bucket, in
    place: the neighbour's single prediction of the overlap rect, and
    the plane blended toward it, (m cur + (64 - m) v + 32) >> 6, with
    the raised-cosine mask m of the rect's height by row (above pass) or
    of its width by column (left pass); masks: `convert`'s obmc_masks."""
    f = f.to(torch.int64)
    v = _single_pred(refstk, f, w, h, (1 << bd) - 1)
    n = w if left else h
    mk = masks[n - 2:2 * n - 2].to(torch.int64)
    mk = mk[None, None, :] if left else mk[None, :, None]
    yy, xx, keep = _rect(f, S_X, S_Y, w, h, plane.shape)
    out = (mk * _read(plane, yy, xx) + (64 - mk) * v + 32) >> 6
    _store(plane, yy, xx, keep & (f[:, S_VALID] != 0)[:, None, None], out)
    return plane


def obmc_resid(plane, resid, rects, w, h, bd):
    """The deferred residual over OBMC blocks, in place: rects [n, 2]
    (x, y) of one (w, h) bucket, clip(plane + residual)."""
    rects = rects.to(torch.int64)
    yy, xx, keep = _rect(rects, 0, 1, w, h, plane.shape)
    out = torch.clamp(_read(plane, yy, xx) + _read(resid, yy, xx), 0,
                      (1 << bd) - 1)
    _store(plane, yy, xx, keep, out)
    return plane


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def mc_units_plain(planes: List[torch.Tensor], resid, refs, plan: Dict,
                   bd: int) -> List[torch.Tensor]:
    """The plain version of `mc_units` (any device): the plan's single,
    pair and warp buckets in the reference's order, in place."""
    dev = planes[0].device
    stk = [torch.stack(list(r)) if r else None for r in refs]
    for (p, w, h), f in sorted(plan["singles"].items()):
        mc_single(planes[p], resid[p], stk[p], _t(f, dev), w, h, bd)
    for (p, w, h), f in sorted(plan["pairs"].items()):
        masks = plan["pair_masks"].get((p, w, h))
        if masks is None:
            masks = np.zeros((1, h, w), np.int32)
        mc_pair(planes[p], resid[p], stk[p], _t(f, dev), _t(masks, dev),
                w, h, bd)
    wf = convert.tables(dev)["warped_filter"]
    for p, f in sorted(plan["warps"].items()):
        mc_warp(planes[p], resid[p], stk[p], _t(f, dev), wf, bd)
    return planes


def obmc_plain(planes: List[torch.Tensor], resid, refs, plan: Dict,
               bd: int) -> List[torch.Tensor]:
    """The plain version of `obmc` (any device), in place."""
    dev = planes[0].device
    stk = [torch.stack(list(r)) if r else None for r in refs]
    masks = convert.tables(dev)["obmc_masks"]
    for name, left in (("obmc_above", False), ("obmc_left", True)):
        for (p, w, h), f in sorted(plan[name].items()):
            obmc_overlay(planes[p], stk[p], _t(f, dev), w, h, bd, left,
                         masks)
    for (p, w, h), rects in sorted(plan["obmc_resid"].items()):
        obmc_resid(planes[p], resid[p], _t(rects, dev), w, h, bd)
    return planes


# ---------------------------------------------------------- tile tables

def _tiles(kind, plane, w, h, n, first, moff=0):
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


def _table(buckets, kind, width, tiles, stacks=None, masks=None):
    """The units of `buckets` {(plane, w, h) or plane: [n, width]},
    concatenated in sorted order, and their tiles appended to `tiles`;
    for pairs, each bucket's mask stack (`stacks`, the plan's
    pair_masks) appended flat to `masks`, its tiles carrying the
    offset."""
    rows, first = [], 0
    for key in sorted(buckets):
        f = buckets[key]
        p, w, h = key if isinstance(key, tuple) else (key, 8, 8)
        moff = 0
        if masks is not None:
            moff = sum(m.size for m in masks)
            masks.append(np.ascontiguousarray(
                stacks.get(key, np.zeros((1, h, w))), np.int32).ravel())
        tiles.append(_tiles(kind, p, w, h, f.shape[0], first, moff))
        rows.append(np.asarray(f, np.int32).reshape(-1, width))
        first += f.shape[0]
    return (np.concatenate(rows) if rows
            else np.zeros((0, width), np.int32))


def mc_tables(plan: Dict) -> Dict[str, np.ndarray]:
    """Kernel 6a's host tables of a plan: "tiles" [T, NT], "singles"
    [n, NS], "pairs" [n, NPR], "warps" [n, NW] and "masks" (the pair
    buckets' mask stacks, flat), int32."""
    tiles, masks = [], []
    out = {"singles": _table(plan["singles"], K_SINGLE, NS, tiles),
           "pairs": _table(plan["pairs"], K_PAIR, NPR, tiles,
                           plan["pair_masks"], masks),
           "warps": _table(plan["warps"], K_WARP, NW, tiles)}
    out["tiles"] = (np.concatenate(tiles) if tiles
                    else np.zeros((0, NT), np.int32))
    out["masks"] = (np.concatenate(masks) if masks
                    else np.zeros(1, np.int32))
    return out


def obmc_tables(plan: Dict) -> List[Dict[str, np.ndarray]]:
    """Kernel 6b's host tables of a plan, one for each pass that has
    units, in order: {"pass": 0 above, 1 left, 2 residual, "tiles"
    [T, NT], "units" [n, NS] or, for the residual, [n, 2] rects}."""
    out = []
    for k, name, width in ((0, "obmc_above", NS), (1, "obmc_left", NS),
                           (2, "obmc_resid", 2)):
        if plan[name]:
            tiles = []
            units = _table(plan[name], K_RESID if k == 2 else K_OVERLAY,
                           width, tiles)
            out.append({"pass": k, "tiles": np.concatenate(tiles),
                        "units": units})
    return out


# ------------------------------------------------------------- wrappers

def _lib():
    from easyav1_tpu_torch import _build
    lib = _build.load("inter_mc")
    if lib.inter_mc_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.inter_mc_launch.restype = ci
        frame = [vp] * 7         # _frame_args
        lib.inter_mc_launch.argtypes = [ci, *frame, vp, ci, vp, vp, vp, vp,
                                        vp, ci, vp]
        lib.obmc_launch.restype = ci
        lib.obmc_launch.argtypes = [ci, ci, *frame, vp, ci, vp, vp, ci, vp]
    return lib


def _frame_args(planes, resid, refs):
    """The per-plane arguments both kernels take, checked: out, resid,
    ph, pw, the ref pointers [np][8], and rw, rh, the references'
    logical width and height (ctypes arrays)."""
    dev = planes[0].device
    n_pl = len(planes)
    if not 1 <= n_pl == len(resid) == len(refs) <= 3:
        raise ValueError("one to three planes, each with resid and refs")
    ptrs = ctypes.c_void_p * n_pl
    ints = ctypes.c_int * n_pl
    ref_ptrs = (ctypes.c_void_p * (8 * n_pl))()
    rw, rh = ints(), ints()
    for p, (o, r, rs) in enumerate(zip(planes, resid, refs)):
        for name, t, dt, shape in (("planes", o, torch.int32, o.shape),
                                   ("resid", r, torch.int16, o.shape)):
            if t.dtype != dt or tuple(t.shape) != tuple(shape) \
                    or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"{name}[{p}]: want contiguous {dt} "
                                 f"{tuple(shape)} on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if len(rs) > 8:
            raise ValueError(f"refs[{p}]: at most 8 slots")
        for s, t in enumerate(rs):
            if t.dtype != torch.uint8 or t.dim() != 2 \
                    or not t.is_contiguous() or t.device != dev \
                    or tuple(t.shape) != tuple(rs[0].shape):
                raise ValueError(f"refs[{p}][{s}]: want contiguous uint8 "
                                 f"planes of one shape on {dev}")
            ref_ptrs[8 * p + s] = t.data_ptr()
        if rs:
            rh[p], rw[p] = rs[0].shape
    return (ptrs(*(o.data_ptr() for o in planes)),
            ptrs(*(r.data_ptr() for r in resid)),
            ints(*(o.shape[0] for o in planes)),
            ints(*(o.shape[1] for o in planes)), ref_ptrs, rw, rh)


def mc_launch(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
              refs: Sequence[Sequence[torch.Tensor]],
              tabs: Dict[str, torch.Tensor], bd: int) -> List[torch.Tensor]:
    """Launch kernel 6a once on CUDA tensors, in place: `mc_tables` on
    the planes' device as `tabs`, other arguments as `mc_units`.  Raises
    if the launch fails."""
    dev = planes[0].device
    args = _frame_args(planes, resid, refs)
    with torch.cuda.device(dev):
        rc = _lib().inter_mc_launch(
            len(planes), *args, tabs["tiles"].data_ptr(),
            tabs["tiles"].shape[0], tabs["singles"].data_ptr(),
            tabs["pairs"].data_ptr(), tabs["warps"].data_ptr(),
            tabs["masks"].data_ptr(),
            convert.tables(dev)["warped_filter"].data_ptr(), bd,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"inter_mc launch failed: cudaError {rc}")
    mc_launch.launches += 1
    return planes


mc_launch.launches = 0


def obmc_launch(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
                refs: Sequence[Sequence[torch.Tensor]],
                tab: Dict[str, torch.Tensor], bd: int) -> List[torch.Tensor]:
    """Launch kernel 6b once on CUDA tensors, for one pass of
    `obmc_tables` ("pass" an int, "tiles" and "units" on the planes'
    device), in place.  Raises if the launch fails."""
    dev = planes[0].device
    args = _frame_args(planes, resid, refs)
    with torch.cuda.device(dev):
        rc = _lib().obmc_launch(
            tab["pass"], len(planes), *args, tab["tiles"].data_ptr(),
            tab["tiles"].shape[0], tab["units"].data_ptr(),
            convert.tables(dev)["obmc_masks"].data_ptr(), bd,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"obmc launch failed: cudaError {rc}")
    obmc_launch.launches += 1
    return planes


obmc_launch.launches = 0


def mc_units(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
             refs: Sequence[Sequence[torch.Tensor]], plan: Dict,
             bd: int) -> List[torch.Tensor]:
    """MC of a frame's single, pair and warp units, in place: planes[p]
    int32 [ph, pw], resid[p] int16 of the same shape, refs[p] the used
    slots' uint8 planes in the plan's order.  CPU tensors take
    `mc_units_plain`; CUDA tensors launch kernel 6a once (`mc_launch`,
    when the plan has units), or raise."""
    dev = planes[0].device
    if dev.type == "cpu":
        return mc_units_plain(planes, resid, refs, plan, bd)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tabs = mc_tables(plan)
    if tabs["tiles"].shape[0] == 0:
        return planes
    return mc_launch(planes, resid, refs,
                     convert.from_reference(tabs, dev), bd)


def obmc(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
         refs: Sequence[Sequence[torch.Tensor]], plan: Dict,
         bd: int) -> List[torch.Tensor]:
    """The OBMC passes of a frame, in place, arguments as `mc_units`.
    CPU tensors take `obmc_plain`; CUDA tensors launch kernel 6b
    (`obmc_launch`) once for each pass that has units, in stream order
    (each pass reads what the one before wrote), or raise."""
    dev = planes[0].device
    if dev.type == "cpu":
        return obmc_plain(planes, resid, refs, plan, bd)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for tab in obmc_tables(plan):
        obmc_launch(planes, resid, refs, {
            "pass": tab["pass"],
            **convert.from_reference({k: tab[k] for k in ("tiles", "units")},
                                     dev)}, bd)
    return planes
