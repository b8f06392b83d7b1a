"""Motion compensation on the device: the counterparts of `mc_jax`'s MC
kernels (`_mc_single_kernel`, `_mc_pair_kernel`, `_mc_warp_kernel`,
`_obmc_overlay_kernel`, `_obmc_resid_kernel`; `mc_jax.py:636-867`).

The units are `mc_plan.export_inter_plan`'s, bucketed by (plane, w, h).
Planes are int32, unpadded and mi-aligned; every write and every
residual read is clipped to the plane, and a unit whose valid field is 0
writes nothing.  Reference windows clamp to the reference's logical
width and height, which are its tensor's: `refs[p]` holds plane p of
each used reference slot, in the plan's dense slot order, as a [rh, rw]
tensor of uint8 at 8 bits and of uint16 at 10 and 12 bits.  The
rounding is the spec's (7.11.3.2): at 12 bits InterRound0 is 5, a single
prediction rounds at 9 and the compound blends shift 2 less than at 8
and 10 bits (`round0`).

- `mc_single`, `mc_pair`, `mc_warp`, `obmc_overlay`, `obmc_resid`: the
  plain torch versions, vectorised over the units of one bucket.
- `mc_units`: every plane's single, pair and warp units of a frame, in
  place.  CPU tensors take `mc_units_plain`; CUDA tensors launch kernel
  6a of `csrc/inter_mc.cu` once (`mc_launch`), or raise.  The host
  uploads the plan's unit tables as they are, in one buffer with a small
  bucket table (`mc_tables`); the kernel finds each tile of each unit
  from a work index (`work_items` is that arithmetic in numpy).
- `obmc`: the OBMC passes of a frame, in place.  CPU tensors take
  `obmc_plain`, the reference's three passes in order: above overlays,
  left overlays, the deferred residual over the OBMC blocks.  CUDA
  tensors launch kernel 6b once (`obmc_launch`), or raise: every overlay
  lies inside its OBMC block's rect and predicts from the references, so
  one tile of a block can blend its above overlays, then its left ones,
  add the residual and store once.  `obmc_tables` groups the overlays by
  block.
- The launches of 6a and 6b count over both sample types, as
  "launches.mc_kernel" and "launches.obmc_kernel" of `trace.counters()`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from easyav1_tpu_torch import _build, convert, trace
from easyav1_tpu_torch.video.av1.recon.mc_plan import (
    NPR, NS, NW, P_MIDX, P_MODE, P_PRED0, P_PRED1, P_VALID, P_W0, P_W1, P_X,
    P_Y, S_FH, S_FV, S_IX, S_IY, S_NORES, S_SLOT, S_VALID, S_X, S_Y, W_ALPHA,
    W_BETA, W_DELTA, W_GAMMA, W_IX4, W_IY4, W_SLOT, W_SX4, W_SY4, W_VALID,
    W_X, W_Y)
from easyav1_tpu_torch.video.av1.wedge import round0

TILE = 16                 # the widest output tile of a warp
K_SINGLE, K_PAIR, K_WARP, K_BLOCK = range(4)
# bucket row: kind, plane, unit w, unit h, first unit (row of the kind's
# table), first work index, byte offset of a pair bucket's mask stack
B_KIND, B_PLANE, B_W, B_H, B_UNIT, B_TILE, B_MASK = range(7)
NB = 8
MAX_BUCKETS = 512         # the kernels keep the buckets' first work
                          # indices in shared memory
# kernel 6b's records: an OBMC block [NK] (x, y, first overlay, above
# count, left count) and an overlay [NOV] (a single unit's NS fields,
# then the rect's w and h)
K_X, K_Y, K_OV, K_NA, K_NL = range(5)
NK = 5
O_W, O_H = NS, NS + 1
NOV = NS + 2


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


def _subpel(refstk, slot, ix, iy, fh8, fv8, w, h, r0):
    """The two 8-tap passes over each unit's (h + 7) x (w + 7) window,
    clamped to the reference: (accH + 2^(r0 - 1)) >> r0, then the
    vertical sum accV [n, h, w] before its final rounding."""
    rh, rw = refstk.shape[1:]
    dev = refstk.device
    rows = torch.clamp(iy[:, None] - 3 + torch.arange(h + 7, device=dev),
                       0, rh - 1)
    cols = torch.clamp(ix[:, None] - 3 + torch.arange(w + 7, device=dev),
                       0, rw - 1)
    win = refstk[slot[:, None, None], rows[:, :, None],
                 cols[:, None, :]].to(torch.int64)
    acc = sum(win[:, :, t:t + w] * fh8[:, t, None, None] for t in range(8))
    m = (acc + (1 << (r0 - 1))) >> r0
    return sum(m[:, t:t + h, :] * fv8[:, t, None, None] for t in range(8))


def _single_pred(refstk, f, w, h, bd):
    r0 = round0(bd)
    acc = _subpel(refstk, f[:, S_SLOT], f[:, S_IX], f[:, S_IY],
                  f[:, S_FH:S_FH + 8], f[:, S_FV:S_FV + 8], w, h, r0)
    return torch.clamp((acc + (1 << (13 - r0))) >> (14 - r0), 0,
                       (1 << bd) - 1)


def mc_single(plane, resid, refstk, f, w, h, bd):
    """Single-reference units f [n, NS] of one (w, h) bucket into plane
    [ph, pw] int32, in place: clip((accV + 1024) >> 11) (at 12 bits
    (accV + 256) >> 9), plus the residual unless the unit's nores is
    set.  refstk [ns, rh, rw]."""
    f = f.to(torch.int64)
    mx = (1 << bd) - 1
    v = _single_pred(refstk, f, w, h, bd)
    yy, xx, keep = _rect(f, S_X, S_Y, w, h, plane.shape)
    out = torch.where((f[:, S_NORES] != 0)[:, None, None], v,
                      torch.clamp(v + _read(resid, yy, xx), 0, mx))
    _store(plane, yy, xx, keep & (f[:, S_VALID] != 0)[:, None, None], out)
    return plane


def mc_pair(plane, resid, refstk, f, masks, w, h, bd):
    """Compound units f [n, NPR] of one bucket, in place: each
    prediction at (accV + 64) >> 7, then the weight blend
    (p0 w0 + p1 w1 + 128) >> 8 or, for blend mode 1, the mask blend
    (p0 m + p1 (64 - m) + 512) >> 10 with m = masks[P_MIDX] [h, w]
    (at 12 bits >> 6 and >> 8); clipped, plus the residual."""
    f = f.to(torch.int64)
    mx = (1 << bd) - 1
    r0 = round0(bd)
    ipr = 7 - r0

    def pred(b):
        acc = _subpel(refstk, f[:, b], f[:, b + 1], f[:, b + 2],
                      f[:, b + 3:b + 11], f[:, b + 11:b + 19], w, h, r0)
        return (acc + 64) >> 7

    p0, p1 = pred(P_PRED0), pred(P_PRED1)
    vw = (p0 * f[:, P_W0, None, None] + p1 * f[:, P_W1, None, None]
          + (8 << ipr)) >> (ipr + 4)
    m = masks.to(torch.int64)[f[:, P_MIDX]]
    vm = (p0 * m + p1 * (64 - m) + (32 << ipr)) >> (ipr + 6)
    v = torch.clamp(torch.where((f[:, P_MODE] == 1)[:, None, None], vm, vw),
                    0, mx)
    yy, xx, keep = _rect(f, P_X, P_Y, w, h, plane.shape)
    out = torch.clamp(v + _read(resid, yy, xx), 0, mx)
    _store(plane, yy, xx, keep & (f[:, P_VALID] != 0)[:, None, None], out)
    return plane


def mc_warp(plane, resid, refstk, f, wf, bd):
    """Affine warp units f [n, NW], one 8x8 output each, in place: the
    15 x 15 window, per-pixel phases of `warped_filter` wf [193, 8],
    (acc + 4) >> 3 across, clip((acc + 1024) >> 11) down (at 12 bits
    >> 5 and >> 9), plus the residual."""
    f = f.to(torch.int64)
    wf = wf.to(torch.int64)
    mx = (1 << bd) - 1
    r0 = round0(bd)
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
    tmp = (tmp + (1 << (r0 - 1))) >> r0
    k2 = torch.arange(8, device=dev)[None, :, None]
    offs_v = ((par(W_SY4) + par(W_DELTA) * k2 + par(W_GAMMA) * ll
               + 512) >> 10) + 64
    cv = wf[offs_v]                                   # [n, 8, 8, 8]
    acc = sum(tmp[:, m:m + 8, :] * cv[..., m] for m in range(8))
    v = torch.clamp((acc + (1 << (13 - r0))) >> (14 - r0), 0, mx)
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
    v = _single_pred(refstk, f, w, h, bd)
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


def _stack(planes) -> Optional[torch.Tensor]:
    """A plane's reference slots as one [ns, rh, rw] tensor; uint16
    slots as int32, since CUDA has no indexing of uint16 tensors."""
    if not planes:
        return None
    return torch.stack([t.to(torch.int32) if t.dtype == torch.uint16 else t
                        for t in planes])


def mc_units_plain(planes: List[torch.Tensor], resid, refs, plan: Dict,
                   bd: int) -> List[torch.Tensor]:
    """The plain version of `mc_units` (any device): the plan's single,
    pair and warp buckets in the reference's order, in place."""
    dev = planes[0].device
    stk = [_stack(r) for r in refs]
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
    stk = [_stack(r) for r in refs]
    masks = convert.tables(dev)["obmc_masks"]
    for name, left in (("obmc_above", False), ("obmc_left", True)):
        for (p, w, h), f in sorted(plan[name].items()):
            obmc_overlay(planes[p], stk[p], _t(f, dev), w, h, bd, left,
                         masks)
    for (p, w, h), rects in sorted(plan["obmc_resid"].items()):
        obmc_resid(planes[p], resid[p], _t(rects, dev), w, h, bd)
    return planes


# ---------------------------------------------------------- host tables

def tile_dims(w: int, h: int) -> Tuple[int, int]:
    """The (width, height) of the tiles a w x h unit is cut into, one
    tile a warp: at most TILE wide, and 256 pixels or 32 rows."""
    tw = min(w, TILE)
    return tw, min(h, TILE if tw == TILE else 2 * TILE)


def _tiles_per_unit(w: int, h: int) -> int:
    tw, th = tile_dims(w, h)
    return (w // tw) * (h // th)


def _check_size(w: int, h: int, name: str):
    if not (w in _SIZES and h in _SIZES):
        raise ValueError(f"{name}: units of {w}x{h}, want powers of two "
                         f"from 2 to 128")


_SIZES = (2, 4, 8, 16, 32, 64, 128)


class _Buffer:
    """The single int32 upload buffer of a kernel's tables: sections are
    laid end to end, `offsets` in int32 words; `host` is the torch
    tensor (pinned when asked), `buf` its numpy view."""

    def __init__(self, sizes: Sequence[int], pinned: bool):
        self.offsets = [0]
        for n in sizes:
            self.offsets.append(self.offsets[-1] + n)
        self.host = torch.empty(max(self.offsets[-1], 1), dtype=torch.int32,
                                pin_memory=pinned)
        self.buf = self.host.numpy()

    def section(self, k: int, width: int, dtype=np.int32) -> np.ndarray:
        a = self.buf[self.offsets[k]:self.offsets[k + 1]]
        return a.view(dtype).reshape(-1, width)


def mc_tables(plan: Dict, pinned: bool = False) -> Dict:
    """Kernel 6a's host tables of a plan, in one buffer: {"host": the
    int32 tensor to upload, "buf": its numpy view, "layout": [buckets,
    work indices, then the int32 offsets in buf of "buckets" [nb, NB],
    "singles" [n, NS], "pairs" [n, NPR], "warps" [n, NW] and "masks"
    (the pair buckets' mask stacks as uint8, flat), warp units], those
    sections as views of buf, "n_tiles"}.  The unit tables are the
    plan's buckets in sorted order, as they are."""
    kinds = ((K_SINGLE, "singles", NS), (K_PAIR, "pairs", NPR),
             (K_WARP, "warps", NW))
    rows, n_tiles, n_mask = [], 0, 0
    stacks = []
    for kind, name, _width in kinds:
        first = 0
        for key in sorted(plan[name]):
            f = plan[name][key]
            p, w, h = (key, 8, 8) if kind == K_WARP else key
            _check_size(w, h, name)
            moff = 0
            if kind == K_PAIR:
                m = plan["pair_masks"].get(key)
                masked = f[:, P_MODE] == 1
                if masked.any() and (m is None or int(
                        f[masked, P_MIDX].max()) >= m.shape[0]):
                    raise ValueError(f"pairs {key}: a mask index without "
                                     f"its mask")
                if m is not None:
                    moff = n_mask
                    stacks.append(m)
                    n_mask += m.size
            rows.append((kind, p, w, h, first, n_tiles, moff, 0))
            first += f.shape[0]
            n_tiles += f.shape[0] * _tiles_per_unit(w, h)
    if len(rows) > MAX_BUCKETS:
        raise ValueError(f"{len(rows)} buckets, at most {MAX_BUCKETS}")
    count = {name: sum(f.shape[0] for f in plan[name].values())
             for _k, name, _w in kinds}
    b = _Buffer([len(rows) * NB] + [count[name] * width
                                    for _k, name, width in kinds]
                + [-(-n_mask // 4)], pinned)
    out = {"host": b.host, "buf": b.buf, "n_tiles": n_tiles,
           "buckets": b.section(0, NB)}
    out["buckets"][:] = np.asarray(rows, np.int32).reshape(-1, NB)
    for k, (_kind, name, width) in enumerate(kinds):
        sec = out[name] = b.section(k + 1, width)
        first = 0
        for key in sorted(plan[name]):
            f = plan[name][key]
            sec[first:first + f.shape[0]] = f
            first += f.shape[0]
    masks = out["masks"] = b.section(4, 1, np.uint8).ravel()
    first = 0
    for m in stacks:
        masks[first:first + m.size] = m.ravel()
        first += m.size
    out["layout"] = [len(rows), n_tiles, *b.offsets[:5], count["warps"]]
    return out


def work_items(buckets: np.ndarray, n_tiles: int, idx: np.ndarray) -> Dict:
    """The kernels' work-index arithmetic in numpy, step for step (the
    kernels divide by shifting: unit and tile sizes are powers of two):
    for each work index of idx, {"bucket": its row of buckets (the last
    whose first work index is not above it, by bisection), "unit": its
    row of the kind's unit table, "ox", "oy": its tile's offset in the
    unit, "tw", "th": the tile's size, "mask": the bucket's mask byte
    offset}."""
    idx = np.asarray(idx, np.int64)
    first = np.append(buckets[:, B_TILE], n_tiles).astype(np.int64)
    lo = np.zeros_like(idx)
    hi = np.full_like(idx, buckets.shape[0])
    while np.any(hi - lo > 1):
        open_ = hi - lo > 1
        mid = (lo + hi) >> 1
        take = first[mid] <= idx
        lo = np.where(open_ & take, mid, lo)
        hi = np.where(open_ & ~take, mid, hi)
    b = buckets[lo].astype(np.int64)
    w, h = b[:, B_W], b[:, B_H]
    tw = np.minimum(w, TILE)
    th = np.minimum(h, np.where(tw == TILE, TILE, 2 * TILE))
    nx = w // tw
    per = nx * (h // th)
    local = idx - b[:, B_TILE]
    t = local % per
    return {"bucket": lo, "unit": b[:, B_UNIT] + local // per,
            "ox": (t % nx) * tw, "oy": (t // nx) * th, "tw": tw, "th": th,
            "mask": b[:, B_MASK]}


def _block_labels(plan: Dict) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """(blocks [n, 4] of x, y, w, h in the sorted order of the plan's
    obmc_resid buckets, per plane a grid of 4x4 cells holding the row of
    the block that covers each cell, or -1)."""
    keys = sorted(plan["obmc_resid"])
    blocks = np.concatenate(
        [np.concatenate([plan["obmc_resid"][k].reshape(-1, 2),
                         np.broadcast_to(np.asarray(k[1:], np.int32),
                                         (plan["obmc_resid"][k].shape[0],
                                          2))], 1) for k in keys]
        or [np.zeros((0, 4), np.int32)]).astype(np.int64)
    if np.any(blocks & 3) or np.any(blocks[:, :2] < 0):
        raise ValueError("OBMC blocks must lie on multiples of 4 pixels")
    labels, first = {}, 0
    for p in sorted({k[0] for k in keys}):
        mine = [k for k in keys if k[0] == p]
        n = sum(plan["obmc_resid"][k].shape[0] for k in mine)
        b = blocks[first:first + n] >> 2
        grid = np.full((int((b[:, 1] + b[:, 3]).max()),
                        int((b[:, 0] + b[:, 2]).max())), -1, np.int64)
        at = 0
        for k in mine:
            m = plan["obmc_resid"][k].shape[0]
            c = b[at:at + m]
            ys = c[:, 1, None, None] + np.arange(k[2] >> 2)[None, :, None]
            xs = c[:, 0, None, None] + np.arange(k[1] >> 2)[None, None, :]
            grid[ys, xs] = np.arange(first + at, first + at + m)[:, None,
                                                                   None]
            at += m
        if np.count_nonzero(grid >= 0) != int((b[:, 2] * b[:, 3]).sum()):
            raise ValueError(f"plane {p}: OBMC blocks overlap")
        labels[p] = grid
        first += n
    return blocks, labels


def obmc_tables(plan: Dict, pinned: bool = False) -> Dict:
    """Kernel 6b's host tables of a plan, in one buffer: {"host",
    "buf", "layout": [buckets, work indices, then the int32 offsets in
    buf of "buckets" [nb, NB] (one for each (plane, w, h) of the OBMC
    blocks), "blocks" [n, NK] and "overlays" [n, NOV]], those sections
    as views, "n_tiles"}.  A work index is one tile of one block.  Each
    overlay goes to the block whose rect holds it: the blocks' rects are
    disjoint, so there is one, and a plan with an overlay outside every
    block raises.  A block's overlays are consecutive, above before
    left."""
    blocks, labels = _block_labels(plan)
    ov, owner, left = [], [], []
    for is_left, name in enumerate(("obmc_above", "obmc_left")):
        for (p, w, h), f in sorted(plan[name].items()):
            x, y = f[:, S_X].astype(np.int64), f[:, S_Y].astype(np.int64)
            grid = labels.get(p)
            if grid is None:
                raise ValueError(f"{name} {(p, w, h)}: no OBMC block")
            cy, cx = y >> 2, x >> 2
            inside = (x >= 0) & (y >= 0) & (cy < grid.shape[0]) \
                & (cx < grid.shape[1])
            blk = np.where(inside, grid[np.where(inside, cy, 0),
                                        np.where(inside, cx, 0)], -1)
            b = blocks[blk]
            held = (blk >= 0) & (x >= b[:, 0]) & (y >= b[:, 1]) \
                & (x + w <= b[:, 0] + b[:, 2]) & (y + h <= b[:, 1] + b[:, 3])
            if not held.all():
                raise ValueError(f"{name} {(p, w, h)}: an overlay outside "
                                 f"every OBMC block")
            rec = np.empty((f.shape[0], NOV), np.int32)
            rec[:, :NS] = f
            rec[:, O_W], rec[:, O_H] = w, h
            ov.append(rec)
            owner.append(blk)
            left.append(np.full(f.shape[0], is_left))
    n_blk = blocks.shape[0]
    owner = np.concatenate(owner or [np.zeros(0, np.int64)])
    left = np.concatenate(left or [np.zeros(0, np.int64)])
    n_above = np.bincount(owner[left == 0], minlength=n_blk)
    n_left = np.bincount(owner[left == 1], minlength=n_blk)
    if n_blk and int((n_above + n_left).max()) > 255:
        raise ValueError("an OBMC block with more than 255 overlays")
    rows, n_tiles, first = [], 0, 0
    for (p, w, h) in sorted(plan["obmc_resid"]):
        _check_size(w, h, "obmc_resid")
        n = plan["obmc_resid"][(p, w, h)].shape[0]
        rows.append((K_BLOCK, p, w, h, first, n_tiles, 0, 0))
        first += n
        n_tiles += n * _tiles_per_unit(w, h)
    if len(rows) > MAX_BUCKETS:
        raise ValueError(f"{len(rows)} buckets, at most {MAX_BUCKETS}")
    b = _Buffer([len(rows) * NB, n_blk * NK, owner.size * NOV], pinned)
    out = {"host": b.host, "buf": b.buf, "n_tiles": n_tiles,
           "buckets": b.section(0, NB), "blocks": b.section(1, NK),
           "overlays": b.section(2, NOV),
           "layout": [len(rows), n_tiles, *b.offsets[:3]]}
    out["buckets"][:] = np.asarray(rows, np.int32).reshape(-1, NB)
    out["blocks"][:, :2] = blocks[:, :2]
    out["blocks"][:, K_OV] = np.cumsum(n_above + n_left) - n_above - n_left
    out["blocks"][:, K_NA] = n_above
    out["blocks"][:, K_NL] = n_left
    if owner.size:
        out["overlays"][:] = np.concatenate(ov)[
            np.lexsort((left, owner))]
    return out


# ------------------------------------------------------------- wrappers

# kernels 6a and 6b, each its uint8 instantiation and its uint16 one
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGS = [_CI, *[_VP] * 7, _VP, _VP, _VP, _CI]
_MC = tuple(_build.Kernel("inter_mc", name, _ARGS, "mc_kernel")
            for name in ("inter_mc_launch", "inter_mc_launch16"))
_OBMC = tuple(_build.Kernel("inter_mc", name, _ARGS, "obmc_kernel")
              for name in ("obmc_launch", "obmc_launch16"))


def sample_dtype(bd: int) -> torch.dtype:
    """A frame's sample type on the device, and so the reference planes'
    type here: uint8 at 8 bits, uint16 at 10 and 12 (the reference's
    casts, `native/__init__.py:1336`, `:1451`)."""
    return torch.uint8 if bd == 8 else torch.uint16


def _frame_args(planes, resid, refs, bd):
    """The per-plane arguments both kernels take, checked: out, resid,
    ph, pw, the ref pointers [np][8], and rw, rh, the references'
    logical width and height (ctypes arrays)."""
    if bd not in (8, 10, 12):
        raise ValueError(f"bit depth {bd}: want 8, 10 or 12")
    want = sample_dtype(bd)
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
            if t.dtype != want or t.dim() != 2 \
                    or not t.is_contiguous() or t.device != dev \
                    or tuple(t.shape) != tuple(rs[0].shape):
                raise ValueError(f"refs[{p}][{s}]: want contiguous {want} "
                                 f"planes of one shape on {dev} at {bd} "
                                 f"bits, got {t.dtype}")
            ref_ptrs[8 * p + s] = t.data_ptr()
        if rs:
            rh[p], rw[p] = rs[0].shape
    return (ptrs(*(o.data_ptr() for o in planes)),
            ptrs(*(r.data_ptr() for r in resid)),
            ints(*(o.shape[0] for o in planes)),
            ints(*(o.shape[1] for o in planes)), ref_ptrs, rw, rh)


def upload(tabs: Dict, dev) -> Dict:
    """A kernel's host tables (`mc_tables`, `obmc_tables`) on the card:
    {"buf": the buffer, in one copy that does not wait where the host
    tensor is pinned, "layout", "n_tiles"}."""
    trace.add(h2d_bytes=tabs["host"].nbytes)
    return {"buf": tabs["host"].to(dev, non_blocking=True),
            "layout": tabs["layout"], "n_tiles": tabs["n_tiles"]}


def _launch(kernels, planes, resid, refs, tabs, table, bd):
    """Launches `kernels`' instantiation for `bd` (uint8 at 8 bits,
    uint16 above) on the planes' device; raises if the launch fails."""
    dev = planes[0].device
    buf = tabs["buf"]
    if buf.device != dev or buf.dtype != torch.int32 \
            or not buf.is_contiguous():
        raise ValueError(f"tables: want a contiguous int32 buffer on {dev}")
    args = _frame_args(planes, resid, refs, bd)
    layout = (ctypes.c_int * len(tabs["layout"]))(*tabs["layout"])
    kernels[bd > 8].launch(dev, len(planes), *args, buf.data_ptr(), layout,
                           convert.tables(dev)[table].data_ptr(), bd)


def mc_launch(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
              refs: Sequence[Sequence[torch.Tensor]], tabs: Dict,
              bd: int) -> List[torch.Tensor]:
    """Launch kernel 6a once on CUDA tensors, in place: `tabs` is
    `upload(mc_tables(plan), device)` with at least one work index,
    other arguments as `mc_units`.  Raises if the launch fails."""
    _launch(_MC, planes, resid, refs, tabs, "warped_filter", bd)
    return planes


def obmc_launch(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
                refs: Sequence[Sequence[torch.Tensor]], tabs: Dict,
                bd: int) -> List[torch.Tensor]:
    """Launch kernel 6b once on CUDA tensors, in place: `tabs` is
    `upload(obmc_tables(plan), device)` with at least one work index.
    Raises if the launch fails."""
    _launch(_OBMC, planes, resid, refs, tabs, "obmc_masks", bd)
    return planes


def mc_units(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
             refs: Sequence[Sequence[torch.Tensor]], plan: Dict,
             bd: int) -> List[torch.Tensor]:
    """MC of a frame's single, pair and warp units, in place: planes[p]
    int32 [ph, pw], resid[p] int16 of the same shape, refs[p] the used
    slots' planes in the plan's order (`sample_dtype(bd)`).  CPU tensors take
    `mc_units_plain`; CUDA tensors launch kernel 6a once (`mc_launch`,
    when the plan has units), or raise."""
    if not _build.on_card(planes[0]):
        return mc_units_plain(planes, resid, refs, plan, bd)
    tabs = mc_tables(plan, pinned=True)
    if tabs["n_tiles"] == 0:
        return planes
    return mc_launch(planes, resid, refs, upload(tabs, planes[0].device), bd)


def obmc(planes: List[torch.Tensor], resid: Sequence[torch.Tensor],
         refs: Sequence[Sequence[torch.Tensor]], plan: Dict,
         bd: int) -> List[torch.Tensor]:
    """The OBMC of a frame, in place, arguments as `mc_units`.  CPU
    tensors take `obmc_plain`; CUDA tensors launch kernel 6b once
    (`obmc_launch`, when the plan has OBMC blocks), or raise."""
    if not _build.on_card(planes[0]):
        return obmc_plain(planes, resid, refs, plan, bd)
    if not plan["obmc_resid"]:
        if plan["obmc_above"] or plan["obmc_left"]:
            raise ValueError("OBMC overlays without an OBMC block")
        return planes
    tabs = obmc_tables(plan, pinned=True)
    return obmc_launch(planes, resid, refs, upload(tabs, planes[0].device),
                       bd)
