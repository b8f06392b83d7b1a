"""Film grain synthesis (spec 7.18.3) as plain torch ops: the plain
version of the grain kernel (`csrc/fg.cu`, launched by
`fg_torch.fg_launch`), and the path of CPU tensors.  The counterpart of
`fg_jax.DeviceFilmGrain` with `_block_randvals`, `_offsets`,
`_grain_plane`, `_apply_luma` and `_apply_chroma` (`fg_jax.py:29-237`).
Imports torch, numpy and the port's tables (the Gaussian sequence) only.

By section of the spec:
- 7.18.3.2, the random number process: `_rand`, the 16-bit LFSR.
- 7.18.3.3, the generate grain process: `generate_grain`, the templates
  with their auto-regressive filter (`_ar_positions` its neighbourhood),
  on the host.  The device path takes its templates from the port's C
  generator (`native.fg_templates`), held to this one by the tests.
- 7.18.3.4, the scaling lookup initialization process: `scaling_lut`,
  and `scaling_luts`, the three planes' tables.
- 7.18.3.5, the add noise synthesis process: `block_randvals` and
  `_offsets` (each 32x32 block's random offsets), `grain_plane` (the
  blocks' grain windows with the overlap blends), `scale_lut` and
  `_noise` (the scaling, the noise add and the clip), and `apply`, a
  frame.

Where it departs from the spec's loop order, each departure exact since
the arithmetic is integer:
- the spec draws a 32-row stripe's random values block by block as it
  goes; `block_randvals` draws each stripe's LFSR stream whole, up front,
  into a table of every block's value, from which each block reads its
  own and its left, upper and upper-left neighbours';
- the spec builds a noise stripe block by block, blending each block's
  first columns into the previous block's two extra columns, then blends
  each stripe's first rows into the previous stripe's extra rows;
  `grain_plane` gathers every block's window at once and computes each
  blend from the neighbours' windows directly (the horizontal blend of
  the current and of the upper rows, then the vertical one, as the spec
  orders them);
- the spec stops at the frame's edge; `apply` edge-pads each plane to
  whole blocks, computes every block whole and crops: a padded sample is
  never read by a sample inside the plane, except through the luma
  average of chroma, whose clamped positions are the edge padding's.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from easyav1_tpu_torch.video.av1 import tables as T

GRAIN_W = 82
GRAIN_H = 73
BLK = 32
# the templates are padded so that no window of a block reaches outside
PAD = BLK + 8


# Copy of easyav1_tpu/video/av1/fg_ref.py::_rand (the 16-bit LFSR).
def _rand(state: int, bits: int):
    bit = ((state >> 0) ^ (state >> 1) ^ (state >> 3) ^ (state >> 12)) & 1
    state = (state >> 1) | (bit << 15)
    return state, (state >> (16 - bits)) & ((1 << bits) - 1)


def _r2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def _ar_positions(lag):
    """AR neighbourhood in coding order (rows -lag..0, columns -lag..lag,
    stopping at the centre)."""
    pos = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            pos.append((dr, dc))
    return pos


# Copy of easyav1_tpu/video/av1/fg_ref.py::generate_grain, on Python
# lists (the AR filter is sequential; list indexing is several times
# faster than numpy scalar indexing).
def generate_grain(fg, bd: int, ssx: int, ssy: int, mono: bool):
    """(luma grain [73, 82], cb grain, cr grain) as int64 arrays; the
    chroma templates are None for a monochrome stream."""
    gauss = T.data()["gaussian_sequence"].tolist()
    shift = 12 - bd + fg.grain_scale_shift
    gmin = -(128 << (bd - 8))
    gmax = (128 << (bd - 8)) - 1
    ar_shift = fg.ar_coeff_shift
    pos = _ar_positions(fg.ar_coeff_lag)

    def noise(state, rows, cols):
        g = [[0] * cols for _ in range(rows)]
        for y in range(rows):
            row = g[y]
            for x in range(cols):
                state, r = _rand(state, 11)
                row[x] = _r2(gauss[r], shift)
        return g

    luma = [[0] * GRAIN_W for _ in range(GRAIN_H)]
    if fg.num_y_points:
        luma = noise(fg.grain_seed, GRAIN_H, GRAIN_W)
        taps = list(zip(pos, fg.ar_coeffs_y))
        for y in range(3, GRAIN_H):
            for x in range(3, GRAIN_W - 3):
                s = 0
                for (dr, dc), c in taps:
                    s += c * luma[y + dr][x + dc]
                v = luma[y][x] + _r2(s, ar_shift)
                luma[y][x] = min(max(v, gmin), gmax)
    luma_a = np.array(luma, np.int64)
    if mono:
        return luma_a, None, None

    cw = 44 if ssx else GRAIN_W
    chh = 38 if ssy else GRAIN_H
    out_c = []
    for num_pts, coeffs, seed_xor in (
            (fg.num_cb_points, fg.ar_coeffs_cb, 0xb524),
            (fg.num_cr_points, fg.ar_coeffs_cr, 0x49d8)):
        cg = [[0] * cw for _ in range(chh)]
        if fg.chroma_scaling_from_luma or num_pts > 0:
            cg = noise(fg.grain_seed ^ seed_xor, chh, cw)
            taps = list(zip(pos, coeffs))
            from_luma = len(coeffs) == len(pos) + 1 and fg.num_y_points
            for y in range(3, chh):
                for x in range(3, cw - 3):
                    s = 0
                    for (dr, dc), c in taps:
                        s += c * cg[y + dr][x + dc]
                    if from_luma:
                        lx = ((x - 3) << ssx) + 3
                        ly = ((y - 3) << ssy) + 3
                        lum = 0
                        for i in range(ssy + 1):
                            for j in range(ssx + 1):
                                lum += luma[ly + i][lx + j]
                        s += coeffs[-1] * _r2(lum, ssx + ssy)
                    v = cg[y][x] + _r2(s, ar_shift)
                    cg[y][x] = min(max(v, gmin), gmax)
        out_c.append(np.array(cg, np.int64))
    return luma_a, out_c[0], out_c[1]


# Copy of easyav1_tpu/video/av1/fg_ref.py::scaling_lut.
def scaling_lut(points_val, points_scl, bd: int) -> np.ndarray:
    """Piecewise-linear scaling LUT (spec init scaling function), 8-bit
    index domain."""
    n = len(points_val)
    lut = np.zeros(256, np.int64)
    if n == 0:
        return lut
    for i in range(points_val[0]):
        lut[i] = points_scl[0]
    for j in range(n - 1):
        dx = points_val[j + 1] - points_val[j]
        dy = points_scl[j + 1] - points_scl[j]
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for k in range(dx):
            lut[points_val[j] + k] = \
                points_scl[j] + ((k * delta + 32768) >> 16)
    for i in range(points_val[-1], 256):
        lut[i] = points_scl[-1]
    return lut


def block_randvals(seed: int, nrows: int, ncols: int) -> np.ndarray:
    """R[r, c]: the c-th 8-bit random value of the LFSR stream seeded for
    block row r."""
    out = np.zeros((nrows, ncols), np.int32)
    for r in range(nrows):
        s = seed
        s ^= ((r * 37 + 178) & 0xFF) << 8
        s ^= (r * 173 + 105) & 0xFF
        for c in range(ncols):
            s, out[r, c] = _rand(s, 8)
    return out


def _offsets(rv: np.ndarray, subx: int, suby: int):
    offx = 3 + (2 >> subx) * (3 + (rv >> 4))
    offy = 3 + (2 >> suby) * (3 + (rv & 0xF))
    return offx.astype(np.int64), offy.astype(np.int64)


def grain_plane(grain_pad: torch.Tensor, offx: torch.Tensor,
                offy: torch.Tensor, bh: int, bw: int, subx: int, suby: int,
                overlap: bool, gmin: int, gmax: int) -> torch.Tensor:
    """The grain windows of every block with left and top overlap blends
    -> [nrows * bh, ncols * bw] int32.

    grain_pad: the template padded by PAD on the device; offx, offy:
    [4, nrows, ncols] int64 window offsets from the random values of
    [this block, the block to the left, the block above, the block above
    and to the left]."""
    _, nrows, ncols = offx.shape
    dev = grain_pad.device
    y_idx = torch.arange(bh, device=dev)[None, :, None]
    x_idx = torch.arange(bw, device=dev)[None, None, :]

    def wins(k, dy, dx):
        oy = offy[k].reshape(-1, 1, 1) + dy
        ox = offx[k].reshape(-1, 1, 1) + dx
        return grain_pad[oy + y_idx, ox + x_idx]        # [n, bh, bw]

    def weights(idx, n_over):
        """(old, new) int32 blend weights along idx; only the first
        n_over entries are used."""
        old, new = ((27, 17), (17, 27)) if n_over == 2 else ((23,), (22,))
        n = idx.numel()
        return tuple(torch.tensor((v + (v[-1],) * n)[:n], dtype=torch.int32,
                                  device=dev).reshape(idx.shape)
                     for v in (old, new))

    def r2_5(x):
        return (x + 16) >> 5

    g_cur = wins(0, 0, 0)
    if not overlap:
        g = g_cur
    else:
        n_over_x, n_over_y = 2 >> subx, 2 >> suby
        wx_old, wx_new = weights(x_idx, n_over_x)
        wy_old, wy_new = weights(y_idx, n_over_y)
        bcol = torch.arange(ncols, device=dev).repeat(nrows)[:, None, None]
        brow = torch.arange(nrows, device=dev).repeat_interleave(
            ncols)[:, None, None]
        xmask = (x_idx < n_over_x) & (bcol > 0)
        ymask = (y_idx < n_over_y) & (brow > 0)

        def hblend(old, new):
            b = r2_5(old * wx_old + new * wx_new).clamp_(gmin, gmax)
            return torch.where(xmask, b, new)

        g_h = hblend(wins(1, 0, bw), g_cur)
        g_th = hblend(wins(3, bh, bw), wins(2, bh, 0))
        g = r2_5(g_th * wy_old + g_h * wy_new).clamp_(gmin, gmax)
        g = torch.where(ymask, g, g_h)
    return (g.reshape(nrows, ncols, bh, bw).permute(0, 2, 1, 3)
            .reshape(nrows * bh, ncols * bw))


def _edge_pad(a: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """`a` as int32, edge-padded on the bottom and the right to
    [ph, pw]."""
    rows = torch.arange(ph, device=a.device).clamp_(max=a.shape[0] - 1)
    cols = torch.arange(pw, device=a.device).clamp_(max=a.shape[1] - 1)
    return a.to(torch.int32)[rows][:, cols]


def scale_lut(lut, val, bd):
    """The scaling of sample values `val` (spec 7.18.3.5 scale_lut):
    lut[val] at 8 bits; above, the LUT's 256 entries interpolated in the
    low bd - 8 bits.  (The JAX package's `fg_jax` indexes
    lut[clip(val, 0, 255)] at every depth, which differs from dav1d
    wherever a 10- or 12-bit sample exceeds 255.)"""
    if bd == 8:
        return lut[val.clamp(0, 255).long()]
    sh = bd - 8
    x = (val >> sh).clamp_(0, 255).long()
    rem = val - (x << sh)
    lo, hi = lut[x], lut[(x + 1).clamp_(max=255)]
    return lo + (((hi - lo) * rem + (1 << (sh - 1))) >> sh)


def _noise(src, val, g, lut, shift, vmin, vmax, bd):
    scale = scale_lut(lut, val, bd)
    return (src + ((scale * g + (1 << (shift - 1))) >> shift)).clamp_(vmin,
                                                                      vmax)


def scaling_luts(fg, bd: int):
    """The scaling LUTs of luma, Cb and Cr (numpy int64 [256] each);
    chroma takes luma's where it scales from luma."""
    lut_y = scaling_lut(fg.point_y_value, fg.point_y_scaling, bd)
    if fg.chroma_scaling_from_luma:
        return lut_y, lut_y, lut_y
    return (lut_y,
            scaling_lut(fg.point_cb_value, fg.point_cb_scaling, bd),
            scaling_lut(fg.point_cr_value, fg.point_cr_scaling, bd))


def planes_grained(fg, mono: bool, n_planes: int) -> List[int]:
    """The planes to which `fg` applies grain: luma where it has scaling
    points, each chroma plane where it has its own or takes luma's."""
    out = [0] if fg.num_y_points else []
    if not mono and n_planes > 1:
        out += [p for p, n in ((1, fg.num_cb_points), (2, fg.num_cr_points))
                if n or fg.chroma_scaling_from_luma]
    return out


def device_tables(templates, luts, device):
    """`apply`'s tables on `device`: ({plane: template padded by PAD,
    int32}, [three int32 LUTs])."""
    grain = {p: torch.from_numpy(np.pad(g, ((0, PAD), (0, PAD))).astype(
        np.int32)).to(device) for p, g in enumerate(templates)
        if g is not None}
    return grain, [torch.from_numpy(np.asarray(t, np.int32)).to(device)
                   for t in luts]


def apply(fg, bd: int, ssx: int, ssy: int, mono: bool, grain, lut,
          planes: List[torch.Tensor]) -> List[torch.Tensor]:
    """A frame's planes with grain: new tensors of the planes' types for
    the planes that take grain, the others as they are; nothing is
    written.  grain, lut: `device_tables` on the planes' device."""
    sx, sy = ssx, ssy
    dev = planes[0].device
    h, w = planes[0].shape
    nrows = (h + BLK - 1) // BLK
    ncols = (w + BLK - 1) // BLK
    R = block_randvals(fg.grain_seed, nrows, ncols)
    z = np.zeros_like(R)
    tl = z.copy()
    tl[1:, 1:] = R[:-1, :-1]
    R4 = np.stack([R,                                   # this block
                   np.concatenate([z[:, :1], R[:, :-1]], 1),   # left
                   np.concatenate([z[:1], R[:-1]], 0),         # above
                   tl])                                 # above-left
    gmin = -(128 << (bd - 8))
    gmax = (128 << (bd - 8)) - 1
    if fg.clip_to_restricted_range:
        ymin, ymax = 16 << (bd - 8), 235 << (bd - 8)
        cmin, cmax = 16 << (bd - 8), 240 << (bd - 8)
    else:
        ymin = cmin = 0
        ymax = cmax = (1 << bd) - 1
    shift = fg.grain_scaling
    overlap = bool(fg.overlap_flag)

    def offsets(subx, suby):
        ox, oy = _offsets(R4, subx, suby)
        return torch.from_numpy(ox).to(dev), torch.from_numpy(oy).to(dev)

    out = list(planes)
    on = planes_grained(fg, mono, len(planes))
    if 0 in on:
        # whole blocks, edge-padded; the tails are cropped after
        src = _edge_pad(planes[0], nrows * BLK, ncols * BLK)
        g = grain_plane(grain[0], *offsets(0, 0), BLK, BLK, 0, 0,
                        overlap, gmin, gmax)
        out[0] = _noise(src, src, g, lut[0], shift, ymin, ymax,
                        bd)[:h, :w].to(planes[0].dtype)
    if 1 in on or 2 in on:
        CH, CW = nrows * (BLK >> sy), ncols * (BLK >> sx)
        # chroma scales by luma averaged in pairs, luma edge-padded
        # to twice the padded chroma size (odd widths end in a pair
        # of the last column)
        luma = _edge_pad(planes[0], CH << sy, CW << sx)
        avg = luma[::(1 << sy), ::(1 << sx)]
        if sx:
            avg = (avg + luma[::(1 << sy), 1::(1 << sx)] + 1) >> 1
        off = offsets(sx, sy)
        for plane in (1, 2):
            if plane not in on:
                continue
            ch, cw2 = planes[plane].shape
            src = _edge_pad(planes[plane], CH, CW)
            g = grain_plane(grain[plane], *off, BLK >> sy, BLK >> sx, sx,
                            sy, overlap, gmin, gmax)
            if fg.chroma_scaling_from_luma:
                val = avg
            else:
                mult = (fg.cb_mult, fg.cr_mult)[plane - 1]
                lmult = (fg.cb_luma_mult, fg.cr_luma_mult)[plane - 1]
                offv = (fg.cb_offset, fg.cr_offset)[plane - 1]
                val = (((avg * (lmult - 128) + src * (mult - 128)) >> 6)
                       + ((offv - 256) << (bd - 8))).clamp_(
                    0, (1 << bd) - 1)
            out[plane] = _noise(src, val, g, lut[plane], shift, cmin, cmax,
                                bd)[:ch, :cw2].to(planes[plane].dtype)
    return out
