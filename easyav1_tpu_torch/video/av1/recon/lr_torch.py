"""Loop restoration on the device (spec 7.17), Wiener and SGR (the
box filter of `RESTORE_SGRPROJ`, spec 7.17.3): the counterpart of
`lr_jax.DeviceLoopRestoration.apply_device` with `_lr_stripes`,
`_stripe_params`, `_row_sources` and `_fil7` (`lr_jax.py:47-182`,
`:266-416`), and of `_lr_plan`
(`easyav1_tpu/native/__init__.py:1516-1530`).

`LoopRestoration.apply` is what the pipe calls: on CUDA tensors it
launches `csrc/lr.cu` (built by nvcc at first use) once a frame for
every plane that restores, through `lr_launch`, or raises; on CPU
tensors it takes the plain version, `apply_plain`.  The kernel reads one
small table a frame, one entry a restoration unit
(`LoopRestoration.unit_table`).

The plain version: stripes of 64 luma rows never read each other's
output, so a plane is one batch of stripe windows [ns, sh + 6, W + 6];
rows above and below a stripe come from the deblocked (pre-CDEF)
snapshot, clamped two rows in.  The host expands each restoration
unit's parameters across its columns (numpy, as in the reference); the
device filters with exact integer torch ops.  Everything is int32 except
the SGR `p * s`, which the reference computes in uint32 and which passes
2^31: int64 here, masked to 32 bits; and b2's product, int64, which
passes 2^31 at 12 bits.  Above 8 bits the SGR variance takes the box
sums rounded to 8 bits and b2 the sum itself, as the spec (7.17.3) and
dav1d do; the JAX package rounds the sum for both.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from easyav1_tpu_torch import _build, convert, trace
from easyav1_tpu_torch.video.av1 import constants as C

# Copies of easyav1_tpu/video/av1/lr_ref.py::SGR_RADII, SGR_S and _DIV_LUT
# (spec Sgr_Params and Div_Lut).
SGR_RADII = [(2, 1)] * 10 + [(0, 1)] * 4 + [(2, 0)] * 2
SGR_S = [(140, 3236), (112, 2158), (93, 1618), (80, 1438),
         (70, 1295), (58, 1177), (47, 1079), (37, 996),
         (30, 925), (25, 863), (0, 2589), (0, 1618),
         (0, 1177), (0, 925), (56, 0), (22, 0)]
_DIV_LUT = {9: 455, 25: 164}


def _a2_lut() -> np.ndarray:
    """a2 as a function of min(z, 255) (spec 7.17.3)."""
    lut = np.empty(256, np.int32)
    lut[0] = 1
    for z in range(1, 255):
        lut[z] = ((z << 8) + z // 2) // (z + 1)
    lut[255] = 256
    return lut


_A2 = _a2_lut()
# ints a restoration unit's entry in `LoopRestoration.unit_table`
LR_ENTRY = 20


@functools.lru_cache(maxsize=None)
def _a2_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_A2).to(device)


def lr_plan(out, bufs) -> SimpleNamespace:
    """The C entropy decoder's restoration unit records -> the plan that
    `LoopRestoration` reads: type, Wiener taps and SGR
    parameters by (plane, unit row, unit column)."""
    plan = SimpleNamespace(lr_type={}, lr_wiener={}, lr_sgr={})
    for u in bufs["lr"][:out.n_lr_units]:
        key = (int(u[0]), int(u[1]), int(u[2]))
        plan.lr_type[key] = int(u[3])
        if u[3] == C.RESTORE_WIENER:
            plan.lr_wiener[key] = [[int(u[4]), int(u[5]), int(u[6])],
                                   [int(u[7]), int(u[8]), int(u[9])]]
        elif u[3] == C.RESTORE_SGRPROJ:
            plan.lr_sgr[key] = (int(u[10]), int(u[11]), int(u[12]))
    return plan


def _fil7_rows(t3: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """The 7-tap Wiener filters [n, 7] of n coded tap triples [n, 3] of
    the planes [n] (chroma has no outer tap)."""
    t0 = np.where(plane != 0, 0, t3[:, 0])
    t1, t2 = t3[:, 1], t3[:, 2]
    return np.stack([t0, t1, t2, 128 - 2 * (t0 + t1 + t2), t2, t1, t0], 1)


def _win2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window sums over the last two axes of [ns, R, Cc] int32 ->
    [ns, R - k + 1, Cc - k + 1] int32.  The running sums are int64
    (torch.cumsum's type for int32 input); a window's sum fits int32."""
    c = torch.nn.functional.pad(torch.cumsum(x, 1), (0, 0, 1, 0))
    rv = c[:, k:] - c[:, :-k]
    c2 = torch.nn.functional.pad(torch.cumsum(rv, 2), (1, 0))
    return (c2[:, :, k:] - c2[:, :, :-k]).to(torch.int32)


def lr_stripes(S, m, lut, sh: int, bd: int) -> torch.Tensor:
    """One plane's stripes.

    S: [ns, sh + 6, W + 6] int32 stripe sources (rows y0 - 3 .. y1 + 3,
    3 edge-replicated columns each side; short stripes padded by
    repeating their last row).  m: the per-column maps of
    `LoopRestoration.stripe_params` on S's device: "FH", "FV"
    [ns, 7, W] Wiener taps; "is_w", "is_s", "r0c", "r1c" [ns, W] bool;
    "s0c", "s1c", "w0c", "w1c" [ns, W] int32; "any_w", "any_s" Python
    bools.  lut: `_A2` on the device.  Returns [ns, sh, W] int32."""
    W = S.shape[2] - 6
    center = S[:, 3:3 + sh, 3:3 + W]
    out = center

    if m["any_w"]:
        FH, FV = m["FH"], m["FV"]
        round0 = 3 + (2 if bd == 12 else 0)
        round1 = 11 - (2 if bd == 12 else 0)
        limit = (1 << (bd + 1 + 7 - round0)) - 1
        inter = torch.full_like(S[:, :, :W], 1 << (bd + 6))
        for k in range(7):
            inter += FH[:, k, None, :] * S[:, :, k:k + W]
        inter += 1 << (round0 - 1)
        inter >>= round0
        inter.clamp_(0, limit)
        # starts below zero: >> on int32 is arithmetic
        resw = torch.full_like(center, -(1 << (bd + round1 - 1)))
        for k in range(7):
            resw += FV[:, k, None, :] * inter[:, k:k + sh, :]
        resw += 1 << (round1 - 1)
        resw >>= round1
        resw.clamp_(0, (1 << bd) - 1)
        out = torch.where(m["is_w"][:, None, :], resw, out)

    if m["any_s"]:
        u = center << 4
        S2 = S * S

        def boxes(radius):
            # grid row g (0 .. sh + 1) is centred at S row g + 2, grid
            # column j at S column j + 2: windows stay in the padding
            k = 2 * radius + 1
            o = 2 - radius
            sub = slice(o, o + sh + 2 + k - 1), slice(o, o + W + 2 + k - 1)
            return _win2d(S2[:, sub[0], sub[1]], k), \
                _win2d(S[:, sub[0], sub[1]], k)       # [ns, sh + 2, W + 2]

        def sgr_pass(radius, n, sc, pass0):
            one_over_n = _DIV_LUT[n]
            asum, bsum = boxes(radius)
            # above 8 bits the variance takes the sums rounded to 8 bits,
            # b2 the sum itself (spec 7.17.3; lr_jax rounds it for both)
            dsum = bsum
            if bd > 8:
                shp = 2 * (bd - 8)
                asum = (asum + (1 << (shp - 1))) >> shp
                dsum = (bsum + (1 << (bd - 9))) >> (bd - 8)
            p = (asum * n - dsum * dsum).clamp_(min=0).to(torch.int64)
            sc = sc[:, None, :].to(torch.int64)

            # a2 and b2 at grid-column offset dx, with the s of the
            # OUTPUT column (a unit recomputes its boundary ring with its
            # own s), [ns, sh + 2, W]
            def ab(dx):
                pp = p[:, :, 1 + dx:1 + dx + W]
                bb = bsum[:, :, 1 + dx:1 + dx + W]
                z = ((pp * sc + (1 << 19)) & 0xFFFFFFFF) >> 20
                a2 = lut[z.clamp_(max=255)]
                # int64: at 12 bits (256 - a2) b one_over_n passes 2^31
                b2 = (((256 - a2).to(torch.int64) * bb * one_over_n
                       + (1 << 11)) >> 12).to(torch.int32)
                return a2, b2

            if pass0:
                # even rows: grid rows i and i + 2 with column weights
                # 5, 6, 5, shift 9; odd rows: grid row i + 1, shift 8
                a_e, b_e, a_o, b_o = (torch.zeros_like(center)
                                      for _ in range(4))
                for dx in (-1, 0, 1):
                    wt = 6 if dx == 0 else 5
                    a2, b2 = ab(dx)
                    a_e += wt * (a2[:, 0:sh] + a2[:, 2:sh + 2])
                    b_e += wt * (b2[:, 0:sh] + b2[:, 2:sh + 2])
                    a_o += wt * a2[:, 1:sh + 1]
                    b_o += wt * b2[:, 1:sh + 1]
                even = (torch.arange(sh, device=S.device) % 2 == 0)[
                    None, :, None]
                return torch.where(even,
                                   (a_e * center + b_e + (1 << 8)) >> 9,
                                   (a_o * center + b_o + (1 << 7)) >> 8)
            a_m, b_m = torch.zeros_like(center), torch.zeros_like(center)
            for dx in (-1, 0, 1):
                a2, b2 = ab(dx)
                for dy in (-1, 0, 1):
                    wt = 4 if (dx == 0 or dy == 0) else 3
                    a_m += wt * a2[:, 1 + dy:sh + 1 + dy]
                    b_m += wt * b2[:, 1 + dy:sh + 1 + dy]
            return (a_m * center + b_m + (1 << 8)) >> 9

        w0c, w1c = m["w0c"][:, None, :], m["w1c"][:, None, :]
        flt0 = torch.where(m["r0c"][:, None, :],
                           sgr_pass(2, 25, m["s0c"], True), u)
        flt1 = torch.where(m["r1c"][:, None, :],
                           sgr_pass(1, 9, m["s1c"], False), u)
        v = w0c * flt0 + w1c * u + (128 - w0c - w1c) * flt1
        ress = ((v + (1 << 10)) >> 11).clamp_(0, (1 << bd) - 1)
        out = torch.where(m["is_s"][:, None, :], ress, out)

    return out


class LoopRestoration:
    """Loop restoration of one frame: `apply(planes, deblocked)` takes
    the planes after CDEF (and superres) and the deblocked snapshot, both
    int32 tensors on one device, possibly mi-padded beyond the visible
    size, and returns new planes with LR applied, equal to
    `lr_jax.DeviceLoopRestoration.apply_device`."""

    def __init__(self, hdr, seq, plan, bitdepth: int):
        self.hdr = hdr
        self.seq = seq
        self.plan = plan
        self.bd = bitdepth
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y

    def _plane_geometry(self, plane):
        hdr = self.hdr
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        pw = (hdr.upscaled_width + ssx) >> ssx
        ph = (hdr.frame_height + ssy) >> ssy
        stripe_h = 64 >> ssy
        stripe_off = 8 >> ssy
        ns = (ph + stripe_off + stripe_h - 1) // stripe_h
        return pw, ph, stripe_h, stripe_off, ns

    def _unit_grid(self, plane):
        """(unit size, unit rows, unit columns) of a plane: the last
        unit of a row or column absorbs the remainder."""
        pw, ph = self._plane_geometry(plane)[:2]
        unit_size = self.hdr.lr.loop_restoration_size[plane]
        return (unit_size, max((ph + (unit_size >> 1)) // unit_size, 1),
                max((pw + (unit_size >> 1)) // unit_size, 1))

    def unit_table(self):
        """Host: what `csrc/lr.cu` reads, (dims, table).  table: int32
        [units, LR_ENTRY], an entry a restoration unit of each plane
        that restores, row-major by unit row and column: type (Wiener,
        SGR, or 0: copied), the horizontal and the vertical 7-tap Wiener
        filters (`_fil7_rows`), the SGR set, xqd0, xqd1, 0, 0.  dims: a list,
        by plane that restores, of (plane, ph, pw, stripe height, its
        offset, unit size, unit rows, unit columns, first entry).  A
        plane restores when its frame type is not NONE and one of its
        units is Wiener or SGR; units of the plan outside a plane's unit
        grid are not read, as in `stripe_params`."""
        lr = getattr(self.hdr, "lr", None)
        dims, tables, n = [], [], 0
        if lr is None or not lr.uses_lr:
            return dims, np.zeros((0, LR_ENTRY), np.int32)
        plan = self.plan
        keys = list(plan.lr_type)
        flat = itertools.chain.from_iterable
        k = np.fromiter(flat(keys), np.int64, 3 * len(keys)).reshape(-1, 3)
        types = np.fromiter(plan.lr_type.values(), np.int64, len(keys))
        # an entry for every unit of the plan, then scattered by plane
        rows = np.zeros((len(keys), LR_ENTRY), np.int32)
        w = np.flatnonzero(types == C.RESTORE_WIENER)
        taps = np.fromiter(flat(flat(plan.lr_wiener[keys[i]] for i in w)),
                           np.int32, 6 * len(w)).reshape(-1, 2, 3)
        rows[w, 0] = C.RESTORE_WIENER
        rows[w, 1:8] = _fil7_rows(taps[:, 1], k[w, 0])
        rows[w, 8:15] = _fil7_rows(taps[:, 0], k[w, 0])
        sg = np.flatnonzero(types == C.RESTORE_SGRPROJ)
        rows[sg, 0] = C.RESTORE_SGRPROJ
        rows[sg, 15:18] = np.fromiter(flat(plan.lr_sgr[keys[i]] for i in sg),
                                      np.int32, 3 * len(sg)).reshape(-1, 3)
        for plane in range(self.seq.color.num_planes):
            if lr.frame_restoration_type[plane] == C.RESTORE_NONE:
                continue
            pw, ph, sh, off, _ns = self._plane_geometry(plane)
            unit_size, urows, ucols = self._unit_grid(plane)
            sel = ((k[:, 0] == plane) & (k[:, 1] < urows)
                   & (k[:, 2] < ucols) & (rows[:, 0] != 0))
            if not sel.any():
                continue
            t = np.zeros((urows * ucols, LR_ENTRY), np.int32)
            t[k[sel, 1] * ucols + k[sel, 2]] = rows[sel]
            dims.append((plane, ph, pw, sh, off, unit_size, urows, ucols,
                         n))
            tables.append(t)
            n += urows * ucols
        if not dims:
            return dims, np.zeros((0, LR_ENTRY), np.int32)
        return dims, np.concatenate(tables)

    def stripe_params(self, plane):
        """Host: (spans, maps) of a plane.  spans: per stripe (y0, h) or
        None; maps: the per-column parameter maps `lr_stripes` reads, as
        numpy, with "any_w" and "any_s"."""
        pw, ph, stripe_h, stripe_off, ns = self._plane_geometry(plane)
        unit_size, unit_rows, unit_cols = self._unit_grid(plane)
        m = {"FH": np.zeros((ns, 7, pw), np.int32),
             "FV": np.zeros((ns, 7, pw), np.int32)}
        for k in ("is_w", "is_s", "r0c", "r1c"):
            m[k] = np.zeros((ns, pw), bool)
        for k in ("s0c", "s1c", "w0c", "w1c"):
            m[k] = np.zeros((ns, pw), np.int32)
        spans = []
        for s in range(ns):
            ss = s * stripe_h - stripe_off
            y0 = max(0, ss)
            y1 = min(ss + stripe_h - 1, ph - 1)
            if y0 > y1:
                spans.append(None)
                continue
            spans.append((y0, y1 - y0 + 1))
            urow = min(unit_rows - 1, (ss + stripe_off) // unit_size)
            for ucol in range(unit_cols):
                key = (plane, urow, ucol)
                rtype = self.plan.lr_type.get(key, C.RESTORE_NONE)
                cs = slice(ucol * unit_size,
                           (ucol + 1) * unit_size
                           if ucol < unit_cols - 1 else pw)
                if rtype == C.RESTORE_WIENER:
                    taps = self.plan.lr_wiener[key]
                    for name, t3 in (("FH", taps[1]), ("FV", taps[0])):
                        m[name][s, :, cs] = _fil7_rows(
                            np.asarray([t3]), np.asarray([plane]))[0][:, None]
                    m["is_w"][s, cs] = True
                elif rtype == C.RESTORE_SGRPROJ:
                    sgr_set, xqd0, xqd1 = self.plan.lr_sgr[key]
                    rad, sv = SGR_RADII[sgr_set], SGR_S[sgr_set]
                    m["s0c"][s, cs], m["s1c"][s, cs] = sv
                    m["r0c"][s, cs] = rad[0] != 0
                    m["r1c"][s, cs] = rad[1] != 0
                    m["w0c"][s, cs], m["w1c"][s, cs] = xqd0, xqd1
                    m["is_s"][s, cs] = True
        return spans, m

    def row_sources(self, plane, spans):
        """Host: per (stripe, source row) the plane row it reads, and
        whether it reads the deblocked snapshot: rows above and below the
        stripe do, clamped two rows into it."""
        _pw, ph, sh, stripe_off, ns = self._plane_geometry(plane)
        row_idx = np.zeros((ns, sh + 6), np.int64)
        sel_debl = np.zeros((ns, sh + 6), bool)
        for s in range(ns):
            if spans[s] is None:
                continue
            ss = s * sh - stripe_off
            se = ss + sh - 1
            y0, h = spans[s]
            y = y0 - 3 + np.minimum(np.arange(sh + 6), h + 5)
            yy = np.clip(y, 0, ph - 1)
            row_idx[s] = np.where(yy < ss, np.maximum(ss - 2, yy),
                                  np.where(yy > se, np.minimum(se + 2, yy),
                                           yy))
            sel_debl[s] = (yy < ss) | (yy > se)
        return row_idx, sel_debl

    def apply(self, planes: List[torch.Tensor],
              deblocked: List[torch.Tensor]) -> List[torch.Tensor]:
        """`lr_launch`: the kernel on CUDA tensors, `apply_plain` on CPU
        tensors."""
        return lr_launch(self, planes, deblocked)

    def apply_plain(self, planes: List[torch.Tensor],
                    deblocked: List[torch.Tensor]) -> List[torch.Tensor]:
        """`apply` as plain torch ops on any device: `lr_stripes` on the
        gathered stripe windows of each plane that restores."""
        lr = getattr(self.hdr, "lr", None)
        out = list(planes)
        if lr is None or not lr.uses_lr:
            return out
        for plane in range(self.seq.color.num_planes):
            if lr.frame_restoration_type[plane] == C.RESTORE_NONE:
                continue
            pw, ph, sh, _off, ns = self._plane_geometry(plane)
            spans, m = self.stripe_params(plane)
            any_w, any_s = bool(m["is_w"].any()), bool(m["is_s"].any())
            if not (any_w or any_s):
                continue
            device = out[plane].device
            row_idx, sel_debl = self.row_sources(plane, spans)
            ymap = np.zeros(ph, np.int64)
            for s, span in enumerate(spans):
                if span is not None:
                    y0, h = span
                    ymap[y0:y0 + h] = s * sh + np.arange(h)
            m = convert.from_reference(
                m | {"rows": row_idx.reshape(-1),
                     "debl": sel_debl.reshape(-1), "ymap": ymap}, device)
            m |= {"any_w": any_w, "any_s": any_s}
            cdef_d = out[plane][:ph, :pw].to(torch.int32)
            debl_d = deblocked[plane][:ph, :pw].to(torch.int32)
            S = torch.where(m["debl"][:, None], debl_d[m["rows"]],
                            cdef_d[m["rows"]]).reshape(ns, sh + 6, pw)
            S = torch.cat([S[:, :, :1].expand(-1, -1, 3), S,
                           S[:, :, -1:].expand(-1, -1, 3)], dim=2)
            res = lr_stripes(S, m, _a2_on(device), sh, self.bd)
            restored = res.reshape(ns * sh, pw)[m["ymap"]]
            new = out[plane].clone()
            new[:ph, :pw] = restored.to(new.dtype)
            out[plane] = new
        return out


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_LR = _build.Kernel("lr", "lr_frame_launch",
                    [ctypes.POINTER(_VP), ctypes.POINTER(_CI), _CI, _VP, _CI],
                    "lr_frame_kernel")


def launch_dims(dims, planes, deblocked) -> List[int]:
    """`lr_frame_launch`'s dims, 11 ints a plane that restores (h, w,
    the snapshot's pitch, ph, pw, stripe height and offset, unit size,
    unit rows and columns, first entry), from `unit_table`'s dims; raises
    unless the planes and snapshots are 2-D int32 tensors that cover the
    visible size."""
    out = []
    for plane, ph, pw, *rest in dims:
        x, d = planes[plane], deblocked[plane]
        if (x.dtype != torch.int32 or d.dtype != torch.int32
                or x.dim() != 2 or d.dim() != 2 or x.shape[0] < ph
                or x.shape[1] < pw or d.shape[0] < ph or d.shape[1] < pw):
            raise ValueError(
                f"plane {plane}: want 2-D int32 planes and snapshots "
                f"covering {ph}x{pw}, got {x.dtype} {tuple(x.shape)} and "
                f"{d.dtype} {tuple(d.shape)}")
        out += [*x.shape, d.shape[1], ph, pw, *rest]
    return out


def lr_launch(lr: LoopRestoration, planes: List[torch.Tensor],
              deblocked: List[torch.Tensor]) -> List[torch.Tensor]:
    """Loop restoration of a frame's int32 planes (possibly mi-padded
    beyond the visible size) from the deblocked snapshot (int32, covering
    the visible size), as `lr` (a `LoopRestoration`) says.  CUDA tensors
    (contiguous) launch `csrc/lr.cu` once for every plane that restores,
    into new planes, or raise; CPU tensors take `lr.apply_plain`.  A
    plane that does not restore is returned as it is; no input is
    written."""
    dims, table = lr.unit_table()
    if not dims:
        return list(planes)
    ints = launch_dims(dims, planes, deblocked)
    on = [d[0] for d in dims]
    if not _build.on_card(planes[on[0]], [t for p in on
                                   for t in (planes[p], deblocked[p])]):
        return lr.apply_plain(planes, deblocked)
    host = torch.from_numpy(table).pin_memory()
    trace.add(h2d_bytes=host.nbytes)
    tab = host.to(planes[on[0]].device, non_blocking=True)
    return frame_launch(planes, deblocked, on, ints, tab, lr.bd)


def frame_launch(planes: List[torch.Tensor], deblocked: List[torch.Tensor],
                 on: List[int], ints: List[int], table: torch.Tensor,
                 bd: int) -> List[torch.Tensor]:
    """The launch of `lr_launch`: the planes `on` restored into new
    planes from `launch_dims`' ints and `unit_table`'s table, int32 on
    the planes' device (the rest as they are).  Raises if the launch
    fails."""
    out = list(planes)
    ptrs = []
    for p in on:
        out[p] = torch.empty_like(planes[p])
        ptrs += [planes[p].data_ptr(), deblocked[p].data_ptr(),
                 out[p].data_ptr()]
    _LR.launch(planes[on[0]].device, (_VP * len(ptrs))(*ptrs),
               (_CI * len(ints))(*ints), len(on), table.data_ptr(), bd)
    return out
