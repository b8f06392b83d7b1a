"""Deblocking then CDEF on the device: the counterpart of
`postfilter_fused.postfilter_frame` (`postfilter_fused.py:176-258`).

The host parameter maps come from the port's copies of the JAX
package's planners: `_lf_size_maps` (`postfilter_fused.py:113`),
`_cell_maps` (`lf_jax.py:197`), `_limits` (`lf_ref.py:55`) and
`unit_maps` (`cdef_jax.py:281`).

Planes and maps may carry a leading stream axis: `stack_maps` uploads
the host maps of frames of one geometry from different streams stacked,
and `postfilter_apply` filters them all in one launch sequence (the
counterpart of `multistream_av1.batched_postfilter_real`'s vmap).

On CUDA planes `postfilter_apply` runs the hand kernels (deblocking,
`csrc/loopfilter.cu`; CDEF, `csrc/cdef.cu`); `postfilter_apply_plain`
is the same chain in plain torch ops, which CPU planes take.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from easyav1_tpu_torch import convert
from easyav1_tpu_torch.video.av1.recon import cdef_torch, lf_torch


def _limits(lvl: int, sharpness: int, bitdepth: int):
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    if sharpness > 0:
        limit = min(max(1, lvl >> shift), 9 - sharpness)
    else:
        limit = max(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    scale = 1 << (bitdepth - 8)
    return limit * scale, blimit * scale, thresh * scale


def _cell_maps(g, plane, vertical: bool):
    """Per-cell edge size map (0=inactive) from lf_ref grids, matching
    the reference's per-edge conditions."""
    gw, gh = g["gw"], g["gh"]
    txw, txh = g["txw"], g["txh"]
    skip = g["skip"].astype(bool)
    if vertical:
        cx = np.arange(1, gw, dtype=np.int32)[None, :]      # [1, ne]
        on_edge = (cx % txw[:, 1:]) == 0
        blk = g["edge_left"][:, 1:]
        sk = skip[:, 1:] & skip[:, :-1]
        active = on_edge & (blk | ~sk)
        min_tx = np.minimum(txw[:, 1:], txw[:, :-1]) * 4
    else:
        cy = np.arange(1, gh, dtype=np.int32)[None, :]      # [1, ne]
        on_edge = (cy % txh[1:, :].T) == 0
        blk = g["edge_top"][1:, :].T
        sk = (skip[1:, :] & skip[:-1, :]).T
        active = on_edge & (blk | ~sk)
        min_tx = np.minimum(txh[1:, :], txh[:-1, :]).T * 4
    if plane == 0:
        s = np.where(min_tx >= 16, 14, np.where(min_tx >= 8, 8, 4))
    else:
        s = np.where(min_tx >= 8, 6, 4)
    return np.where(active, s, 0).astype(np.int32)


def _lf_size_maps(hdr, bd, dims, grids_for):
    """Host, for a frame whose deblocking is on: for each plane None
    when its level is 0 (it is not deblocked), else its (size_v, size_h)
    cell grids plus PER-EDGE level grids (levels vary per block on inter
    frames via ref/mode deltas, segments and delta_lf; the C decoder
    exports the resolved per-cell level grids), all uint8 with one row a
    4x4-cell row of lines; and the 64-entry (limit, blimit, thresh) LUT
    over the level, int32 [3, 64]."""
    level = hdr.lf.level
    plane_on = (bool(level[0] or level[1]), bool(level[2]), bool(level[3]))
    # 64-entry (limit, blimit, thresh) LUTs over the level
    luts = np.zeros((3, 64), np.int32)
    for lv in range(1, 64):
        luts[:, lv] = _limits(lv, hdr.lf.sharpness, bd)
    out = []
    for p, (ph, pw) in enumerate(dims):
        if not plane_on[p]:
            out.append(None)
            continue
        g = grids_for(p, (ph, pw))
        sizes, levels = [], []
        for pass_ in (0, 1):
            vertical = pass_ == 0
            ne = g["gw"] - 1 if vertical else g["gh"] - 1
            rows = (ph + 3) // 4 if vertical else (pw + 3) // 4
            if ne <= 0:
                size = np.zeros((rows, max(ne, 0)), np.uint8)
                lvl_e = np.zeros((rows, max(ne, 0)), np.uint8)
            else:
                size = _cell_maps(g, p, vertical)
                # per-edge level: current cell's, else the neighbour's
                lv = g["lvl0"] if pass_ == 0 else g["lvl1"]
                if vertical:
                    lvl_e = np.where(lv[:, 1:] > 0, lv[:, 1:],
                                     lv[:, :-1])
                else:
                    lvl_e = np.where(lv[1:, :] > 0, lv[1:, :],
                                     lv[:-1, :]).T
                size = np.where(lvl_e > 0, size, 0).astype(np.uint8)
                # visible-frame crop (parity: lf_ref._filter_pass)
                ss_x = 1 if g["gw"] < hdr.mi_cols else 0
                ss_y = 1 if g["gh"] < hdr.mi_rows else 0
                h4u = (hdr.frame_height + 3) >> 2
                w4u = (hdr.upscaled_width + 3) >> 2
                vis_h = min(ph, ((h4u + ss_y) >> ss_y) << 2)
                vis_w = min(pw, ((w4u + ss_x) >> ss_x) << 2)
                if vertical:
                    size[(vis_h + 3) >> 2:, :] = 0
                    ecap = (vis_w >> 2) - 1      # edge e at x=4(e+1)
                    size[:, max(ecap, 0):] = 0
                else:
                    size[(vis_w + 3) >> 2:, :] = 0
                    ecap = (vis_h >> 2) - 1
                    size[:, max(ecap, 0):] = 0
                lvl_e = lvl_e.astype(np.uint8)
            sizes.append(size)
            levels.append(lvl_e)
        out.append((*sizes, *levels))
    return out, luts


def unit_maps(skip_grid: np.ndarray, cdef_idx_grid: np.ndarray,
              mi_rows: int, mi_cols: int):
    """Per-8x8-unit (filtered?, strength index) maps from the mi skip
    grid and the per-64x64 cdef index grid (vectorized host math)."""
    uh = (mi_rows + 1) // 2
    uw = (mi_cols + 1) // 2
    # pad the skip grid to even dims replicating the last row/col
    # (matches min(r+1, mi_rows-1) in the scalar walk)
    sk = np.asarray(skip_grid, np.int8)
    if mi_rows & 1:
        sk = np.vstack([sk, sk[-1:]])
    if mi_cols & 1:
        sk = np.hstack([sk, sk[:, -1:]])
    all_skip = (sk[0::2, 0::2] & sk[0::2, 1::2]
                & sk[1::2, 0::2] & sk[1::2, 1::2])
    uy, ux = np.mgrid[0:uh, 0:uw]
    idxm = cdef_idx_grid[(uy * 2) // 16, (ux * 2) // 16].astype(np.int32)
    filt = ((all_skip == 0) & (idxm >= 0)).astype(np.int32)
    idxm = np.where(filt, idxm, -1)
    return filt, idxm


def postfilter_maps(hdr, seq, dims, grids_for, skip_grid: np.ndarray,
                    cdef_idx_grid: np.ndarray, device: torch.device) -> Dict:
    """The host half: a frame's LF and CDEF parameter maps, uploaded to
    `device`, for planes of shapes `dims`.  grids_for(plane, shape) ->
    lf_ref-style grids; skip_grid / cdef_idx_grid: the mi skip grid and
    the per-64x64 CDEF indices.  "lf" / "cdef" are None when the filter
    is off, and an entry of "lf" is None for a plane that is not
    deblocked."""
    return upload_maps(host_maps(hdr, seq, dims, grids_for, skip_grid,
                                 cdef_idx_grid), device)


def host_maps(hdr, seq, dims, grids_for, skip_grid: np.ndarray,
              cdef_idx_grid: np.ndarray) -> Dict:
    """`postfilter_maps` before the upload: the same dict of numpy
    arrays, without CDEF's "tabs"."""
    return {"bd": seq.color.bitdepth,
            "lf": lf_host_maps(hdr, seq, dims, grids_for),
            "cdef": cdef_host_maps(hdr, seq, skip_grid, cdef_idx_grid)}


def lf_host_maps(hdr, seq, dims, grids_for):
    """The deblocking half of `host_maps`: None when the frame does not
    deblock, else for each plane None (its level is 0) or its uint8 cell
    maps {"sv", "lv", "sh", "lh"}, one row a 4x4-cell row of lines (the
    kernel reads them so), and the frame's "lut"."""
    if not any(hdr.lf.level[:4]) or getattr(hdr, "allow_intrabc", False):
        return None
    cells, lut = _lf_size_maps(hdr, seq.color.bitdepth, dims, grids_for)
    return [None if c is None else
            {"sv": c[0][:(ph + 3) >> 2], "sh": c[1][:(pw + 3) >> 2],
             "lv": c[2][:(ph + 3) >> 2], "lh": c[3][:(pw + 3) >> 2],
             "lut": lut}
            for c, (ph, pw) in zip(cells, dims)]


def cdef_host_maps(hdr, seq, skip_grid: np.ndarray,
                   cdef_idx_grid: np.ndarray):
    """The CDEF half of `host_maps`: None when CDEF is off, else the
    int32 unit maps (strengths shifted by coeff_shift, 0 where a unit is
    skipped; the filter flags) and the frame's constants."""
    cd = hdr.cdef
    cdef_on = (getattr(seq, "enable_cdef", False) and cd is not None
               and not hdr.coded_lossless
               and not getattr(hdr, "allow_intrabc", False)
               and (max(cd.y_pri_strength, default=0)
                    or max(cd.y_sec_strength, default=0)
                    or max(cd.uv_pri_strength, default=0)
                    or max(cd.uv_sec_strength, default=0)))
    if not cdef_on:
        return None
    cs = seq.color.bitdepth - 8
    filt, idxm = unit_maps(skip_grid, cdef_idx_grid, hdr.mi_rows,
                           hdr.mi_cols)
    safe = np.where(idxm >= 0, idxm, 0)
    sel = filt != 0
    nz = np.zeros(8, np.int32)     # monochrome streams code no uv
    strengths = {
        "pri_y": cd.y_pri_strength, "sec_y": cd.y_sec_strength,
        "pri_uv": cd.uv_pri_strength if len(cd.uv_pri_strength) else nz,
        "sec_uv": cd.uv_sec_strength if len(cd.uv_sec_strength) else nz}
    return {k: (np.where(sel, np.asarray(v, np.int32)[safe], 0)
                << cs).astype(np.int32) for k, v in strengths.items()} | {
        "filt": filt.astype(np.int32), "cs": cs,
        "damping": cd.damping + cs,
        "ss": (seq.color.subsampling_x, seq.color.subsampling_y)}


def upload_maps(maps: Dict, device: torch.device) -> Dict:
    """The numpy arrays of `host_maps` as tensors on `device`, with
    CDEF's tables."""
    def up(d):
        arrays = {k: v for k, v in d.items() if isinstance(v, np.ndarray)}
        return d | convert.from_reference(arrays, device)

    out = dict(maps)
    if maps["lf"] is not None:
        out["lf"] = [None if m is None else up(m) for m in maps["lf"]]
    if maps["cdef"] is not None:
        out["cdef"] = up(maps["cdef"]) | {"tabs": convert.tables(device)}
    return out


def stack_maps(maps: List[Dict], dims, device: torch.device) -> Dict:
    """The `host_maps` of S frames of one geometry and bit depth (planes
    of shapes `dims`) as `upload_maps` gives them, each map stacked on a
    leading stream axis ([S, ...]; CDEF's damping [S, 1, 1]).  Each
    frame's arrays are copied into their slice of the stacked tensor on
    `device`, with no copy on the host.  A frame whose filter is off gets
    zero maps there, which filter nothing: size 0 deblocks no edge,
    strength 0 leaves a pixel as it is (the JAX package pads the
    zero-width edge maps of an LF-off stream,
    `multistream_av1.py:298-307`).  "lf" or "cdef", or a plane's entry of
    "lf", is None only when it is None for every frame."""
    bds = {m["bd"] for m in maps}
    if len(bds) != 1:
        raise ValueError(f"one batch, one bit depth: {sorted(bds)}")

    def stack(arrays, shape, dtype=torch.int32):
        out = torch.empty((len(arrays), *shape), dtype=dtype, device=device)
        for s, a in enumerate(arrays):
            if a is None:
                out[s].zero_()
            else:
                out[s].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return out

    out = {"bd": bds.pop(), "lf": None, "cdef": None}
    if any(m["lf"] is not None for m in maps):
        out["lf"] = []
        for p, (ph, pw) in enumerate(dims):
            per = [None if m["lf"] is None else m["lf"][p] for m in maps]
            if all(d is None for d in per):
                out["lf"].append(None)      # no stream deblocks plane p
                continue
            nev, neh = max((pw + 3) // 4 - 1, 0), max((ph + 3) // 4 - 1, 0)
            rv, rh = (ph + 3) // 4, (pw + 3) // 4
            shapes = {"sv": (rv, nev), "lv": (rv, nev), "sh": (rh, neh),
                      "lh": (rh, neh)}
            lf = {k: stack([None if d is None else d[k] for d in per], shape,
                           torch.uint8) for k, shape in shapes.items()}
            lf["lut"] = stack([None if d is None else d["lut"] for d in per],
                              (3, 64))
            out["lf"].append(lf)
    on = [m["cdef"] for m in maps if m["cdef"] is not None]
    if on:
        keys = ("pri_y", "sec_y", "pri_uv", "sec_uv", "filt")
        per = [m["cdef"] or {} for m in maps]
        out["cdef"] = {k: stack([d.get(k) for d in per], on[0][k].shape)
                       for k in keys} | {
            "cs": on[0]["cs"], "ss": on[0]["ss"],
            "damping": torch.tensor(
                [d.get("damping", on[0]["damping"]) for d in per],
                dtype=torch.int32, device=device).reshape(-1, 1, 1),
            "tabs": convert.tables(device)}
    return out


def postfilter_apply(planes: List[torch.Tensor], maps: Dict,
                     want_deblocked: bool = False):
    """The device half: LF + CDEF over mi-aligned int32 planes with the
    maps of `postfilter_maps`, through the kernels' wrappers (on CUDA
    planes one `lf_torch.lf_launch` when a plane deblocks, and one
    `cdef_torch.dirs_launch` and one `cdef_torch.filter_launch` when CDEF
    is on: three launches a frame at most); returns the filtered planes, or with
    `want_deblocked` (planes, deblocked): also the planes after LF and
    before CDEF, which loop restoration reads above and below a stripe
    (`postfilter_fused.py:206`, `:256-257`).  No function here writes a
    plane it was given, so with LF off the snapshot is the input planes
    and with CDEF off it is the result.  Planes [S, ph, pw] with the
    maps of `stack_maps` filter S frames at once."""
    return _apply(planes, maps, want_deblocked, lf_torch.lf_launch,
                  cdef_torch.dirs_launch, cdef_torch.filter_launch)


def postfilter_apply_plain(planes: List[torch.Tensor], maps: Dict,
                           want_deblocked: bool = False):
    """`postfilter_apply` as plain torch ops on any device
    (`lf_frame_plain`, `find_dirs`, `filter_planes`): what the kernels are held to on the
    card, and what `postfilter_apply` runs on CPU planes."""
    return _apply(planes, maps, want_deblocked, lf_torch.lf_frame_plain,
                  cdef_torch.find_dirs, cdef_torch.filter_planes)


def _apply(planes, maps, want_deblocked, deblock, find_dirs, filt):
    bd = maps["bd"]
    out = list(planes)
    if maps["lf"] is not None:
        out = deblock(out, maps["lf"], bd)
    deblocked = list(out)
    m = maps["cdef"]
    if m is not None:
        uh, uw = m["filt"].shape[-2:]
        dirs, var = find_dirs(out[0], uh, uw, m["cs"], m["tabs"])
        out = filt(out, dirs, var, *cdef_torch.strengths(m, len(out)),
                   m["filt"], *m["ss"], bd, m["damping"], m["tabs"])
    return (out, deblocked) if want_deblocked else out


def postfilter_frame(planes: List[torch.Tensor], hdr, seq, grids_for,
                     skip_grid: np.ndarray, cdef_idx_grid: np.ndarray,
                     want_deblocked: bool = False):
    """LF + CDEF over mi-aligned int32 planes on one device; returns as
    `postfilter_apply`.  Arguments as `postfilter_maps`."""
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in planes)
    return postfilter_apply(planes, postfilter_maps(
        hdr, seq, dims, grids_for, skip_grid, cdef_idx_grid,
        planes[0].device), want_deblocked)
