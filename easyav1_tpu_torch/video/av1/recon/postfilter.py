"""Deblocking then CDEF on the device: the counterpart of
`postfilter_fused.postfilter_frame` (`postfilter_fused.py:176-258`).

The host parameter maps come from the JAX package's own planners
(`_lf_size_maps`, `unit_maps`), shared by import.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from easyav1_tpu.video.av1.recon.cdef_jax import unit_maps
from easyav1_tpu.video.av1.recon.postfilter_fused import _lf_size_maps
from easyav1_tpu_torch import convert
from easyav1_tpu_torch.video.av1.recon import cdef_torch, lf_torch


def postfilter_maps(hdr, seq, dims, grids_for, skip_grid: np.ndarray,
                    cdef_idx_grid: np.ndarray, device: torch.device) -> Dict:
    """The host half: a frame's LF and CDEF parameter maps, uploaded to
    `device`, for planes of shapes `dims`.  grids_for(plane, shape) ->
    lf_ref-style grids; skip_grid / cdef_idx_grid: the mi skip grid and
    the per-64x64 CDEF indices.  "lf" / "cdef" are None when the filter
    is off."""
    bd = seq.color.bitdepth
    num_planes = len(dims)
    maps = {"bd": bd, "lf": None, "cdef": None}
    lf_on = not (hdr.lf.level[0] == 0 and hdr.lf.level[1] == 0
                 and hdr.lf.level[2] == 0 and hdr.lf.level[3] == 0) \
        and not getattr(hdr, "allow_intrabc", False)
    if lf_on:
        sizes_v, sizes_h, lims_v, lims_h = _lf_size_maps(
            hdr, bd, dims, num_planes, grids_for)
        maps["lf"] = [convert.from_reference(
            {"sv": np.repeat(sizes_v[p], 4, axis=0)[:ph],
             "lv": np.repeat(lims_v[p], 4, axis=1)[:, :ph],
             "sh": np.repeat(sizes_h[p], 4, axis=0)[:pw],
             "lh": np.repeat(lims_h[p], 4, axis=1)[:, :pw]}, device)
            for p, (ph, pw) in enumerate(dims)]

    cd = hdr.cdef
    cdef_on = (getattr(seq, "enable_cdef", False) and cd is not None
               and not hdr.coded_lossless
               and not getattr(hdr, "allow_intrabc", False)
               and (max(cd.y_pri_strength, default=0)
                    or max(cd.y_sec_strength, default=0)
                    or max(cd.uv_pri_strength, default=0)
                    or max(cd.uv_sec_strength, default=0)))
    if cdef_on:
        cs = bd - 8
        filt, idxm = unit_maps(skip_grid, cdef_idx_grid, hdr.mi_rows,
                               hdr.mi_cols)
        safe = np.where(idxm >= 0, idxm, 0)
        sel = filt != 0
        nz = np.zeros(8, np.int32)     # monochrome streams code no uv
        strengths = {
            "pri_y": cd.y_pri_strength, "sec_y": cd.y_sec_strength,
            "pri_uv": cd.uv_pri_strength if len(cd.uv_pri_strength) else nz,
            "sec_uv": cd.uv_sec_strength if len(cd.uv_sec_strength) else nz}
        maps["cdef"] = convert.from_reference(
            {k: (np.where(sel, np.asarray(v, np.int32)[safe], 0)
                 << cs).astype(np.int32) for k, v in strengths.items()}
            | {"filt": filt.astype(np.int32)}, device) | {
            "cs": cs, "damping": cd.damping + cs,
            "ss": (seq.color.subsampling_x, seq.color.subsampling_y),
            "tabs": convert.tables(device)}
    return maps


def postfilter_apply(planes: List[torch.Tensor],
                     maps: Dict) -> List[torch.Tensor]:
    """The device half: LF + CDEF over mi-aligned int32 planes with the
    maps of `postfilter_maps`; returns the filtered planes."""
    bd = maps["bd"]
    out = list(planes)
    if maps["lf"] is not None:
        for p, m in enumerate(maps["lf"]):
            buf = lf_torch.pass_body(out[p], m["sv"], *m["lv"], bd)
            out[p] = lf_torch.pass_body(buf.T, m["sh"], *m["lh"], bd).T
    m = maps["cdef"]
    if m is not None:
        uh, uw = m["filt"].shape
        dirs, var = cdef_torch.find_dirs(out[0], uh, uw, m["cs"], m["tabs"])
        out = [cdef_torch.filter_plane(
            out[p], dirs, var, m["pri_y" if p == 0 else "pri_uv"],
            m["sec_y" if p == 0 else "sec_uv"], m["filt"], *m["ss"], p, bd,
            m["damping"], m["tabs"]) for p in range(len(out))]
    return out


def postfilter_frame(planes: List[torch.Tensor], hdr, seq, grids_for,
                     skip_grid: np.ndarray,
                     cdef_idx_grid: np.ndarray) -> List[torch.Tensor]:
    """LF + CDEF over mi-aligned int32 planes on one device; returns the
    filtered planes.  Arguments as `postfilter_maps`."""
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in planes)
    return postfilter_apply(planes, postfilter_maps(
        hdr, seq, dims, grids_for, skip_grid, cdef_idx_grid,
        planes[0].device))
