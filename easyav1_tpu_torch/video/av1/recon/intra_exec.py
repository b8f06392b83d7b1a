"""Intra frame recon on the device: the counterpart of
`jax_exec.PallasRecon` (`jax_exec.py:997-1183`).

The host prepares the records (`preprocess_units`), the residual
(`compose_residual_host`, palette folded in by `apply_literals`) and the
superblock schedule (`intra_strip.sb_schedule`); the device runs the
strip executor on all planes in one launch, a superblock wavefront in
which U and V follow luma, whose CfL they read.  Intrabc frames, whose
copies read anywhere above, take the sequential schedule instead.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from easyav1_tpu_torch import convert
from easyav1_tpu_torch.video.av1.recon.intra_strip import (
    check_units, sb_schedule, sequential_schedule, strip_exec_frame)
from easyav1_tpu_torch.video.av1.recon.records import (
    apply_literals, compose_residual_host, narrow_residual,
    preprocess_units)


class IntraRecon:
    """Reconstructs one intra frame's mi-aligned planes on `device`;
    sb_size is the stream's superblock size in luma pixels (64 or 128),
    which sets the wavefront's grid."""

    def __init__(self, mi_rows: int, mi_cols: int, ssx: int, ssy: int,
                 bitdepth: int, num_planes: int, sb_size: int,
                 device: torch.device):
        self.bd = bitdepth
        self.ssx, self.ssy = ssx, ssy
        self.np_ = num_planes
        self.sb = sb_size
        self.device = device
        self.cfl = ssx == 1 and ssy == 1      # CfL is wired for 4:2:0
        aw, ah = mi_cols * 4, mi_rows * 4
        self.dims = [(ah, aw), (ah >> ssy, aw >> ssx),
                     (ah >> ssy, aw >> ssx)][:num_planes]

    def _interintra(self, fields: List[np.ndarray]
                    ) -> List[Optional[np.ndarray]]:
        """Each plane's interintra mask stack, its fields' F_RES made an
        index into it.  Intra frames have none."""
        return [None] * self.np_

    def prepare(self, units: np.ndarray, txs: np.ndarray,
                coeffs: np.ndarray, literals=None,
                intrabc: bool = False) -> Optional[Tuple]:
        """The host half: per-plane unit fields [n, NF] int32, residual
        planes int16, interintra mask stacks (None for a plane without
        interintra units) and the SB schedule (`sb_schedule`, or for an
        intrabc frame `sequential_schedule`), or None when the frame
        needs what the executor lacks: CfL outside 4:2:0 or a residual
        (palette literals folded in) outside int16."""
        if self.np_ > 1 and not self.cfl \
                and np.any(units[units[:, 0] > 0][:, 5] == 8):
            return None
        fields = preprocess_units(units, self.dims)
        resid = compose_residual_host(txs, coeffs, self.dims, self.bd)
        if literals is not None:
            apply_literals(resid, literals)
        resid = narrow_residual(resid)
        if resid is None:
            return None
        masks = self._interintra(fields)
        for p, (f, m) in enumerate(zip(fields, masks)):
            check_units(f, self.dims[p], p > 0 and self.cfl,
                        *((0, 0) if m is None else m.shape[:2]))
        return fields, resid, masks, (
            sequential_schedule(fields, self.dims) if intrabc else
            sb_schedule(fields, self.dims, self.sb))

    def upload(self, fields: List[np.ndarray], resid: List[np.ndarray],
               masks: List[Optional[np.ndarray]], schedule) -> Tuple:
        """`prepare`'s host arrays as tensors on the device: (fields,
        resid, masks, schedule)."""
        sbh, sbw, spans = schedule
        arrays = {f"{k}{p}": a for k, arrs in zip(("f", "r"), (fields, resid))
                  for p, a in enumerate(arrs)}
        arrays |= {f"m{p}": m for p, m in enumerate(masks) if m is not None}
        t = convert.from_reference(arrays | {"spans": spans}, self.device)
        return ([t[f"f{p}"] for p in range(self.np_)],
                [t[f"r{p}"] for p in range(self.np_)],
                [t.get(f"m{p}") for p in range(self.np_)],
                (sbh, sbw, t["spans"]))

    def launch(self, fields: List[torch.Tensor], resid: List[torch.Tensor],
               schedule, masks=None, base=None) -> List[torch.Tensor]:
        """The device half on uploaded fields, residuals and schedule:
        all planes in one launch, chroma CfL reading the luma; in place
        on `base` (an inter frame's MC planes) if given, with `masks`
        the planes' interintra stacks."""
        return strip_exec_frame(fields, resid, self.dims, self.bd, schedule,
                                base=base, masks=masks)

    def run(self, units: np.ndarray, txs: np.ndarray, coeffs: np.ndarray,
            literals=None, intrabc: bool = False
            ) -> Optional[List[torch.Tensor]]:
        """int32 [ph, pw] planes on the device, or None (declined)."""
        prep = self.prepare(units, txs, coeffs, literals, intrabc)
        if prep is None:
            return None
        fields, resid, masks, schedule = self.upload(*prep)
        return self.launch(fields, resid, schedule, masks)
