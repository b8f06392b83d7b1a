"""Intra frame recon on the device: the counterpart of
`jax_exec.PallasRecon` (`jax_exec.py:997-1183`).

The host prepares the records (`preprocess_units`), the residual
(`compose_residual_host`, palette folded in by `apply_literals`) and the
superblock schedule (`intra_strip.sb_schedule`); the device runs the
strip executor on all planes in one launch, a superblock wavefront in
which U and V follow luma, whose CfL they read.  Intrabc frames, whose
copies read anywhere above, take the sequential schedule instead.

With `host_residual=False` (the reference's `EASYAV1_HOST_RESID=0`) the
host uploads the transform records and coefficients in place of the
residual planes, and the device composes them (`compose`,
`itx_torch.compose_residual`), with the reference's declines: a frame
with a lossless transform or with palette literals, whose fold needs
the host composer (`jax_exec.py:949-960`), and the port's own, a 12-bit
residual outside int16.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from easyav1_tpu_torch import convert
from easyav1_tpu_torch.video.av1.recon import itx_torch
from easyav1_tpu_torch.video.av1.recon.intra_strip import (
    check_units, sb_schedule, sequential_schedule, strip_exec_frame)
from easyav1_tpu_torch.video.av1.recon.records import (
    apply_literals, compose_residual_host, narrow_residual,
    preprocess_units)


class IntraRecon:
    """Reconstructs one intra frame's mi-aligned planes on `device`;
    sb_size is the stream's superblock size in luma pixels (64 or 128),
    which sets the wavefront's grid.  host_residual: the residual planes
    are composed by the host C composer (the default), or on the
    device."""

    def __init__(self, mi_rows: int, mi_cols: int, ssx: int, ssy: int,
                 bitdepth: int, num_planes: int, sb_size: int,
                 device: torch.device, host_residual: bool = True):
        self.bd = bitdepth
        self.host_residual = host_residual
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
                coeffs: np.ndarray, literals=None, intrabc: bool = False,
                clock=None) -> Optional[Tuple]:
        """The host half: per-plane unit fields [n, NF] int32, the
        residual, interintra mask stacks (None for a plane without
        interintra units) and the SB schedule (`sb_schedule`, or for an
        intrabc frame `sequential_schedule`), or None when the frame
        needs what the executor lacks: CfL outside 4:2:0 or a residual
        (palette literals folded in) outside int16.  The residual is the
        int16 planes, or with `host_residual` False the records and
        coefficients (txs, coeffs) for the device composer, which
        declines frames with lossless transforms or palette literals.
        clock: a stage clock (`pipe._Stages`) that marks the host
        composer as "compose", what ran before it as "prepare"."""
        if self.np_ > 1 and not self.cfl \
                and np.any(units[units[:, 0] > 0][:, 5] == 8):
            return None
        if self.host_residual:
            if clock is not None:
                clock.mark("prepare")
            resid = compose_residual_host(txs, coeffs, self.dims, self.bd)
            if clock is not None:
                clock.mark("compose")
            if literals is not None:
                apply_literals(resid, literals)
            resid = narrow_residual(resid)
            if resid is None:
                return None
        else:
            if literals is not None or np.any(
                    txs[:, itx_torch.R_LOSSLESS] != 0):
                return None
            itx_torch.check_txs(txs, coeffs.shape[0], self.np_)
            resid = (txs, coeffs)
        fields = preprocess_units(units, self.dims)
        masks = self._interintra(fields)
        for p, (f, m) in enumerate(zip(fields, masks)):
            check_units(f, self.dims[p], p > 0 and self.cfl,
                        *((0, 0) if m is None else m.shape[:2]))
        return fields, resid, masks, (
            sequential_schedule(fields, self.dims) if intrabc else
            sb_schedule(fields, self.dims, self.sb))

    def upload(self, fields: List[np.ndarray], resid,
               masks: List[Optional[np.ndarray]], schedule) -> Tuple:
        """`prepare`'s host arrays as tensors on the device: (fields,
        resid, masks, schedule), resid as `prepare` gave it (planes, or
        the records and coefficients)."""
        sbh, sbw, spans = schedule
        arrays = {f"f{p}": a for p, a in enumerate(fields)}
        arrays |= ({"txs": resid[0], "coeffs": resid[1]}
                   if isinstance(resid, tuple) else
                   {f"r{p}": a for p, a in enumerate(resid)})
        arrays |= {f"m{p}": m for p, m in enumerate(masks) if m is not None}
        t = convert.from_reference(arrays | {"spans": spans}, self.device)
        return ([t[f"f{p}"] for p in range(self.np_)],
                ((t["txs"], t["coeffs"]) if isinstance(resid, tuple) else
                 [t[f"r{p}"] for p in range(self.np_)]),
                [t.get(f"m{p}") for p in range(self.np_)],
                (sbh, sbw, t["spans"]))

    def compose(self, resid) -> Optional[List[torch.Tensor]]:
        """The int16 residual planes on the device from `upload`'s
        resid: planes as they are, or records and coefficients composed
        by `itx_torch.compose_residual` (one kernel launch); None when a
        12-bit residual leaves int16 (the frame is declined)."""
        if not isinstance(resid, tuple):
            return resid
        return itx_torch.narrow_residual(
            itx_torch.compose_residual(*resid, self.dims, self.bd))

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
        resid = self.compose(resid)
        if resid is None:
            return None
        return self.launch(fields, resid, schedule, masks)
