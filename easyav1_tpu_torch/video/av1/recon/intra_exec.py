"""Intra frame recon on the device: the counterpart of
`jax_exec.PallasRecon` (`jax_exec.py:997-1183`).

The host prepares the records (`preprocess_units`) and the residual
(`compose_residual_host`, palette folded in by `apply_literals`), both
shared with the JAX package; the device runs the strip executor on luma,
then on U and V, whose CfL reads the finished luma.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from easyav1_tpu.video.av1.recon.jax_exec import (
    F_CLS, K_IBC, apply_literals, compose_residual_host, preprocess_units)
from easyav1_tpu_torch import convert
from easyav1_tpu_torch.video.av1.recon.intra_strip import (check_units,
                                                           strip_exec)


def prepare_fields(units: np.ndarray, dims) -> List[np.ndarray]:
    """Per-plane unit fields [n, NF] int32 of the strip executor: the
    shared `preprocess_units(units, dims, pad=0)`."""
    return preprocess_units(units, dims, pad=0)


class IntraRecon:
    """Reconstructs one intra frame's mi-aligned planes on `device`."""

    def __init__(self, mi_rows: int, mi_cols: int, ssx: int, ssy: int,
                 bitdepth: int, num_planes: int, device: torch.device):
        self.bd = bitdepth
        self.ssx, self.ssy = ssx, ssy
        self.np_ = num_planes
        self.device = device
        self.cfl = ssx == 1 and ssy == 1      # CfL is wired for 4:2:0
        aw, ah = mi_cols * 4, mi_rows * 4
        self.dims = [(ah, aw), (ah >> ssy, aw >> ssx),
                     (ah >> ssy, aw >> ssx)][:num_planes]

    def prepare(self, units: np.ndarray, txs: np.ndarray,
                coeffs: np.ndarray, literals=None
                ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray]]]:
        """The host half: per-plane unit fields [n, NF] int32 and residual
        planes int16, or None when the frame needs what the executor
        lacks: CfL outside 4:2:0, intrabc units, a residual wider than
        int16, or no host residual composer."""
        if self.np_ > 1 and not self.cfl \
                and np.any(units[units[:, 0] > 0][:, 5] == 8):
            return None
        fields = prepare_fields(units, self.dims)
        if any(np.any(f[:, F_CLS] == K_IBC) for f in fields):
            return None
        resid = compose_residual_host(txs, coeffs, self.dims, 0, 0, self.bd)
        if resid is None or resid[0].dtype != np.int16:
            return None
        if literals is not None:
            apply_literals(resid, literals, 0, 0)
        for p, f in enumerate(fields):
            check_units(f, self.dims[p], has_luma=p > 0 and self.cfl)
        return fields, resid

    def upload(self, fields: List[np.ndarray], resid: List[np.ndarray]
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """`prepare`'s host arrays as tensors on the device."""
        t = convert.from_reference(
            {f"{k}{p}": a for k, arrs in zip(("f", "r"), (fields, resid))
             for p, a in enumerate(arrs)}, self.device)
        return ([t[f"f{p}"] for p in range(self.np_)],
                [t[f"r{p}"] for p in range(self.np_)])

    def launch(self, fields: List[torch.Tensor],
               resid: List[torch.Tensor]) -> List[torch.Tensor]:
        """The device half on uploaded fields and residuals: luma, then
        U and V with CfL reading the finished luma."""
        luma = strip_exec(fields[:1], resid[:1], self.dims[0], self.bd)[0]
        if self.np_ == 1:
            return [luma]
        return [luma] + strip_exec(fields[1:], resid[1:], self.dims[1],
                                   self.bd, luma if self.cfl else None)

    def run(self, units: np.ndarray, txs: np.ndarray, coeffs: np.ndarray,
            literals=None) -> Optional[List[torch.Tensor]]:
        """int32 [ph, pw] planes on the device, or None (declined)."""
        prep = self.prepare(units, txs, coeffs, literals)
        if prep is None:
            return None
        return self.launch(*self.upload(*prep))
