"""Inter frame recon on the device: the counterpart of
`mc_jax.DeviceInterRecon` (`mc_jax.py:873-1181`).

The host composes the residual (`compose_residual_host`, palette folded
in by `apply_literals`; or, with `host_residual=False`, the device does,
as `IntraRecon`), lays out the pred units of the frame's intra and
interintra blocks (`preprocess_units`), builds the interintra mask
stacks (`ii_masks`) and the superblock schedule.  The device then runs,
in place on int32 planes that start at zero: MC of the single, pair and
warp units (kernel 6a), the OBMC passes (kernel 6b), and the strip
executor on the pred units, a superblock wavefront in which U and V
follow luma, whose CfL they read.  Inter pixels are final before the
strip executor starts; an interintra unit blends its intra prediction
with the bare MC prediction there, then adds the residual.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from easyav1_tpu_torch.video.av1 import constants as C
from easyav1_tpu_torch.video.av1 import tables as T
from easyav1_tpu_torch.video.av1.recon import inter_mc
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.recon.records import F_H, F_RES, F_W
from easyav1_tpu_torch.video.av1.wedge import subsample_mask, wedge_mask

# interintra mode -> II_SIZE_SCALE (libaom ii_size_scales)
_II_SIZE_SCALE = (32, 16, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2, 1, 1, 1, 8, 8,
                  4, 4, 2, 2)


def ii_masks(f: np.ndarray, plane: int, ssx: int, ssy: int,
             ws: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Replace each unit's F_RES blend pack with a 1-based index into a
    fresh (n, ws, ws) mask stack (wedge tables or the ii_weights1d decay
    ramps; av1_mc.h interintra_blend masks).  Returns (fields, stack or
    None).  The port's copy of `DeviceInterRecon._ii_masks`
    (`mc_jax.py:1112-1174`) without its power-of-two stack capacity."""
    rows = np.flatnonzero(f[:, F_RES] != 0)
    if rows.size == 0:
        return f, None
    wts = T.data()["ii_weights1d"].astype(np.int32)
    sx = ssx if plane else 0
    sy = ssy if plane else 0
    f = f.copy()
    stack = []
    for r in rows:
        packed = int(f[r, F_RES])
        iim = (packed & 0xF) - 1
        widx = (packed >> 4) & 0xFF
        wedge = (packed >> 12) & 1
        bsize = (packed >> 16) & 0x1F
        w = int(f[r, F_W])
        h = int(f[r, F_H])
        if wedge:
            ml = wedge_mask(bsize, widx, 0)
            mk = ml if plane == 0 else subsample_mask(ml, sx, sy)
            mk = np.asarray(mk[:h, :w], np.int32)
        else:
            if plane == 0:
                pbsize = bsize
            else:
                cw4 = max(1, C.BLOCK_W4[bsize] >> sx)
                ch4 = max(1, C.BLOCK_H4[bsize] >> sy)
                pbsize = next(b for b in range(22)
                              if C.BLOCK_W4[b] == cw4
                              and C.BLOCK_H4[b] == ch4)
            scale = _II_SIZE_SCALE[pbsize]
            if iim == 0:
                mk = np.full((h, w), 32, np.int32)
            elif iim == 1:
                mk = np.broadcast_to(
                    wts[np.clip(np.arange(h) * scale, 0, 127)][:, None],
                    (h, w)).astype(np.int32)
            elif iim == 2:
                mk = np.broadcast_to(
                    wts[np.clip(np.arange(w) * scale, 0, 127)][None, :],
                    (h, w)).astype(np.int32)
            else:
                idx = np.minimum(np.arange(h)[:, None],
                                 np.arange(w)[None, :])
                mk = wts[np.clip(idx * scale, 0, 127)].astype(np.int32)
        padded = np.zeros((ws, ws), np.int32)
        padded[:h, :w] = mk
        stack.append(padded)
        f[r, F_RES] = len(stack)        # 1-based
    return f, np.stack(stack)


class InterRecon(IntraRecon):
    """Reconstructs one inter frame's mi-aligned planes on `device`;
    sb_size is the stream's superblock size in luma pixels (64 or 128),
    which sets the strip executor's wavefront.  The host half is
    `IntraRecon`'s, with the interintra mask stacks."""

    # the interintra mask stacks' extent, as the reference's windows
    WS = (64, 32, 32)

    def _interintra(self, fields: List[np.ndarray]
                    ) -> List[Optional[np.ndarray]]:
        masks = []
        for p in range(self.np_):
            fields[p], m = ii_masks(fields[p], p, self.ssx, self.ssy,
                                    self.WS[p])
            masks.append(m)
        return masks

    def motion(self, resid: Sequence[torch.Tensor], plan: Dict,
               refs: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """The MC planes: zero planes, then MC of every single, pair and
        warp unit (kernel 6a), then the OBMC passes (kernel 6b).  refs[p]:
        the planes of the plan's slots (uint8, or uint16 above 8 bits)."""
        planes = [torch.zeros(d, dtype=torch.int32, device=self.device)
                  for d in self.dims]
        inter_mc.mc_units(planes, resid, refs, plan, self.bd)
        return inter_mc.obmc(planes, resid, refs, plan, self.bd)

    def intra(self, planes: List[torch.Tensor], fields, resid, masks,
              schedule) -> List[torch.Tensor]:
        """The pred units in place on the MC planes, all planes in one
        launch, chroma CfL reading the finished luma."""
        return self.launch(fields, resid, schedule, masks, base=planes)

    def run(self, units: np.ndarray, txs: np.ndarray, coeffs: np.ndarray,
            plan: Dict, refs, literals=None) -> Optional[List[torch.Tensor]]:
        """int32 [ph, pw] planes on the device, or None (declined)."""
        prep = self.prepare(units, txs, coeffs, literals)
        if prep is None:
            return None
        fields, resid, masks, schedule = self.upload(*prep)
        resid = self.compose(resid)
        if resid is None:
            return None
        planes = self.motion(resid, plan, refs)
        return self.intra(planes, fields, resid, masks, schedule)
