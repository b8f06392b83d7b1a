"""AV1 backend that decodes through the port's frame pipe.

`TorchAV1Backend` is the reference `AV1Backend` with one change of route:
where the reference calls `native.decode_and_recon_native`
(`backend.py:324`), it calls the port's `native.decode_and_recon` with
its device.  Frame-parallel decode stays off: the reference's
frame-parallel branch decodes every frame on the C path, so the port
would never run.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from easyav1_tpu.container.webm import TrackInfo
from easyav1_tpu.types import VideoFrame
from easyav1_tpu.video.av1 import constants as C
from easyav1_tpu.video.av1.backend import AV1Backend
from easyav1_tpu.video.av1.cdf import CdfContext
from easyav1_tpu.video.av1.headers import FrameHeader
from easyav1_tpu.video.av1.recon_ref import FrameRecon
from easyav1_tpu.video.av1.tile import TileDecoder
from easyav1_tpu_torch import native


class TorchAV1Backend(AV1Backend):
    def __init__(self, track: TrackInfo, device: torch.device,
                 threads: int = 0):
        super().__init__(track, threads=threads)
        self.device = device
        self._fp_on = False

    def _decode_frame(self, hdr: FrameHeader, tile_payloads: List[bytes],
                      ts: int) -> Optional[VideoFrame]:
        """`AV1Backend._decode_frame` (reference `backend.py:289-418`)
        without the frame-parallel branch, decoding through the port."""
        seq = self.seq
        plan = None
        tiles = self._split_tiles(hdr, tile_payloads)
        from easyav1_tpu import native as ref_native
        from easyav1_tpu.native.cdf_layout import blob_to_cdf, cdf_to_blob
        init_blob: Optional[bytes] = None
        if hdr.primary_ref_frame != C.PRIMARY_REF_NONE:
            init_blob = self._ref_cdfs[
                hdr.ref_frame_idx[hdr.primary_ref_frame]]
        want_cdf = (not hdr.disable_frame_end_update_cdf
                    and hdr.refresh_frame_flags != 0)
        tpl = None
        if hdr.use_ref_frame_mvs:
            from easyav1_tpu.video.av1.mfmv import setup_motion_field
            tpl = setup_motion_field(
                hdr, seq, [s if s.valid else None for s in self.hp.refs],
                self._ref_tmvs)
        out_blob: Optional[bytes] = None
        planes = None
        nat_grids = None
        planes16 = None
        res = native.decode_and_recon(
            seq, hdr, tiles, self.device, cdf_in=init_blob,
            want_cdf=want_cdf, tpl=tpl, refs=self._ref_u16,
            threads=self.threads)
        if res is not None:
            planes, out_blob, nat_grids, planes16 = res
        else:
            # the C entropy decoder declined: the reference's host path
            plan = self._empty_plan(hdr)
            nres = ref_native.decode_frame_native(
                seq, hdr, plan, tiles, cdf_in=init_blob,
                want_cdf=want_cdf, tpl=tpl, threads=self.threads)
            if nres is None:
                init_cdf = (blob_to_cdf(init_blob)
                            if init_blob is not None
                            else CdfContext.default(hdr.quant.base_q_idx))
                end_cdf = init_cdf
                dec = TileDecoder(seq, hdr, init_cdf, plan)
                if tpl is not None:
                    dec.tpl_mv, dec.tpl_off = tpl
                n_cols = hdr.tile.cols
                update_tid = hdr.tile.context_update_tile_id
                for tile_num, tdata in enumerate(tiles):
                    tcdf = init_cdf.copy()
                    dec.cdf = tcdf.t
                    dec.decode_tile(tdata, tile_num // n_cols,
                                    tile_num % n_cols)
                    if tile_num == update_tid and \
                            not hdr.disable_frame_end_update_cdf:
                        end_cdf = tcdf
                if want_cdf:
                    end_cdf.reset_counters()
                    out_blob = cdf_to_blob(end_cdf)
            elif want_cdf:
                out_blob = nres
            recon = FrameRecon(seq, hdr, plan, refs=self._ref_planes)
            aligned = recon.run_aligned()
            from easyav1_tpu.video.av1.lf_ref import LoopFilter
            from easyav1_tpu.video.av1.cdef_ref import Cdef
            LoopFilter(hdr, seq, plan, seq.color.bitdepth).apply(aligned)
            uses_lr = getattr(getattr(hdr, "lr", None), "uses_lr", False)
            deblocked = [p.copy() for p in aligned] if uses_lr else None
            Cdef(hdr, seq, plan, seq.color.bitdepth).apply(aligned)
            if getattr(hdr, "use_superres", False):
                from easyav1_tpu.video.av1.superres_ref import \
                    superres_upscale
                aligned = superres_upscale(aligned, hdr, seq)
                if deblocked is not None:
                    deblocked = superres_upscale(deblocked, hdr, seq)
            if uses_lr:
                from easyav1_tpu.video.av1.lr_ref import LoopRestoration
                LoopRestoration(hdr, seq, plan,
                                seq.color.bitdepth).apply(aligned, deblocked)
            planes = recon.crop(aligned)
        if not want_cdf:
            out_blob = (init_blob if init_blob is not None
                        else self._default_blob(hdr.quant.base_q_idx))
        frame = self._make_frame(planes, hdr, ts)
        from easyav1_tpu.video.av1.mfmv import save_tmvs
        if nat_grids is not None:
            tmvs = save_tmvs(hdr, nat_grids[0], nat_grids[1],
                             nat_grids[2])
        elif hdr.frame_is_intra \
                or getattr(plan, "ref0_grid", None) is None:
            h8 = (hdr.mi_rows + 1) >> 1
            w8 = (hdr.mi_cols + 1) >> 1
            tmvs = (np.full((h8, w8), C.NONE_FRAME, np.int8),
                    np.zeros((h8, w8, 2), np.int16))
        else:
            tmvs = save_tmvs(hdr, plan.ref0_grid, plan.ref1_grid,
                             plan.mvs_grid)
        self.hp.update_refs(hdr)
        if hdr.refresh_frame_flags:
            u16 = (planes16 if planes16 is not None else
                   [(np.ascontiguousarray(p, np.uint16), p.shape[1],
                     p.shape[0]) for p in planes])
        for i in range(C.NUM_REF_FRAMES):
            if hdr.refresh_frame_flags & (1 << i):
                self._out_refs[i] = frame
                self._ref_planes[i] = planes
                self._ref_u16[i] = u16
                self._ref_cdfs[i] = out_blob
                self._ref_tmvs[i] = tmvs
        return frame if hdr.show_frame else None

    def _film_grain_device(self, fg, seq, planes):
        """Grain frames are declined to the C recon; their grain is the
        host C synthesis (the reference's device grain is JAX)."""
        from easyav1_tpu import native as ref_native
        return ref_native.film_grain_native(fg, seq, planes)
