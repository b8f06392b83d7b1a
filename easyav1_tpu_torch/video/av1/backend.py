# Copy of easyav1_tpu/video/av1/backend.py, the JAX package's counterpart.
"""AV1 decoder backend: OBU stream -> decoded frames.

The reference's `AV1Backend` with one of two routes for every frame:

- `device=None`: the C decoder and C recon,
  `native.decode_and_recon_native` (the reference's native path without
  its frame-parallel branch);
- a torch device: the port's pipe, `native.pipe.decode_and_recon`, which
  reconstructs the frames it covers on that device, film grain
  included, and declines the rest to the C recon (their grain runs in
  host C).  With `resident` the frames' planes stay on the device until
  a consumer indexes them; with `host_residual` False the device
  composes the residual planes in place of the host C composer.  With
  `pipe` "postfilter" the C recon makes every frame without its
  filters, and deblocking, CDEF, loop restoration and film grain run on
  the device (the reference's `EASYAV1_PIPE=device`).

Where the reference falls back to its pure-Python decoder when the C
decoder declines a frame (a tile-count mismatch or a corrupt tile), the
port raises AV1DecodeError, and the API sets an error status.
"""

from __future__ import annotations

from typing import List, Optional

import dataclasses

import numpy as np

from easyav1_tpu_torch import native
from easyav1_tpu_torch.container.webm import TrackInfo
from easyav1_tpu_torch.native import pipe
from easyav1_tpu_torch.native.cdf_layout import cdf_to_blob
from easyav1_tpu_torch.settings import (BitsPerColor, ChromaSamplePosition,
                                        ColorPrimaries, ColorSpace,
                                        MatrixCoefficients, PixelLayout,
                                        TransferCharacteristics)
from easyav1_tpu_torch.types import VideoFrame, VideoFrameProperties
from easyav1_tpu_torch.video.av1 import constants as C
from easyav1_tpu_torch.video.av1.bitreader import BitReader
from easyav1_tpu_torch.video.av1.cdf import CdfContext
from easyav1_tpu_torch.video.av1.headers import (FrameHeader, HeaderParser,
                                                 SequenceHeader,
                                                 parse_sequence_header,
                                                 split_obus)
from easyav1_tpu_torch.video.av1.mfmv import save_tmvs, setup_motion_field
from easyav1_tpu_torch.video.av1.recon.fg_torch import FilmGrain


class AV1DecodeError(Exception):
    pass


class AV1Backend:
    def __init__(self, track: TrackInfo, device=None, threads: int = 0,
                 resident: bool = False, host_residual: bool = True,
                 pipe: str = "recon"):
        self.track = track
        # None: the C recon; a torch.device: the port's pipe
        self.device = device
        # the port's pipe on that device (`pipe.PIPES`)
        self.pipe = pipe
        # the pipe's frames stay on the device until they are indexed
        self.resident = resident
        # the residual planes: the host C composer, or the device's
        self.host_residual = host_residual
        # (grain parameters, their FilmGrain on the device), kept across
        # frames whose parameters do not change
        self._dev_fg = None
        # tile-parallel entropy worker count; 0 = auto (cpu count),
        # EASYAV1_THREADS still overrides inside native.decode_threads()
        self.threads = threads
        self.seq: Optional[SequenceHeader] = None
        self.hp: Optional[HeaderParser] = None
        self._out_refs: List[Optional[VideoFrame]] = [None] * C.NUM_REF_FRAMES
        # (plane, logical w, logical h) triples per slot for the C
        # motion compensation
        self._ref_u16: List[Optional[list]] = [None] * C.NUM_REF_FRAMES
        # per-slot saved entropy contexts (spec frame_end_update_cdf /
        # load_cdfs via primary_ref_frame)
        self._ref_cdfs: List[Optional[bytes]] = [None] * C.NUM_REF_FRAMES
        # per-slot saved 8x8 motion fields (spec SavedMvs/SavedRefFrames)
        self._ref_tmvs: List[Optional[tuple]] = [None] * C.NUM_REF_FRAMES

    # -- VideoBackend interface -------------------------------------------

    def decode(self, chunks: List[bytes], timestamp_ms: int) -> List[VideoFrame]:
        frames = []
        for chunk in chunks:
            frames.extend(self._decode_temporal_unit(chunk, timestamp_ms))
        return frames

    def flush(self) -> None:
        pass

    def probe_sequence_header(self, chunks: List[bytes]) -> bool:
        for chunk in chunks:
            try:
                for obu in split_obus(chunk):
                    if obu.type == C.OBU_SEQUENCE_HEADER:
                        return True
            except Exception:  # noqa: BLE001
                return False
        return False

    # ------------------------------------------------------------------

    def _decode_temporal_unit(self, data: bytes, ts: int) -> List[VideoFrame]:
        out = []
        hdr: Optional[FrameHeader] = None
        tile_payloads: List[bytes] = []
        for obu in split_obus(data):
            if obu.type == C.OBU_SEQUENCE_HEADER:
                self.seq = parse_sequence_header(obu.payload)
                self.hp = HeaderParser(self.seq)
            elif obu.type == C.OBU_FRAME_HEADER:
                hdr = self._parse_frame_header(obu.payload)
                if hdr.show_existing_frame:
                    f = self._show_existing(hdr, ts)
                    if f is not None:
                        out.append(f)
                    hdr = None
            elif obu.type == C.OBU_FRAME:
                hdr = self._parse_frame_header(obu.payload)
                offset_bits = hdr.header_bit_offset
                byte_off = (offset_bits + 7) // 8
                tile_payloads = [obu.payload[byte_off:]]
                f = self._decode_frame(hdr, tile_payloads, ts)
                if f is not None:
                    out.append(f)
                hdr = None
                tile_payloads = []
            elif obu.type == C.OBU_TILE_GROUP:
                tile_payloads.append(obu.payload)
                # a frame may split its tiles across several tile-group
                # OBUs (spec 5.11.1); decode once the group carrying the
                # last tile arrives
                if hdr is not None and self._tg_is_last(hdr, obu.payload):
                    f = self._decode_frame(hdr, tile_payloads, ts)
                    if f is not None:
                        out.append(f)
                    hdr = None
                    tile_payloads = []
        return out

    def _parse_frame_header(self, payload: bytes) -> FrameHeader:
        if self.hp is None:
            raise AV1DecodeError("no sequence header before frame header")
        return self.hp.parse_frame_header(payload)

    def _show_existing(self, hdr: FrameHeader, ts: int) -> Optional[VideoFrame]:
        f = self._out_refs[hdr.frame_to_show_map_idx]
        if f is None:
            return None
        return VideoFrame(properties=f.properties, timestamp=ts, data=f.data)

    # ------------------------------------------------------------------

    def _decode_frame(self, hdr: FrameHeader, tile_payloads: List[bytes],
                      ts: int) -> Optional[VideoFrame]:
        seq = self.seq
        tiles = self._split_tiles(hdr, tile_payloads)
        # entropy context: inherit the primary ref's saved state (spec
        # load_cdfs) or reset to the per-q defaults, as packed blobs
        init_blob: Optional[bytes] = None
        if hdr.primary_ref_frame != C.PRIMARY_REF_NONE:
            init_blob = self._ref_cdfs[
                hdr.ref_frame_idx[hdr.primary_ref_frame]]
        want_cdf = (not hdr.disable_frame_end_update_cdf
                    and hdr.refresh_frame_flags != 0)
        # temporal mv projection (host-side numpy)
        tpl = None
        if hdr.use_ref_frame_mvs:
            tpl = setup_motion_field(
                hdr, seq, [s if s.valid else None for s in self.hp.refs],
                self._ref_tmvs)
        if self.device is None:
            res = native.decode_and_recon_native(
                seq, hdr, tiles, cdf_in=init_blob, want_cdf=want_cdf,
                tpl=tpl, refs=self._ref_u16, threads=self.threads)
        else:
            res = pipe.decode_and_recon(
                seq, hdr, tiles, self.device, cdf_in=init_blob,
                want_cdf=want_cdf, tpl=tpl, refs=self._ref_u16,
                threads=self.threads, resident=self.resident,
                grain=self._film_grain_device,
                host_residual=self.host_residual, pipe=self.pipe)
        if res is None:
            raise AV1DecodeError("the C decoder declined the frame "
                                 "(tile count or tile data)")
        planes, out_blob, nat_grids, planes16 = res
        if not want_cdf:
            # spec: when frame-end update is disabled the INIT state is
            # what a later frame inherits
            out_blob = (init_blob if init_blob is not None
                        else self._default_blob(hdr.quant.base_q_idx))
        frame = self._make_frame(planes, hdr, ts)
        # per-8x8 motion storage for later temporal projection
        if nat_grids is not None:
            tmvs = save_tmvs(hdr, nat_grids[0], nat_grids[1],
                             nat_grids[2])
        else:
            h8 = (hdr.mi_rows + 1) >> 1
            w8 = (hdr.mi_cols + 1) >> 1
            tmvs = (np.full((h8, w8), C.NONE_FRAME, np.int8),
                    np.zeros((h8, w8, 2), np.int16))
        self.hp.update_refs(hdr)
        for i in range(C.NUM_REF_FRAMES):
            if hdr.refresh_frame_flags & (1 << i):
                self._out_refs[i] = frame
                self._ref_u16[i] = planes16
                self._ref_cdfs[i] = out_blob
                self._ref_tmvs[i] = tmvs
        return frame if hdr.show_frame else None

    _DEFAULT_BLOBS: dict = {}

    @classmethod
    def _default_blob(cls, base_q_idx: int) -> bytes:
        """Packed default entropy state for the quantizer context."""
        qctx = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 \
            else 2 if base_q_idx <= 120 else 3
        blob = cls._DEFAULT_BLOBS.get(qctx)
        if blob is None:
            blob = cdf_to_blob(CdfContext.default(base_q_idx))
            cls._DEFAULT_BLOBS[qctx] = blob
        return blob

    @staticmethod
    def _tg_is_last(hdr: FrameHeader, payload: bytes) -> bool:
        """True if this tile-group OBU carries the frame's last tile
        (tile_group header, spec 5.11.1)."""
        n_tiles = hdr.tile.cols * hdr.tile.rows
        if n_tiles == 1:
            return True
        r = BitReader(payload)
        if not r.f1():          # tile_start_and_end_present_flag
            return True         # single TG with all tiles
        bits = hdr.tile.cols_log2 + hdr.tile.rows_log2
        r.f(bits)               # tg_start
        return r.f(bits) == n_tiles - 1

    @staticmethod
    def _split_tiles(hdr: FrameHeader, payloads: List[bytes]) -> List[bytes]:
        """Tile group parsing (spec §5.11.1)."""
        n_tiles = hdr.tile.cols * hdr.tile.rows
        tiles: List[bytes] = []
        for payload in payloads:
            r = BitReader(payload)
            tg_start, tg_end = 0, n_tiles - 1
            if n_tiles > 1:
                flag = r.f1()
                if flag:
                    bits = hdr.tile.cols_log2 + hdr.tile.rows_log2
                    tg_start = r.f(bits)
                    tg_end = r.f(bits)
            r.byte_align()
            pos = r.pos // 8
            for tn in range(tg_start, tg_end + 1):
                if tn == tg_end:
                    tiles.append(payload[pos:])
                else:
                    size = int.from_bytes(
                        payload[pos:pos + hdr.tile.tile_size_bytes],
                        "little") + 1
                    pos += hdr.tile.tile_size_bytes
                    tiles.append(payload[pos:pos + size])
                    pos += size
        return tiles

    def _make_frame(self, planes, hdr: FrameHeader, ts: int) -> VideoFrame:
        seq = self.seq
        cc = seq.color
        layout = {(1, 1): PixelLayout.YUV420, (1, 0): PixelLayout.YUV422,
                  (0, 0): PixelLayout.YUV444}.get(
            (cc.subsampling_x, cc.subsampling_y), PixelLayout.UNKNOWN)
        if cc.mono_chrome:
            layout = PixelLayout.YUV400
        props = VideoFrameProperties(
            pixel_layout=layout,
            bits_per_color={8: BitsPerColor.BITS_8, 10: BitsPerColor.BITS_10,
                            12: BitsPerColor.BITS_12}[cc.bitdepth],
            color_space=(ColorSpace.FULL if cc.color_range
                         else ColorSpace.LIMITED),
            color_primaries=_safe_enum(ColorPrimaries, cc.color_primaries),
            transfer_characteristics=_safe_enum(
                TransferCharacteristics, cc.transfer_characteristics),
            matrix_coefficients=_safe_enum(
                MatrixCoefficients, cc.matrix_coefficients),
            chroma_sample_position=_safe_enum(
                ChromaSamplePosition, cc.chroma_sample_position),
            width=hdr.upscaled_width, height=hdr.frame_height,
        )
        fg = getattr(hdr, "film_grain", None)
        out_planes = planes
        if (fg is not None and fg.apply_grain
                and not isinstance(planes, pipe.LazyPlanes)):
            # grain is an output-only transform; reference frames stay
            # grain-free (spec 7.18.1).  A frame the device made has its
            # grain already (pipe._tail); this is one the C recon made.
            out_planes = native.film_grain_native(fg, seq, planes)
            if out_planes is None:
                raise AV1DecodeError("film grain synthesis failed")
        return VideoFrame(properties=props, timestamp=ts,
                          data=out_planes)

    def _film_grain_device(self, fg, seq, planes):
        """Film grain on the device planes of a frame the pipe made; the
        templates and LUTs are kept while the parameters stay the same
        (the reference's `_film_grain_device`)."""
        key = tuple(tuple(v) if isinstance(v, list) else v
                    for v in (getattr(fg, f.name)
                              for f in dataclasses.fields(fg)))
        if self._dev_fg is None or self._dev_fg[0] != key:
            self._dev_fg = (key, FilmGrain(fg, seq, seq.color.bitdepth,
                                           self.device))
        return self._dev_fg[1].apply(planes)


def _safe_enum(enum_cls, value):
    try:
        return enum_cls(value)
    except ValueError:
        return enum_cls(0)
