"""Multi-stream AV1 decode with one device postfilter step a frame index:
the counterpart of `easyav1_tpu/parallel/multistream_av1.py`.

BASELINE config 5 (N concurrent streams batched on one chip): each
stream's frames are entropy-decoded and reconstructed by the port's C
decoder with deblocking and CDEF suppressed; then LF + CDEF runs once for
the frames of one index across all streams, over a leading stream axis
(`postfilter.stack_maps`, `postfilter_apply`).  The JAX package vmaps
that step and shards the stream axis over a mesh's `dp` axis; one card
has no mesh, so the port's loop variant (`batched_postfilter_loop`) runs
the streams one after another on the one device.

`run_multistream_real` holds every frame against the port's synchronous
C session (`api.native_session`, `api.frame_hash`), never against the
reference's frame-parallel native path.  The reference's pure-Python
decoder and its synthetic encoder are not ported: `decode_tu_unfiltered`
decodes a temporal unit with the C decoder, and `run_multistream` takes
TUs made elsewhere (the JAX package's `make_stream_tu` makes them in the
port's tests).
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch

from easyav1_tpu_torch import native as nat
from easyav1_tpu_torch.api import frame_hash, native_session, resolve_device
from easyav1_tpu_torch.container import TrackType, WebMDemuxer
from easyav1_tpu_torch.container.webm import TrackInfo
from easyav1_tpu_torch.native.pipe import recon_unfiltered
from easyav1_tpu_torch.video.av1 import constants as C
from easyav1_tpu_torch.video.av1.backend import AV1Backend, AV1DecodeError
from easyav1_tpu_torch.video.av1.headers import (HeaderParser,
                                                 parse_sequence_header,
                                                 split_obus)
from easyav1_tpu_torch.video.av1.recon.postfilter import (
    host_maps, postfilter_apply, postfilter_frame, stack_maps)


class _Parser:
    """The sequence header and frame headers of a stream's packets."""

    def __init__(self):
        self.seq = self.hp = None

    def frame(self, packet: bytes):
        """(seq, hdr, tile payloads) of the one frame in `packet`."""
        hdr, tiles = None, None
        for obu in split_obus(packet):
            if obu.type == C.OBU_SEQUENCE_HEADER:
                self.seq = parse_sequence_header(obu.payload)
                self.hp = HeaderParser(self.seq)
            elif obu.type in (C.OBU_FRAME, C.OBU_FRAME_HEADER):
                if self.hp is None:
                    raise AV1DecodeError("no sequence header before frame "
                                         "header")
                hdr = self.hp.parse_frame_header(obu.payload)
                if obu.type == C.OBU_FRAME:
                    tiles = [obu.payload[(hdr.header_bit_offset + 7) // 8:]]
            elif obu.type == C.OBU_TILE_GROUP:
                tiles = (tiles or []) + [obu.payload]
        if hdr is None or tiles is None:
            raise AV1DecodeError("packet holds no frame")
        return self.seq, hdr, AV1Backend._split_tiles(hdr, tiles)


def _unfiltered_frame(lib, seq, hdr, tiles):
    """C entropy + recon of one intra frame with LF and CDEF suppressed
    (`multistream_av1.py:206-247`; the postfilter pipe's
    `pipe.recon_unfiltered`): (seq, hdr, mi-aligned uint16 planes,
    LF grids by plane, mi skip grid, CDEF index grid), every part a
    snapshot (the decoder's buffers are reused by the next frame)."""
    if not hdr.frame_is_intra:
        raise ValueError("the multi-stream batch takes intra frames only")
    if (getattr(hdr, "use_superres", False) or getattr(
            getattr(hdr, "lr", None), "uses_lr", False) or getattr(
            getattr(hdr, "film_grain", None), "apply_grain", False)):
        raise ValueError("the multi-stream batch runs LF + CDEF only: a "
                         "frame with superres, loop restoration or film "
                         "grain needs the single-stream pipe")
    res = nat._run_tiles(lib, seq, hdr, tiles)
    if res is None:
        raise AV1DecodeError("the C decoder declined the frame")
    out, bufs, _blob, (fp_rc, _keep) = res
    rp = nat._build_rp(seq, hdr)
    pl = recon_unfiltered(lib, seq, hdr, out, fp_rc, rp, nat._RefPlanes())
    if pl is None:
        raise AV1DecodeError("the C recon failed")
    grids_for = nat._grids_exporter(lib, rp, out)
    grids = {p: grids_for(p, pl[p].shape) for p in range(len(pl))}
    return (seq, hdr, pl, grids, bufs["grids"]["skip"].copy(),
            bufs["cdef"].copy())


def decode_frames_unfiltered_native(path: str, max_frames: int):
    """The first `max_frames` frames of a WebM stream, each as
    `_unfiltered_frame` gives it.  Intra streams only (no reference
    chain)."""
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while len(pkts) < max_frames and (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    lib, parse = nat._load(), _Parser()
    return [_unfiltered_frame(lib, *parse.frame(pk))
            for pk in pkts[:max_frames]]


def decode_tu_unfiltered(tu: bytes):
    """One temporal unit (a sequence header and an intra frame) decoded
    as `decode_frames_unfiltered_native` decodes a packet."""
    return _unfiltered_frame(nat._load(), *_Parser().frame(tu))


def batch_maps(batch):
    """(plane dims, `postfilter.host_maps` of each frame) of a batch of
    `_unfiltered_frame` tuples of one geometry and bit depth."""
    dims = tuple(p.shape for p in batch[0][2])
    keys = {(seq.color.bitdepth, seq.color.subsampling_x,
             seq.color.subsampling_y, tuple(p.shape for p in planes))
            for seq, _hdr, planes, *_ in batch}
    if len(keys) != 1:
        raise ValueError(f"one batch, one geometry and bit depth: {keys}")
    maps = [host_maps(hdr, seq, dims, lambda p, shape, g=grids: g[p], skip,
                      cdef)
            for seq, hdr, _planes, grids, skip, cdef in batch]
    return dims, maps


def batch_inputs(batch, device: torch.device):
    """What `postfilter_apply` takes for a batch: [S, ph, pw] int32 planes
    (each frame's uint16 plane copied into its slice on `device`) and the
    stacked maps there."""
    dims, maps = batch_maps(batch)
    planes = []
    for p, shape in enumerate(dims):
        pl = torch.empty((len(batch), *shape), dtype=torch.uint16,
                         device=device)
        for s, b in enumerate(batch):
            pl[s].copy_(torch.from_numpy(b[2][p]))
        planes.append(pl.to(torch.int32))
    return planes, stack_maps(maps, dims, device)


def batched_postfilter_real(batch, device="cuda") -> List[torch.Tensor]:
    """One LF + CDEF pass over frames of one geometry from different
    streams.  batch: `_unfiltered_frame` tuples.  Returns one [S, ph, pw]
    int32 tensor a plane on `device` (`out[p][s]` is stream s's plane p,
    as the JAX package's `outs[p][s]`)."""
    return postfilter_apply(*batch_inputs(batch, resolve_device(device)))


def batched_postfilter_loop(batch, device="cuda") -> List[List[torch.Tensor]]:
    """The same result, one stream after another on the one device
    (`postfilter_frame` a frame).  Returns out[p][s], [ph, pw] int32."""
    device = resolve_device(device)
    results = []
    for seq, hdr, planes, grids, skip, cdef in batch:
        dev = [torch.from_numpy(p).to(device).to(torch.int32)
               for p in planes]
        results.append(postfilter_frame(dev, hdr, seq,
                                        lambda p, shape, g=grids: g[p],
                                        skip, cdef))
    return [[results[s][p] for s in range(len(batch))]
            for p in range(len(batch[0][2]))]


def shown_planes(frame, planes) -> List[np.ndarray]:
    """A frame's filtered mi-aligned planes cropped to the frame and cast
    to its sample type, as the API shows them."""
    seq, hdr = frame[0], frame[1]
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    w, h = hdr.upscaled_width, hdr.frame_height
    crops = ((h, w), ((h + ssy) >> ssy, (w + ssx) >> ssx))
    dt = np.uint8 if seq.color.bitdepth == 8 else np.uint16
    return [np.asarray(p[:crops[min(i, 1)][0], :crops[min(i, 1)][1]].cpu(),
                       dtype=dt) for i, p in enumerate(planes)]


def native_frame_hashes(path: str, n: int) -> List[int]:
    """`api.frame_hash` of the first n frames of the port's synchronous C
    session."""
    av = native_session(str(path))
    out = []
    try:
        for _ in range(4 * n + 16):
            if av.is_finished() or len(out) >= n:
                break
            av.decode_next()
            while av.has_video_frame() and len(out) < n:
                out.append(frame_hash(av.get_video_frame().data))
    finally:
        av.close()
    return out


def run_multistream_real(paths: Sequence[str], max_frames: int = 4,
                         check: bool = True, device="cuda"):
    """BASELINE config 5 at real scale: N WebM streams (C entropy and
    recon on the host), one LF + CDEF pass on the device a frame index
    across all of them.  Returns (n_streams, total_frames, wall seconds
    of the device passes).  check: every frame's hash against the port's
    native C session (`native_frame_hashes`)."""
    device = resolve_device(device)
    streams = [decode_frames_unfiltered_native(p, max_frames) for p in paths]
    n_frames = min(len(s) for s in streams)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = [batched_postfilter_real([s[k] for s in streams], device)
            for k in range(n_frames)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if check:
        for s, path in enumerate(paths):
            want = native_frame_hashes(path, n_frames)
            got = [frame_hash(shown_planes(streams[s][k],
                                           [o[s] for o in outs[k]]))
                   for k in range(n_frames)]
            if got != want:
                bad = [k for k in range(n_frames) if got[k] != want[k]]
                raise RuntimeError(f"stream {s} ({path}): frames {bad} "
                                   "differ from the native C session")
    return len(paths), len(paths) * n_frames, wall


def run_multistream(tus: Sequence[bytes], device="cuda",
                    check: bool = True) -> List[List[np.ndarray]]:
    """The batch over one temporal unit a stream: decode each TU
    unfiltered (`decode_tu_unfiltered`), filter all of them in one pass,
    and return each stream's filtered mi-aligned int32 planes (numpy,
    filtered[s][p], as the JAX package's `batched_postfilter`).  check:
    each against the port's C decode of the same TU."""
    frames = [decode_tu_unfiltered(tu) for tu in tus]
    out = batched_postfilter_real(frames, device)
    filtered = [[out[p][s].cpu().numpy() for p in range(len(out))]
                for s in range(len(tus))]
    if check:
        for s, tu in enumerate(tus):
            be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
            ref = be.decode([tu], 0)[0]
            got = shown_planes(frames[s], [torch.from_numpy(p)
                                           for p in filtered[s]])
            for p, (a, b) in enumerate(zip(got, ref.data)):
                if not np.array_equal(a, np.asarray(b)):
                    raise RuntimeError(f"stream {s} plane {p} differs from "
                                       "the C decode")
    return filtered
