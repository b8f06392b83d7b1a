"""The port's frame pipe: the C entropy decoder's export feeds the device.

The counterpart of the reference's device pipe for intra frames:
`_pallas_frame`'s intra branch, the LF + CDEF part of
`_device_pipe_finish`, and the crop-and-cast tail
(`easyav1_tpu/native/__init__.py:1274-1348`, `:1533-1551`).  The entropy
decoder, the record export and the host planners are the JAX package's
own, shared by import.

A frame the port does not cover is declined: it is reconstructed by the
shared C recon from the same entropy output, and counted in
`stats["fallbacks"]`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

import easyav1_tpu.native as nat
from easyav1_tpu.container.webm import TrackType, WebMDemuxer
from easyav1_tpu.video.av1.backend import AV1Backend
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.recon.postfilter import postfilter_frame

# frames that reached the pipe, and those of them declined to the C recon
stats = {"frames": 0, "fallbacks": 0}
_stats_lock = threading.Lock()


def _count(fallback: bool) -> None:
    with _stats_lock:
        stats["frames"] += 1
        stats["fallbacks"] += int(fallback)


def covers(seq, hdr) -> bool:
    """The slice: 8-bit intra frames without intrabc, superres, loop
    restoration or film grain (non-4:2:0 CfL is declined by IntraRecon)."""
    fg = getattr(hdr, "film_grain", None)
    return (hdr.frame_is_intra and seq.color.bitdepth == 8
            and not getattr(hdr, "allow_intrabc", False)
            and not getattr(hdr, "use_superres", False)
            and not getattr(getattr(hdr, "lr", None), "uses_lr", False)
            and not (fg is not None and fg.apply_grain))


def export_units(lib, hdr, out, rp) -> Optional[np.ndarray]:
    """The C decoder's pred-unit records [N, 24] of the decoded frame
    (`av1_export_pred_units`), or None if the export fails."""
    units = np.empty((nat._max_pred_units(out, hdr), 24), np.int32)
    n_out = ctypes.c_int64(0)
    rc = lib.av1_export_pred_units(ctypes.byref(rp), ctypes.byref(out),
                                   nat._vp(units), units.shape[0],
                                   ctypes.byref(n_out))
    return units[:n_out.value] if rc == 0 else None


def intra_inputs(lib, seq, hdr, out, bufs, rp, device) -> Optional[dict]:
    """The device inputs of an intra frame, or None when the executor
    declines it: {"recon": IntraRecon, "fields", "resid": per-plane
    tensors on `device`, "maps": postfilter_frame's (grids_for, skip
    grid, CDEF index grid), "units": the pred-unit count}."""
    units = export_units(lib, hdr, out, rp)
    if units is None:
        return None
    ir = IntraRecon(hdr.mi_rows, hdr.mi_cols, seq.color.subsampling_x,
                    seq.color.subsampling_y, seq.color.bitdepth,
                    seq.color.num_planes, device)
    prep = ir.prepare(units, bufs["txs"][:out.n_txs],
                      bufs["coeffs"][:out.coeffs_used],
                      literals=nat._export_literals(lib, rp, out))
    if prep is None:
        return None
    fields, resid = ir.upload(*prep)
    return {"recon": ir, "fields": fields, "resid": resid,
            "maps": (nat._grids_exporter(lib, rp, out),
                     bufs["grids"]["skip"], bufs["cdef"]),
            "units": units.shape[0]}


def _intra_frame(lib, seq, hdr, out, bufs, rp, device):
    """Device recon + LF + CDEF of an intra frame.  Returns (display
    planes uint8, ref triples of mi-aligned uint16 planes) on the host,
    or None when the executor declines the frame."""
    inp = intra_inputs(lib, seq, hdr, out, bufs, rp, device)
    if inp is None:
        return None
    dev = inp["recon"].launch(inp["fields"], inp["resid"])
    dev = postfilter_frame(dev, hdr, seq, *inp["maps"])
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    w, h = hdr.upscaled_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    planes, refs = [], []
    for d, (pw_, ph_) in zip(dev, ((w, h), (cw, ch), (cw, ch))):
        planes.append(d[:ph_, :pw_].to(torch.uint8).cpu().numpy())
        refs.append((d.to(torch.int16).cpu().numpy().view(np.uint16),
                     pw_, ph_))
    return planes, refs


class _FirstFrame(AV1Backend):
    """Parses a stream and keeps its first frame's (seq, hdr, tiles)."""

    def _decode_frame(self, hdr, tile_payloads, ts):
        if not hasattr(self, "captured"):
            self.captured = (self.seq, hdr,
                             self._split_tiles(hdr, tile_payloads))


def first_frame_inputs(path: str, device: torch.device) -> Optional[dict]:
    """`intra_inputs` of a WebM stream's first frame, entropy-decoded in
    C, plus its "hdr" and "seq"; the postfilter maps are snapshots, so
    they stay valid across later decodes."""
    dmx = WebMDemuxer(path)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = _FirstFrame(vt)
    while not hasattr(be, "captured"):
        p = dmx.read_packet()
        if p is None:
            return None
        if p.track == vt.number:
            be.decode(p.frames, 0)
    seq, hdr, tiles = be.captured
    lib = nat._load()
    if lib is None:
        raise RuntimeError("the native C decoder library is unavailable")
    out, bufs, _blob, _fp = nat._run_tiles(lib, seq, hdr, tiles)
    inp = intra_inputs(lib, seq, hdr, out, bufs, nat._build_rp(seq, hdr),
                       device)
    if inp is None:
        return None
    grids_for, skip, cdef = inp["maps"]
    grids = {p: grids_for(p, d) for p, d in enumerate(inp["recon"].dims)}
    inp["maps"] = (lambda p, shape: grids[p], skip.copy(), cdef.copy())
    return inp | {"hdr": hdr, "seq": seq}


def _c_recon(lib, seq, hdr, out, fp_rc, rp, rfl):
    """The shared 16-bit C recon + postfilters on the entropy output.
    Returns (display planes, ref triples) or None if the recon fails."""
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    aw, ah = hdr.mi_cols * 4, hdr.mi_rows * 4
    # superres frames land at the upscaled width
    aw_y = max(aw, hdr.upscaled_width)
    aw_c = max(aw >> ssx, (hdr.upscaled_width + ssx) >> ssx)
    pl = (np.empty((ah, aw_y), np.uint16),
          np.empty((ah >> ssy, aw_c), np.uint16),
          np.empty((ah >> ssy, aw_c), np.uint16))
    rc = lib.av1_recon_frame(ctypes.byref(rp), ctypes.byref(out),
                             ctypes.byref(fp_rc), ctypes.byref(rfl),
                             *(nat._vp(p) for p in pl))
    if rc != 0:
        return None
    w, h = hdr.upscaled_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    dt = np.uint8 if seq.color.bitdepth == 8 else np.uint16
    planes, refs = [], []
    for p, (pw_, ph_) in zip(pl[:seq.color.num_planes],
                             ((w, h), (cw, ch), (cw, ch))):
        planes.append(p[:ph_, :pw_].astype(dt))
        refs.append((p, pw_, ph_))
    return planes, refs


def decode_and_recon(seq, hdr, tiles: List[bytes], device: torch.device,
                     cdf_in=None, want_cdf=False, tpl=None, refs=None,
                     threads=0) -> Optional[Tuple]:
    """Entropy decode in C, then the port's device recon (or the C recon
    for a declined frame).  Returns (display planes, cdf blob or None,
    mv grids or None, ref triples), or None when the C entropy decoder
    is unavailable or declines the frame.  refs: per-slot triples of
    (uint16 mi-aligned plane, logical w, logical h)."""
    lib = nat._load()
    if lib is None:
        return None
    rfl = nat._RefPlanes()
    keep_refs = []
    if not hdr.frame_is_intra:
        if refs is None or any(refs[s] is None
                               for s in set(hdr.ref_frame_idx)):
            return None
        for slot in range(8):
            for pi, (arr, lw, lh) in enumerate(refs[slot] or ()):
                arr = np.ascontiguousarray(arr, np.uint16)
                keep_refs.append(arr)
                rfl.plane[slot][pi] = nat._vp(arr).value
                rfl.w[slot][pi] = lw
                rfl.h[slot][pi] = lh
                rfl.stride[slot][pi] = arr.shape[1]
    res = nat._run_tiles(lib, seq, hdr, tiles, cdf_in=cdf_in,
                         want_cdf=want_cdf, tpl=tpl, threads=threads)
    if res is None:
        return None
    out, bufs, blob, (fp_rc, keep_fp) = res
    rp = nat._build_rp(seq, hdr)
    mv_grids = None
    if not hdr.frame_is_intra:
        mv_grids = (bufs["ref0"], bufs["ref1"], bufs["mvs"])
    got = (_intra_frame(lib, seq, hdr, out, bufs, rp, device)
           if covers(seq, hdr) else None)
    _count(fallback=got is None)
    if got is None:
        got = _c_recon(lib, seq, hdr, out, fp_rc, rp, rfl)
    del keep_fp, keep_refs
    if got is None:
        return None
    planes, ref_triples = got
    return planes, blob, mv_grids, ref_triples
