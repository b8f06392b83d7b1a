"""The port's frame pipes: the C entropy decoder's export feeds the device.

Two pipes, as the reference has two device pipes.  "recon", the main
pipe, is the counterpart of `EASYAV1_PIPE=pallas`: `_pallas_frame` for
intra frames (its intrabc branch included), `_device_frame_inter` for
inter frames, `_device_pipe_finish` (LF, the deblocked snapshot, CDEF,
superres of both, loop restoration), the crop-and-cast tail and
`_LazyPlanes` (`easyav1_tpu/native/__init__.py:1203-1242`, `:1274-1460`,
`:1533-1577`), and film grain on the display copy (`backend.py:499-529`
there).  "postfilter" is the counterpart of `EASYAV1_PIPE=device`
(`native/__init__.py:1121-1145`, `_device_postfilter` `:1580-1612`
there): the C recon with deblocking, CDEF and loop restoration held back
(`recon_unfiltered`), then those filters, the tail and film grain on the
device; superres frames take the whole C path, counted as fallbacks.  The
entropy decoder and the record export are the port's own copy of the C
decoder (`native/`); the host planners are the port's copies of the JAX
package's (`recon/records.py`, `recon/mc_plan.py`).

A frame the port does not cover is declined: it is reconstructed by the
port's C recon from the same entropy output, and counted in
`stats["fallbacks"]`.  Reference frames are kept as `DevRef`s: the device
plane that MC reads, and the host plane that the C recon and the
diffwtd masks read, each made once.  Display planes are `LazyPlanes`: in
resident mode nothing is downloaded until a consumer indexes them.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from easyav1_tpu_torch import native as nat
from easyav1_tpu_torch import trace
from easyav1_tpu_torch.container.webm import TrackType, WebMDemuxer
from easyav1_tpu_torch.video.av1.recon.inter_exec import InterRecon
from easyav1_tpu_torch.video.av1.recon.inter_mc import sample_dtype
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.recon.lr_torch import (LoopRestoration,
                                                        lr_plan)
from easyav1_tpu_torch.video.av1.recon.mc_plan import export_inter_plan
from easyav1_tpu_torch.video.av1.recon.postfilter import postfilter_frame
from easyav1_tpu_torch.video.av1.recon.sr_torch import upscale_plane

# frames that reached the pipe, and those of them declined to the C recon
stats = {"frames": 0, "fallbacks": 0}
_stats_lock = threading.Lock()


def _count(fallback: bool) -> None:
    with _stats_lock:
        stats["frames"] += 1
        stats["fallbacks"] += int(fallback)
    trace.count("pipe.frames")
    trace.count("pipe.fallbacks", int(fallback))


# The stage clock of a frame (`trace.Stages`): its marks name the stages
# (see `trace`).  The benchmark's traced run stands a subclass of its own
# in for this name, so the pipe makes each clock through it.
_Stages = trace.Stages


class LazyPlanes:
    """A frame's planes on the device (uint8, or uint16 above 8 bits),
    as a sequence of numpy planes that are downloaded when first indexed (the counterpart of
    the reference's `_LazyPlanes`).  With `eager` the download is made
    at once; without it (resident mode) a frame that is only hashed on
    the device (`device_planes`) never crosses to the host."""

    __slots__ = ("_devs", "_np")

    def __init__(self, devs: List[torch.Tensor], eager: bool = True):
        self._devs = devs
        self._np = None
        if eager:
            self._mat()

    @property
    def device_planes(self) -> List[torch.Tensor]:
        return self._devs

    @property
    def materialised(self) -> bool:
        return self._np is not None

    def _mat(self):
        if self._np is None:
            with trace.span("download"):
                self._np = [d.cpu().numpy() for d in self._devs]
                trace.add(d2h_bytes=sum(a.nbytes for a in self._np))
        return self._np

    def __len__(self):
        return len(self._devs)

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())


class DevRef:
    """One plane of a reference frame (the counterpart of the reference's
    `_DevRef`, `native/__init__.py:1249-1271`): the [lh, lw] plane on the
    device that MC reads, uint8 at 8 bits and uint16 above, and the
    uint16 host plane that the C recon and the diffwtd masks read.  A
    plane the device made has its host plane made once, on demand: from
    the frame's `LazyPlanes` where those are downloaded already, else by
    downloading this plane alone (in resident mode the frame itself stays
    on the device); a plane the C recon made is uploaded once, at its
    first use by MC."""

    __slots__ = ("_dev", "_lazy", "_host", "lw", "lh", "dtype")

    def __init__(self, lw: int, lh: int, dev: Optional[torch.Tensor] = None,
                 lazy: Optional[Tuple[LazyPlanes, int]] = None,
                 host: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.uint8):
        self.lw, self.lh = lw, lh
        self._dev, self._lazy, self._host = dev, lazy, host
        self.dtype = dev.dtype if dev is not None else dtype

    def host(self) -> np.ndarray:
        """The host plane, uint16, C-contiguous, at least lh x lw."""
        if self._host is None:
            planes, i = self._lazy
            if planes.materialised:
                got = planes[i]
            else:
                got = self._dev.cpu().numpy()
                trace.add(d2h_bytes=got.nbytes)
            self._host = got.astype(np.uint16)
        return self._host

    def tensor(self, device: torch.device) -> torch.Tensor:
        """The [lh, lw] plane on `device`, of type `dtype`."""
        if self._dev is None or self._dev.device != device:
            h = np.ascontiguousarray(
                self.host()[:self.lh, :self.lw],
                np.uint8 if self.dtype == torch.uint8 else np.uint16)
            self._dev = torch.from_numpy(h).to(device)
            trace.add(h2d_bytes=h.nbytes)
        return self._dev


def covers(seq, hdr) -> bool:
    """The slice: 8-, 10- and 12-bit frames, intra (intrabc too) or
    inter, with superres, loop restoration and film grain.  Non-4:2:0
    CfL is declined by the recons; intrabc blocks inside inter frames
    and scaled references by the MC planner."""
    return seq.color.bitdepth in (8, 10, 12)


def export_units(lib, hdr, out, rp) -> Optional[np.ndarray]:
    """The C decoder's pred-unit records [N, 24] of the decoded frame
    (`av1_export_pred_units`), or None if the export fails."""
    units = np.empty((nat._max_pred_units(out, hdr), 24), np.int32)
    n_out = ctypes.c_int64(0)
    rc = lib.av1_export_pred_units(ctypes.byref(rp), ctypes.byref(out),
                                   nat._vp(units), units.shape[0],
                                   ctypes.byref(n_out))
    return units[:n_out.value] if rc == 0 else None


def intra_inputs(lib, seq, hdr, out, bufs, rp, device, clock,
                 host_residual=True) -> Optional[dict]:
    """The device inputs of an intra frame, or None when the executor
    declines it: {"recon": IntraRecon, "fields", "resid": per-plane
    tensors on `device`, "schedule": the SB schedule there, "maps":
    postfilter_frame's (grids_for, skip grid, CDEF index grid), "units":
    the pred-unit count, "records": the uploaded (txs, coeffs,
    class_offsets) the device composer read (`records.pack_coeff_rows`),
    or None with `host_residual`}.  clock: the frame's `_Stages`, which
    is told why a frame is declined."""
    units = export_units(lib, hdr, out, rp)
    if units is None:
        clock.decline("export")
        return None
    ir = IntraRecon(hdr.mi_rows, hdr.mi_cols, seq.color.subsampling_x,
                    seq.color.subsampling_y, seq.color.bitdepth,
                    seq.color.num_planes,
                    128 if seq.use_128x128_superblock else 64, device,
                    host_residual)
    prep = ir.prepare(units, bufs["txs"][:out.n_txs],
                      bufs["coeffs"][:out.coeffs_used],
                      literals=nat._export_literals(lib, rp, out),
                      intrabc=bool(getattr(hdr, "allow_intrabc", False)),
                      clock=clock)
    clock.mark("prepare")
    if prep is None:
        clock.decline("prepare")
        return None
    fields, records, _masks, schedule = ir.upload(*prep)
    clock.mark("upload")
    resid = ir.compose(records)
    clock.mark("compose")
    if resid is None:
        clock.decline("composer")
        return None
    return {"recon": ir, "fields": fields, "resid": resid,
            "schedule": schedule,
            "maps": (nat._grids_exporter(lib, rp, out),
                     bufs["grids"]["skip"], bufs["cdef"]),
            "units": units.shape[0],
            "records": records if isinstance(records, tuple) else None}


def _finish(dev, seq, hdr, out, bufs, maps, clock):
    """The postfilter chain on the device, the counterpart of
    `_device_pipe_finish`: LF, the deblocked snapshot, CDEF, superres of
    the planes and of the snapshot, then loop restoration.  dev: the
    reconstructed mi-aligned int32 planes; maps: `postfilter_frame`'s
    (grids_for, skip grid, CDEF index grid).  Returns the planes, at the
    upscaled width for a superres frame."""
    device = dev[0].device
    lr_on = bool(getattr(getattr(hdr, "lr", None), "uses_lr", False)
                 and out.n_lr_units > 0)
    res = postfilter_frame(dev, hdr, seq, *maps, want_deblocked=lr_on)
    dev, debl = res if lr_on else (res, None)
    clock.mark("lf_cdef")
    if getattr(hdr, "use_superres", False):
        ssx, bd = seq.color.subsampling_x, seq.color.bitdepth

        def up(planes):
            sub = [ssx if p else 0 for p in range(len(planes))]
            return [upscale_plane(d, (hdr.frame_width + sx) >> sx,
                                  (hdr.upscaled_width + sx) >> sx, bd)
                    for d, sx in zip(planes, sub)]

        dev, debl = up(dev), up(debl) if lr_on else None
        clock.mark("sr")
    if lr_on:
        dev = LoopRestoration(hdr, seq, lr_plan(out, bufs),
                              seq.color.bitdepth).apply(dev, debl)
        clock.mark("lr")
    return dev


def _tail(dev, seq, hdr, resident, grain, clock):
    """Crop and cast, then film grain on a copy: (display planes, a
    `LazyPlanes` of device planes of `sample_dtype`; ref triples of
    DevRef) from the post-filtered planes.  grain: None, or a callable (film grain
    parameters, seq, device planes) -> new grained device planes.  The
    references keep the planes without grain; the display planes are
    downloaded at once unless `resident`."""
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    w, h = hdr.upscaled_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    fg = getattr(hdr, "film_grain", None)
    grained = grain is not None and fg is not None and fg.apply_grain
    dt = sample_dtype(seq.color.bitdepth)
    clean = [d[:ph_, :pw_].to(dt).contiguous()
             for d, (pw_, ph_) in zip(dev, ((w, h), (cw, ch), (cw, ch)))]
    planes = LazyPlanes(clean, eager=not (resident or grained))
    refs = [(DevRef(c.shape[1], c.shape[0], dev=c, lazy=(planes, p)),
             c.shape[1], c.shape[0]) for p, c in enumerate(clean)]
    clock.mark("tail")
    if grained:
        noisy = grain(fg, seq, clean)
        clock.mark("grain")
        planes = LazyPlanes(noisy, eager=not resident)
        clock.mark("tail")
    return planes, refs


def _intra_frame(lib, seq, hdr, out, bufs, rp, device, clock,
                 host_residual):
    """Device recon and postfilters of an intra frame.  Returns the
    post-filtered device planes, or None when the executor declines the
    frame."""
    inp = intra_inputs(lib, seq, hdr, out, bufs, rp, device, clock,
                       host_residual)
    if inp is None:
        return None
    dev = inp["recon"].launch(inp["fields"], inp["resid"], inp["schedule"])
    clock.mark("intra")
    return _finish(dev, seq, hdr, out, bufs, inp["maps"], clock)


class _HostLuma:
    """The reference slots' host luma planes, made on demand: all that
    `export_inter_plan` reads of `ref_planes` (diffwtd masks)."""

    def __init__(self, refs):
        self.refs = refs

    def __getitem__(self, slot):
        return [self.refs[slot][0][0].host()]


def _inter_frame(lib, seq, hdr, out, bufs, rp, refs, device, clock,
                 host_residual):
    """Device MC + OBMC + intra units and postfilters of an inter frame,
    the counterpart of `_device_frame_inter`.  refs: per-slot triples of
    (DevRef, lw, lh).  Returns as `_intra_frame`, or None when the
    planner or the recon declines the frame."""
    ref_dims = [None if refs[s] is None else (refs[s][0][1], refs[s][0][2])
                for s in range(8)]
    plan = export_inter_plan(seq, hdr, bufs["blocks"][:out.n_blocks],
                             bufs["ref0"], bufs["mvs"], bufs["interp"],
                             ref_dims, ref_planes=_HostLuma(refs),
                             bsize_g=bufs["grids"]["bsize"])
    clock.mark("plan")
    if plan is None:
        clock.decline("planner")
        return None
    units = export_units(lib, hdr, out, rp)
    if units is None:
        clock.decline("export")
        return None
    ir = InterRecon(hdr.mi_rows, hdr.mi_cols, seq.color.subsampling_x,
                    seq.color.subsampling_y, seq.color.bitdepth,
                    seq.color.num_planes,
                    128 if seq.use_128x128_superblock else 64, device,
                    host_residual)
    prep = ir.prepare(units, bufs["txs"][:out.n_txs],
                      bufs["coeffs"][:out.coeffs_used],
                      literals=nat._export_literals(lib, rp, out),
                      clock=clock)
    clock.mark("prepare")
    if prep is None:
        clock.decline("prepare")
        return None
    fields, resid, masks, schedule = ir.upload(*prep)
    dev_refs = [[refs[s][p][0].tensor(device) for s in plan["slots"]]
                for p in range(seq.color.num_planes)]
    clock.mark("upload")
    resid = ir.compose(resid)
    clock.mark("compose")
    if resid is None:
        clock.decline("composer")
        return None
    dev = ir.motion(resid, plan, dev_refs)
    clock.mark("mc")
    dev = ir.intra(dev, fields, resid, masks, schedule)
    clock.mark("intra")
    return _finish(dev, seq, hdr, out, bufs,
                   (nat._grids_exporter(lib, rp, out), bufs["grids"]["skip"],
                    bufs["cdef"]), clock)


def first_frame_inputs(path: str, device: torch.device,
                       host_residual: bool = True) -> Optional[dict]:
    """`intra_inputs` of a WebM stream's first frame, entropy-decoded in
    C, plus its "hdr" and "seq" and "dense": the decoder's own (txs,
    coeffs) export (dense blocks, decode order); the postfilter maps
    and the records are snapshots, so they stay valid across later
    decodes."""
    # the backend imports this module
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    class FirstFrame(AV1Backend):
        """Parses a stream and keeps its first frame's (seq, hdr,
        tiles)."""

        def _decode_frame(self, hdr, tile_payloads, ts):
            if not hasattr(self, "captured"):
                self.captured = (self.seq, hdr,
                                 self._split_tiles(hdr, tile_payloads))

    dmx = WebMDemuxer(path)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = FirstFrame(vt)
    while not hasattr(be, "captured"):
        p = dmx.read_packet()
        if p is None:
            return None
        if p.track == vt.number:
            be.decode(p.frames, 0)
    seq, hdr, tiles = be.captured
    lib = nat._load()
    out, bufs, _blob, _fp = nat._run_tiles(lib, seq, hdr, tiles)
    with _Stages() as clock:
        inp = intra_inputs(lib, seq, hdr, out, bufs,
                           nat._build_rp(seq, hdr), device, clock,
                           host_residual)
    if inp is None:
        return None
    grids_for, skip, cdef = inp["maps"]
    grids = {p: grids_for(p, d) for p, d in enumerate(inp["recon"].dims)}
    inp["maps"] = (lambda p, shape: grids[p], skip.copy(), cdef.copy())
    if inp["records"] is not None:
        # on the CPU the uploaded records share the decoder's buffers
        inp["records"] = tuple(t.clone() if isinstance(t, torch.Tensor)
                               else t.copy() for t in inp["records"])
    dense = (bufs["txs"][:out.n_txs].copy(),
             bufs["coeffs"][:out.coeffs_used].copy())
    return inp | {"hdr": hdr, "seq": seq, "dense": dense}


def recon_unfiltered(lib, seq, hdr, out, fp_rc, rp, rfl):
    """The 16-bit C recon of an entropy-decoded frame without superres,
    with deblocking, CDEF and loop restoration held back (the
    reference's `EASYAV1_PIPE=device` recon, `native/__init__.py:1121-
    1137` there): the mi-aligned uint16 planes, or None if the recon
    fails.  rp and fp_rc keep their real filter parameters, which the
    grid export and the filters read.  rfl: the reference planes
    (`_c_refs`)."""
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    aw, ah = hdr.mi_cols * 4, hdr.mi_rows * 4
    pl = [np.zeros((ah, aw), np.uint16),
          np.zeros((ah >> ssy, aw >> ssx), np.uint16),
          np.zeros((ah >> ssy, aw >> ssx), np.uint16)]
    saved = tuple(rp.lf_level), rp.enable_cdef, fp_rc.lr_uses
    rp.lf_level = (ctypes.c_int32 * 4)(0, 0, 0, 0)
    rp.enable_cdef = fp_rc.lr_uses = 0
    try:
        rc = lib.av1_recon_frame(ctypes.byref(rp), ctypes.byref(out),
                                 ctypes.byref(fp_rc), ctypes.byref(rfl),
                                 *(nat._vp(p) for p in pl))
    finally:
        rp.lf_level = (ctypes.c_int32 * 4)(*saved[0])
        rp.enable_cdef, fp_rc.lr_uses = saved[1:]
    return pl[:seq.color.num_planes] if rc == 0 else None


def _postfilter_frame(lib, seq, hdr, out, bufs, fp_rc, rp, refs, device,
                      clock):
    """The postfilter pipe's frame: `recon_unfiltered`, then the planes'
    upload and `_finish` (LF, CDEF, loop restoration) on the device.
    Returns the post-filtered device planes, or None if the C recon
    fails."""
    rfl, keep_refs = _c_refs(None if hdr.frame_is_intra else refs)
    planes = recon_unfiltered(lib, seq, hdr, out, fp_rc, rp, rfl)
    del keep_refs
    clock.mark("recon")
    if planes is None:
        clock.decline("recon")
        return None
    host = [p.astype(np.int32) for p in planes]
    dev = [torch.from_numpy(p).to(device) for p in host]
    trace.add(h2d_bytes=sum(p.nbytes for p in host))
    clock.mark("upload")
    return _finish(dev, seq, hdr, out, bufs,
                   (nat._grids_exporter(lib, rp, out), bufs["grids"]["skip"],
                    bufs["cdef"]), clock)


def _c_recon(lib, seq, hdr, out, fp_rc, rp, rfl):
    """The 16-bit C recon + postfilters on the entropy output.
    Returns (display planes, ref triples of DevRef) or None if the recon
    fails."""
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
        refs.append((DevRef(pw_, ph_, host=p,
                            dtype=sample_dtype(seq.color.bitdepth)),
                     pw_, ph_))
    return planes, refs


def _c_refs(refs):
    """The C recon's reference list: the host plane of every slot's
    planes (made here, once, for a plane the device made), and the
    arrays it points into, to keep alive through the call."""
    rfl = nat._RefPlanes()
    keep = []
    for slot in range(8 if refs is not None else 0):
        for pi, (ref, lw, lh) in enumerate(refs[slot] or ()):
            arr = ref.host()
            keep.append(arr)
            rfl.plane[slot][pi] = nat._vp(arr).value
            rfl.w[slot][pi] = lw
            rfl.h[slot][pi] = lh
            rfl.stride[slot][pi] = arr.shape[1]
    return rfl, keep


PIPES = ("recon", "postfilter")


def decode_and_recon(seq, hdr, tiles: List[bytes], device: torch.device,
                     cdf_in=None, want_cdf=False, tpl=None, refs=None,
                     threads=0, resident=False, grain=None,
                     host_residual=True, pipe="recon") -> Optional[Tuple]:
    """Entropy decode in C, then the port's device recon (or the C recon
    for a declined frame); with `pipe` "postfilter", the C recon without
    its filters, then the filters on the device (the C path for a
    superres frame).  Returns (display planes, cdf blob or None,
    mv grids or None, ref triples), or None when the C entropy decoder
    declines the frame.  refs: per-slot triples of (DevRef, logical w,
    logical h).  The display planes of a frame the device made are a
    `LazyPlanes`, with film grain already applied by `grain` (see
    `_tail`); those of a declined frame are numpy planes without
    grain.  resident: download no plane until a consumer indexes it.
    host_residual: the host C composer makes the residual planes (the
    default), or the device composer (`itx_torch.compose_residual`)."""
    lib = nat._load()
    if not hdr.frame_is_intra and (
            refs is None or any(refs[s] is None
                                for s in set(hdr.ref_frame_idx))):
        return None
    with _Stages() as clock:
        clock.tag(kind="key" if hdr.frame_is_intra else "inter")
        res = nat._run_tiles(lib, seq, hdr, tiles, cdf_in=cdf_in,
                             want_cdf=want_cdf, tpl=tpl, threads=threads)
        if res is None:
            return None
        out, bufs, blob, (fp_rc, keep_fp) = res
        clock.mark("entropy")
        rp = nat._build_rp(seq, hdr)
        mv_grids = None
        if not hdr.frame_is_intra:
            mv_grids = (bufs["ref0"], bufs["ref1"], bufs["mvs"])
        got = None
        if pipe == "postfilter":
            if getattr(hdr, "use_superres", False):
                clock.decline("superres")
            else:
                got = _postfilter_frame(lib, seq, hdr, out, bufs, fp_rc, rp,
                                        refs, device, clock)
        elif not covers(seq, hdr):
            clock.decline("bit depth")
        else:
            got = (_intra_frame(lib, seq, hdr, out, bufs, rp, device, clock,
                                host_residual)
                   if hdr.frame_is_intra else
                   _inter_frame(lib, seq, hdr, out, bufs, rp, refs, device,
                                clock, host_residual))
        if got is not None:
            got = _tail(got, seq, hdr, resident, grain, clock)
        _count(fallback=got is None)
        if got is None:
            rfl, keep_refs = _c_refs(None if hdr.frame_is_intra else refs)
            got = _c_recon(lib, seq, hdr, out, fp_rc, rp, rfl)
            del keep_refs
            clock.mark("recon")
        del keep_fp
    if got is None:
        return None
    planes, ref_triples = got
    return planes, blob, mv_grids, ref_triples
