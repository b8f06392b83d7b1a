# Copy of easyav1_tpu/native/__init__.py, the JAX package's counterpart.
"""Native (C) decoder bindings via ctypes.

The port's own copy of the C entropy decoder, recon, film grain and
Vorbis symbol decoder (`av1_tile.c`, `av1_recon.c`, `av1_recon8.c`,
`vorbis_dec.c` and the `av1_*.h` beside them), and of the reference's
bindings to them.  The JAX device pipes of the reference are left out.

Nothing builds on import: `_load()` builds the library at first use
with gcc into `easyav1_tpu_torch/_build/libeasyav1.so` (the four
sources compiled in parallel, then linked), under a file lock so that
concurrent processes build it once, and rebuilds it when a source is
newer.  It raises when the build fails: the port has no pure-Python
decoder to fall back to.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import subprocess
import sys
import weakref
from typing import List, Optional

import numpy as np

from easyav1_tpu_torch import trace

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD, "libeasyav1.so")
_SRCS = [os.path.join(_DIR, n) for n in (
    "av1_tile.c", "av1_recon.c", "av1_recon8.c", "vorbis_dec.c")]
# every header participates in the staleness check
_HDRS = sorted(glob.glob(os.path.join(_DIR, "*.h")))
CFLAGS = ["-O3", "-funroll-loops", "-march=native", "-fPIC", "-pthread"]

class _TileParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "mi_rows", "mi_cols", "sb128", "bitdepth", "num_planes", "ssx",
        "ssy", "base_q_idx", "dq_y_dc", "dq_u_dc", "dq_u_ac", "dq_v_dc",
        "dq_v_ac", "tx_mode", "reduced_tx_set", "coded_lossless",
        "allow_update_cdf", "enable_cdef", "cdef_bits",
        "enable_filter_intra", "allow_intrabc", "delta_q_present",
        "delta_q_res", "delta_lf_present", "delta_lf_multi", "col_start",
        "col_end", "row_start", "row_end", "qctx", "allow_screen",
        "fill_aux")]


class _FrameParams(ctypes.Structure):
    """Per-frame inter header fields + entropy-state chaining
    (av1_common.h FrameParams)."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "frame_is_intra", "reference_select", "skip_mode_present",
        "skip_mode_frame0", "skip_mode_frame1",
        "allow_high_precision_mv", "force_integer_mv",
        "interpolation_filter", "enable_dual_filter",
        "is_motion_mode_switchable", "allow_warped_motion",
        "enable_interintra_compound", "enable_masked_compound",
        "enable_jnt_comp", "enable_order_hint", "order_hint_bits",
        "order_hint")] + [
        ("order_hints", ctypes.c_int32 * 8),
        ("sign_bias", ctypes.c_int32 * 8),
        ("gm_type", ctypes.c_int32 * 8),
        ("gm_invalid", ctypes.c_int32 * 8),
        ("gm_params", (ctypes.c_int32 * 6) * 8),
        ("ref_frame_idx", ctypes.c_int32 * 8),
        ("lr_uses", ctypes.c_int32),
        ("lr_frame_type", ctypes.c_int32 * 3),
        ("lr_unit_size", ctypes.c_int32 * 3),
        ("frame_width", ctypes.c_int32),
        ("frame_height", ctypes.c_int32),
        ("use_superres", ctypes.c_int32),
        ("downscaled_width", ctypes.c_int32),
        ("superres_denom", ctypes.c_int32),
        ("use_tpl", ctypes.c_int32),
        ("w8", ctypes.c_int32), ("h8", ctypes.c_int32),
        ("tpl_mv", ctypes.c_void_p), ("tpl_off", ctypes.c_void_p),
        ("cdf_in", ctypes.c_void_p), ("cdf_out", ctypes.c_void_p),
    ]


BLK_FIELDS = 52


class _FgParams(ctypes.Structure):
    """headers.FilmGrainParams mirror (av1_fg.h FgParams)."""

    _fields_ = [
        ("grain_seed", ctypes.c_int32),
        ("num_y_points", ctypes.c_int32),
        ("num_cb_points", ctypes.c_int32),
        ("num_cr_points", ctypes.c_int32),
        ("point_y_value", ctypes.c_int32 * 15),
        ("point_y_scaling", ctypes.c_int32 * 15),
        ("point_cb_value", ctypes.c_int32 * 11),
        ("point_cb_scaling", ctypes.c_int32 * 11),
        ("point_cr_value", ctypes.c_int32 * 11),
        ("point_cr_scaling", ctypes.c_int32 * 11),
        ("chroma_scaling_from_luma", ctypes.c_int32),
        ("grain_scaling", ctypes.c_int32),
        ("ar_coeff_lag", ctypes.c_int32),
        ("ar_coeffs_y", ctypes.c_int32 * 24),
        ("ar_coeffs_cb", ctypes.c_int32 * 25),
        ("ar_coeffs_cr", ctypes.c_int32 * 25),
        ("n_ar_y", ctypes.c_int32),
        ("n_ar_cb", ctypes.c_int32),
        ("n_ar_cr", ctypes.c_int32),
        ("ar_coeff_shift", ctypes.c_int32),
        ("grain_scale_shift", ctypes.c_int32),
        ("cb_mult", ctypes.c_int32),
        ("cb_luma_mult", ctypes.c_int32),
        ("cb_offset", ctypes.c_int32),
        ("cr_mult", ctypes.c_int32),
        ("cr_luma_mult", ctypes.c_int32),
        ("cr_offset", ctypes.c_int32),
        ("overlap_flag", ctypes.c_int32),
        ("clip_to_restricted_range", ctypes.c_int32),
    ]


def _fg_params(fg) -> _FgParams:
    """The C mirror of a `headers.FilmGrainParams`."""
    p = _FgParams(
        grain_seed=fg.grain_seed, num_y_points=fg.num_y_points,
        num_cb_points=fg.num_cb_points, num_cr_points=fg.num_cr_points,
        chroma_scaling_from_luma=int(fg.chroma_scaling_from_luma),
        grain_scaling=fg.grain_scaling, ar_coeff_lag=fg.ar_coeff_lag,
        n_ar_y=len(fg.ar_coeffs_y), n_ar_cb=len(fg.ar_coeffs_cb),
        n_ar_cr=len(fg.ar_coeffs_cr),
        ar_coeff_shift=fg.ar_coeff_shift,
        grain_scale_shift=fg.grain_scale_shift,
        cb_mult=fg.cb_mult, cb_luma_mult=fg.cb_luma_mult,
        cb_offset=fg.cb_offset, cr_mult=fg.cr_mult,
        cr_luma_mult=fg.cr_luma_mult, cr_offset=fg.cr_offset,
        overlap_flag=int(fg.overlap_flag),
        clip_to_restricted_range=int(fg.clip_to_restricted_range))
    for name, vals in (("point_y_value", fg.point_y_value),
                       ("point_y_scaling", fg.point_y_scaling),
                       ("point_cb_value", fg.point_cb_value),
                       ("point_cb_scaling", fg.point_cb_scaling),
                       ("point_cr_value", fg.point_cr_value),
                       ("point_cr_scaling", fg.point_cr_scaling),
                       ("ar_coeffs_y", fg.ar_coeffs_y),
                       ("ar_coeffs_cb", fg.ar_coeffs_cb),
                       ("ar_coeffs_cr", fg.ar_coeffs_cr)):
        arr = getattr(p, name)
        for i, v in enumerate(vals):
            arr[i] = int(v)
    return p


def fg_templates(fg, bd: int, ssx: int, ssy: int, mono: bool):
    """The grain templates of a parameter set from the C generator
    (av1_fg.h `av1_fg_templates`, spec 7.18.3.3): (luma [73, 82], Cb,
    Cr) int32 arrays, each chroma template [38 or 73, 44 or 82] by the
    subsampling; the chroma templates are None for a monochrome
    stream."""
    out = np.zeros((3, 73, 82), np.int32)
    rc = _load().av1_fg_templates(ctypes.byref(_fg_params(fg)), bd, ssx,
                                  ssy, int(mono), _vp(out))
    if rc != 0:
        raise MemoryError("av1_fg_templates: out of memory")
    if mono:
        return out[0], None, None
    ch, cw = (38 if ssy else 73), (44 if ssx else 82)
    return out[0], out[1, :ch, :cw].copy(), out[2, :ch, :cw].copy()


def film_grain_native(fg, seq, planes):
    """Apply film grain via the C path; returns new planes (dtype of
    the inputs) or None when the C synthesis fails."""
    lib = _load()
    p = _fg_params(fg)
    src = [np.asarray(pl) for pl in planes]
    # copies: at 16 bits ascontiguousarray would hand back the caller's
    # planes, and the grain would land in the reference frames
    work = [np.array(pl, np.uint16) for pl in src]
    luma_orig = np.ascontiguousarray(src[0], np.uint16)
    ptrs = (ctypes.c_void_p * 3)()
    for i in range(3):
        ptrs[i] = _vp(work[i]).value if i < len(work) else None
    h, w = src[0].shape
    mono = int(getattr(seq.color, "mono_chrome", False))
    rc = lib.av1_film_grain(
        ctypes.byref(p), seq.color.bitdepth, seq.color.subsampling_x,
        seq.color.subsampling_y, mono, len(work), ptrs, _vp(luma_orig),
        w, h)
    if rc != 0:
        return None
    return [wk.astype(s.dtype) for wk, s in zip(work, src)]


class _RefPlanes(ctypes.Structure):
    """Reference planes per slot (av1_common.h), in the frame's pel
    dtype (uint8 for the 8bpc recon build, uint16 otherwise): logical
    w/h plus the row stride in elements (the planes may be views into
    the mi-aligned recon buffers, avoiding a per-frame copy)."""

    _fields_ = [
        ("plane", (ctypes.c_void_p * 3) * 8),
        ("w", (ctypes.c_int32 * 3) * 8),
        ("h", (ctypes.c_int32 * 3) * 8),
        ("stride", (ctypes.c_int32 * 3) * 8),
    ]


class _TileDesc(ctypes.Structure):
    """Mirror of TileDesc (av1_tile.c tile-parallel entry)."""
    _fields_ = [
        ("data", ctypes.c_char_p), ("size", ctypes.c_int64),
        ("col_start", ctypes.c_int32), ("col_end", ctypes.c_int32),
        ("row_start", ctypes.c_int32), ("row_end", ctypes.c_int32),
        ("cdf_out", ctypes.c_void_p),
    ]


def decode_threads() -> int:
    """Worker count for tile-parallel entropy decode.  EASYAV1_THREADS
    overrides; 0/unset = auto (cpu count, dav1d-auto analog
    easyav1.c:1401-1408).  A frame's count is `tile_workers`."""
    try:
        n = int(os.environ.get("EASYAV1_THREADS", "0"))
    except ValueError:
        n = 0
    if n <= 0:
        n = os.cpu_count() or 1
    return max(1, n)


# av1_decode_tiles_mt's largest pool
_MAX_WORKERS = 64


def tile_workers(hdr, threads: int = 0) -> int:
    """The threads that entropy-decode a frame: 1 for a frame of one
    tile, else `threads` (or `decode_threads()` where it is 0), at most
    one a tile and `_MAX_WORKERS`, as the C entry caps them.  More than
    1 takes the tile-parallel entry, `av1_decode_tiles_mt`."""
    n_tiles = hdr.tile.cols * hdr.tile.rows
    if n_tiles == 1:
        return 1
    n = threads if threads > 0 else decode_threads()
    return min(n, n_tiles, _MAX_WORKERS)


class _TileOut(ctypes.Structure):
    _fields_ = [
        ("y_mode", ctypes.c_void_p), ("uv_mode", ctypes.c_void_p),
        ("angle_y", ctypes.c_void_p), ("angle_uv", ctypes.c_void_p),
        ("skip", ctypes.c_void_p), ("bsize", ctypes.c_void_p),
        ("blocks", ctypes.c_void_p),
        ("max_blocks", ctypes.c_int64), ("n_blocks", ctypes.c_int64),
        ("txs", ctypes.c_void_p),
        ("max_txs", ctypes.c_int64), ("n_txs", ctypes.c_int64),
        ("coeffs", ctypes.c_void_p),
        ("coeffs_cap", ctypes.c_int64), ("coeffs_used", ctypes.c_int64),
        ("lf_txs", ctypes.c_void_p),
        ("max_lf", ctypes.c_int64), ("n_lf", ctypes.c_int64),
        ("cdef_idx", ctypes.c_void_p),
        ("error", ctypes.c_int32),
        ("ref0_g", ctypes.c_void_p), ("ref1_g", ctypes.c_void_p),
        ("mvs_g", ctypes.c_void_p), ("interp_g", ctypes.c_void_p),
        ("modes_g", ctypes.c_void_p),
        ("intrabc_g", ctypes.c_void_p),
        ("lr_units", ctypes.c_void_p),
        ("max_lr_units", ctypes.c_int64), ("n_lr_units", ctypes.c_int64),
        ("pal_units", ctypes.c_void_p),
        ("max_pal_units", ctypes.c_int64),
        ("n_pal_units", ctypes.c_int64),
        ("pal_maps", ctypes.c_void_p),
        ("pal_maps_cap", ctypes.c_int64),
        ("pal_maps_used", ctypes.c_int64),
    ]


class _ReconParams(ctypes.Structure):
    _fields_ = [
        ("bitdepth", ctypes.c_int32), ("num_planes", ctypes.c_int32),
        ("ssx", ctypes.c_int32), ("ssy", ctypes.c_int32),
        ("mi_rows", ctypes.c_int32), ("mi_cols", ctypes.c_int32),
        ("enable_intra_edge_filter", ctypes.c_int32),
        ("lf_level", ctypes.c_int32 * 4),
        ("lf_sharpness", ctypes.c_int32),
        ("lf_delta_enabled", ctypes.c_int32),
        ("lf_ref_deltas", ctypes.c_int32 * 8),
        ("lf_mode_deltas", ctypes.c_int32 * 2),
        ("enable_cdef", ctypes.c_int32),
        ("cdef_damping", ctypes.c_int32),
        ("cdef_y_pri", ctypes.c_int32 * 8),
        ("cdef_y_sec", ctypes.c_int32 * 8),
        ("cdef_uv_pri", ctypes.c_int32 * 8),
        ("cdef_uv_sec", ctypes.c_int32 * 8),
        ("coded_lossless", ctypes.c_int32),
        ("allow_intrabc", ctypes.c_int32),
        ("frame_width", ctypes.c_int32),
        ("frame_height", ctypes.c_int32),
        ("tile_cols", ctypes.c_int32),
        ("tile_rows", ctypes.c_int32),
        ("tile_col_starts", ctypes.c_int32 * 65),
        ("tile_row_starts", ctypes.c_int32 * 65),
    ]


_lib: Optional[ctypes.CDLL] = None


def _fresh() -> bool:
    newest = max(os.path.getmtime(f) for f in _SRCS + _HDRS)
    return os.path.exists(_SO) and os.path.getmtime(_SO) >= newest


def _build() -> str:
    """Path of the library, built from the sources beside this file
    unless it is newer than all of them.  Raises with gcc's output on
    failure."""
    if _fresh():
        return _SO
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "libeasyav1.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():                # another process built it meanwhile
            return _SO
        tag = f"{os.getpid()}.tmp"
        objs = [os.path.join(_BUILD, os.path.basename(s)[:-2] + f".{tag}.o")
                for s in _SRCS]
        tmp = f"{_SO}.{tag}"
        try:
            procs = [subprocess.Popen(["gcc", *CFLAGS, "-c", "-o", o, s],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for s, o in zip(_SRCS, objs)]
            logs = [p.communicate()[0] for p in procs]
            bad = [(s, g) for s, g, p in zip(_SRCS, logs, procs)
                   if p.returncode != 0]
            if not bad:
                r = subprocess.run(["gcc", "-shared", "-pthread", "-o", tmp,
                                    *objs], capture_output=True, text=True)
                if r.returncode != 0:
                    bad = [("link", r.stdout + r.stderr)]
            if bad:
                raise RuntimeError("gcc failed building the native decoder:\n"
                                   + "\n".join(f"{s}:\n{g}" for s, g in bad))
            # atomic: a concurrent loader sees no library or the whole one
            os.replace(tmp, _SO)
        finally:
            for f in objs + [tmp]:
                if os.path.exists(f):
                    os.unlink(f)
    return _SO


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    lib.av1_decode_tile.restype = ctypes.c_int
    lib.av1_decode_tile.argtypes = [
        ctypes.POINTER(_TileParams), ctypes.POINTER(_FrameParams),
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_TileOut)]
    lib.av1_decode_tiles_mt.restype = ctypes.c_int
    lib.av1_decode_tiles_mt.argtypes = [
        ctypes.POINTER(_TileParams), ctypes.POINTER(_FrameParams),
        ctypes.POINTER(_TileDesc), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_TileOut)]
    lib.av1_cdf_blob_size.restype = ctypes.c_int
    lib.av1_cdf_blob_size.argtypes = []
    lib.av1_compose_residual.restype = ctypes.c_int
    lib.av1_compose_residual.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.av1_pack_coeff_rows.restype = ctypes.c_int64
    lib.av1_pack_coeff_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.av1_strip_levels.restype = ctypes.c_int64
    lib.av1_strip_levels.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.av1_recon_frame.restype = ctypes.c_int
    lib.av1_recon_frame.argtypes = [
        ctypes.POINTER(_ReconParams), ctypes.POINTER(_TileOut),
        ctypes.POINTER(_FrameParams), ctypes.POINTER(_RefPlanes),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.av1_recon_frame_8.restype = ctypes.c_int
    lib.av1_recon_frame_8.argtypes = lib.av1_recon_frame.argtypes
    lib.av1_lf_grids_export.restype = ctypes.c_int
    lib.av1_lf_grids_export.argtypes = [
        ctypes.POINTER(_ReconParams), ctypes.POINTER(_TileOut),
        ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
    lib.av1_export_pred_units.restype = ctypes.c_int
    lib.av1_export_pred_units.argtypes = [
        ctypes.POINTER(_ReconParams), ctypes.POINTER(_TileOut),
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.av1_save_tmvs.restype = ctypes.c_int
    lib.av1_save_tmvs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.av1_project_mvfield.restype = ctypes.c_int
    lib.av1_project_mvfield.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.av1_pack8.restype = ctypes.c_int
    lib.av1_pack8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.av1_pack8_8.restype = ctypes.c_int
    lib.av1_pack8_8.argtypes = lib.av1_pack8.argtypes
    lib.av1_film_grain.restype = ctypes.c_int
    lib.av1_film_grain.argtypes = [
        ctypes.POINTER(_FgParams), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p * 3), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]
    lib.av1_fg_templates.restype = ctypes.c_int
    lib.av1_fg_templates.argtypes = [
        ctypes.POINTER(_FgParams), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.vorbis_create.restype = ctypes.c_void_p
    lib.vorbis_create.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.vorbis_destroy.restype = None
    lib.vorbis_destroy.argtypes = [ctypes.c_void_p]
    lib.vorbis_decode_packet.restype = ctypes.c_int
    lib.vorbis_decode_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vorbis_synth_block.restype = ctypes.c_long
    lib.vorbis_synth_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    lib.vorbis_synth_track.restype = ctypes.c_long
    lib.vorbis_synth_track.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vorbis_decode_pcm.restype = ctypes.c_long
    lib.vorbis_decode_pcm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
    lib.vorbis_synth_reset.restype = None
    lib.vorbis_synth_reset.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _qctx(base_q_idx: int) -> int:
    if base_q_idx <= 20:
        return 0
    if base_q_idx <= 60:
        return 1
    if base_q_idx <= 120:
        return 2
    return 3


def cdf_blob_size(lib) -> int:
    """sizeof(CdfState); asserted against the generated Python layout."""
    from easyav1_tpu_torch.native.cdf_layout import CDF_BLOB_BYTES
    n = lib.av1_cdf_blob_size()
    assert n == CDF_BLOB_BYTES, (n, CDF_BLOB_BYTES)
    return n



def _build_fp(hdr, seq, cdf_in: Optional[bytes], cdf_out, tpl):
    """FrameParams from the parsed headers (+ optional temporal-mv
    projection arrays and CDF chaining buffers).  Returns (fp, keep)
    where `keep` holds buffers that must outlive the C call."""
    fp = _FrameParams(
        frame_is_intra=int(hdr.frame_is_intra),
        reference_select=int(getattr(hdr, "reference_select", False)),
        skip_mode_present=int(getattr(hdr, "skip_mode_present", False)),
        skip_mode_frame0=getattr(hdr, "skip_mode_frames", [0, 0])[0],
        skip_mode_frame1=getattr(hdr, "skip_mode_frames", [0, 0])[1],
        allow_high_precision_mv=int(
            getattr(hdr, "allow_high_precision_mv", False)),
        force_integer_mv=int(getattr(hdr, "force_integer_mv", False)),
        interpolation_filter=getattr(hdr, "interpolation_filter", 0),
        enable_dual_filter=int(getattr(seq, "enable_dual_filter", False)),
        is_motion_mode_switchable=int(
            getattr(hdr, "is_motion_mode_switchable", False)),
        allow_warped_motion=int(
            getattr(hdr, "allow_warped_motion", False)),
        enable_interintra_compound=int(
            getattr(seq, "enable_interintra_compound", False)),
        enable_masked_compound=int(
            getattr(seq, "enable_masked_compound", False)),
        enable_jnt_comp=int(getattr(seq, "enable_jnt_comp", False)),
        enable_order_hint=int(getattr(seq, "enable_order_hint", False)),
        order_hint_bits=getattr(seq, "order_hint_bits", 0),
        order_hint=getattr(hdr, "order_hint", 0),
    )
    keep = []
    oh = getattr(hdr, "order_hints", None)
    if oh is not None:
        fp.order_hints[:len(oh[:8])] = [int(v) for v in oh[:8]]
    sb = getattr(hdr, "ref_frame_sign_bias", None)
    if sb is not None:
        fp.sign_bias[:len(sb[:8])] = [int(v) for v in sb[:8]]
    gm_t = getattr(hdr, "gm_type", [0] * 8)
    gm_p = getattr(hdr, "gm_params", [[0, 0, 1 << 16, 0, 0, 1 << 16]] * 8)
    gm_i = getattr(hdr, "gm_invalid", [False] * 8)
    # bulk-fill the gm block: nested ctypes indexing materialises a
    # fresh array object per [i] access (~22us/frame); flat one-shot
    # slice assignments keep it ~4us
    fp.gm_type[:] = [int(v) for v in gm_t[:8]]
    fp.gm_invalid[:] = [int(v) for v in gm_i[:8]]
    flat = [int(x) for row in gm_p[:8] for x in row]
    ctypes.cast(fp.gm_params,
                ctypes.POINTER(ctypes.c_int32 * 48)).contents[:] = flat
    rfi = getattr(hdr, "ref_frame_idx", [0] * 7)
    # indexed by ref frame 1..7
    fp.ref_frame_idx[1:1 + len(rfi[:7])] = [int(v) for v in rfi[:7]]
    lr = getattr(hdr, "lr", None)
    if lr is not None and getattr(lr, "uses_lr", False):
        fp.lr_uses = 1
        for i in range(3):
            fp.lr_frame_type[i] = int(lr.frame_restoration_type[i])
            fp.lr_unit_size[i] = int(lr.loop_restoration_size[i])
    fp.frame_width = hdr.upscaled_width
    fp.frame_height = hdr.frame_height
    fp.use_superres = int(getattr(hdr, "use_superres", False))
    fp.downscaled_width = hdr.frame_width
    fp.superres_denom = int(getattr(hdr, "superres_denom", 8))
    if tpl is not None:
        tpl_mv, tpl_off = tpl
        tpl_mv = np.ascontiguousarray(tpl_mv, np.int16)
        tpl_off = np.ascontiguousarray(tpl_off, np.int8)
        keep += [tpl_mv, tpl_off]
        fp.use_tpl = 1
        fp.h8, fp.w8 = tpl_off.shape
        fp.tpl_mv = _vp(tpl_mv)
        fp.tpl_off = _vp(tpl_off)
    if cdf_in is not None:
        buf = ctypes.create_string_buffer(cdf_in, len(cdf_in))
        keep.append(buf)
        fp.cdf_in = ctypes.cast(buf, ctypes.c_void_p)
    if cdf_out is not None:
        fp.cdf_out = ctypes.cast(cdf_out, ctypes.c_void_p)
    return fp, keep


def _run_tiles(lib, seq, hdr, tiles, cdf_in=None, want_cdf=False,
               tpl=None, fill_aux=False, threads=0, gen=0):
    """Run the C tile decoder over all tiles of a frame.

    Returns (TileOut, bufs, cdf_blob_or_None) or None when the frame
    uses syntax outside the C decoder's scope.  cdf_in: packed CdfState
    blob for inherited entropy state (spec load_cdfs); want_cdf: export
    the end-of-tile state of the context_update_tile_id tile.
    gen: buffer-pool generation — frame-parallel decode alternates 0/1
    so frame N+1's entropy never overwrites the arrays frame N's
    still-running recon reads."""
    mi_rows, mi_cols = hdr.mi_rows, hdr.mi_cols
    q = hdr.quant
    p = _TileParams(
        mi_rows=mi_rows, mi_cols=mi_cols,
        sb128=1 if seq.use_128x128_superblock else 0,
        bitdepth=seq.color.bitdepth, num_planes=seq.color.num_planes,
        ssx=seq.color.subsampling_x, ssy=seq.color.subsampling_y,
        base_q_idx=q.base_q_idx, dq_y_dc=q.delta_q_y_dc,
        dq_u_dc=q.delta_q_u_dc, dq_u_ac=q.delta_q_u_ac,
        dq_v_dc=q.delta_q_v_dc, dq_v_ac=q.delta_q_v_ac,
        tx_mode=hdr.tx_mode, reduced_tx_set=int(hdr.reduced_tx_set),
        coded_lossless=int(hdr.coded_lossless),
        allow_update_cdf=0 if hdr.disable_cdf_update else 1,
        enable_cdef=int(getattr(seq, "enable_cdef", False)),
        cdef_bits=hdr.cdef.bits if hdr.cdef else 0,
        enable_filter_intra=int(getattr(seq, "enable_filter_intra", False)),
        allow_intrabc=int(getattr(hdr, "allow_intrabc", False)),
        delta_q_present=int(hdr.delta_q_present),
        delta_q_res=hdr.delta_q_res,
        delta_lf_present=int(getattr(hdr, "delta_lf_present", False)),
        delta_lf_multi=int(getattr(hdr, "delta_lf_multi", False)),
        qctx=_qctx(q.base_q_idx),
        allow_screen=int(getattr(hdr, "allow_screen_content_tools",
                                 False)),
        fill_aux=int(fill_aux),
    )

    n_mi = mi_rows * mi_cols
    max_blocks = n_mi + 64
    max_txs = 3 * n_mi + 64
    max_lf = 3 * n_mi + 64
    coeffs_cap = 2 * n_mi * 16 + 4096
    # buffer pool keyed by mi dims — the C decoder overwrites every
    # consumed element, so reuse without re-zeroing (cdef grid and the
    # inter-state grids excepted)
    key = (mi_rows, mi_cols, gen)
    bufs = _BUF_POOL.get(key)
    if bufs is None:
        bufs = {
            "grids": {k: np.empty((mi_rows, mi_cols), np.int8)
                      for k in ("y_mode", "uv_mode", "angle_y", "angle_uv",
                                "skip", "bsize")},
            "blocks": np.empty((max_blocks, BLK_FIELDS), np.int32),
            "txs": np.empty((max_txs, 8), np.int32),
            "coeffs": np.empty(coeffs_cap, np.int32),
            "lf": np.empty((max_lf, 4), np.int32),
            "cdef": np.empty(((mi_rows + 15) // 16, (mi_cols + 15) // 16),
                             np.int8),
            "ref0": np.empty((mi_rows, mi_cols), np.int8),
            "ref1": np.empty((mi_rows, mi_cols), np.int8),
            "mvs": np.empty((mi_rows, mi_cols, 2, 2), np.int16),
            "interp": np.empty((mi_rows, mi_cols, 2), np.int8),
            "modes": np.empty((mi_rows, mi_cols), np.int16),
            "intrabc": np.empty((mi_rows, mi_cols), np.int8),
            # LR units: ceil over 64px min unit size per plane, 3 planes
            "lr": np.empty(((mi_rows * 4 // 64 + 2)
                            * (mi_cols * 4 // 64 + 2) * 3 + 64, 13),
                           np.int32),
            # palette: one unit per >=8x8 block; maps bounded by ~1.5x
            # the mi-aligned pixel area (y + subsampled uv)
            "pal": np.empty((n_mi // 4 + 64, 32), np.int32),
            "pal_maps": np.empty(2 * n_mi * 16 + 4096, np.int8),
        }
        _BUF_POOL[key] = bufs
    bufs["cdef"].fill(-1)
    # NOTE: ref0/ref1/mvs/interp/modes need no per-frame init: every
    # in-frame mi cell is overwritten by the per-block MI_FILL in
    # av1_decode_tile (blocks tile the frame), and all C readers
    # (refmvs above/left scans, OBMC, sub8x8 chroma, save_tmvs) only
    # touch cells of already-decoded blocks.  The fills cost ~8 MB of
    # memset per 4K frame (~1.2 ms).
    if getattr(hdr, "allow_intrabc", False):
        # filled/read only under allow_intrabc (screen-content intra)
        bufs["intrabc"].fill(0)
    grids = bufs["grids"]
    # inter/intrabc blocks skip the y/uv mode-grid fill in C (their
    # value is always DC_PRED == 0), so those two grids DO need a
    # per-frame zero here — a 2-plane memset is far cheaper than the
    # per-block row fills it replaces
    grids["y_mode"].fill(0)
    grids["uv_mode"].fill(0)

    out = bufs.get("out_struct")
    if out is None:
        out = _TileOut(
            y_mode=_vp(grids["y_mode"]), uv_mode=_vp(grids["uv_mode"]),
            angle_y=_vp(grids["angle_y"]), angle_uv=_vp(grids["angle_uv"]),
            skip=_vp(grids["skip"]), bsize=_vp(grids["bsize"]),
            blocks=_vp(bufs["blocks"]), max_blocks=max_blocks,
            txs=_vp(bufs["txs"]), max_txs=max_txs,
            coeffs=_vp(bufs["coeffs"]), coeffs_cap=coeffs_cap,
            lf_txs=_vp(bufs["lf"]), max_lf=max_lf,
            cdef_idx=_vp(bufs["cdef"]),
            ref0_g=_vp(bufs["ref0"]), ref1_g=_vp(bufs["ref1"]),
            mvs_g=_vp(bufs["mvs"]), interp_g=_vp(bufs["interp"]),
            modes_g=_vp(bufs["modes"]),
            intrabc_g=_vp(bufs["intrabc"]),
            lr_units=_vp(bufs["lr"]), max_lr_units=bufs["lr"].shape[0],
            pal_units=_vp(bufs["pal"]),
            max_pal_units=bufs["pal"].shape[0],
            pal_maps=_vp(bufs["pal_maps"]),
            pal_maps_cap=bufs["pal_maps"].shape[0])
        bufs["out_struct"] = out
    out.n_blocks = 0
    out.n_txs = 0
    out.coeffs_used = 0
    out.n_lf = 0
    out.error = 0
    out.n_lr_units = 0
    out.n_pal_units = 0
    out.pal_maps_used = 0

    sb_shift = 5 if seq.use_128x128_superblock else 4
    t = hdr.tile
    n_cols = t.cols
    n_tiles = t.cols * t.rows
    if len(tiles) != n_tiles:
        return None
    update_tid = t.context_update_tile_id
    cdf_out_buf = (ctypes.create_string_buffer(cdf_blob_size(lib))
                   if want_cdf else None)
    # one FrameParams for every tile: only cdf_out differs per tile
    # (each tile restarts from cdf_in; the C decoder never writes fp)
    fp, keep = _build_fp(hdr, seq, cdf_in, None, tpl)
    n_threads = tile_workers(hdr, threads)
    if n_threads > 1:
        # tile-parallel path (dav1d thread_task.c analog): workers pull
        # whole tiles; merge relocates append-buffer indices in C
        descs = (_TileDesc * n_tiles)()
        for tile_num, tdata in enumerate(tiles):
            tr, tc = tile_num // n_cols, tile_num % n_cols
            d = descs[tile_num]
            d.data = tdata
            d.size = len(tdata)
            d.col_start = min(t.col_starts[tc] << sb_shift, mi_cols)
            d.col_end = min(t.col_starts[tc + 1] << sb_shift, mi_cols)
            d.row_start = min(t.row_starts[tr] << sb_shift, mi_rows)
            d.row_end = min(t.row_starts[tr + 1] << sb_shift, mi_rows)
            d.cdf_out = (ctypes.cast(cdf_out_buf, ctypes.c_void_p)
                         if (want_cdf and tile_num == update_tid)
                         else None)
        fp.cdf_out = None
        rc = lib.av1_decode_tiles_mt(ctypes.byref(p), ctypes.byref(fp),
                                     descs, n_tiles, n_threads,
                                     ctypes.byref(out))
        if rc != 0:
            return None
    else:
        for tile_num, tdata in enumerate(tiles):
            tr, tc = tile_num // n_cols, tile_num % n_cols
            p.col_start = min(t.col_starts[tc] << sb_shift, mi_cols)
            p.col_end = min(t.col_starts[tc + 1] << sb_shift, mi_cols)
            p.row_start = min(t.row_starts[tr] << sb_shift, mi_rows)
            p.row_end = min(t.row_starts[tr + 1] << sb_shift, mi_rows)
            fp.cdf_out = (ctypes.cast(cdf_out_buf, ctypes.c_void_p)
                          if (want_cdf and tile_num == update_tid)
                          else None)
            rc = lib.av1_decode_tile(ctypes.byref(p), ctypes.byref(fp),
                                     tdata, len(tdata),
                                     ctypes.byref(out))
            if rc != 0:
                return None
    trace.count("entropy.tiles", n_tiles)
    trace.count("entropy.parallel", int(n_threads > 1))
    # hand fp back for the recon stage (cdf pointers cleared: their
    # backing buffers die with `keep`); keep rides along so the tpl
    # arrays fp still points at outlive the recon call
    fp.cdf_in = None
    fp.cdf_out = None
    blob = cdf_out_buf.raw if cdf_out_buf is not None else None
    return out, bufs, blob, (fp, keep)


_VP_CACHE: dict = {}


def _vp(a):
    """ctypes data pointer of a numpy array.  Pool buffers are reused
    across frames and ~70 conversions per frame cost ~1ms/frame in
    ctypes plumbing, so cache by id with weakref-identity validation
    (an alive array's data pointer never moves; a recycled id fails
    the `is` check and recomputes)."""
    key = id(a)
    ent = _VP_CACHE.get(key)
    if ent is not None and ent[0]() is a:
        return ent[1]
    # NOT data_as(): that attaches a strong array reference to the
    # returned pointer, which would pin pooled planes through this
    # cache and kill the refcount-gated buffer rotation.  The weakref
    # identity check above is what keeps the cached pointer valid.
    p = ctypes.c_void_p(a.ctypes.data)
    _VP_CACHE[key] = (weakref.ref(a), p)
    if len(_VP_CACHE) > 4096:
        _VP_CACHE.clear()
    return p


_BUF_POOL: dict = {}

_LIBC = ctypes.CDLL(None, use_errno=True)
_MADV_HUGEPAGE = 14
_HUGE = 2 << 20


def _alloc_huge(shape, dtype):
    """np.empty with the backing range 2MB-aligned and madvised
    MADV_HUGEPAGE: frame-sized planes in 4 KB pages thrash the STLB at
    4K (the MC copy walks a new page every row); THP cuts the page
    count 512x.  Harmless no-op where THP is unavailable."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    raw = np.empty(nbytes + _HUGE, np.uint8)
    addr = raw.ctypes.data
    off = (-addr) % _HUGE
    try:
        _LIBC.madvise(ctypes.c_void_p(addr + off),
                      ctypes.c_size_t(nbytes), _MADV_HUGEPAGE)
    except Exception:
        pass
    return raw[off:off + nbytes].view(dtype).reshape(shape)


def _build_rp(seq, hdr):
    cdef = hdr.cdef

    def pad8(v):
        a = (ctypes.c_int32 * 8)()
        for i in range(min(8, len(v))):
            a[i] = v[i]
        return a

    def starts_mi(starts_sb, mi_max):
        # tile starts, sb -> mi units, clamped to the frame
        sbl = 5 if seq.use_128x128_superblock else 4
        a = (ctypes.c_int32 * 65)()
        for i, s in enumerate(starts_sb[:65]):
            a[i] = min(s << sbl, mi_max)
        return a

    return _ReconParams(
        bitdepth=seq.color.bitdepth, num_planes=seq.color.num_planes,
        ssx=seq.color.subsampling_x, ssy=seq.color.subsampling_y,
        mi_rows=hdr.mi_rows, mi_cols=hdr.mi_cols,
        enable_intra_edge_filter=int(
            getattr(seq, "enable_intra_edge_filter", False)),
        lf_level=(ctypes.c_int32 * 4)(*hdr.lf.level),
        lf_sharpness=hdr.lf.sharpness,
        lf_delta_enabled=int(hdr.lf.delta_enabled),
        lf_ref_deltas=(ctypes.c_int32 * 8)(*hdr.lf.ref_deltas),
        lf_mode_deltas=(ctypes.c_int32 * 2)(*hdr.lf.mode_deltas),
        enable_cdef=int(getattr(seq, "enable_cdef", False)),
        cdef_damping=cdef.damping if cdef else 3,
        cdef_y_pri=pad8(cdef.y_pri_strength if cdef else []),
        cdef_y_sec=pad8(cdef.y_sec_strength if cdef else []),
        cdef_uv_pri=pad8(cdef.uv_pri_strength if cdef else []),
        cdef_uv_sec=pad8(cdef.uv_sec_strength if cdef else []),
        coded_lossless=int(hdr.coded_lossless),
        allow_intrabc=int(getattr(hdr, "allow_intrabc", False)),
        frame_width=hdr.upscaled_width,
        frame_height=hdr.frame_height,
        tile_cols=hdr.tile.cols, tile_rows=hdr.tile.rows,
        tile_col_starts=starts_mi(hdr.tile.col_starts, hdr.mi_cols),
        tile_row_starts=starts_mi(hdr.tile.row_starts, hdr.mi_rows),
    )


def decode_and_recon_native(seq, hdr, tiles: List[bytes], cdf_in=None,
                            want_cdf=False, tpl=None, refs=None,
                            threads=0):
    """Full native frame path: tile decode + recon + loop filter + CDEF
    in C.  Returns (cropped planes, cdf_blob_or_None, mv_grids, ref
    triples), or None if the C decoder declines the frame.  mv_grids =
    (ref0, ref1, mvs) per-4x4 grids for the backend's temporal-mv
    storage (save_tmvs), None on intra frames.  refs: per-slot triples
    of (pel plane, logical w, logical h) in the bitdepth's pel dtype;
    each plane may be an mi-aligned recon buffer wider than w (the C MC
    reads with an explicit row stride).  The reference's
    `decode_and_recon_native` with want_u16=True on its native pipe."""
    lib = _load()
    # 8bpc streams reconstruct in uint8 planes (av1_recon8.c: half the
    # pixel memory traffic); 10/12bpc use the 16-bit build
    pel8 = seq.color.bitdepth == 8
    pel_dt = np.uint8 if pel8 else np.uint16
    rfl = _RefPlanes()
    keep_refs = []
    if not hdr.frame_is_intra:
        if refs is None:
            return None
        for slot in set(hdr.ref_frame_idx):
            if refs[slot] is None:
                return None
        for slot in range(8):
            pls = refs[slot]
            if pls is None:
                continue
            for pi, (arr, lw, lh) in enumerate(pls):
                if arr.dtype != pel_dt or not arr.flags.c_contiguous:
                    arr = np.ascontiguousarray(arr, pel_dt)
                keep_refs.append(arr)
                rfl.plane[slot][pi] = _vp(arr).value
                rfl.w[slot][pi] = lw
                rfl.h[slot][pi] = lh
                rfl.stride[slot][pi] = arr.shape[1]
    res = _run_tiles(lib, seq, hdr, tiles, cdf_in=cdf_in,
                     want_cdf=want_cdf, tpl=tpl, threads=threads)
    if res is None:
        return None
    out, bufs, blob, (fp_rc, keep_fp) = res
    rp = _build_rp(seq, hdr)

    mv_grids = None
    if not hdr.frame_is_intra:
        # no copy: the backend's save_tmvs consumes these within the
        # same frame, before the next _run_tiles reuses the buffers
        mv_grids = (bufs["ref0"], bufs["ref1"], bufs["mvs"])
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    aw, ah = hdr.mi_cols * 4, hdr.mi_rows * 4
    # superres frames land at the upscaled width (C upscales between
    # CDEF and LR); buffers must fit both the coded and upscaled dims
    aw_y = max(aw, hdr.upscaled_width)
    aw_c = max(aw >> ssx, (hdr.upscaled_width + ssx) >> ssx)
    pkey = ("planes", ah, aw_y, aw_c, ssy, int(pel8))

    def _plane(h_, w_):
        return _alloc_huge((h_, w_), pel_dt)
    if pel8:
        # Zero-copy refs: the uint8 recon target itself is handed to
        # the ref slots (the C MC reads with an explicit row stride and
        # clamps to the logical w/h, so the mi-aligned overhang is never
        # read).  A small rotation of plane sets is kept; a set is
        # reusable once nothing outside the pool references it.
        pool = _BUF_POOL.setdefault(pkey + ("rot",), [])
        pl = None
        for cand in pool:
            # refs on the plane array: pool tuple + genexp binding +
            # getrefcount arg.  ALSO gate on the backing allocation
            # (a.base): a consumer-held display view `src[:h,:w]` pins
            # a.base, NOT a
            if all(sys.getrefcount(a) == 3
                   and sys.getrefcount(a.base) == 2 for a in cand):
                pl = cand
                break
        if pl is None:
            pl = (_plane(ah, aw_y),
                  _plane(ah >> ssy, aw_c),
                  _plane(ah >> ssy, aw_c))
            pool.append(pl)
    else:
        pl = _BUF_POOL.get(pkey)
        if pl is None:
            pl = (_plane(ah, aw_y),
                  _plane(ah >> ssy, aw_c),
                  _plane(ah >> ssy, aw_c))
            _BUF_POOL[pkey] = pl
    py, pu, pv = pl
    recon_fn = lib.av1_recon_frame_8 if pel8 else lib.av1_recon_frame
    rc = recon_fn(ctypes.byref(rp), ctypes.byref(out),
                  ctypes.byref(fp_rc), ctypes.byref(rfl),
                  _vp(py), _vp(pu), _vp(pv))
    del keep_fp, keep_refs
    if rc != 0:
        return None
    n_pl = seq.color.num_planes
    w, h = hdr.upscaled_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    if pel8:
        # u8 recon planes ARE the display planes: strided views (rows
        # are contiguous, row pitch = mi-aligned width), no pack copy
        planes = []
        ref_triples = []
        for src, (pw_, ph_) in zip((py, pu, pv)[:n_pl],
                                   ((w, h), (cw, ch), (cw, ch))):
            planes.append(src[:ph_, :pw_])
            ref_triples.append((src, pw_, ph_))
        return planes, blob, mv_grids, ref_triples
    planes = [py[:h, :w].astype(np.uint16)]
    if n_pl > 1:
        planes.append(pu[:ch, :cw].astype(np.uint16))
        planes.append(pv[:ch, :cw].astype(np.uint16))
    ref_triples = [(np.ascontiguousarray(p, pel_dt), p.shape[1],
                    p.shape[0]) for p in planes]
    return planes, blob, mv_grids, ref_triples


def _grids_exporter(lib, rp, out):
    """grids_for(plane, shape) closure over the C decoder's exported
    per-4x4-cell loop-filter grids."""
    def grids_for(plane, shape):
        h, w = shape
        gw, gh = (w + 3) >> 2, (h + 3) >> 2
        a = [np.empty((gh, gw), np.uint8) for _ in range(7)]
        rc = lib.av1_lf_grids_export(
            ctypes.byref(rp), ctypes.byref(out), plane, w, h,
            _vp(a[0]), _vp(a[1]), _vp(a[2]), _vp(a[3]), _vp(a[4]),
            _vp(a[5]), _vp(a[6]))
        if rc != 0:
            raise RuntimeError("lf grids export failed")
        return {"txw": a[0].astype(np.int32), "txh": a[1].astype(np.int32),
                "skip": a[2].astype(np.int32),
                "edge_left": a[3].astype(bool),
                "edge_top": a[4].astype(bool),
                "lvl0": a[5].astype(np.int32),
                "lvl1": a[6].astype(np.int32), "gw": gw, "gh": gh}
    return grids_for


def _max_pred_units(out, hdr):
    """Upper bound on exported pred-unit records: n_lf counts coded
    (non-skip) txs, but skip blocks export units too (one per tx
    tile), so bound by the 4x4 grid: <= mi_rows*mi_cols luma +
    2*mi_rows*mi_cols chroma (4:4:4 worst case) + interintra extras."""
    return max(int(out.n_lf) * 2,
               3 * int(hdr.mi_rows) * int(hdr.mi_cols)) + 256


def _export_literals(lib, rp, out):
    """Palette-prediction patches for the device pipes: (recs[N,6],
    pix int32) or None when the frame has no palette blocks."""
    if out.n_pal_units <= 0:
        return None
    # worst case: a 64x64 palette block tiled by 4x4 txs = 256 luma +
    # 2*64 chroma records
    max_recs = int(out.n_pal_units) * 512 + 64
    max_pix = int(out.pal_maps_used) * 4 + 4096
    recs = np.empty((max_recs, 6), np.int32)
    pix = np.empty(max_pix, np.int32)
    n_recs = ctypes.c_int64(0)
    pix_used = ctypes.c_int64(0)
    rc = lib.av1_export_literal_preds(
        ctypes.byref(rp), ctypes.byref(out), _vp(recs),
        ctypes.c_int64(max_recs), ctypes.byref(n_recs), _vp(pix),
        ctypes.c_int64(max_pix), ctypes.byref(pix_used))
    if rc != 0:
        raise RuntimeError("literal pred export overflow")
    return recs[:n_recs.value], pix[:pix_used.value]
