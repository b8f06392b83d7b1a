"""The port's deblocking + CDEF against the JAX package's, exactly.

Both run on the same raw C recon planes (LF and CDEF off) with the same
host maps from the C decoder's export.  The fixtures are those of
test_lf_jax.py and test_cdef_jax.py, plus the odd-size CDEF stream of
test_av1_real.py.  Where the 8x8 CDEF unit grid overhangs a plane, the
JAX package searches directions on the host and the port on the device
in int64; no stream gives that case (MiRows and MiCols are even), so
test_cdef_overhang_vs_host_search makes it by cropping a plane.
"""

import ctypes

import numpy as np
import pytest
import torch

import easyav1_tpu.native as nat
from easyav1_tpu.video.av1.recon import cdef_jax
from easyav1_tpu.video.av1.recon.postfilter_fused import \
    postfilter_frame as postfilter_jax
from easyav1_tpu_torch import convert
from easyav1_tpu_torch.video.av1.recon import cdef_torch
from easyav1_tpu_torch.video.av1.recon.postfilter import postfilter_frame

from test_av1_real import NEAR_DEFAULT, real_fixture
from test_torch_fixtures import steady
from test_torch_intra import _assert_equal, _first_keyframe

ODD_CDEF = ("vopt:enable-restoration=0", "vopt:enable-palette=0",
            "vopt:enable-filter-intra=0", "vopt:enable-cdef=1")


def _raw_frame(tag, w, h, crf, extra, frames=1):
    """C entropy + raw C recon of the first frame, and its host maps."""
    path, _ = steady(real_fixture, tag, w, h, crf, frames, extra)
    lib, seq, hdr, tiles = _first_keyframe(path)
    out, bufs, _blob, (fp_rc, _keep) = nat._run_tiles(lib, seq, hdr, tiles)
    rp = nat._build_rp(seq, hdr)
    saved = tuple(rp.lf_level), rp.enable_cdef
    rp.lf_level = (ctypes.c_int32 * 4)(0, 0, 0, 0)
    rp.enable_cdef = 0
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    ah, aw = hdr.mi_rows * 4, hdr.mi_cols * 4
    raw = [np.empty((ah, aw), np.uint16),
           np.empty((ah >> ssy, aw >> ssx), np.uint16),
           np.empty((ah >> ssy, aw >> ssx), np.uint16)]
    assert lib.av1_recon_frame(ctypes.byref(rp), ctypes.byref(out),
                               ctypes.byref(fp_rc),
                               ctypes.byref(nat._RefPlanes()),
                               *(nat._vp(r) for r in raw)) == 0
    rp.lf_level = (ctypes.c_int32 * 4)(*saved[0])
    rp.enable_cdef = saved[1]
    maps = (nat._grids_exporter(lib, rp, out), bufs["grids"]["skip"].copy(),
            bufs["cdef"].copy())
    return seq, hdr, [r.astype(np.int32) for r in raw], maps


@pytest.mark.parametrize("tag,w,h,crf,extra", [
    ("neardflt", 96, 96, 30, tuple(NEAR_DEFAULT)),
    ("neardflt0", 96, 96, 20, tuple(NEAR_DEFAULT + ["content=0"])),
    ("neardflt_qcif", 176, 144, 35, tuple(NEAR_DEFAULT + ["content=0"])),
    ("64hiq", 64, 64, 10, ()),
    ("odd", 66, 50, 30, ()),
    ("oddcdef", 84, 52, 30, ODD_CDEF),
])
def test_postfilter_vs_jax(tag, w, h, crf, extra):
    frames = 2 if tag == "oddcdef" else 1
    seq, hdr, raw, (grids_for, skip, cdef_idx) = _raw_frame(
        tag, w, h, crf, extra, frames)
    want = postfilter_jax([r.copy() for r in raw], hdr, seq, grids_for,
                          skip, cdef_idx)
    got = postfilter_frame([torch.from_numpy(r.copy()) for r in raw], hdr,
                           seq, grids_for, skip, cdef_idx)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.numpy(), np.asarray(b), f"{tag} plane {p}")


def test_cdef_overhang_vs_host_search():
    """The 9x7 unit grid over the odd fixture's luma cropped to 68x52:
    the port's int64 device search against the JAX package's host
    search (CDEF_VERY_LARGE enters the partial sums), then the filter of
    every plane at random strengths against `cdef_jax._filter_body`."""
    _seq, _hdr, raw, _ = _raw_frame("odd", 66, 50, 30, ())
    raw = [np.ascontiguousarray(raw[0][:52, :68])] + \
        [np.ascontiguousarray(r[:26, :34]) for r in raw[1:]]
    uh, uw = 7, 9
    lpad = np.full((uh * 8 + 4, uw * 8 + 4), cdef_jax.CDEF_VERY_LARGE,
                   np.int32)
    lpad[2:2 + raw[0].shape[0], 2:2 + raw[0].shape[1]] = raw[0]
    d_want, v_want = cdef_jax.find_dirs_host(
        np.asarray(cdef_jax._make_partial_kernel(uh, uw, 0)(lpad)))
    tabs = convert.tables(torch.device("cpu"))
    d_got, v_got = cdef_torch.find_dirs(torch.from_numpy(raw[0]), uh, uw, 0,
                                        tabs)
    _assert_equal(d_got.numpy(), d_want, "dir")
    _assert_equal(v_got.numpy(), v_want, "var")

    rng = np.random.default_rng(7)
    pri = rng.integers(0, 16, (uh, uw)).astype(np.int32)
    sec = np.array([0, 1, 2, 4])[rng.integers(0, 4, (uh, uw))].astype(
        np.int32)
    filt = rng.integers(0, 2, (uh, uw)).astype(np.int32)
    damping = 5
    for p, plane in enumerate(raw):
        want = cdef_jax._make_kernel(plane.shape[0], plane.shape[1], 1, 1, p,
                                     8, damping)(plane, d_want, v_want, pri,
                                                 sec, filt)
        t = convert.from_reference({"plane": plane, "dir": d_want,
                                    "var": v_want, "pri": pri, "sec": sec,
                                    "filt": filt}, "cpu")
        got = cdef_torch.filter_plane(t["plane"], t["dir"], t["var"],
                                      t["pri"], t["sec"], t["filt"], 1, 1, p,
                                      8, damping, tabs)
        _assert_equal(got.numpy(), np.asarray(want), f"plane {p}")
