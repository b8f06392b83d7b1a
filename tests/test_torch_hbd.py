"""10- and 12-bit frames through the port, on the CPU, tolerance 0.

- The plain MC of every unit kind (kernels 6a and 6b's plain versions)
  at 10 bits, on uint16 references, against `mc_jax`'s jit functions;
- the strip kernel's plain version at 10 and 12 bits against the Pallas
  kernel in interpret mode, as tests/test_intra_pallas.py runs it;
- deblocking and CDEF at 10 and 12 bits against
  `postfilter_fused.postfilter_frame`, and the CDEF filter at both
  depths against `cdef_jax`'s, CDEF_VERY_LARGE at the edges included;
- the plain frame hash on uint16 planes against
  `resident.frame_hash_host`;
- the film grain scaling at 12 bits against fg_ref with the spec's
  `scale_lut` and against the port's C grain;
- the residual narrowing that lets 12-bit frames run;
- the whole slice on the committed high-bit-depth streams through
  `EasyAV1(device="cpu")`, equal to `api.native_session` and to dav1d,
  with no fallback, and through `decode_resident`.

At 12 bits the reference rounds MC as at 8 bits (`mc_jax`, its C
decoder), which differs from dav1d; the port rounds as the spec does, so
12-bit MC is held against dav1d through hbd_12p.webm.  The card-only
tests of the uint16 kernels are in test_torch_inter.py and
test_torch_resident.py, whose modules the card's machine can import.
"""

import ctypes
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import easyav1_tpu.native as ref_nat
import easyav1_tpu_torch
from easyav1_tpu.video.av1.recon import cdef_jax
from easyav1_tpu.video.av1.recon import jax_exec as JX
from easyav1_tpu.video.av1.recon import mc_jax as MJ
from easyav1_tpu.video.av1.recon import resident as ref_resident
from easyav1_tpu.video.av1.recon.mc_jax import PAD
from easyav1_tpu.video.av1.recon.postfilter_fused import \
    postfilter_frame as postfilter_jax
from easyav1_tpu_torch import convert
from easyav1_tpu_torch.api import frame_hash, native_session
from easyav1_tpu_torch.native import film_grain_native
from easyav1_tpu_torch.unit_programs import (MI_COLS, MI_ROWS,
                                             random_mc_program,
                                             random_program)
from easyav1_tpu_torch.video.av1.recon import (cdef_torch, fg_plain,
                                               fg_torch, inter_mc, resident)
from easyav1_tpu_torch.video.av1.recon.intra_strip import strip_exec_plain
from easyav1_tpu_torch.video.av1.recon.postfilter import postfilter_frame
from easyav1_tpu_torch.video.av1.recon.records import narrow_residual

from test_fg_jax import _params
from test_torch_fg import _fg_ref_spec
from test_torch_fixtures import SMOKE, smoke_oracle
from test_torch_intra import _first_keyframe

# the committed streams: (name, frames shown)
STREAMS = [("hbd_10i.webm", 4), ("hbd_10p.webm", 4), ("hbd_10pf.webm", 4),
           ("hbd_12i.webm", 4), ("hbd_12p.webm", 8), ("hbd_444x10.webm", 4),
           ("hbd_10fg.webm", 3), ("hbd_12fg.webm", 3)]


@pytest.fixture
def synchronous_native(monkeypatch):
    # the reference's frame-parallel branch is not a steady yardstick
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)


def _assert_equal(got, want, what):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert d.max() == 0, (f"{what}: maxdiff {d.max()} at "
                          f"{np.argwhere(d > 0)[:4].tolist()}")


# ------------------------------------------------ plain MC against JAX

MC_KINDS = ("singles", "pairs", "warps", "obmc_above", "obmc_left",
            "obmc_resid")


def _largest(plan, name):
    """The largest luma bucket of a kind (the warps' luma table)."""
    if name == "warps":
        return 0
    keys = [k for k in plan[name] if k[0] == 0]
    return max(keys, key=lambda k: plan[name][k].shape[0])


@pytest.mark.parametrize("name", MC_KINDS)
def test_plain_mc_vs_jax_10bit(name):
    """One luma bucket of each kind of a 10-bit random MC program
    (uint16 references) through the plain version and the JAX jit
    function, on the same plane, residual and references."""
    import jax.numpy as jnp

    bd = 10
    prog = random_mc_program(14, bd=bd)
    assert prog["refs"][0][0].dtype == np.uint16
    plan = prog["plan"]
    key = _largest(plan, name)
    units = plan[name][key]
    n = units.shape[0]
    assert n > 0
    rng = np.random.default_rng(5)
    ph, pw = prog["dims"][0]
    base = rng.integers(0, 1 << bd, (ph, pw)).astype(np.int32)
    resid = prog["resid"][0]
    refs = np.stack(prog["refs"][0])
    ns, rh, rw = refs.shape
    php, pwp = JX.pad_dims(ph, pw, 64)
    jplane = np.zeros((php, pwp), np.int32)
    jplane[PAD:PAD + ph, PAD:PAD + pw] = base
    jres = np.zeros((php, pwp), np.int32)
    jres[PAD:PAD + ph, PAD:PAD + pw] = resid
    jrefs = jnp.asarray(refs.astype(np.int32))
    plane = torch.from_numpy(base.copy())
    tres = torch.from_numpy(resid)
    trefs = torch.from_numpy(refs)
    tu = torch.from_numpy(units)
    tabs = convert.reference_tables()
    if name == "singles":
        _, w, h = key
        want = MJ._mc_single_kernel(php, pwp, rh, rw, ns, w, h, n, bd)(
            jnp.asarray(jplane), jnp.asarray(jres), jrefs, jnp.asarray(units))
        inter_mc.mc_single(plane, tres, trefs, tu, w, h, bd)
    elif name == "pairs":
        _, w, h = key
        masks = plan["pair_masks"].get(key, np.zeros((1, h, w), np.int32))
        want = MJ._mc_pair_kernel(php, pwp, rh, rw, ns, w, h, n,
                                  masks.shape[0], bd)(
            jnp.asarray(jplane), jnp.asarray(jres), jrefs,
            jnp.asarray(units), jnp.asarray(masks))
        inter_mc.mc_pair(plane, tres, trefs, tu, torch.from_numpy(masks),
                         w, h, bd)
    elif name == "warps":
        want = MJ._mc_warp_kernel(php, pwp, rh, rw, ns, n, bd)(
            jnp.asarray(jplane), jnp.asarray(jres), jrefs,
            jnp.asarray(units))
        inter_mc.mc_warp(plane, tres, trefs, tu,
                         torch.from_numpy(tabs["warped_filter"]), bd)
    elif name in ("obmc_above", "obmc_left"):
        _, w, h = key
        left = name == "obmc_left"
        want = MJ._obmc_overlay_kernel(php, pwp, rh, rw, ns, w, h, n, bd,
                                       left)(
            jnp.asarray(jplane), jrefs, jnp.asarray(units))
        inter_mc.obmc_overlay(plane, trefs, tu, w, h, bd, left,
                              torch.from_numpy(tabs["obmc_masks"]))
    else:
        _, w, h = key
        fpad = np.ones((n, 3), np.int32)
        fpad[:, :2] = units
        want = MJ._obmc_resid_kernel(php, pwp, w, h, n, bd)(
            jnp.asarray(jplane), jnp.asarray(jres), jnp.asarray(fpad))
        inter_mc.obmc_resid(plane, tres, tu, w, h, bd)
    want = np.asarray(want)[PAD:PAD + ph, PAD:PAD + pw]
    assert not np.array_equal(want, base), "the units wrote nothing"
    assert want.max() > 255
    _assert_equal(plane.numpy(), want, name)


def test_refs_of_the_wrong_type_are_refused():
    prog = random_mc_program(12, bd=10)
    planes = [torch.zeros(d, dtype=torch.int32) for d in prog["dims"]]
    resid = [torch.from_numpy(r) for r in prog["resid"]]
    refs = [[torch.from_numpy(r) for r in rs] for rs in prog["refs"]]
    inter_mc._frame_args(planes, resid, refs, 10)
    with pytest.raises(ValueError, match="uint8"):
        inter_mc._frame_args(planes, resid, refs, 8)
    with pytest.raises(ValueError, match="bit depth"):
        inter_mc._frame_args(planes, resid, refs, 9)


# ----------------------------------------- the strip kernel against Pallas

@pytest.mark.parametrize("bd,seed", [(10, 301), (10, 305), (12, 304),
                                     (12, 317)])
def test_strip_plain_vs_pallas_interpret(bd, seed):
    import jax.numpy as jnp
    from easyav1_tpu.video.av1.recon import intra_pallas as IP

    prog = random_program(seed, bd=bd)
    plane = prog["plane"]
    pr = JX.PallasRecon(MI_ROWS, MI_COLS, 1, 1, bd, 3, interpret=True)
    fields = JX.preprocess_units(prog["units"], pr.dims, pad=0)
    hp, wp, ns = pr.layouts[plane]
    ph, pw = pr.dims[plane]
    rp = np.zeros((hp, wp), np.int32)
    rp[:ph, IP.LPAD:IP.LPAD + pw] = prog["resid"][plane]
    u3, cnt, umax = pr._strip_fields(fields[plane], plane)
    args = [jnp.asarray(u3), jnp.asarray(cnt), jnp.asarray(rp)]
    wp0 = 0
    if plane:
        hp0, wp0, _ = pr.layouts[0]
        lum = np.zeros((hp0, wp0), np.int32)
        lum[:pr.dims[0][0], IP.LPAD:IP.LPAD + pr.dims[0][1]] = prog["luma"]
        args.append(jnp.asarray(lum))
    k = IP.make_strip_kernel(pr.strips[plane], wp, ns, umax, bd, plane > 0,
                             wp0, True)
    want = np.asarray(k(*args))[:ph, IP.LPAD:IP.LPAD + pw]
    luma = torch.from_numpy(prog["luma"]) if plane else None
    got = strip_exec_plain(torch.from_numpy(fields[plane]),
                           torch.from_numpy(prog["resid"][plane]),
                           prog["dims"][plane], bd, luma)
    assert want.max() > 255
    _assert_equal(got.numpy(), want, f"plane {plane}")


# ------------------------------------------------- deblocking and CDEF

def _raw_first_frame(name):
    """C entropy + raw C recon (LF and CDEF off) of a committed stream's
    first frame, and its host maps."""
    lib, seq, hdr, tiles = _first_keyframe(os.path.join(SMOKE, name))
    out, bufs, _blob, (fp_rc, _keep) = ref_nat._run_tiles(lib, seq, hdr,
                                                          tiles)
    rp = ref_nat._build_rp(seq, hdr)
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
                               ctypes.byref(ref_nat._RefPlanes()),
                               *(ref_nat._vp(r) for r in raw)) == 0
    rp.lf_level = (ctypes.c_int32 * 4)(*saved[0])
    rp.enable_cdef = saved[1]
    maps = (ref_nat._grids_exporter(lib, rp, out),
            bufs["grids"]["skip"].copy(), bufs["cdef"].copy())
    return seq, hdr, [r.astype(np.int32) for r in raw], maps


@pytest.mark.parametrize("name,bd", [("hbd_10pf.webm", 10),
                                     ("hbd_12i.webm", 12)])
def test_postfilter_vs_jax(name, bd):
    seq, hdr, raw, (grids_for, skip, cdef_idx) = _raw_first_frame(name)
    assert seq.color.bitdepth == bd
    want = postfilter_jax([r.copy() for r in raw], hdr, seq, grids_for,
                          skip, cdef_idx)
    got = postfilter_frame([torch.from_numpy(r.copy()) for r in raw], hdr,
                           seq, grids_for, skip, cdef_idx)
    changed = 0
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.numpy(), np.asarray(b), f"{name} plane {p}")
        changed += int((a.numpy() != raw[p]).sum())
    assert changed > 0, "the filters changed nothing"


@pytest.mark.parametrize("bd", [10, 12])
def test_cdef_filter_vs_jax(bd):
    """Random strengths over every plane of a random bd-bit frame whose
    8x8 grid ends at the plane's edge, where the taps read
    CDEF_VERY_LARGE."""
    rng = np.random.default_rng(bd)
    uh, uw = 5, 7
    raw = [rng.integers(0, 1 << bd, (uh * 8, uw * 8)).astype(np.int32)] + \
        [rng.integers(0, 1 << bd, (uh * 4, uw * 4)).astype(np.int32)
         for _ in range(2)]
    tabs = convert.tables(torch.device("cpu"))
    lpad = np.full((uh * 8 + 4, uw * 8 + 4), cdef_jax.CDEF_VERY_LARGE,
                   np.int32)
    lpad[2:2 + uh * 8, 2:2 + uw * 8] = raw[0]
    d_want, v_want = cdef_jax.find_dirs_host(
        np.asarray(cdef_jax._make_partial_kernel(uh, uw, bd - 8)(lpad)))
    d_got, v_got = cdef_torch.find_dirs(torch.from_numpy(raw[0]), uh, uw,
                                        bd - 8, tabs)
    _assert_equal(d_got.numpy(), d_want, "dir")
    _assert_equal(v_got.numpy(), v_want, "var")
    pri = rng.integers(0, 16, (uh, uw)).astype(np.int32)
    sec = np.array([0, 1, 2, 4])[rng.integers(0, 4, (uh, uw))].astype(
        np.int32)
    filt = np.ones((uh, uw), np.int32)
    for p, plane in enumerate(raw):
        sub = 1 if p else 0
        want = cdef_jax._make_kernel(plane.shape[0], plane.shape[1], sub,
                                     sub, p, bd, 6)(plane, d_want, v_want,
                                                    pri, sec, filt)
        t = convert.from_reference({"plane": plane, "dir": d_want,
                                    "var": v_want, "pri": pri, "sec": sec,
                                    "filt": filt}, "cpu")
        got = cdef_torch.filter_plane(t["plane"], t["dir"], t["var"],
                                      t["pri"], t["sec"], t["filt"], sub,
                                      sub, p, bd, 6, tabs)
        _assert_equal(got.numpy(), np.asarray(want), f"plane {p}")
        assert not np.array_equal(got.numpy(), plane)


# ---------------------------------------------------- hash, grain, resid

@pytest.mark.parametrize("dims", [[(66, 97), (33, 49), (33, 49)],
                                  [(2160 // 8, 3840 // 8)], [(1, 1)]])
def test_hash_plain_on_uint16_vs_reference(dims):
    rng = np.random.default_rng(len(dims))
    host = [rng.integers(0, 4096, d).astype(np.uint16) for d in dims]
    got = resident.hash_value(resident.frame_hash_plain(
        [torch.from_numpy(p) for p in host]))
    assert got == ref_resident.frame_hash_host(host) == frame_hash(host)
    views = [p[1:, 1:] for p in host if p.shape[0] > 1]
    if views:
        assert resident.hash_value(resident.frame_hash_plain(
            [torch.from_numpy(v) for v in views])) == frame_hash(views)


def test_grain_scaling_at_12_bits_vs_the_c_grain():
    fg = _params()
    fg.num_y_points = 3
    fg.point_y_value, fg.point_y_scaling = [0, 90, 255], [20, 200, 40]
    bd = 12
    rng = np.random.default_rng(12)
    planes = [rng.integers(0, 1 << bd, (66, 97)).astype(np.uint16)] + \
        [rng.integers(0, 1 << bd, (33, 49)).astype(np.uint16)
         for _ in range(2)]
    seq = SimpleNamespace(color=SimpleNamespace(
        bitdepth=bd, subsampling_x=1, subsampling_y=1, mono_chrome=False))
    want = film_grain_native(fg, seq, [p.copy() for p in planes])
    spec = _fg_ref_spec().FilmGrain(fg, seq, bd).apply(planes)
    got = fg_torch.FilmGrain(fg, seq, bd, "cpu").apply(
        [torch.from_numpy(p.astype(np.int32)) for p in planes])
    for p in range(3):
        _assert_equal(got[p].numpy(), want[p], f"plane {p}")
        _assert_equal(got[p].numpy(), spec[p], f"plane {p} vs fg_ref spec")
    lut = torch.tensor(fg_plain.scaling_lut(fg.point_y_value,
                                            fg.point_y_scaling, bd))
    v = torch.arange(1 << bd)
    s = fg_plain.scale_lut(lut, v, bd)
    assert torch.equal(s[::16], lut[:256]) and int(s[-1]) == int(lut[255])


def test_narrow_residual():
    small = [np.array([[-32768, 32767]], np.int32)]
    got = narrow_residual(small)
    assert got[0].dtype == np.int16 and got[0].tolist() == [[-32768, 32767]]
    assert narrow_residual([np.array([[32768]], np.int32)]) is None
    i16 = [np.zeros((2, 2), np.int16)]
    assert narrow_residual(i16) is i16


# ------------------------------------------------------- the whole slice

def _frames(make):
    av = make()
    out = []
    try:
        for _ in range(64):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                out.append([np.array(p, copy=True)
                            for p in av.get_video_frame().data])
        assert av.is_finished() and not av.get_status().is_error
    finally:
        av.close()
    return out


def _dav1d(name, n):
    prefix = smoke_oracle(name)
    meta = json.loads(prefix.with_suffix(".json").read_text())
    w, h = meta["width"], meta["height"]
    cw = (w + (1 << meta["ss_x"]) - 1) >> meta["ss_x"]
    ch = (h + (1 << meta["ss_y"]) - 1) >> meta["ss_y"]
    raw = np.fromfile(prefix.with_suffix(".yuv"), np.uint16)
    per = w * h + 2 * cw * ch
    assert meta["vframes"] == n and raw.size == n * per
    return [[raw[b:b + w * h].reshape(h, w),
             raw[b + w * h:b + w * h + cw * ch].reshape(ch, cw),
             raw[b + w * h + cw * ch:b + per].reshape(ch, cw)]
            for b in range(0, n * per, per)]


@pytest.mark.parametrize("name,n", STREAMS)
def test_stream_vs_native_and_dav1d(name, n, synchronous_native):
    path = os.path.join(SMOKE, name)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = _frames(lambda: easyav1_tpu_torch.EasyAV1(path, device="cpu"))
    assert easyav1_tpu_torch.stats == {"frames": n, "fallbacks": 0}
    want = _frames(lambda: native_session(path))
    gold = _dav1d(name, n)
    assert len(got) == len(want) == n
    for k, (a, b, c) in enumerate(zip(got, want, gold)):
        for p in range(3):
            assert a[p].dtype == np.uint16
            _assert_equal(a[p], b[p], f"{name} frame {k} plane {p} vs C")
            _assert_equal(a[p], c[p], f"{name} frame {k} plane {p} vs dav1d")


def test_4k_10bit_native_session_vs_dav1d(synchronous_native):
    """The port's C session, which decodes every symbol the device path
    reads, equals dav1d on all 8 frames of the 4K 10-bit bench stream.
    Its frame 6 has a warped 128x128 block whose top-right neighbour the
    spec leaves out of the warp samples (blocks wider or taller than 64);
    the JAX package's decoder takes it in (ROADMAP C3)."""
    name = "../bench/bench_av1_10bit_3840x2160_8.webm"
    prefix = smoke_oracle(name)
    meta = json.loads(prefix.with_suffix(".json").read_text())
    w, h = meta["width"], meta["height"]
    assert (w, h, meta["depth"], meta["vframes"]) == (3840, 2160, 10, 8)
    cw, ch = w >> 1, h >> 1
    per = w * h + 2 * cw * ch
    raw = np.memmap(prefix.with_suffix(".yuv"), np.uint16, "r")
    assert raw.size == 8 * per
    av = native_session(os.path.join(SMOKE, name))
    k = 0
    try:
        for _ in range(64):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                got = av.get_video_frame().data
                b = k * per
                gold = [raw[b:b + w * h].reshape(h, w),
                        raw[b + w * h:b + w * h + cw * ch].reshape(ch, cw),
                        raw[b + w * h + cw * ch:b + per].reshape(ch, cw)]
                for p in range(3):
                    _assert_equal(got[p], gold[p], f"frame {k} plane {p}")
                k += 1
    finally:
        av.close()
    assert k == 8


@pytest.mark.parametrize("name", ["hbd_10p.webm", "hbd_12p.webm"])
def test_resident_decode_keeps_uint16_planes(name, synchronous_native):
    path = os.path.join(SMOKE, name)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    n, _wall, hashes, frames = resident.decode_resident(path, "cpu")
    assert easyav1_tpu_torch.stats["fallbacks"] == 0
    assert not any(f.data.materialised for f in frames)
    assert all(t.dtype == torch.uint16 for f in frames
               for t in f.data.device_planes)
    want = [frame_hash(f) for f in _frames(lambda: native_session(path))]
    assert n == len(want) and hashes == want
