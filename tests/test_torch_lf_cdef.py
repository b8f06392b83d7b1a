"""Deblocking and CDEF: the port's plain versions against the JAX
package's functions, exactly, and the hand kernels' sources against the
plain versions.

- `lf_torch.pass_body` (through `lf_pass_plain`, both directions, on
  the per-line maps `expand_maps` makes of the decoder's cell maps)
  against `lf_jax._pass_body` at 8, 10 and 12 bits on seeded planes and
  maps (`unit_programs.random_postfilter_case`) of odd and even sizes,
  with edges whose taps reach past the plane at both ends; the seeded
  inputs reach every filter length, with `hev` on and off.  The whole
  frame (`lf_frame_plain`, `expand_maps` included) on cell maps against
  the JAX package's expansion of them, `postfilter_fused._lf_stage`.
- `cdef_torch.find_dirs` against `cdef_jax._dirs_body` where the 8x8
  unit grid covers the plane, and against the host search
  (`find_dirs_host`) where it overhangs, at each bit depth.
- `cdef_torch.filter_plane` against `cdef_jax._filter_body` for each
  plane at 4:2:0 and 4:4:4, at each bit depth.
- The wrappers (`lf_launch`, `dirs_launch`, `filter_launch`) take the
  plain version for CPU tensors and leave their launch counts at 0;
  `postfilter.host_maps` keeps the decoder's deblocking maps at cell
  granularity.
- `csrc/loopfilter.cu` and `csrc/cdef.cu`, compiled by g++ against
  tools/cuda_host_shim (each CUDA thread an OS thread, `__syncthreads` a
  barrier), equal the plain versions on seeded inputs: one launch for
  the three planes of different sizes of a frame, or for a luma plane
  alone as `postfilter_torch.make_postfilter` calls them, at each bit
  depth, odd sizes whose unit grid overhangs, a stream axis, several
  tiles a plane, cell maps and one map row a pixel line, overlapping
  edges in both directions, 4:2:0, 4:2:2 and 4:4:4, and CDEF's upper
  clamp binding beside the plane's border.  That runs the
  kernels' arithmetic, tiling and halo logic as written; what nvcc
  accepts and how fast it runs show only on the card (the `cuda` tests,
  and `chip_smoke.py`).
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from easyav1_tpu.video.av1.recon import cdef_jax, lf_jax
from easyav1_tpu_torch import convert, trace
from easyav1_tpu_torch.unit_programs import random_postfilter_case
from easyav1_tpu_torch.video.av1.recon import cdef_torch, lf_torch
from easyav1_tpu_torch.video.av1.recon.postfilter import (postfilter_apply,
                                                          upload_maps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "easyav1_tpu_torch", "csrc")
CPU = torch.device("cpu")
TABS = convert.tables(CPU)
BDS = [8, 10, 12]
# 4:2:0 luma sizes: odd (the unit grid overhangs, the last edge's taps
# pass the plane's end) and even
LUMA = [(37, 53), (48, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _eq(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} against {want.shape}"
    bad = np.argwhere(got != want)
    assert not len(bad), (f"{what}: {len(bad)} differ, first at "
                          f"{bad[0].tolist()}: {got[tuple(bad[0])]} against "
                          f"{want[tuple(bad[0])]}")


def _dims(luma, ss):
    h, w = luma
    return [luma] + [((h + ss[1]) >> ss[1], (w + ss[0]) >> ss[0])] * 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------- deblocking

def _jax_pass(plane, size, lim, bd, horizontal):
    import jax

    if horizontal:
        plane = plane.T
    H, W = plane.shape
    out = jax.jit(lf_jax._pass_body(H, W, bd))(plane, size, *lim)
    out = np.asarray(out)
    return out.T if horizontal else out


@pytest.mark.parametrize("horizontal", [False, True], ids=["vert", "horz"])
@pytest.mark.parametrize("luma", LUMA, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("bd", BDS)
def test_lf_pass_plain_vs_jax(bd, luma, horizontal):
    case = random_postfilter_case(11 * bd + luma[1], _dims(luma, (1, 1)), bd)
    for p, (plane, m) in enumerate(zip(case["planes"], case["maps"]["lf"])):
        size, level = (m["sh"], m["lh"]) if horizontal else (m["sv"],
                                                             m["lv"])
        # the first and the last edge of each fourth cell row 14 long:
        # their taps reach past the plane's ends
        size = size.copy()
        size[::3, 0] = size[::3, -1] = 14
        got = lf_torch.lf_pass_plain(_t(plane), _t(size), _t(level),
                                     _t(m["lut"]), bd, horizontal)
        lines = plane.shape[1 if horizontal else 0]
        sz, lim = lf_torch.expand_maps(_t(size), _t(level), _t(m["lut"]),
                                       lines)
        want = _jax_pass(plane, sz.numpy(), lim.numpy(), bd, horizontal)
        _eq(got, want, f"plane {p}")
        assert (got.numpy() != plane).any(), f"plane {p}: nothing filtered"


# (size, thresh) of a pass, and of the pass it must differ from: each
# longer filter against the next shorter one, the 4-tap filter against
# no filter, and hev on (thresh 0) against off
FILTERS = {"14": ((14, None), (8, None)), "8": ((8, None), (6, None)),
           "6": ((6, None), (4, None)), "4": ((4, None), (0, None)),
           "hev": ((4, 0), (4, 1 << 12))}


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("bd", BDS)
def test_lf_seeded_inputs_reach_every_filter(bd, name):
    """With every edge of one size, the pass equals the JAX package's and
    differs from the pass with the next shorter filter (or with hev
    off): the seeded planes reach that filter."""
    case = random_postfilter_case(5 * bd, [(48, 64)], bd)
    plane, m = case["planes"][0], case["maps"]["lf"][0]

    def run(size_v, thresh):
        size = np.full_like(m["sv"], size_v)
        lut = m["lut"].copy()
        if thresh is not None:
            lut[2] = thresh
        got = lf_torch.lf_pass_plain(_t(plane), _t(size), _t(m["lv"]),
                                     _t(lut), bd).numpy()
        sz, lim = lf_torch.expand_maps(_t(size), _t(m["lv"]), _t(lut), 48)
        _eq(got, _jax_pass(plane, sz.numpy(), lim.numpy(), bd, False),
            f"size {size_v}")
        return got

    this, other = (run(*a) for a in FILTERS[name])
    assert (this != other).sum() > 10, f"{name}: the seeded planes miss it"


@pytest.mark.parametrize("luma", LUMA, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("bd", BDS)
def test_lf_frame_plain_on_cell_maps_vs_jax(bd, luma):
    """`lf_torch.lf_frame_plain` on the decoder's cell maps (uint8 sizes
    and levels, a LUT) against the JAX package's own expansion of cell
    maps, `postfilter_fused._lf_stage` (int32 size cells, limits
    lut[:, level] a cell), every plane of a 4:2:0 frame."""
    from easyav1_tpu.video.av1.recon import postfilter_fused

    dims = _dims(luma, (1, 1))
    case = random_postfilter_case(13 * bd + luma[0], dims, bd)
    lf = case["maps"]["lf"]
    want = postfilter_fused._lf_stage(tuple(dims), bd)(
        case["planes"], [m["sv"].astype(np.int32) for m in lf],
        [m["sh"].astype(np.int32) for m in lf],
        [m["lut"][:, m["lv"]] for m in lf],
        [m["lut"][:, m["lh"]] for m in lf])
    planes = [_t(p) for p in case["planes"]]
    got = lf_torch.lf_frame_plain(planes, upload_maps(case["maps"],
                                                      CPU)["lf"], bd)
    for p, (a, b) in enumerate(zip(got, want)):
        _eq(a, np.asarray(b), f"plane {p}")
        assert not torch.equal(a, planes[p]), f"plane {p}: nothing filtered"


# ---------------------------------------------------------------- CDEF

def _luma_pad(luma, uh, uw):
    pad = np.full((uh * 8 + 4, uw * 8 + 4), cdef_jax.CDEF_VERY_LARGE,
                  np.int32)
    pad[2:2 + luma.shape[0], 2:2 + luma.shape[1]] = luma
    return pad


@pytest.mark.parametrize("luma", LUMA, ids=["overhang", "covered"])
@pytest.mark.parametrize("bd", BDS)
def test_find_dirs_vs_jax(bd, luma):
    import jax

    plane = random_postfilter_case(3 * bd, [luma], bd)["planes"][0]
    uh, uw = (luma[0] + 7) // 8, (luma[1] + 7) // 8
    cs = bd - 8
    if luma[0] % 8 or luma[1] % 8:
        # the JAX package searches on the host where the grid overhangs
        want = cdef_jax.find_dirs_host(np.asarray(
            cdef_jax._make_partial_kernel(uh, uw, cs)(
                _luma_pad(plane, uh, uw))))
    else:
        want = jax.jit(cdef_jax._dirs_body(uh, uw, cs))(
            _luma_pad(plane, uh, uw))
    got = cdef_torch.dirs_launch(_t(plane), uh, uw, cs, TABS)
    _eq(got[0], np.asarray(want[0]), "dir")
    _eq(got[1], np.asarray(want[1]), "var")
    assert len(np.unique(got[0].numpy())) > 2


@pytest.mark.parametrize("p", [0, 1, 2])
@pytest.mark.parametrize("ss", [(1, 1), (0, 0)], ids=["420", "444"])
@pytest.mark.parametrize("bd", BDS)
def test_filter_plane_vs_jax(bd, ss, p):
    luma = (37, 53)
    case = random_postfilter_case(7 * bd + p, _dims(luma, ss), bd, ss=ss)
    m = case["maps"]["cdef"]
    uh, uw = m["filt"].shape
    rng = np.random.default_rng(bd + p)
    dirs = rng.integers(0, 8, (uh, uw)).astype(np.int32)
    var = rng.integers(0, 1 << 14, (uh, uw)).astype(np.int32)
    var[0] = 0
    pri, sec = (m["pri_y"], m["sec_y"]) if p == 0 else (m["pri_uv"],
                                                        m["sec_uv"])
    plane = case["planes"][p]
    want = cdef_jax._make_kernel(*plane.shape, *ss, p, bd, m["damping"])(
        plane, dirs, var, pri, sec, m["filt"])
    got = cdef_torch.filter_plane(_t(plane), _t(dirs), _t(var), _t(pri),
                                  _t(sec), _t(m["filt"]), *ss, p, bd,
                                  m["damping"], TABS)
    _eq(got, np.asarray(want), f"plane {p}")
    assert (got.numpy() != plane).any()


# ------------------------------------------------------------ wrappers

def _wrapper_calls(case):
    """(name, launch counter, call, plain call) of the three wrappers on a
    case's planes."""
    planes = [_t(p) for p in case["planes"]]
    maps = upload_maps(case["maps"], CPU)
    cd = maps["cdef"]
    uh, uw = cd["filt"].shape
    dirs, var = cdef_torch.find_dirs(planes[0], uh, uw, cd["cs"], TABS)
    pri, sec = cdef_torch.strengths(cd, 3)
    return [
        ("deblock", "launches.lf_frame_kernel",
         lambda: lf_torch.lf_launch(planes, maps["lf"], 8),
         lambda: [lf_torch.pass_body(
             lf_torch.pass_body(x, *_rows(m["sv"], m["lv"], m["lut"],
                                          x.shape[0]), 8).T,
             *_rows(m["sh"], m["lh"], m["lut"], x.shape[1]), 8).T
             for x, m in zip(planes, maps["lf"])]),
        ("cdef_dirs", "launches.cdef_dirs_kernel",
         lambda: cdef_torch.dirs_launch(planes[0], uh, uw, 0, TABS),
         lambda: cdef_torch.find_dirs(planes[0], uh, uw, 0, TABS)),
        ("cdef_filter", "launches.cdef_filter_kernel",
         lambda: cdef_torch.filter_launch(
             planes, dirs, var, pri, sec, cd["filt"], 1, 1, 8,
             cd["damping"], TABS),
         lambda: [cdef_torch.filter_plane(
             planes[p], dirs, var, pri[p], sec[p], cd["filt"], 1, 1, p, 8,
             cd["damping"], TABS) for p in range(3)])]


def _rows(size, level, lut, lines):
    """The per-line maps `pass_body` takes, limits unbound."""
    sz, lim = lf_torch.expand_maps(size, level, lut, lines)
    return (sz, *lim)


@pytest.mark.parametrize("k", range(3), ids=["deblock", "cdef_dirs",
                                             "cdef_filter"])
def test_wrapper_on_cpu_takes_the_plain_version(k):
    _name, counter, call, plain = _wrapper_calls(
        random_postfilter_case(1, _dims((37, 53), (1, 1)), 8))[k]
    before = trace.counters()[counter]
    got, want = call(), plain()
    for a, b in zip(got if isinstance(got, (tuple, list)) else (got,),
                    want if isinstance(want, (tuple, list)) else (want,)):
        _eq(a, b, "wrapper against plain")
    assert trace.counters()[counter] == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    planes = torch.zeros((2, 16, 20), dtype=torch.int32)
    u8 = torch.uint8

    def lf_maps(rv, rh, dtype=u8):
        return {"sv": torch.zeros((2, rv, 4), dtype=dtype),
                "lv": torch.zeros((2, rv, 4), dtype=dtype),
                "sh": torch.zeros((2, rh, 3), dtype=dtype),
                "lh": torch.zeros((2, rh, 3), dtype=dtype),
                "lut": torch.zeros((2, 3, 64), dtype=torch.int32)}

    assert len(lf_torch.lf_launch([planes], [lf_maps(4, 5)], 8)) == 1
    assert len(lf_torch.lf_launch([planes], [lf_maps(16, 20)], 8)) == 1
    with pytest.raises(ValueError):     # the map has one cell row too many
        lf_torch.lf_launch([planes], [lf_maps(5, 5)], 8)
    with pytest.raises(ValueError):     # int32 size maps
        lf_torch.lf_launch([planes], [lf_maps(4, 5, torch.int32)], 8)
    with pytest.raises(ValueError):     # int64 planes
        cdef_torch.dirs_launch(planes.long(), 2, 3, 0, TABS)
    units = torch.zeros((2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):     # 2x2 units do not cover 16x20
        cdef_torch.filter_launch([planes], *[units] * 2, [units], [units],
                                 units, 1, 1, 8, 5, TABS)
    units = units.repeat(1, 2, 2)
    with pytest.raises(ValueError):     # one damping for two streams
        cdef_torch.filter_launch([planes], *[units] * 2, [units], [units],
                                 units, 1, 1, 8,
                                 torch.tensor([5], dtype=torch.int32), TABS)
    with pytest.raises(ValueError):     # a strength map short for a plane
        cdef_torch.filter_launch([planes, planes], *[units] * 2, [units],
                                 [units], units, 0, 0, 8, 5, TABS)


def test_postfilter_apply_skips_a_plane_whose_deblocking_is_off():
    case = random_postfilter_case(2, _dims((37, 53), (1, 1)), 8)
    case["maps"]["lf"][1] = None
    planes = [_t(p) for p in case["planes"]]
    got, debl = postfilter_apply(planes, upload_maps(case["maps"], CPU),
                                 want_deblocked=True)
    assert torch.equal(debl[1], planes[1])
    assert not torch.equal(debl[0], planes[0])
    assert not torch.equal(debl[2], planes[2])


# --------------------------------------- the kernel sources on the host

def _host_lib(name, tmp, csrc=CSRC):
    """<csrc>/<name>.cu built by g++ against tools/cuda_host_shim."""
    src = os.path.join(tmp, f"{name}_host.cpp")
    with open(src, "w") as f:
        f.write("#include <cuda_runtime.h>\n"
                "#define HOST_LAUNCH(kernel, grid, threads, stream, ...) "
                "host_launch(grid, threads, [=] { kernel(__VA_ARGS__); })\n"
                "#define LF_LAUNCH HOST_LAUNCH\n"
                "#define CDEF_LAUNCH HOST_LAUNCH\n"
                f'#include "{os.path.join(csrc, name)}.cu"\n')
    out = os.path.join(tmp, f"{name}_host.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I",
                    os.path.join(REPO, "tools", "cuda_host_shim"), src, "-o",
                    out], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pp, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
    for fn, args in (("lf_frame_launch", [pp, pi, ci, ci, ci, vp]),
                     ("lf_twopass_launch", [pp, pi, ci, ci, ci, vp]),
                     ("cdef_dirs_launch", [vp] * 3 + [ci] * 6 + [vp]),
                     ("cdef_frame_launch", [pp, pi] + [vp] * 4 + [ci] * 8
                      + [vp])):
        if hasattr(lib, fn):
            getattr(lib, fn).restype = ci
            getattr(lib, fn).argtypes = args
    return lib


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("postfilter_kernels"))
    return {n: _host_lib(n, tmp) for n in ("loopfilter", "cdef")}


def host_deblock(lib, planes, maps, bd, twopass=False):
    """`lf_launch`'s one launch through a host build of the source, or
    with `twopass` the two launches of tools/torch_loopfilter_twopass.cu
    (through a scratch plane)."""
    on = [p for p, m in enumerate(maps) if m is not None]
    out = [torch.full_like(x, -1) for x in planes]
    tmp = [torch.full_like(x, -1) for x in planes]
    ptrs, dims = [], []
    for p in on:
        x, m = planes[p], maps[p]
        mid = [tmp[p].data_ptr()] if twopass else []
        ptrs += [x.data_ptr(), *mid, out[p].data_ptr()] + [
            m[k].data_ptr() for k in ("sv", "lv", "sh", "lh", "lut")]
        dims += [*x.shape[-2:], lf_torch.map_shift(m["sv"].shape[-2],
                                                   x.shape[-2]),
                 lf_torch.map_shift(m["sh"].shape[-2], x.shape[-1])]
    lead = planes[0].shape[:-2]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launch = lib.lf_twopass_launch if twopass else lib.lf_frame_launch
    assert launch((vp * len(ptrs))(*ptrs), (ci * len(dims))(*dims), len(on),
                  lead[0] if lead else 1, bd, None) == 0
    return out


def host_cdef(lib, planes, dirs, var, pri, sec, filt, ss, bd, damping):
    """`filter_launch`'s one launch through a host build of the source."""
    out = [torch.full_like(x, -1) for x in planes]
    ptrs = [t.data_ptr() for p in range(len(planes))
            for t in (planes[p], out[p], pri[p], sec[p])]
    dims = [d for x in planes for d in x.shape[-2:]]
    lead = planes[0].shape[:-2]
    damp = damping if isinstance(damping, torch.Tensor) else None
    vp, ci = ctypes.c_void_p, ctypes.c_int
    assert lib.cdef_frame_launch(
        (vp * len(ptrs))(*ptrs), (ci * len(dims))(*dims), dirs.data_ptr(),
        var.data_ptr(), filt.data_ptr(),
        None if damp is None else damp.data_ptr(),
        0 if damp is not None else damping, len(planes),
        lead[0] if lead else 1, *filt.shape[-2:], *ss, bd, None) == 0
    return out


# (luma size, streams, map-row shift, chroma subsampling, what): several
# tiles a plane in both directions, odd sizes whose unit grid overhangs,
# a stream axis and none, the decoder's cell maps and one map row a
# pixel line, 4:2:0, 4:2:2 and 4:4:4, every edge 14 long so that
# neighbouring edges' writes overlap in both directions, a luma plane
# alone (make_postfilter's per-line maps and shared limits), and CDEF's
# upper clamp binding beside the border, where taps read
# CDEF_VERY_LARGE (`random_postfilter_case(clamp=True)`)
HOST_CASES = {
    "odd-S2-cells": ((141, 299), 2, 2, (1, 1), None),
    "even-S0-cells": ((72, 136), 0, 2, (1, 1), None),
    "odd-rows-422": ((75, 133), 0, 0, (1, 0), None),
    "overlap-S3-444": ((70, 90), 3, 2, (0, 0), "overlap"),
    "luma-rows-S2": ((67, 131), 2, 0, (1, 1), "luma"),
    "border-clamp-S2": ((69, 101), 2, 2, (1, 1), "clamp"),
}


def _host_case(bd, name):
    luma, streams, shift, ss, what = HOST_CASES[name]
    case = random_postfilter_case(bd * 7 + luma[0] + shift,
                                  _dims(luma, ss), bd, streams, ss=ss,
                                  map_shift=shift, clamp=what == "clamp")
    maps = case["maps"]
    if what == "overlap":
        for m in maps["lf"]:
            m["sv"][:] = m["sh"][:] = 14
            m["lut"][..., 2, :] = 0
    if what == "luma":
        case["planes"] = case["planes"][:1]
        maps["lf"] = maps["lf"][:1]
        for m in maps["lf"]:
            m["lv"][:] = 0
            m["lut"][...] = m["lut"][..., :1]
    return [_t(p) for p in case["planes"]], upload_maps(maps, CPU)


@pytest.mark.parametrize("name", list(HOST_CASES))
@pytest.mark.parametrize("bd", BDS)
def test_loopfilter_source_on_the_host(host_libs, bd, name):
    planes, maps = _host_case(bd, name)
    got = host_deblock(host_libs["loopfilter"], planes, maps["lf"], bd)
    want = lf_torch.lf_frame_plain(planes, maps["lf"], bd)
    for p, (a, b) in enumerate(zip(got, want)):
        _eq(a, b, f"plane {p}")
        assert not torch.equal(b, planes[p]), f"plane {p}: nothing filtered"


@pytest.fixture(scope="module")
def twopass_lib(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("twopass"))
    return _host_lib("torch_loopfilter_twopass", tmp,
                     os.path.join(REPO, "tools"))


@pytest.mark.parametrize("name", list(HOST_CASES))
@pytest.mark.parametrize("bd", BDS)
def test_loopfilter_twopass_on_the_host(twopass_lib, bd, name):
    """The two-launch design the shipped deblocking is raced against on
    the card (tools/torch_loopfilter_twopass.cu) equals the plain
    version too."""
    planes, maps = _host_case(bd, name)
    got = host_deblock(twopass_lib, planes, maps["lf"], bd, twopass=True)
    want = lf_torch.lf_frame_plain(planes, maps["lf"], bd)
    for p, (a, b) in enumerate(zip(got, want)):
        _eq(a, b, f"plane {p}")


@pytest.mark.parametrize("name", list(HOST_CASES))
@pytest.mark.parametrize("bd", BDS)
def test_cdef_source_on_the_host(host_libs, bd, name):
    lib = host_libs["cdef"]
    planes, maps = _host_case(bd, name)
    m = maps["cdef"]
    uh, uw = m["filt"].shape[-2:]
    lead = planes[0].shape[:-2]
    dirs, var = (torch.full(m["filt"].shape, -1, dtype=torch.int32)
                 for _ in range(2))
    assert lib.cdef_dirs_launch(planes[0].data_ptr(), dirs.data_ptr(),
                                var.data_ptr(), lead[0] if lead else 1,
                                *planes[0].shape[-2:], uh, uw, bd - 8,
                                None) == 0
    want = cdef_torch.find_dirs(planes[0], uh, uw, bd - 8, TABS)
    _eq(dirs, want[0], "dir")
    _eq(var, want[1], "var")
    pri, sec = cdef_torch.strengths(m, len(planes))
    got = host_cdef(lib, planes, dirs, var, pri, sec, m["filt"], m["ss"],
                    bd, m["damping"])
    want = cdef_torch.filter_planes(planes, dirs, var, pri, sec, m["filt"],
                                    *m["ss"], bd, m["damping"], TABS)
    for p, (a, b) in enumerate(zip(got, want)):
        _eq(a, b, f"plane {p}")
        assert not torch.equal(b, planes[p]), f"plane {p}: nothing filtered"


def test_host_maps_keep_cell_maps():
    """The decoder's path uploads the deblocking maps as `_lf_size_maps`
    makes them, one uint8 row a 4x4-cell row: `host_maps` repeats no
    row."""
    from easyav1_tpu_torch.video.av1.recon import postfilter

    case = random_postfilter_case(9, _dims((37, 53), (1, 1)), 8)
    dims = [p.shape for p in case["planes"]]
    cells = [(m["sv"], m["sh"], m["lv"], m["lh"]) for m in
             case["maps"]["lf"]]
    lut = case["maps"]["lf"][0]["lut"]

    class Hdr:
        class lf:
            level = (10, 10, 10, 10)

    class Seq:
        class color:
            bitdepth = 8

    real = postfilter._lf_size_maps
    postfilter._lf_size_maps = lambda *a: (cells, lut)
    try:
        got = postfilter.lf_host_maps(Hdr, Seq, dims, None)
    finally:
        postfilter._lf_size_maps = real
    for p, ((ph, pw), m) in enumerate(zip(dims, got)):
        assert m["sv"].shape[0] == m["lv"].shape[0] == (ph + 3) // 4
        assert m["sh"].shape[0] == m["lh"].shape[0] == (pw + 3) // 4
        assert all(m[k].dtype == np.uint8 for k in ("sv", "lv", "sh", "lh"))
        assert m["lut"].shape == (3, 64)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("bd", BDS)
def test_kernels_on_the_card(cuda_device, bd):
    """Each kernel against its plain version on the card, with a stream
    axis, on an odd size; then the whole postfilter against the CPU."""
    case = random_postfilter_case(bd, _dims((141, 299), (1, 1)), bd, 3)
    maps = upload_maps(case["maps"], cuda_device)
    planes = [_t(p).to(cuda_device) for p in case["planes"]]
    got = lf_torch.lf_launch(planes, maps["lf"], bd)
    want = lf_torch.lf_frame_plain(planes, maps["lf"], bd)
    for p in range(3):
        _eq(got[p].cpu(), want[p].cpu(), f"LF plane {p}")
    cd = maps["cdef"]
    uh, uw = cd["filt"].shape[-2:]
    got = cdef_torch.dirs_launch(planes[0], uh, uw, bd - 8, cd["tabs"])
    want = cdef_torch.find_dirs(planes[0], uh, uw, bd - 8, cd["tabs"])
    for a, b in zip(got, want):
        _eq(a.cpu(), b.cpu(), "dirs")
    out = postfilter_apply(planes, maps)
    ref = postfilter_apply([_t(p) for p in case["planes"]],
                           upload_maps(case["maps"], CPU))
    for p in range(3):
        _eq(out[p].cpu(), ref[p], f"postfilter plane {p}")
