"""Deblocking and CDEF: the port's plain versions against the JAX
package's functions, exactly, and the hand kernels' sources against the
plain versions.

- `lf_torch.pass_body` (through `lf_launch` on CPU tensors, both
  directions) against `lf_jax._pass_body` at 8, 10 and 12 bits on
  seeded planes and maps (`unit_programs.random_postfilter_case`) of odd
  and even sizes, with edges whose taps reach past the plane at both
  ends; the seeded inputs reach every filter length, with `hev` on and
  off.
- `cdef_torch.find_dirs` against `cdef_jax._dirs_body` where the 8x8
  unit grid covers the plane, and against the host search
  (`find_dirs_host`) where it overhangs, at each bit depth.
- `cdef_torch.filter_plane` against `cdef_jax._filter_body` for each
  plane at 4:2:0 and 4:4:4, at each bit depth.
- The wrappers (`lf_launch`, `dirs_launch`, `filter_launch`) take the
  plain version for CPU tensors and leave their launch counts at 0.
- `csrc/loopfilter.cu` and `csrc/cdef.cu`, compiled by g++ against
  tools/cuda_host_shim (each CUDA thread an OS thread, `__syncthreads` a
  barrier), equal the plain versions on seeded inputs with a stream axis
  and several tiles a plane.  That runs the kernels' arithmetic, tiling
  and halo logic as written; what nvcc accepts and how fast it runs show
  only on the card (the `cuda` tests, and `chip_smoke.py`).
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from easyav1_tpu.video.av1.recon import cdef_jax, lf_jax
from easyav1_tpu_torch import convert
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
        size, lim = (m["sh"], m["lh"]) if horizontal else (m["sv"], m["lv"])
        # the first and the last edge of each line 14 long: their taps
        # reach past the plane's ends
        size = size.copy()
        size[::3, 0] = size[::3, -1] = 14
        got = lf_torch.lf_launch(_t(plane), _t(size), _t(lim), bd,
                                 horizontal)
        want = _jax_pass(plane, size, lim, bd, horizontal)
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
        lim = m["lv"].copy()
        if thresh is not None:
            lim[2] = thresh
        got = lf_torch.lf_launch(_t(plane), _t(size), _t(lim), bd).numpy()
        _eq(got, _jax_pass(plane, size, lim, bd, False), f"size {size_v}")
        return got

    this, other = (run(*a) for a in FILTERS[name])
    assert (this != other).sum() > 10, f"{name}: the seeded planes miss it"


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
    got = cdef_torch.filter_launch(_t(plane), _t(dirs), _t(var), _t(pri),
                                   _t(sec), _t(m["filt"]), *ss, p, bd,
                                   m["damping"], TABS)
    _eq(got, np.asarray(want), f"plane {p}")
    assert (got.numpy() != plane).any()


# ------------------------------------------------------------ wrappers

def _wrapper_calls(case):
    """(name, wrapper, call) of the three wrappers on a case's planes."""
    planes = [_t(p) for p in case["planes"]]
    maps = upload_maps(case["maps"], CPU)
    lf, cd = maps["lf"][0], maps["cdef"]
    uh, uw = cd["filt"].shape
    dirs, var = cdef_torch.find_dirs(planes[0], uh, uw, cd["cs"], TABS)
    return [
        ("deblock", lf_torch.lf_launch,
         lambda: lf_torch.lf_launch(planes[0], lf["sv"], lf["lv"], 8),
         lambda: lf_torch.pass_body(planes[0], lf["sv"], *lf["lv"], 8)),
        ("cdef_dirs", cdef_torch.dirs_launch,
         lambda: cdef_torch.dirs_launch(planes[0], uh, uw, 0, TABS),
         lambda: cdef_torch.find_dirs(planes[0], uh, uw, 0, TABS)),
        ("cdef_filter", cdef_torch.filter_launch,
         lambda: cdef_torch.filter_launch(
             planes[0], dirs, var, cd["pri_y"], cd["sec_y"], cd["filt"], 1,
             1, 0, 8, cd["damping"], TABS),
         lambda: cdef_torch.filter_plane(
             planes[0], dirs, var, cd["pri_y"], cd["sec_y"], cd["filt"], 1,
             1, 0, 8, cd["damping"], TABS))]


@pytest.mark.parametrize("k", range(3), ids=["deblock", "cdef_dirs",
                                             "cdef_filter"])
def test_wrapper_on_cpu_takes_the_plain_version(k):
    _name, fn, call, plain = _wrapper_calls(
        random_postfilter_case(1, _dims((37, 53), (1, 1)), 8))[k]
    fn.launches = 0
    got, want = call(), plain()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _eq(a, b, "wrapper against plain")
    assert fn.launches == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    planes = torch.zeros((2, 16, 20), dtype=torch.int32)
    with pytest.raises(ValueError):     # the map has one line too many
        lf_torch.lf_launch(planes, torch.zeros((2, 17, 4), dtype=torch.int32),
                           torch.zeros((2, 3, 17, 4), dtype=torch.int32), 8)
    with pytest.raises(ValueError):     # int64 planes
        cdef_torch.dirs_launch(planes.long(), 2, 3, 0, TABS)
    units = torch.zeros((2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):     # 2x2 units do not cover 16x20
        cdef_torch.filter_launch(planes, *[units] * 5, 1, 1, 0, 8, 5, TABS)
    with pytest.raises(ValueError):     # one damping for two streams
        cdef_torch.filter_launch(planes, *[units.repeat(1, 2, 2)] * 5, 1, 1,
                                 0, 8, torch.tensor([5], dtype=torch.int32),
                                 TABS)


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

def _host_lib(name, tmp):
    """csrc/<name>.cu built by g++ against tools/cuda_host_shim."""
    src = os.path.join(tmp, f"{name}_host.cpp")
    with open(src, "w") as f:
        f.write("#include <cuda_runtime.h>\n"
                "#define HOST_LAUNCH(kernel, grid, threads, stream, ...) "
                "host_launch(grid, threads, [=] { kernel(__VA_ARGS__); })\n"
                "#define LF_LAUNCH HOST_LAUNCH\n"
                "#define CDEF_LAUNCH HOST_LAUNCH\n"
                f'#include "{os.path.join(CSRC, name)}.cu"\n')
    out = os.path.join(tmp, f"{name}_host.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I",
                    os.path.join(REPO, "tools", "cuda_host_shim"), src, "-o",
                    out], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (("lf_pass_launch", [vp] * 4 + [ci] * 6 + [vp]),
                     ("cdef_dirs_launch", [vp] * 3 + [ci] * 6 + [vp]),
                     ("cdef_filter_launch", [vp] * 8 + [ci] * 10 + [vp])):
        if hasattr(lib, fn):
            getattr(lib, fn).restype = ci
            getattr(lib, fn).argtypes = args
    return lib


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("postfilter_kernels"))
    return {n: _host_lib(n, tmp) for n in ("loopfilter", "cdef")}


# (luma size, streams): several tiles a plane in both directions, odd
# sizes, a stream axis and none
HOST_CASES = [((141, 299), 2), ((72, 136), 0)]


@pytest.mark.parametrize("luma,streams", HOST_CASES,
                         ids=["odd-S2", "even-S0"])
@pytest.mark.parametrize("bd", BDS)
def test_loopfilter_source_on_the_host(host_libs, bd, luma, streams):
    lib = host_libs["loopfilter"]
    case = random_postfilter_case(bd + luma[0], _dims(luma, (1, 1)), bd,
                                  streams)
    for p, (plane, m) in enumerate(zip(case["planes"], case["maps"]["lf"])):
        src = _t(plane)
        for horizontal, size, lim in ((0, m["sv"], m["lv"]),
                                      (1, m["sh"], m["lh"])):
            size, lim = _t(size), _t(lim)
            H, W = src.shape[-2:]
            out = torch.full_like(src, -1)
            assert lib.lf_pass_launch(
                src.data_ptr(), out.data_ptr(), size.data_ptr(),
                lim.data_ptr(), streams or 1, H, W, size.shape[-1],
                horizontal, bd, None) == 0
            want = lf_torch.lf_launch(src, size, lim, bd, bool(horizontal))
            _eq(out, want, f"plane {p}, {'horizontal' if horizontal else 'vertical'}")
            src = out.contiguous()


@pytest.mark.parametrize("luma,streams", HOST_CASES,
                         ids=["odd-S2", "even-S0"])
@pytest.mark.parametrize("bd", BDS)
def test_cdef_source_on_the_host(host_libs, bd, luma, streams):
    lib = host_libs["cdef"]
    case = random_postfilter_case(bd * 3 + luma[1], _dims(luma, (1, 1)), bd,
                                  streams)
    m = upload_maps(case["maps"], CPU)["cdef"]
    planes = [_t(p) for p in case["planes"]]
    uh, uw = m["filt"].shape[-2:]
    n = streams or 1
    dirs, var = (torch.full(m["filt"].shape, -1, dtype=torch.int32)
                 for _ in range(2))
    assert lib.cdef_dirs_launch(planes[0].data_ptr(), dirs.data_ptr(),
                                var.data_ptr(), n, *luma, uh, uw, bd - 8,
                                None) == 0
    want = cdef_torch.find_dirs(planes[0], uh, uw, bd - 8, TABS)
    _eq(dirs, want[0], "dir")
    _eq(var, want[1], "var")
    damp = m["damping"]
    for p, plane in enumerate(planes):
        out = torch.full_like(plane, -1)
        pri, sec = (m["pri_y"], m["sec_y"]) if p == 0 else (m["pri_uv"],
                                                            m["sec_uv"])
        assert lib.cdef_filter_launch(
            plane.data_ptr(), out.data_ptr(), dirs.data_ptr(), var.data_ptr(),
            pri.data_ptr(), sec.data_ptr(), m["filt"].data_ptr(),
            damp.data_ptr() if streams else None,
            0 if streams else damp, n, *plane.shape[-2:], uh, uw, 1, 1, p,
            bd, None) == 0
        want = cdef_torch.filter_plane(plane, dirs, var, pri, sec, m["filt"],
                                       1, 1, p, bd, damp, TABS)
        _eq(out, want, f"plane {p}")


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("bd", BDS)
def test_kernels_on_the_card(cuda_device, bd):
    """Each kernel against its plain version on the card, with a stream
    axis, on an odd size; then the whole postfilter against the CPU."""
    case = random_postfilter_case(bd, _dims((141, 299), (1, 1)), bd, 3)
    maps = upload_maps(case["maps"], cuda_device)
    planes = [_t(p).to(cuda_device) for p in case["planes"]]
    for p, m in enumerate(maps["lf"]):
        for h, size, lim in ((False, m["sv"], m["lv"]),
                             (True, m["sh"], m["lh"])):
            got = lf_torch.lf_launch(planes[p], size, lim, bd, h)
            plane = planes[p].transpose(-1, -2) if h else planes[p]
            want = lf_torch.pass_body(plane, size, *lim.unbind(-3), bd)
            _eq(got.cpu(), (want.transpose(-1, -2) if h else want).cpu(),
                f"LF plane {p}")
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
