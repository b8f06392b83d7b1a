"""Film grain's kernel source (`csrc/fg.cu`) on the CPU, and the grain
templates of the port's C generator.

The kernel's source is compiled by g++ against tools/cuda_host_shim
(each CUDA thread an OS thread, `__syncthreads` a barrier) and held to
the plain version (`FilmGrain.apply_plain`, `fg_plain.apply`) at
tolerance 0 on seeded frames (`unit_programs.random_fg_case`): overlap
on and off, every AR lag, chroma scaling from luma and the mult and
offset path, restricted and full range, 4:2:0, 4:2:2, 4:4:4 and
monochrome, odd sizes and a frame narrower than one block, 8, 10 and 12
bits (samples above 255), and the 1080p grain bench stream's own two
parameter sets at a small size.  The wrapper `fg_launch` takes the plain
version on CPU tensors and refuses what the kernel does not take.  The
C templates (`native.fg_templates`) equal `fg_plain.generate_grain`'s
template for template.  What nvcc accepts and how fast it runs show only
on the card (tests/test_torch_fg_card.py, `chip_smoke.py`)."""

import ctypes
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from easyav1_tpu_torch import _build, native, trace
from easyav1_tpu_torch.unit_programs import random_fg_case, stream_grain
from easyav1_tpu_torch.video.av1.recon import fg_plain, fg_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAIN_STREAM = os.path.join(REPO, "tests", "data", "bench",
                            "bench_av1_lr_grain_1920x1080_8.webm")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/fg.cu built by g++ against tools/cuda_host_shim."""
    tmp = tmp_path_factory.mktemp("fg_kernel")
    src, out = tmp / "fg_host.cpp", tmp / "fg_host.so"
    src.write_text(
        "#include <cuda_runtime.h>\n"
        "#define FG_LAUNCH(kernel, grid, threads, stream, ...) "
        "host_launch(grid, threads, [=] { kernel(__VA_ARGS__); })\n"
        f'#include "{os.path.join(REPO, "easyav1_tpu_torch", "csrc")}'
        '/fg.cu"\n')
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I",
                    os.path.join(REPO, "tools", "cuda_host_shim"), str(src),
                    "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fg_frame_launch.restype = ci
    lib.fg_frame_launch.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ci),
                                    ci, ctypes.POINTER(ci), vp, vp]
    return lib


def _grain(fg, seq):
    return fg_torch.FilmGrain(fg, seq, seq.color.bitdepth, "cpu")


def host_launch(lib, grain, planes, dims=None, params=None):
    """`fg_launch`'s one launch through a host build of the source:
    (return code, planes); the planes that take grain are new, filled
    with 77 before the launch."""
    on, d, p = fg_torch.launch_args(grain, planes)
    dims = d if dims is None else dims
    params = p if params is None else params
    out, ptrs = list(planes), []
    for i, x in enumerate(planes):
        if i in on:
            out[i] = torch.full_like(x, 77)
        ptrs += [x.data_ptr(), out[i].data_ptr() if i in on else 0]
    table = grain.table(torch.device("cpu"))
    ci = ctypes.c_int
    rc = lib.fg_frame_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ci * len(dims))(*dims),
        len(planes), (ci * len(params))(*params), table.data_ptr(), None)
    return rc, out


def _hold(lib, fg, seq, planes):
    """The source's planes equal the plain version's, which change some
    sample, and the inputs stay as they were."""
    grain = _grain(fg, seq)
    tin = [torch.from_numpy(p) for p in planes]
    kept = [t.clone() for t in tin]
    rc, got = host_launch(lib, grain, tin)
    assert rc == 0
    want = grain.apply_plain(tin)
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == tin[p].dtype
        bad = torch.nonzero(g != w)
        assert not len(bad), (f"plane {p}: {len(bad)} differ, first at "
                              f"{bad[0].tolist()}")
        assert torch.equal(tin[p], kept[p]), "input written"
    assert any(not torch.equal(w, t) for w, t in zip(want, tin))


# seeded frames: random_fg_case's keywords
CASES = {
    "420-overlap": dict(seed=1, width=97, height=61),
    "420-no-overlap": dict(seed=2, width=97, height=61, overlap=False),
    "lag0": dict(seed=3, width=70, height=40, lag=0),
    "lag1": dict(seed=4, width=70, height=40, lag=1),
    "lag2": dict(seed=5, width=70, height=40, lag=2),
    "from-luma": dict(seed=6, width=97, height=61, chroma="luma"),
    "chroma-only": dict(seed=7, width=66, height=50, luma=False),
    "restricted": dict(seed=8, width=97, height=61, restricted=True),
    "422": dict(seed=9, width=75, height=41, ss=(1, 0)),
    "444": dict(seed=10, width=75, height=41, ss=(0, 0)),
    "444-from-luma": dict(seed=11, width=40, height=33, ss=(0, 0),
                          chroma="luma", overlap=False),
    "mono": dict(seed=12, width=97, height=61, mono=True),
    "narrow": dict(seed=13, width=20, height=70),
    "one-row": dict(seed=14, width=100, height=1, ss=(1, 0)),
    "10bit": dict(seed=15, width=97, height=61, bd=10),
    "10bit-422-restricted": dict(seed=16, width=65, height=35, bd=10,
                                 ss=(1, 0), restricted=True),
    "12bit": dict(seed=17, width=97, height=61, bd=12),
    "12bit-444-from-luma": dict(seed=18, width=45, height=38, bd=12,
                                ss=(0, 0), chroma="luma"),
    # 19 block columns: the random values several LFSR strides in
    "wide": dict(seed=19, width=600, height=40),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_source_on_the_host(host_lib, name):
    _hold(host_lib, *random_fg_case(**CASES[name]))


@pytest.mark.parametrize("bd", [10, 12])
def test_kernel_source_above_255(host_lib, bd):
    """Every sample above 255: the LUT interpolated between entries."""
    fg, seq, planes = random_fg_case(20 + bd, 64, 48, bd=bd)
    for p in planes:
        p[:] = np.maximum(p, 256)
    _hold(host_lib, fg, seq, planes)


@pytest.mark.parametrize("which", [0, 1])
def test_kernel_source_on_the_stream_parameters(host_lib, which):
    """The 1080p grain bench stream's two parameter sets, at 130x70."""
    fg, seq = stream_grain(GRAIN_STREAM)[which]
    rng = np.random.default_rng(which)
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((70, 130), (35, 65), (35, 65))]
    _hold(host_lib, fg, seq, planes)


def test_the_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    fg, seq, planes = random_fg_case(30, 50, 34)
    grain = _grain(fg, seq)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    tin = [torch.from_numpy(p) for p in planes]
    before = trace.counters()
    got = grain.apply(tin)
    assert trace.counters()["launches.fg_frame_kernel"] \
        == before["launches.fg_frame_kernel"]
    for g, w in zip(got, grain.apply_plain(tin)):
        assert torch.equal(g, w)


def _bad_planes():
    fg, seq, planes = random_fg_case(31, 50, 34)
    t = [torch.from_numpy(p) for p in planes]
    return fg, seq, {
        "int32 planes": [x.to(torch.int32) for x in t],
        "two planes": t[:2],
        "chroma of the wrong size": [t[0], t[1][:, :-1], t[2]],
        "a 3-D plane": [t[0][None], t[1], t[2]]}


@pytest.mark.parametrize("case", sorted(_bad_planes()[2]))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    fg, seq, bad = _bad_planes()
    with pytest.raises(ValueError):
        fg_torch.launch_args(_grain(fg, seq), bad[case])


@pytest.mark.parametrize("field,value", [
    ("bd", 9), ("ssy", 1, ), ("shift", 7), ("shift", 12), ("height", 0),
    ("chroma", 1)])
def test_the_launch_refuses_bad_arguments(host_lib, field, value):
    fg, seq, planes = random_fg_case(32, 50, 34, ss=(0, 0))
    grain = _grain(fg, seq)
    tin = [torch.from_numpy(p) for p in planes]
    _, dims, params = fg_torch.launch_args(grain, tin)
    if field == "bd":
        params[0] = value
    elif field == "ssy":
        params[2] = value           # 4:4:0 is not AV1's
    elif field == "shift":
        params[5] = value
    elif field == "height":
        dims[0] = value
    else:
        dims[3] += value            # Cb one row taller than luma's
    rc, _ = host_launch(host_lib, grain, tin, dims, params)
    assert rc != 0


# ---------------------------------------------- the templates from C


def _color(ssx, ssy, mono, bd):
    return SimpleNamespace(color=SimpleNamespace(
        subsampling_x=ssx, subsampling_y=ssy, mono_chrome=mono, bitdepth=bd))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_c_templates_equal_python(lag, ss, bd):
    fg, _, _ = random_fg_case(40 + lag, 8, 8, bd=bd, ss=ss, lag=lag)
    want = fg_plain.generate_grain(fg, bd, *ss, False)
    got = native.fg_templates(fg, bd, *ss, False)
    for w, g in zip(want, got):
        assert g.dtype == np.int32 and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("case", ["mono", "from-luma", "no-points",
                                  "chroma-only", "no-chroma"])
def test_c_templates_equal_python_in_the_corners(case):
    kw = {"mono": dict(mono=True), "from-luma": dict(chroma="luma"),
          "no-points": dict(luma=False, chroma="none"),
          "chroma-only": dict(luma=False),
          "no-chroma": dict(chroma="none")}[case]
    fg, _, _ = random_fg_case(50, 8, 8, lag=3, **kw)
    mono = kw.get("mono", False)
    want = fg_plain.generate_grain(fg, 8, 1, 1, mono)
    got = native.fg_templates(fg, 8, 1, 1, mono)
    for w, g in zip(want, got):
        assert (w is None) == (g is None) == (mono and w is not want[0])
        assert w is None or np.array_equal(g, w)


def test_film_grain_counts_the_template_sets_it_makes():
    fg, seq, _ = random_fg_case(60, 8, 8)
    before = trace.counters()
    grain = _grain(fg, seq)
    assert trace.counters()["fg.templates"] == before["fg.templates"] + 1
    assert all(np.array_equal(a, b) for a, b in zip(
        grain.templates, fg_plain.generate_grain(fg, 8, 1, 1, False)))
