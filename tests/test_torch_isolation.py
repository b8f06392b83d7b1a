"""The port stands on its own.

- No module of `easyav1_tpu_torch`, and not `chip_smoke.py`, imports
  jax or anything of the JAX package (`easyav1_tpu`), by an `ast` scan
  of every source file (test_torch_pipe.py::test_port_never_imports_jax
  checks `sys.modules` after a decode);
- no C or CUDA source of the port includes a file outside
  `easyav1_tpu_torch/`, and the C ABI shim imports only the port's
  package (test_torch_capi.py runs it with poisoned `easyav1_tpu` and
  `jax` packages on the path);
- the port's native C session (`api.native_session`), the yardstick the
  card's smoke run holds the port to, equals the reference's native C
  path (`easyav1_tpu.api.EasyAV1` under EASYAV1_PIPE=native) frame hash
  for frame hash, and audio sample for sample, on cached fixtures with
  inter frames, audio, film grain, 10-bit samples, 128x128 superblocks
  and several tile columns.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

from easyav1_tpu import api as ref_api
from easyav1_tpu_torch.api import frame_hash, native_session

from fixtures import make_fixture
from test_torch_fixtures import SMOKE, steady

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted(str(p.relative_to(REPO)) for p in
                 (REPO / "easyav1_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imported(path):
    """Top-level names of every module a file imports."""
    tree = ast.parse((REPO / path).read_text(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES)
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "easyav1_tpu")]
    assert not bad, f"{path} imports {bad}"


PORT = REPO / "easyav1_tpu_torch"
C_SOURCES = sorted(str(p.relative_to(REPO)) for ext in ("c", "h", "cu", "cuh")
                   for p in PORT.rglob(f"*.{ext}"))
_INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)


@pytest.mark.parametrize("path", C_SOURCES)
def test_c_sources_include_only_the_port(path):
    """Every quoted #include names a file of the port, and no include
    names the JAX package or jax."""
    src = REPO / path
    includes = _INCLUDE.findall(src.read_text())
    for quote, name in includes:
        assert "easyav1_tpu/" not in name and "jax" not in name, name
        if quote == '"':
            target = (src.parent / name).resolve()
            assert target.is_file() and PORT in target.parents, \
                f"{path} includes {name}"


def _shim_python(src):
    """The Python the shim runs through PyRun_SimpleString."""
    blocks = re.findall(r"PyRun_SimpleString\((.*?)\);", src, re.S)
    return "".join(lit.encode().decode("unicode_escape") for b in blocks
                   for lit in re.findall(r'"((?:[^"\\]|\\.)*)"', b))


def test_shim_imports_only_the_port():
    from easyav1_tpu_torch.capi import bridge

    src = (PORT / "capi" / "easyav1_capi.c").read_text()
    assert re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src) == [
        "easyav1_tpu_torch.capi.bridge"]
    code = _shim_python(src)
    imported = {a.name for n in ast.walk(ast.parse(code))
                if isinstance(n, ast.Import) for a in n.names}
    assert imported == {"os", "sys"}
    # the sys.path search looks for the port's package, and only for it
    assert re.findall(r"os\.path\.join\(c, '(\w+)'\)", code) == [
        "easyav1_tpu_torch"]
    # every bridge function the C side calls by name is there
    called = set(re.findall(r'g_bridge, "(\w+)"', src)) | set(
        re.findall(r'call_ll1?\(h, "(\w+)"', src))
    assert len(called) > 30
    assert not [n for n in called if not callable(getattr(bridge, n, None))]


def test_scan_sees_the_port():
    assert len(SOURCES) > 40
    assert len(C_SOURCES) > 20
    assert "easyav1_tpu_torch/capi/easyav1_capi.c" in C_SOURCES
    assert "torch" in set(m.split(".")[0] for m in
                          _imported("easyav1_tpu_torch/api.py"))


# the deblocking and CDEF kernels and the modules that launch them
POSTFILTER_KERNELS = ["easyav1_tpu_torch/csrc/loopfilter.cu",
                      "easyav1_tpu_torch/csrc/cdef.cu"]
POSTFILTER_MODULES = ["easyav1_tpu_torch/video/av1/recon/lf_torch.py",
                      "easyav1_tpu_torch/video/av1/recon/cdef_torch.py",
                      "easyav1_tpu_torch/video/av1/recon/postfilter.py",
                      "easyav1_tpu_torch/video/av1/recon/postfilter_torch.py"]


@pytest.mark.parametrize("path", POSTFILTER_KERNELS + POSTFILTER_MODULES)
def test_scans_cover_the_postfilter_kernels(path):
    if path.endswith(".cu"):
        assert path in C_SOURCES
        test_c_sources_include_only_the_port(path)
        # a kernel source of the port includes the CUDA runtime and C
        # headers, and nothing else
        assert {n for _q, n in _INCLUDE.findall((REPO / path).read_text())} \
            <= {"cuda_runtime.h", "stdint.h"}
    else:
        assert path in SOURCES
        test_no_import_of_jax_or_the_jax_package(path)


def _gop4():
    from test_torch_pipe import _gop4_fixture
    return _gop4_fixture()


def _grain():
    from test_frame_parallel import _fixture
    return steady(_fixture, "grain", w=160, h=128, frames=8, gop=8, crf=30,
                  **{"vopt:denoise-noise-level": 12})


def _sb128_tiles4():
    from test_av1_multitg import _fixture
    return steady(_fixture, 640, 360, 3, 100, 2, tile_cols=2,
                  tile_rows=0)[0]


# each made as the helper of the test named beside it makes it, under the
# port's own names (test_torch_fixtures.steady), or committed
FIXTURES = {
    "gop4": _gop4,                          # test_torch_pipe.py
    "audio": lambda: steady(make_fixture, frames=8, audio_secs=1.0, w=96,
                            h=96, fps=10, gop=1),   # test_capi.py
    "grain": _grain,                        # test_frame_parallel.py
    # test_av1_hbd.py's hbd_10p, committed
    "10bit_inter": lambda: SMOKE / "hbd_10p.webm",
    "sb128_tiles4": _sb128_tiles4,          # test_av1_multitg.py
}


def _session(make):
    """(frame hashes, audio frames) of a whole session."""
    av = make()
    hashes, audio = [], []
    try:
        for _ in range(256):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                hashes.append(frame_hash(av.get_video_frame().data))
            a = av.get_audio_frame()
            if a is not None:
                audio.append((a.timestamp, a.samples,
                              np.concatenate([np.ravel(c) for c in a.pcm])))
        assert av.is_finished() and not av.get_status().is_error
    finally:
        av.close()
    return hashes, audio


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_native_session_equals_reference_native(name, monkeypatch):
    path = str(FIXTURES[name]())
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    # the reference's frame-parallel branch is not a steady yardstick
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
    want = _session(lambda: ref_api.EasyAV1(path))
    got = _session(lambda: native_session(path))
    assert len(got[0]) == len(want[0]) > 0
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    assert (len(got[1]) > 0) == (name == "audio")
    for (ta, na, pa), (tb, nb, pb) in zip(got[1], want[1]):
        assert (ta, na) == (tb, nb)
        assert np.array_equal(pa, pb)

