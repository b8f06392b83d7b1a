"""The port's C ABI (`easyav1_tpu_torch/capi/`) end to end, on the CPU.

The port's client, `capi/capi_smoke.c`, is built with gcc against the
port's shim and run with `EASYAV1_TORCH_DEVICE=cpu` (the kernels' plain
torch versions) on `test_capi.py`'s fixture, through each pipe that
`EASYAV1_PIPE` names.  It must behave as the JAX package's client does
(`test_capi.py::test_capi_smoke`), and its frames, hashed in C, must
equal the port's native C session and the JAX package's native path.
Without the device variable, on a host with no card, init fails: the
ABI never carries on on the CPU or on the C path.  The embedded
interpreter imports nothing of the JAX package, and the port's header
declares what the JAX package's declares.
"""

import os
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

from easyav1_tpu import api as ref_api
from easyav1_tpu_torch import capi
from easyav1_tpu_torch.api import frame_hash, native_session

from fixtures import make_fixture
from test_torch_fixtures import SMOKE, steady

REPO = Path(__file__).resolve().parent.parent


def _fixture():
    """test_capi.py's fixture: 8 key frames of 96x96 and a second of audio."""
    return steady(make_fixture, frames=8, audio_secs=1.0, w=96, h=96,
                  fps=10, gop=1)


def _client(path, pythonpath=(), **env):
    """Run the port's client on `path`: (returncode, key=value pairs,
    per-frame hashes, stdout, stderr).  env: variables to set, or to
    remove where the value is None."""
    _lib, client = capi.build()
    e = dict(os.environ, PYTHONPATH=os.pathsep.join([*pythonpath,
                                                     str(REPO)]))
    for k, v in env.items():
        if v is None:
            e.pop(k, None)
        else:
            e[k] = v
    r = subprocess.run([str(client), str(path)], capture_output=True,
                       text=True, env=e, timeout=300)
    kv, hashes = {}, []
    for line in r.stdout.splitlines():
        m = re.fullmatch(r"frame=(\d+) ts=\d+ hash=(\d+)", line)
        if m:
            assert int(m.group(1)) == len(hashes)
            hashes.append(int(m.group(2)))
            continue
        for part in line.split():
            if "=" in part:
                k, v = part.split("=", 1)
                kv[k] = v
    return r.returncode, kv, hashes, r.stdout, r.stderr


def _hashes(make):
    av = make()
    out = []
    try:
        for _ in range(256):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                out.append(frame_hash(av.get_video_frame().data))
    finally:
        av.close()
    return out


@pytest.mark.parametrize("pipe", ["pallas", "device", "native"])
def test_client_on_each_pipe(pipe, monkeypatch):
    path = str(_fixture())
    rc, kv, hashes, out, err = _client(path, EASYAV1_TORCH_DEVICE="cpu",
                                       EASYAV1_PIPE=pipe)
    assert rc == 0, f"stdout={out}\nstderr={err}"
    # test_capi.py::test_capi_smoke's values
    assert kv["has_video"] == "1"
    assert kv["has_audio"] == "1"
    assert kv["width"] == "96"
    assert kv["height"] == "96"
    assert kv["fps"] == "10"
    assert int(kv["duration"]) > 0
    assert kv["sample_rate"] == "48000"
    assert kv["channels"] == "2"
    assert kv["decode_status"] == "2"          # FINISHED
    assert int(kv["video_cb_frames"]) == 8
    assert int(kv["audio_cb_frames"]) > 0
    assert int(kv["luma_sum"]) > 0
    assert int(kv["frames_processed"]) == 8
    assert kv["seek_status"] == "1"
    assert kv["pull_frame"] == "1"
    assert kv["pull_w"] == "96"
    assert kv["layout"] == "2"                 # YUV420
    assert kv["mem_init"] == "1"
    assert kv["mem_width"] == "96"
    assert kv["destroyed"] == "1"
    # the rate pass: every frame, to the end
    assert (kv["rate_status"], kv["rate_frames"]) == ("2", "8")
    assert float(kv["rate_fps"]) > 0
    # the frames, hashed in C: the port's native C session's, and the
    # JAX package's native path's (frame by frame: its frame-parallel
    # branch is not a steady yardstick)
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    want = _hashes(lambda: native_session(path))
    assert hashes == want and len(want) == 8
    assert int(kv["pull_hash"]) == want[0]
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
    assert hashes == _hashes(lambda: ref_api.EasyAV1(path))


@pytest.mark.parametrize("name,depth", [("hbd_10p.webm", 10),
                                        ("inter_modes_96x96.webm", 8)])
def test_c_hash_is_api_frame_hash(name, depth):
    """The client's hash, computed in C on uint8 planes at 8 bits and on
    uint16 planes above, equals `api.frame_hash` of the same frames."""
    path = str(SMOKE / name)
    frames = []
    av = native_session(path)
    try:
        for _ in range(256):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                frames.append([np.array(p) for p in
                               av.get_video_frame().data])
    finally:
        av.close()
    assert frames[0][0].dtype == (np.uint8 if depth == 8 else np.uint16)
    rc, kv, hashes, out, err = _client(path, EASYAV1_TORCH_DEVICE="cpu",
                                       EASYAV1_PIPE="pallas")
    assert rc == 0, f"stdout={out}\nstderr={err}"
    assert hashes == [frame_hash(f) for f in frames] and len(hashes) > 1
    assert len(set(hashes)) == len(hashes)


def test_init_fails_without_a_card_or_the_cpu_request():
    """No card and no EASYAV1_TORCH_DEVICE: the port's session raises
    for its CUDA device, init returns NULL, and the client decodes
    nothing, on the CPU or on the C path."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the session would run on it")
    rc, kv, hashes, out, err = _client(_fixture(), EASYAV1_TORCH_DEVICE=None,
                                       EASYAV1_PIPE=None)
    assert rc != 0
    assert "init failed" in err and "no CUDA device" in err
    assert not kv and not hashes


def test_embedded_interpreter_never_imports_the_jax_package(tmp_path):
    """`easyav1_tpu` and `jax` packages that record and refuse any import,
    first on PYTHONPATH: the client still decodes every frame, on each
    device pipe, and neither was imported."""
    marker = tmp_path / "imported.txt"
    for pkg in ("easyav1_tpu", "jax"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "__init__.py").write_text(
            f"with open({str(marker)!r}, 'a') as f:\n"
            f"    f.write({pkg!r} + '\\n')\n"
            f"raise ImportError('the port imported {pkg}')\n")
    for pipe in ("pallas", "device"):
        rc, kv, hashes, out, err = _client(
            _fixture(), pythonpath=[str(tmp_path)],
            EASYAV1_TORCH_DEVICE="cpu", EASYAV1_PIPE=pipe)
        assert rc == 0, f"stdout={out}\nstderr={err}"
        assert len(hashes) == 8 and kv["decode_status"] == "2"
    assert not marker.exists(), marker.read_text()


def _declarations(path):
    """The header's text with its comments stripped and its whitespace
    folded: the declarations alone."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return " ".join(text.split())


def test_header_declares_what_the_jax_package_declares():
    """The same functions, structs, fields and enum values, and every
    function the header declares is exported by the port's library."""
    ours = _declarations(REPO / "easyav1_tpu_torch" / "capi" / "easyav1.h")
    theirs = _declarations(REPO / "easyav1_tpu" / "capi" / "easyav1.h")
    assert ours == theirs
    # the comparison saw the whole surface: its entry points and the
    # structs the shim fills
    functions = set(re.findall(r"\b(easyav1_\w+)\s*\(", ours))
    assert len(functions) == 34, sorted(functions)
    for name in ("easyav1_settings", "easyav1_video_frame",
                 "easyav1_audio_frame", "easyav1_status"):
        assert f"}} {name};" in ours
    lib, _client = capi.build()
    exported = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout.split()
    assert functions <= set(exported), functions - set(exported)


def test_library_and_client_are_rebuilt_when_a_source_is_newer():
    lib, client = capi.build()
    assert lib.exists() and client.exists()
    assert capi.build() == (lib, client)
    mtime = lib.stat().st_mtime
    shim = REPO / "easyav1_tpu_torch" / "capi" / "easyav1_capi.c"
    os.utime(lib, (mtime, shim.stat().st_mtime - 10))
    capi.build()
    assert lib.stat().st_mtime >= shim.stat().st_mtime
    assert client.stat().st_mtime >= lib.stat().st_mtime
