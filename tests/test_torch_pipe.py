"""The port end to end through its public API, on the CPU.

`easyav1_tpu_torch.EasyAV1(..., device="cpu")` runs the plain torch
versions of the kernels.  Held against the dav1d oracle, the JAX device
pipe (EASYAV1_PIPE=pallas) and the native C path, with the frame and
fallback counts asserted, and against the routes that would silently
take frames around the port: the frame-parallel branch, EASYAV1_PIPE,
and a CPU fallback when no card is there.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import easyav1_tpu_torch
from easyav1_tpu import api as ref_api
from easyav1_tpu.container.webm import TrackInfo
from easyav1_tpu.settings import EasyAV1Status
from easyav1_tpu.video.av1.backend import AV1Backend
from easyav1_tpu_torch.video.av1.backend import TorchAV1Backend

from fixtures import CACHE, tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cached(prefix, args_tail, oracle=True):
    """A stream of the fixture cache, made as test_av1_filter_intra.py
    makes it (same arguments, same name)."""
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"{prefix}_{phash}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)] + args_tail,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    if oracle and not out.with_suffix(".yuv").exists():
        subprocess.run([str(tool("oracle")), str(out),
                        str(CACHE / out.stem)], check=True,
                       capture_output=True)
    return out


def _fi_fixture(cpu, w, h):
    return _cached("fi", [
        f"w={w}", f"h={h}", "fps=10", "frames=3", "gop=1", "crf=30",
        "audio_secs=0", f"cpu-used={cpu}", "vopt:enable-restoration=0",
        "vopt:enable-palette=0", "vopt:enable-intrabc=0",
        "vopt:lag-in-frames=0"])


def _gop4_fixture():
    return _cached("fii", [
        "w=128", "h=96", "fps=10", "frames=4", "gop=4", "crf=30",
        "audio_secs=0", "cpu-used=4", "vopt:enable-restoration=0",
        "vopt:enable-palette=0", "vopt:enable-intrabc=0",
        "vopt:lag-in-frames=0"], oracle=False)


def _decode(make):
    """Every video frame of a session, as copied planes."""
    av = make()
    frames = []
    try:
        for _ in range(256):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                f = av.get_video_frame()
                frames.append([np.array(p, copy=True) for p in f.data])
        assert av.get_status() == EasyAV1Status.FINISHED, av.get_status()
    finally:
        av.close()
    return frames


def _port(path):
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    return _decode(lambda: easyav1_tpu_torch.EasyAV1(str(path),
                                                     device="cpu"))


def _assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for k, (fa, fb) in enumerate(zip(got, want)):
        for p, (a, b) in enumerate(zip(fa, fb)):
            assert np.array_equal(a, b), f"frame {k} plane {p}"


@pytest.mark.parametrize("cpu,w,h", [(4, 96, 96), (5, 94, 98)])
def test_filter_intra_vs_dav1d_and_pallas(cpu, w, h, monkeypatch):
    path = _fi_fixture(cpu, w, h)
    # the reference backend would take the frame-parallel C branch here
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "1")
    got = _port(path)
    assert easyav1_tpu_torch.stats == {"frames": 3, "fallbacks": 0}

    raw = np.fromfile(path.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    per = w * h + 2 * cw * ch
    oracle = []
    for k in range(len(got)):
        b = k * per
        oracle.append([raw[b:b + w * h].reshape(h, w),
                       raw[b + w * h:b + w * h + cw * ch].reshape(ch, cw),
                       raw[b + w * h + cw * ch:b + per].reshape(ch, cw)])
    _assert_frames_equal(got, oracle)

    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    _assert_frames_equal(got, _decode(lambda: ref_api.EasyAV1(str(path))))


def test_gop4_key_frame_then_counted_fallbacks(monkeypatch):
    """Key frame through the port; the three inter frames are declined
    to the C recon, which reads the port's uint16 refs."""
    path = _gop4_fixture()
    got = _port(path)
    assert easyav1_tpu_torch.stats == {"frames": 4, "fallbacks": 3}
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    _assert_frames_equal(got, _decode(lambda: ref_api.EasyAV1(str(path))))


@pytest.mark.parametrize("tag,kv,fallbacks", [
    ("444i", {"ss": 444}, 1),         # the frame with chroma CfL
    ("422i", {"ss": 422}, 0),
    ("monoi", {"ss": "mono"}, 0),
    ("10i", {"bitdepth": 10}, 4),     # the slice is 8-bit
])
def test_formats_run_or_decline_exactly(tag, kv, fallbacks, monkeypatch):
    """Non-4:2:0 CfL and bit depths above 8 are declined; every frame,
    run or declined, equals the native decode."""
    from test_av1_hbd import BASE, fixture

    path = fixture(tag, **BASE, gop=1, **kv)
    got = _port(path)
    assert easyav1_tpu_torch.stats == {"frames": 4, "fallbacks": fallbacks}
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    _assert_frames_equal(got, _decode(lambda: ref_api.EasyAV1(str(path))))


def _synthetic_frame(tu, monkeypatch):
    """One synthetic temporal unit through the port's backend (cpu) and
    through the native one."""
    track = TrackInfo(number=1, type=None, codec_id="V_AV1")
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = [[np.array(p, copy=True) for p in f.data] for f in
           TorchAV1Backend(track, torch.device("cpu")).decode([tu], 0)]
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    want = [[np.array(p, copy=True) for p in f.data] for f in
            AV1Backend(track).decode([tu], 0)]
    _assert_frames_equal(got, want)
    return dict(easyav1_tpu_torch.stats)


def test_palette_with_residual_runs_on_port(monkeypatch):
    """Palette prediction folded into the residual (cls-10 units)."""
    from test_av1_palette_synth import W, H, _fillers
    from easyav1_tpu.video.av1 import constants as C
    from easyav1_tpu.video.av1.av1_enc import EncBlock, encode_frame

    m = np.random.default_rng(3).integers(0, 4, (16, 16)).astype(np.int32)
    blk = EncBlock(r=0, c=0, bsize=C.BLOCK_16X16, skip=False,
                   palette_y=([40, 90, 160, 220], m),
                   luma_coeffs=[[(3, 0), (2, 1), (1, 0)]])
    blocks = [blk] + _fillers({(r, c) for r in (0, 2) for c in (0, 2)})
    tu = encode_frame(W, H, 60, blocks, adapt=True, screen=True)
    assert _synthetic_frame(tu, monkeypatch) == {"frames": 1,
                                                 "fallbacks": 0}


def test_intrabc_frame_is_declined(monkeypatch):
    """allow_intrabc frames go to the C recon (the scan executor is the
    next slice), exactly."""
    import test_av1_intrabc as TI
    from easyav1_tpu.video.av1 import constants as C

    blocks = TI._intra_fill(np.random.default_rng(3), 48)
    dv = (-48 * 4 * 8, 0)
    assert TI.dv_valid(48, 0, C.BLOCK_16X16, dv)
    blocks.append(TI.EncBlock(r=48, c=0, bsize=C.BLOCK_16X16, skip=True,
                              dv=dv))
    for r in range(48, TI.H // 4, 4):
        for c in range(0, TI.W // 4, 4):
            if (r, c) != (48, 0):
                blocks.append(TI.EncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                          skip=True))
    tu = TI.encode_frame(TI.W, TI.H, 60, blocks, intrabc=True)
    assert _synthetic_frame(tu, monkeypatch) == {"frames": 1,
                                                 "fallbacks": 1}


def test_port_never_imports_jax():
    """In a fresh process (this one has jax: tests/conftest.py imports
    it), decode with EASYAV1_PIPE=pallas set, which would route the
    reference's frames into JAX."""
    script = (
        "import json, sys\n"
        "import easyav1_tpu_torch as T\n"
        f"av = T.EasyAV1({str(_gop4_fixture())!r}, device='cpu')\n"
        "n = 0\n"
        "while not av.is_finished() and n < 64:\n"
        "    av.decode_next()\n"
        "    while av.has_video_frame():\n"
        "        av.get_video_frame(); n += 1\n"
        "av.close()\n"
        "print(json.dumps({'n': n, 'stats': T.stats,\n"
        "                  'jax': 'jax' in sys.modules}))\n")
    env = dict(os.environ, EASYAV1_PIPE="pallas", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res == {"n": 4, "stats": {"frames": 4, "fallbacks": 3},
                   "jax": False}


def test_cuda_device_without_card_raises(monkeypatch):
    """device="cuda" never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        easyav1_tpu_torch.EasyAV1(str(_gop4_fixture()), device="cuda")


@pytest.mark.parametrize("tag,w,h,crf,frames,extra", [
    ("64hiq", 64, 64, 10, 1, ()),
    ("oddcdef", 84, 52, 30, 2, ("vopt:enable-restoration=0",
                                "vopt:enable-palette=0",
                                "vopt:enable-filter-intra=0",
                                "vopt:enable-cdef=1")),
])
def test_first_frame_inputs_vs_native(tag, w, h, crf, frames, extra,
                                      monkeypatch):
    """The first-frame export that the card's smoke run holds the kernel
    on: recon, then the split postfilter (host maps, device filters) on
    maps snapshotted before a later decode, equals the native first frame
    plane for plane and by frame hash."""
    from easyav1_tpu_torch.api import frame_hash, native_session
    from easyav1_tpu_torch.native import first_frame_inputs
    from easyav1_tpu_torch.video.av1.recon.postfilter import (
        postfilter_apply, postfilter_maps)
    from test_av1_real import real_fixture

    path, _ = real_fixture(tag, w, h, crf, frames, extra)
    key = first_frame_inputs(str(path), torch.device("cpu"))
    assert key is not None and key["units"] > 0
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    want = _decode(lambda: native_session(str(path)))[0]
    planes = key["recon"].launch(key["fields"], key["resid"])
    planes = postfilter_apply(planes, postfilter_maps(
        key["hdr"], key["seq"], key["recon"].dims, *key["maps"], "cpu"))
    got = [d[:b.shape[0], :b.shape[1]].to(torch.uint8).numpy()
           for d, b in zip(planes, want)]
    _assert_frames_equal([got], [want])
    assert frame_hash(got) == frame_hash(want)


def test_native_session_refuses_other_pipes(monkeypatch):
    from easyav1_tpu_torch.api import native_session

    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    with pytest.raises(RuntimeError, match="native C path"):
        native_session(str(_gop4_fixture()))
