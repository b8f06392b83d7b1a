"""The port's API surface on its device pipe, on the CPU (ROADMAP C6).

`tests/test_api_video.py` drives seeks, `decode_until` and `play` on the
JAX package; these cases drive the same calls on
`easyav1_tpu_torch.EasyAV1(device="cpu")` with the host residual
composer, with the device composer and with resident frames, on the
same fixture (320x180, 20 frames, gop 10, audio), through
`test_torch_fixtures.steady`.  Every frame must equal the dav1d oracle
and the port's native C session driven the same way, with no fallback.
These are the calls the C ABI makes (`capi/bridge.py`).
"""

import time

import numpy as np
import pytest

import easyav1_tpu_torch
from easyav1_tpu_torch.api import native_session
from easyav1_tpu_torch.settings import EasyAV1Settings

from fixtures import Golden, make_fixture, oracle_decode
from test_torch_fixtures import steady

FPS = 10
# the device sessions: the host C composer, the device composer, and
# frames kept on the device until they are indexed
SESSIONS = {"host composer": {},
            "device composer": {"host_residual": False},
            "resident": {"resident": True}}


def _av_fixture():
    fx = make_fixture(w=320, h=180, fps=FPS, frames=20, gop=10, crf=35,
                      audio_secs=2, content=1)
    return fx, oracle_decode(fx).prefix


def _fixture():
    fx, prefix = steady(_av_fixture)
    return str(fx), Golden(prefix).video_frames()


def _frame(fr, golden):
    """(frame index, planes) of a pulled frame, its planes equal to the
    oracle's."""
    k = round(fr.timestamp * FPS / 1000)
    assert 0 <= k < len(golden), fr.timestamp
    planes = [np.array(p) for p in fr.data]
    for p, name in zip(planes, "yuv"):
        assert np.array_equal(p, golden[k][name]), f"frame {k} {name}"
    return k, planes


def _port(session, settings=None):
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    return easyav1_tpu_torch.EasyAV1(_fixture()[0], settings, device="cpu",
                                     **SESSIONS[session])


def _assert_no_fallback():
    assert easyav1_tpu_torch.stats["frames"] > 0
    assert easyav1_tpu_torch.stats["fallbacks"] == 0


def _after_seek(av, golden, n=5):
    """The first n frames after a seek to 1,500 ms."""
    got = []
    try:
        assert av.seek_to_timestamp(1500) == 1
        for _ in range(100):
            if av.is_finished() or len(got) == n:
                break
            av.decode_next()
            if av.has_video_frame():
                got.append(_frame(av.get_video_frame(), golden))
    finally:
        av.close()
    return got


@pytest.mark.parametrize("session", SESSIONS)
@pytest.mark.parametrize("fast,first", [(False, 15), (True, 10)])
def test_seek_exact_and_fast(session, fast, first, monkeypatch):
    """The exact seek lands on frame 15, the fast one on the key frame
    before it (gop 10), as on the native session."""
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    path, golden = _fixture()
    settings = EasyAV1Settings(use_fast_seeking=fast)
    want = _after_seek(native_session(path, settings), golden)
    got = _after_seek(_port(session, settings), golden)
    _assert_no_fallback()
    assert [k for k, _ in got] == list(range(first, first + 5))
    assert [k for k, _ in want] == [k for k, _ in got]
    for (k, a), (_, b) in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), k


def _until(av, golden, ts=950):
    try:
        assert av.decode_until(ts) == 1
        got = []
        while av.has_video_frame():
            got.append(_frame(av.get_video_frame(), golden))
    finally:
        av.close()
    return got


@pytest.mark.parametrize("session", SESSIONS)
def test_decode_until(session, monkeypatch):
    """decode_until(950) decodes the first ten frames; the frames it
    leaves to pull are the native session's."""
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    path, golden = _fixture()
    want = _until(native_session(path), golden)
    got = _until(_port(session), golden)
    _assert_no_fallback()
    assert easyav1_tpu_torch.stats["frames"] == 10
    assert got and [k for k, _ in got] == [k for k, _ in want]
    assert got[-1][0] == 9
    for (k, a), (_, b) in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), k


def test_play_smoke():
    """play() paces decode on its own thread against the wall clock:
    frames come out in order, each equal to the oracle.  Every frame is
    decoded (skip_unprocessed_frames off): in latest-only mode a session
    more than a second behind the clock seeks ahead, and how far it falls
    behind on the CPU depends on the host's load.  The reader polls
    while the playback thread decodes (a reader that waited for the
    decode thread to go idle saw it busy for as long as play() was behind
    the clock, while the ring of 11 dropped the frames it came for), and
    takes the frames still queued when the stream has ended."""
    _path, golden = _fixture()
    av = _port("host composer",
               EasyAV1Settings(skip_unprocessed_frames=False))
    seen = []
    try:
        assert av.play() == 1
        t0 = time.time()
        while time.time() - t0 < 60.0 and len(seen) < 8:
            fr = av.get_video_frame() if av.has_video_frame() else None
            if fr is not None:
                seen.append(_frame(fr, golden)[0])
            elif av.is_finished() and not av.has_video_frame():
                break
            else:
                time.sleep(0.01)
        av.stop()
        assert not av.is_playing()
    finally:
        av.close()
    _assert_no_fallback()
    assert seen == list(range(8)), seen
