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
from easyav1_tpu_torch.video.av1.backend import AV1Backend as TorchAV1Backend

from fixtures import CACHE, tool
from test_torch_fixtures import smoke_oracle, steady

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cached(prefix, args_tail, oracle=True):
    """A stream made with test_av1_filter_intra.py's arguments, and
    dav1d's decode of it (oracle); run under `steady`."""
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
    return steady(_cached, "fi", [
        f"w={w}", f"h={h}", "fps=10", "frames=3", "gop=1", "crf=30",
        "audio_secs=0", f"cpu-used={cpu}", "vopt:enable-restoration=0",
        "vopt:enable-palette=0", "vopt:enable-intrabc=0",
        "vopt:lag-in-frames=0"])


def _gop4_fixture():
    return steady(_cached, "fii", [
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


def _reference_native(path, monkeypatch):
    """Every frame of the reference's native C path, frame by frame: its
    frame-parallel branch (the default for streams with inter frames) is
    not a steady yardstick."""
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
    return _decode(lambda: ref_api.EasyAV1(str(path)))


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
    """Key frame and the three inter frames through the port, no
    fallback: MC reads the port's device references."""
    path = _gop4_fixture()
    got = _port(path)
    assert easyav1_tpu_torch.stats == {"frames": 4, "fallbacks": 0}
    _assert_frames_equal(got, _reference_native(path, monkeypatch))


@pytest.mark.parametrize("declined", [None, 2])
def test_gop4_references_cross_between_device_and_c(declined, monkeypatch):
    """With inter frame `declined` (1-based) refused by InterRecon, the
    C recon reads the references the device made (their host planes made
    from the display copies, there and only there), and the next inter
    frame's MC reads the one the C recon made, uploaded at its first
    use.  Every frame equals the native decode."""
    from easyav1_tpu_torch.native import pipe
    from easyav1_tpu_torch.video.av1.recon.inter_exec import InterRecon

    calls, made = [], {"host": 0, "upload": 0}
    prepare, host, tensor = (InterRecon.prepare, pipe.DevRef.host,
                             pipe.DevRef.tensor)

    def decline(self, *a, **k):
        calls.append(1)
        return None if len(calls) == declined else prepare(self, *a, **k)

    def spy_host(self):
        made["host"] += self._host is None
        return host(self)

    def spy_tensor(self, device):
        made["upload"] += self._dev is None
        return tensor(self, device)

    monkeypatch.setattr(InterRecon, "prepare", decline)
    monkeypatch.setattr(pipe.DevRef, "host", spy_host)
    monkeypatch.setattr(pipe.DevRef, "tensor", spy_tensor)
    path = _gop4_fixture()
    got = _port(path)
    assert len(calls) == 3
    assert easyav1_tpu_torch.stats == {"frames": 4,
                                       "fallbacks": int(declined is not None)}
    if declined is None:
        assert made == {"host": 0, "upload": 0}
    else:
        assert made["host"] > 0 and made["upload"] > 0, made
    _assert_frames_equal(got, _reference_native(path, monkeypatch))


@pytest.mark.parametrize("tag,kv,fallbacks", [
    ("444i", {"ss": 444}, 1),         # the frame with chroma CfL
    ("422i", {"ss": 422}, 0),
    ("monoi", {"ss": "mono"}, 0),
    ("10i", {"bitdepth": 10}, 0),     # 10-bit frames run on the device
])
def test_formats_run_or_decline_exactly(tag, kv, fallbacks, monkeypatch):
    """Non-4:2:0 CfL is declined, 10-bit frames run; every frame, run or
    declined, equals the native decode."""
    from test_av1_hbd import BASE, fixture

    path = steady(fixture, tag, **BASE, gop=1, **kv)
    got = _port(path)
    assert easyav1_tpu_torch.stats == {"frames": 4, "fallbacks": fallbacks}
    _assert_frames_equal(got, _reference_native(path, monkeypatch))


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
    """allow_intrabc frames run on the port, under the sequential
    schedule, exactly as the native recon."""
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
                                                 "fallbacks": 0}


def test_port_never_imports_jax():
    """In a fresh process (this one has jax: tests/conftest.py imports
    it), decode through the port on the CPU, with EASYAV1_PIPE=pallas
    set, which would route the reference's frames into JAX, and a stream
    with audio through the port and through its native C session: no
    module of jax or of the JAX package (easyav1_tpu) is imported."""
    from fixtures import make_fixture

    audio = steady(make_fixture, frames=8, audio_secs=1.0, w=96, h=96,
                   fps=10, gop=1)
    script = (
        "import json, os, sys\n"
        "import easyav1_tpu_torch as T\n"
        "from easyav1_tpu_torch.api import native_session\n"
        "def run(av):\n"
        "    n = a = 0\n"
        "    while not av.is_finished() and n < 64:\n"
        "        av.decode_next()\n"
        "        while av.has_video_frame():\n"
        "            av.get_video_frame(); n += 1\n"
        "        a += av.get_audio_frame() is not None\n"
        "    av.close()\n"
        "    return n, a > 0\n"
        f"res = {{'gop4': run(T.EasyAV1({str(_gop4_fixture())!r}, "
        "device='cpu'))}\n"
        "res['stats'] = dict(T.stats)\n"
        "os.environ['EASYAV1_PIPE'] = 'native'\n"
        f"res['audio'] = run(T.EasyAV1({str(audio)!r}, device='cpu'))\n"
        f"res['native'] = run(native_session({str(audio)!r}))\n"
        "res['jax'] = sorted(m for m in sys.modules\n"
        "                    if m.split('.')[0] in ('jax', 'easyav1_tpu'))\n"
        "print(json.dumps(res))\n")
    env = dict(os.environ, EASYAV1_PIPE="pallas", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res == {"gop4": [4, False],
                   "stats": {"frames": 4, "fallbacks": 0},
                   "audio": [8, True], "native": [8, True], "jax": []}


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
    from easyav1_tpu_torch.native.pipe import first_frame_inputs
    from easyav1_tpu_torch.video.av1.recon.postfilter import (
        postfilter_apply, postfilter_maps)
    from test_av1_real import real_fixture

    path, _ = steady(real_fixture, tag, w, h, crf, frames, extra)
    key = first_frame_inputs(str(path), torch.device("cpu"))
    assert key is not None and key["units"] > 0
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    want = _decode(lambda: native_session(str(path)))[0]
    planes = key["recon"].launch(key["fields"], key["resid"],
                                 key["schedule"])
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


# ---- superres, loop restoration and film grain frames on the port

SMOKE = os.path.join(REPO, "tests", "data", "smoke")
# in-repo streams: (file, frames, also held against the JAX device pipe).
# The JAX package's decoder counts a superres frame's restoration unit
# columns in coded pixels (right for one unit column only), so the wide
# superres stream is held against dav1d and the native C session alone.
NEW_SMOKE = [("lreal_mix_e8bf32ba.webm", 1, True),
             ("lreal_interlr_863022fc.webm", 4, True),
             ("fgreal_7cdd830f.webm", 2, True),
             ("superres_lr_88x64.webm", 3, True),
             ("superres_lr_1920x128.webm", 3, False)]


def _dav1d_frames(path, tag):
    """Every frame of a stream of tests/data/smoke/ as the dav1d oracle
    tool decodes it."""
    prefix = smoke_oracle(os.path.basename(path))
    meta = json.loads(prefix.with_suffix(".json").read_text())
    w, h = meta["width"], meta["height"]
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    per = w * h + 2 * cw * ch
    return [[raw[b:b + w * h].reshape(h, w),
             raw[b + w * h:b + w * h + cw * ch].reshape(ch, cw),
             raw[b + w * h + cw * ch:b + per].reshape(ch, cw)]
            for b in range(0, meta["vframes"] * per, per)]


def _jax_pipe(path, monkeypatch):
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    return _decode(lambda: ref_api.EasyAV1(str(path)))


@pytest.mark.parametrize("name,n,jax_pipe", NEW_SMOKE)
def test_sr_lr_grain_smoke_streams(name, n, jax_pipe, monkeypatch):
    """The in-repo streams with loop restoration (Wiener, SGR,
    intra and inter), film grain and superres: no fallback, every plane
    equal to the port's native C session, to dav1d and to the JAX
    device pipe."""
    from easyav1_tpu_torch.api import native_session

    path = os.path.join(SMOKE, name)
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    got = _port(path)
    assert easyav1_tpu_torch.stats == {"frames": n, "fallbacks": 0}
    _assert_frames_equal(got, _decode(lambda: native_session(path)))
    _assert_frames_equal(got, _dav1d_frames(path, name.split(".")[0]))
    if jax_pipe:
        _assert_frames_equal(got, _jax_pipe(path, monkeypatch))


@pytest.mark.parametrize("tag,w,h,crf,extra", [
    ("sgr", 96, 96, 30, ()),
    ("wiener", 200, 320, 18, ()),
    ("noise", 160, 160, 35, ("content=1",)),
])
def test_lr_cached_streams(tag, w, h, crf, extra, monkeypatch):
    """The libaom loop-restoration key frames of test_av1_lr_real.py
    through the port: no fallback, equal to dav1d, to the native C
    session and (the small ones) to the JAX device pipe."""
    from easyav1_tpu_torch.api import native_session
    from test_av1_lr_real import lr_fixture

    path, prefix = steady(lr_fixture, tag, w, h, crf, 1, extra)
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    got = _port(path)
    assert easyav1_tpu_torch.stats == {"frames": 1, "fallbacks": 0}
    _assert_frames_equal(got, _decode(lambda: native_session(str(path))))
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    _assert_frames_equal(got, [[
        raw[:w * h].reshape(h, w),
        raw[w * h:w * h + cw * ch].reshape(ch, cw),
        raw[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)]])
    if tag != "wiener":
        _assert_frames_equal(got, _jax_pipe(path, monkeypatch))


def _superres_tu(w, h, denom, seed=7, **kw):
    from easyav1_tpu.video.av1.av1_enc import encode_frame
    from test_av1_lr import blocks_with_texture

    wd = (w * 8 + denom // 2) // denom
    return encode_frame(w, h, 60, blocks_with_texture(
        2 * ((wd + 7) >> 3), 2 * ((h + 7) >> 3), seed),
        superres_denom=denom, **kw)


SR_CASES = {
    "d9": (72, 64, 9, {}),
    "d13": (104, 64, 13, {}),
    "d16": (128, 64, 16, {}),
    "unaligned": (64, 64, 9, {}),             # coded width 57
    "wide": (192, 64, 16, {}),
    "lf": (96, 64, 12, {"lf_levels": (24, 20)}),
    "cdef": (120, 64, 15, {"cdef": (3, [(4, 2, 3, 1)])}),
    "lr": (88, 64, 11, {"lr": [2, 0, 0], "lr_units": {
        (0, 0, 0): ("wiener", [[2, -5, 20], [-1, 3, 10]])}}),
    "lf_cdef_lr": (88, 64, 11, {"lr": [2, 0, 0], "lr_units": {
        (0, 0, 0): ("wiener", [[2, -5, 20], [-1, 3, 10]])},
        "lf_levels": (10, 8), "cdef": (3, [(4, 2, 3, 1)])}),
    "sgr": (88, 64, 11, {"lr": [3, 0, 0], "lr_units": {
        (0, 0, 0): ("sgr", 4, 12, 30)}, "lf_levels": (10, 8)}),
}


@pytest.mark.parametrize("case", list(SR_CASES))
def test_superres_synthetic_frames(case, monkeypatch):
    """Synthetic superres key frames (the cases of test_av1_superres.py)
    through the port's backend: no fallback, the upscaled size, equal to
    the reference's native C recon and to dav1d."""
    from av1_synth import dav1d_decode_ivf
    from easyav1_tpu.video.av1.av1_enc import make_ivf

    w, h, denom, kw = SR_CASES[case]
    tu = _superres_tu(w, h, denom, seed=denom, **kw)
    assert _synthetic_frame(tu, monkeypatch) == {"frames": 1, "fallbacks": 0}
    got = [np.array(p) for p in TorchAV1Backend(
        TrackInfo(number=1, type=None, codec_id="V_AV1"),
        torch.device("cpu")).decode([tu], 0)[0].data]
    assert got[0].shape == (h, w)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), f"torch_sr_{case}")[0]
    _assert_frames_equal([got], [[dav["y"], dav["u"], dav["v"]]])


def test_superres_frame_vs_jax_pipe(monkeypatch):
    """One superres frame with LF, CDEF and LR against the JAX device
    pipe on the same temporal unit."""
    w, h, denom, kw = SR_CASES["lf_cdef_lr"]
    tu = _superres_tu(w, h, denom, **kw)
    track = TrackInfo(number=1, type=None, codec_id="V_AV1")
    got = [np.array(p) for p in TorchAV1Backend(
        track, torch.device("cpu")).decode([tu], 0)[0].data]
    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    want = [np.array(p) for p in AV1Backend(track).decode([tu], 0)[0].data]
    _assert_frames_equal([got], [want])


def test_film_grain_runs_on_the_device_and_spares_the_references(
        monkeypatch):
    """A grain frame the port covers gets its grain from fg_torch on a
    copy: host C grain is not called, and the reference planes the next
    frame would read are the planes without grain."""
    from easyav1_tpu_torch import native as tnat
    from easyav1_tpu_torch.api import native_session
    from easyav1_tpu_torch.native import pipe

    def no_host_grain(*a, **k):
        raise AssertionError("host C grain called for a device frame")

    path = os.path.join(SMOKE, "fgreal_7cdd830f.webm")
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    want = _decode(lambda: native_session(path))
    refs = []
    tail = pipe._tail

    def spy_tail(*a, **k):
        planes, triples = tail(*a, **k)
        refs.append(([t[0].tensor(torch.device("cpu")).numpy().copy()
                      for t in triples],
                     [np.array(p) for p in planes]))
        return planes, triples

    monkeypatch.setattr(tnat, "film_grain_native", no_host_grain)
    monkeypatch.setattr(pipe, "_tail", spy_tail)
    got = _port(path)
    _assert_frames_equal(got, want)
    assert len(refs) == 2
    for clean, shown in refs:
        assert any(not np.array_equal(a, b) for a, b in zip(clean, shown))
    # the references are the frames as decoded without grain
    hdr_off = pipe._tail
    monkeypatch.setattr(pipe, "_tail", lambda dev, seq, hdr, resident, grain,
                        clock: tail(dev, seq, hdr, resident, None, clock))
    bare = _port(path)
    monkeypatch.setattr(pipe, "_tail", hdr_off)
    _assert_frames_equal([c for c, _ in refs], bare)


def test_covers_declines_only_high_bit_depth():
    from types import SimpleNamespace as NS
    from easyav1_tpu_torch.native.pipe import covers

    # every bit depth of AV1 runs, superres, LR and grain too; only a
    # depth the kernels have no instantiation for is declined
    hdr = NS(use_superres=True, lr=NS(uses_lr=True),
             film_grain=NS(apply_grain=True))
    for bd in (8, 10, 12):
        assert covers(NS(color=NS(bitdepth=bd)), hdr)
        assert covers(NS(color=NS(bitdepth=bd)), NS())
    assert not covers(NS(color=NS(bitdepth=16)), hdr)


@pytest.mark.parametrize("tag,w,h,crf,extra,lf_off", [
    ("oddcdef", 84, 52, 30, "odd", False),      # LF and CDEF on
    ("odd", 66, 50, 30, "none", False),         # LF on, CDEF off
    ("64hiq", 64, 64, 10, "none", False),
    ("neardflt", 96, 96, 30, "near", False),    # LF off as coded, CDEF on
    ("oddcdef", 84, 52, 30, "odd", True),       # LF forced off
])
def test_want_deblocked_vs_jax(tag, w, h, crf, extra, lf_off):
    """`postfilter_frame(want_deblocked=True)`: the planes after LF and
    before CDEF equal `postfilter_fused.postfilter_frame`'s; with LF off
    the snapshot is the input planes, and CDEF never writes it."""
    from easyav1_tpu.video.av1.recon.postfilter_fused import \
        postfilter_frame as postfilter_jax
    from easyav1_tpu_torch.video.av1.recon.postfilter import postfilter_frame
    from test_av1_real import NEAR_DEFAULT
    from test_torch_postfilter import ODD_CDEF, _raw_frame

    extra = {"near": tuple(NEAR_DEFAULT), "none": (), "odd": ODD_CDEF}[extra]
    seq, hdr, raw, (grids_for, skip, cdef_idx) = _raw_frame(
        tag, w, h, crf, extra, 2 if tag == "oddcdef" else 1)
    if lf_off:
        hdr.lf.level = [0, 0, 0, 0]
    lf_on = any(hdr.lf.level[:2])
    assert lf_on == (tag != "neardflt" and not lf_off)
    want, want_d = postfilter_jax([r.copy() for r in raw], hdr, seq,
                                  grids_for, skip, cdef_idx,
                                  want_deblocked=True)
    tin = [torch.from_numpy(r.copy()) for r in raw]
    got, got_d = postfilter_frame(tin, hdr, seq, grids_for, skip, cdef_idx,
                                  want_deblocked=True)
    for p in range(3):
        assert np.array_equal(got[p].numpy(), np.asarray(want[p])), p
        assert np.array_equal(got_d[p].numpy(), np.asarray(want_d[p])), p
        assert np.array_equal(tin[p].numpy(), raw[p]), "input written"
    if not lf_on:
        assert all(np.array_equal(d.numpy(), r) for d, r in zip(got_d, raw))
    else:
        assert any(not np.array_equal(d.numpy(), r)
                   for d, r in zip(got_d, raw))
    # where CDEF changed a plane it left the snapshot alone
    cdef_on = max(hdr.cdef.y_pri_strength + hdr.cdef.y_sec_strength) > 0
    assert cdef_on == any(not torch.equal(a, b) for a, b in zip(got, got_d))
