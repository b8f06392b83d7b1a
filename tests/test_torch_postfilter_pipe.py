"""The port's postfilter pipe, `EasyAV1(..., pipe="postfilter")`, on the CPU.

The counterpart of the reference's second device pipe,
`EASYAV1_PIPE=device`: the C recon with deblocking, CDEF and loop
restoration held back, then those filters, the tail and film grain on
the device; superres frames take the whole C path, counted as
fallbacks.  Held against the port's native C session on every stream,
and against the JAX package's `EASYAV1_PIPE=device` on the 8-bit ones
(above 8 bits its loop restoration and grain differ from the spec,
ROADMAP C3).
"""

import os

import pytest

import easyav1_tpu_torch
from easyav1_tpu import api as ref_api
from easyav1_tpu_torch.api import native_session
from easyav1_tpu_torch.native import pipe

from test_torch_fixtures import SMOKE
from test_torch_pipe import _assert_frames_equal, _decode, _gop4_fixture

# (stream, 8-bit: also held against the JAX package's device pipe)
STREAMS = [
    ("lreal_mix_e8bf32ba.webm", True),      # LR, Wiener and SGR units
    ("lreal_interlr_863022fc.webm", True),  # LR on inter frames
    ("fgreal_7cdd830f.webm", True),         # film grain
    ("inter_modes_96x96.webm", True),       # compound, warps, OBMC
    ("gop4", True),                         # libaom inter frames
    ("hbd_10p.webm", False),
    ("hbd_10pf.webm", False),               # 10-bit deblocking and CDEF
    ("superres_lr_88x64.webm", True),       # superres frames: the C path
]


def _path(name):
    return str(_gop4_fixture() if name == "gop4" else SMOKE / name)


@pytest.mark.parametrize("name,jax_too", STREAMS)
def test_postfilter_pipe_vs_native_and_jax(name, jax_too, monkeypatch):
    path = _path(name)
    # the port's native session refuses any other EASYAV1_PIPE
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    want = _decode(lambda: native_session(path))

    superres = []
    decode_and_recon = pipe.decode_and_recon

    def spy(seq, hdr, *a, **k):
        superres.append(bool(getattr(hdr, "use_superres", False)))
        return decode_and_recon(seq, hdr, *a, **k)

    monkeypatch.setattr(pipe, "decode_and_recon", spy)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = _decode(lambda: easyav1_tpu_torch.EasyAV1(path, device="cpu",
                                                    pipe="postfilter"))
    assert easyav1_tpu_torch.stats == {"frames": len(superres),
                                       "fallbacks": sum(superres)}
    assert any(superres) == name.startswith("superres")
    _assert_frames_equal(got, want)
    if jax_too:
        monkeypatch.setenv("EASYAV1_PIPE", "device")
        monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
        _assert_frames_equal(got, _decode(lambda: ref_api.EasyAV1(path)))


def test_postfilter_pipe_holds_back_the_c_filters(monkeypatch):
    """Every C recon of the pipe runs with deblocking, CDEF and loop
    restoration off, and gives the real parameters back (the grid export
    and the device filters read them); no frame reaches the full C
    recon."""
    from easyav1_tpu_torch import native as nat

    lib = nat._load()
    c_recon, during, around = lib.av1_recon_frame, [], []

    def filters(rp, fp):
        return tuple(rp.lf_level), rp.enable_cdef, fp.lr_uses

    def c_spy(rp, out, fp, *rest):
        during.append(filters(rp._obj, fp._obj))
        return c_recon(rp, out, fp, *rest)

    recon = pipe.recon_unfiltered

    def spy(lib, seq, hdr, out, fp_rc, rp, rfl):
        before = filters(rp, fp_rc)
        planes = recon(lib, seq, hdr, out, fp_rc, rp, rfl)
        around.append((before, filters(rp, fp_rc)))
        return planes

    def full_recon(*a):
        raise AssertionError("a covered frame reached the full C recon")

    monkeypatch.setattr(lib, "av1_recon_frame", c_spy)
    monkeypatch.setattr(pipe, "recon_unfiltered", spy)
    monkeypatch.setattr(pipe, "_c_recon", full_recon)
    _decode(lambda: easyav1_tpu_torch.EasyAV1(
        str(SMOKE / "lreal_interlr_863022fc.webm"), device="cpu",
        pipe="postfilter"))
    assert during == [((0, 0, 0, 0), 0, 0)] * 4
    assert len(around) == 4 and all(a == b for a, b in around)
    # the stream deblocks and restores: there was something to hold back
    assert any(any(lf) for (lf, _c, _l), _ in around)
    assert any(lr for (_lf, _c, lr), _ in around)


def test_unknown_pipe_raises():
    with pytest.raises(ValueError, match="pipe="):
        easyav1_tpu_torch.EasyAV1(os.path.join(SMOKE, "hbd_10p.webm"),
                                  device="cpu", pipe="device")
