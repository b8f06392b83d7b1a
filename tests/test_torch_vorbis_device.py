"""The port's Vorbis device synthesis on the CPU: `audio/vorbis/device.py`
(`VorbisDeviceSynth`) and `parallel/mesh.py` (`MultiStreamVorbisSynth`).

- `VorbisDeviceSynth` within 5e-6 (`tests/test_vorbis.py`'s TOL) of the
  JAX package's on the same blocks, and of the port's host decoder
  (`decode_packet_host`), on a mono, a stereo and a mixed-block-size
  stream (`audio_kind=1`); chunk 7 and chunk 64 bit-equal, a band limit
  changes nothing, `reset` resynchronises, feeding packet by packet
  equals one `process`; TF32 is off at every matmul of the synth.
- `MultiStreamVorbisSynth` within 5e-6 of the JAX one on a (dp, tp) mesh
  (its `psum` reorders the sum) on `example_inputs` of one numpy seed,
  relative to the output's peak: those inputs are standard-normal
  spectra, whose samples reach some 110, where one float32 step is 7.6e-6
  (the JAX package's own tp=1 and tp=2 steps differ by 7.1e-5); and four
  streams bit-equal to four single-stream steps.
"""

import numpy as np
import pytest
import torch

from easyav1_tpu_torch.audio.vorbis import VorbisDecoder
from easyav1_tpu_torch.audio.vorbis.device import (IMDCT_TILE,
                                                   VorbisDeviceSynth, imdct)
from easyav1_tpu_torch.container import TrackType, WebMDemuxer
from easyav1_tpu_torch.parallel.mesh import MultiStreamVorbisSynth

from fixtures import make_fixture
from test_torch_fixtures import SMOKE, steady

TOL = 5e-6
BENCH = SMOKE.parent / "bench"


def _packets(path, limit=None):
    d = WebMDemuxer(str(path))
    at = d.tracks_of_type(TrackType.AUDIO)[0]
    pkts = []
    while (p := d.read_packet()) is not None:
        if p.track == at.number:
            pkts.extend(p.frames)
    return at.vorbis_headers(), pkts[:limit]


STREAMS = {
    "mono": lambda: _packets(steady(make_fixture, frames=0, audio_secs=1.0,
                                    channels=1)),
    # the first 1.7 s of the committed 30 s stereo stream
    "stereo": lambda: _packets(BENCH / "bench_vorbis_stereo_48k_30s.webm",
                               80),
    # the first 1.2 s of the committed clicks stream, both block sizes
    "clicks": lambda: _packets(SMOKE / "vorbis_clicks_2s.webm", 120),
}


def _blocks(name):
    headers, pkts = STREAMS[name]()
    dec = VorbisDecoder(headers)
    blocks = [b for b in (dec.decode_packet_symbols(p) for p in pkts)
              if b is not None]
    return headers, pkts, dec, blocks


def _synth(dec, blocks, chunk, band=False, **kw):
    i = dec.info
    return VorbisDeviceSynth(i.channels, i.blocksize0, i.blocksize1,
                             tuple(blocks[0].coupling), chunk=chunk,
                             band_limit=(dec.spectral_band_limits() if band
                                         else (0, 0)),
                             device="cpu", **kw)


def _host(headers, pkts):
    dec = VorbisDecoder(headers)
    return np.concatenate([dec.decode_packet_host(p) for p in pkts])


@pytest.mark.parametrize("name", list(STREAMS))
def test_mixed_stream_has_both_block_sizes(name):
    _h, _p, dec, blocks = _blocks(name)
    sizes = {b.n for b in blocks}
    assert len(sizes) == (2 if name == "clicks" else len(sizes))
    assert dec.info.channels == (1 if name == "mono" else 2)


@pytest.mark.parametrize("band", [False, True], ids=["full", "band_limit"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_synth_vs_host_decoder(name, band):
    headers, pkts, dec, blocks = _blocks(name)
    got = _synth(dec, blocks, 64, band).process(blocks)
    want = _host(headers, pkts)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("name", list(STREAMS))
def test_synth_vs_jax(name):
    from easyav1_tpu.audio.vorbis.device import VorbisDeviceSynth as Ref

    _h, _p, dec, blocks = _blocks(name)
    i = dec.info
    want = Ref(i.channels, i.blocksize0, i.blocksize1,
               tuple(blocks[0].coupling), chunk=32).process(blocks)
    got = _synth(dec, blocks, 32).process(blocks)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("name", list(STREAMS))
def test_chunk_size_and_band_limit_change_nothing(name):
    _h, _p, dec, blocks = _blocks(name)
    a = _synth(dec, blocks, 7).process(blocks)
    b = _synth(dec, blocks, 64).process(blocks)
    c = _synth(dec, blocks, 64, band=True).process(blocks)
    assert np.array_equal(a, b) and np.array_equal(b, c)


@pytest.mark.parametrize("name", ["stereo", "clicks"])
def test_reset_resynchronises_and_feed_by_packet(name):
    headers, pkts, dec, blocks = _blocks(name)
    synth = _synth(dec, blocks, 16)
    first = synth.process(blocks)
    synth.reset()
    assert np.array_equal(synth.process(blocks), first)
    # fed packet by packet through a fresh decoder, as a player does
    synth.reset()
    dec = VorbisDecoder(headers)
    synth.begin()
    for p in pkts:
        b = dec.decode_packet_symbols(p)
        if b is not None:
            synth.feed([b])
    assert np.array_equal(synth.finish(), first)


def test_tf32_is_off_at_every_matmul(monkeypatch):
    _h, _p, dec, blocks = _blocks("clicks")
    seen = []
    matmul = torch.matmul

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*a, **kw)

    monkeypatch.setattr(torch, "matmul", spy)
    _synth(dec, blocks, 64).process(blocks[:80])
    assert seen and not any(seen)


@pytest.mark.parametrize("m", [1, 14, IMDCT_TILE, 300])
def test_imdct_rows_do_not_depend_on_their_neighbours(m):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, 384)).astype(np.float32))
    mat = torch.from_numpy(rng.standard_normal((384, 512)).astype(np.float32))
    out = imdct(x, mat)
    for r in {0, m // 2, m - 1}:
        assert torch.equal(out[r], imdct(x[r:r + 1], mat)[0])
    # zero bins cut off the end change nothing
    assert torch.equal(imdct(x[:, :256], mat[:256]),
                       imdct(torch.cat([x[:, :256], torch.zeros(m, 128)], 1),
                             mat))
    assert torch.allclose(out, x @ mat, rtol=1e-4, atol=1e-3)


# --------------------------------------------------------- multi-stream

def test_multistream_vs_jax_mesh():
    from easyav1_tpu.parallel.mesh import (MultiStreamVorbisSynth as Ref,
                                           make_mesh)

    ref = Ref(make_mesh(4, tp=2), 4, 2, 256, 2048, chunk=8)
    inputs = ref.example_inputs(np.random.default_rng(5))
    want = np.asarray(ref.step(*inputs))
    port = MultiStreamVorbisSynth(4, 2, 256, 2048, chunk=8, device="cpu")
    for a, b in zip(inputs, port.example_inputs(np.random.default_rng(5))):
        assert np.array_equal(a, b)
    got = port.step(*inputs).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_multistream_equals_single_stream_steps():
    port = MultiStreamVorbisSynth(4, 2, 256, 2048, chunk=8, device="cpu")
    one = MultiStreamVorbisSynth(1, 2, 256, 2048, chunk=8, device="cpu")
    rng = np.random.default_rng(9)
    spec, floor, wids, offsets, cache = port.example_inputs(rng)
    # each stream its own windows, offsets and carried cache
    wids = rng.integers(1, 5, wids.shape).astype(np.int32)
    offsets = (offsets + rng.integers(0, 64, (4, 1))).astype(np.int32)
    cache = rng.standard_normal(cache.shape).astype(np.float32)
    got = port.step(spec, floor, wids, offsets, cache)
    for s in range(4):
        want = one.step(spec[s:s + 1], floor[s:s + 1], wids[s:s + 1],
                        offsets[s:s + 1], cache[s:s + 1])
        assert torch.equal(got[s], want[0])


@pytest.mark.parametrize("make", [
    lambda: VorbisDeviceSynth(2, 256, 2048, ((0, 1),)),
    lambda: MultiStreamVorbisSynth(8, 2, 256, 2048),
], ids=["VorbisDeviceSynth", "MultiStreamVorbisSynth"])
def test_entry_points_default_to_cuda(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stereo", "clicks"])
def test_synth_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    headers, pkts, dec, blocks = _blocks(name)
    i = dec.info
    synth = {c: VorbisDeviceSynth(i.channels, i.blocksize0, i.blocksize1,
                                  tuple(blocks[0].coupling), chunk=c,
                                  device="cuda") for c in (7, 64)}
    a, b = (synth[c].process(blocks) for c in (7, 64))
    assert np.array_equal(a, b)
    assert np.abs(a - _host(headers, pkts)).max() < TOL
