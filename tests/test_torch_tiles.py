"""Frames of several tiles through the port, on the CPU.

The committed `tests/data/smoke/tiles2x2_10bit_256x192.webm` (10-bit
4:2:0, 6 frames: a key frame and 5 inter frames, 64x64 SBs, 2x2 tiles
on every frame; LR on every frame, CDEF on every frame, deblocking on
frames 1 and 5) was made with

    tools/build/make_fixture tiles2x2_10bit_256x192.webm w=256 h=192 \
        fps=30 frames=6 gop=6 bitdepth=10 crf=40 audio_secs=0 \
        cpu-used=4 vopt:tile-columns=1 vopt:tile-rows=1

(libaom takes the tile counts' log2).  Tiles bound the intra edges,
split the SB rows in decode order and are entropy-decoded on several
threads (`native.tile_workers`, `av1_decode_tiles_mt`), whose outputs a
merge joins; deblocking, CDEF and LR cross them.  The counterpart of
tests/test_tile_parallel.py, which holds the JAX package.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import easyav1_tpu_torch
from easyav1_tpu_torch import native as nat
from easyav1_tpu_torch import trace
from easyav1_tpu_torch.api import native_session

from test_torch_fixtures import SMOKE, smoke_oracle

NAME = "tiles2x2_10bit_256x192.webm"
FRAMES, TILES = 6, 4
BENCH_8K = (Path(__file__).resolve().parent / "data" / "bench"
            / "bench_av1_10bit_7680x4320_8.webm")


def _frames(make):
    av = make()
    out = []
    try:
        for _ in range(64):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                out.append([np.array(p, copy=True)
                            for p in av.get_video_frame().data])
        assert av.is_finished() and not av.get_status().is_error
    finally:
        av.close()
    return out


def _dav1d():
    prefix = smoke_oracle(NAME)
    meta = json.loads(prefix.with_suffix(".json").read_text())
    w, h = meta["width"], meta["height"]
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    raw = np.fromfile(prefix.with_suffix(".yuv"), np.uint16)
    per = w * h + 2 * cw * ch
    assert (meta["depth"], meta["vframes"]) == (10, FRAMES)
    assert raw.size == FRAMES * per
    return [[raw[b:b + w * h].reshape(h, w),
             raw[b + w * h:b + w * h + cw * ch].reshape(ch, cw),
             raw[b + w * h + cw * ch:b + per].reshape(ch, cw)]
            for b in range(0, FRAMES * per, per)]


@pytest.mark.parametrize("threads", [1, 4])
def test_tiles_on_the_main_pipe_vs_dav1d(threads, monkeypatch):
    """Every frame bit-equal to dav1d with none declined, on one entropy
    thread and on four (the tile-parallel entry); the tile counters and
    the frame spans' attributes say which path ran."""
    monkeypatch.setenv("EASYAV1_THREADS", str(threads))
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    before = trace.counters()
    trace.start()
    try:
        got = _frames(lambda: easyav1_tpu_torch.EasyAV1(
            str(SMOKE / NAME), device="cpu"))
    finally:
        spans = trace.stop()
    after = trace.counters()
    assert easyav1_tpu_torch.stats == {"frames": FRAMES, "fallbacks": 0}
    assert after["entropy.tiles"] - before["entropy.tiles"] \
        == FRAMES * TILES
    assert after["entropy.parallel"] - before["entropy.parallel"] \
        == (FRAMES if threads > 1 else 0)
    frames = [s for s in spans if s.name == "frame"]
    assert len(frames) == FRAMES
    assert all(s.attrs["tiles"] == TILES
               and s.attrs["workers"] == min(threads, TILES)
               for s in frames)
    gold = _dav1d()
    assert len(got) == FRAMES
    for k, (a, b) in enumerate(zip(got, gold)):
        for p in range(3):
            assert a[p].dtype == np.uint16
            assert np.array_equal(a[p], b[p]), f"frame {k} plane {p}"


@pytest.mark.parametrize("cols,rows,threads,env,want", [
    (1, 1, 8, "", 1),       # one tile: the serial entry whatever is asked
    (2, 2, 1, "", 1),       # one thread asked
    (2, 2, 0, "3", 3),      # EASYAV1_THREADS where the caller asks none
    (2, 2, 0, "16", 4),     # at most one a tile
    (2, 1, 6, "1", 2),      # the caller's count over the environment's
    (16, 8, 100, "", 64),   # av1_decode_tiles_mt's largest pool
])
def test_tile_workers(cols, rows, threads, env, want, monkeypatch):
    class Tile:
        pass

    class Hdr:
        tile = Tile()

    Hdr.tile.cols, Hdr.tile.rows = cols, rows
    monkeypatch.setenv("EASYAV1_THREADS", env)
    assert nat.tile_workers(Hdr, threads) == want


def test_tile_parallel_entropy_equals_serial(monkeypatch):
    """Each frame's entropy output (blocks, transforms, coefficients, the
    deblocking, LR and CDEF records, the mode grids and the CDF blob) on
    four threads equals the serial decode's, byte for byte: the merge
    keeps decode order and relocates each tile's indices."""
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    run = nat._run_tiles
    seen = []

    def both(lib, seq, hdr, tiles, **kw):
        serial = run(lib, seq, hdr, tiles, **{**kw, "threads": 1})
        assert serial is not None
        want = _snapshot(*serial)
        got = run(lib, seq, hdr, tiles, **{**kw, "threads": 4})
        assert nat.tile_workers(hdr, 4) == TILES
        have = _snapshot(*got)
        assert have.keys() == want.keys()
        for k in want:
            assert np.array_equal(have[k], want[k]), \
                f"frame {len(seen)}: {k}"
        seen.append(hdr.frame_is_intra)
        return got

    monkeypatch.setattr(nat, "_run_tiles", both)
    gold = _dav1d()
    got = _frames(lambda: native_session(str(SMOKE / NAME)))
    assert seen == [True] + [False] * (FRAMES - 1)
    for k, (a, b) in enumerate(zip(got, gold)):
        for p in range(3):
            assert np.array_equal(a[p], b[p]), f"frame {k} plane {p}"


def _snapshot(out, bufs, blob, _fp):
    """Copies of what a frame's entropy decode wrote."""
    snap = {"blocks": bufs["blocks"][:out.n_blocks],
            "txs": bufs["txs"][:out.n_txs],
            "coeffs": bufs["coeffs"][:out.coeffs_used],
            "lf": bufs["lf"][:out.n_lf],
            "lr": bufs["lr"][:out.n_lr_units],
            "cdef": bufs["cdef"],
            "blob": np.frombuffer(blob or b"", np.uint8)}
    snap.update({f"grid.{k}": g for k, g in bufs["grids"].items()})
    return {k: np.array(v, copy=True) for k, v in snap.items()}


def _headers(path):
    """Each frame's header facts, read by the port's parser."""
    from easyav1_tpu_torch.container.webm import TrackType, WebMDemuxer
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    facts = []

    class Headers(AV1Backend):
        def _decode_frame(self, hdr, tile_payloads, ts):
            # later headers are parsed against the references it refreshes
            self.hp.update_refs(hdr)
            t, lr = hdr.tile, hdr.lr
            facts.append({
                "intra": bool(hdr.frame_is_intra),
                "size": (hdr.upscaled_width, hdr.frame_height),
                "bitdepth": self.seq.color.bitdepth,
                "sb": 128 if self.seq.use_128x128_superblock else 64,
                "tiles": (t.cols, t.rows, list(t.col_starts),
                          list(t.row_starts)),
                "lr": bool(lr is not None and lr.uses_lr),
                "deblock": any(hdr.lf.level),
                "cdef": hdr.cdef is not None and (
                    any(hdr.cdef.y_pri_strength)
                    or any(hdr.cdef.uv_pri_strength)
                    or any(hdr.cdef.y_sec_strength)
                    or any(hdr.cdef.uv_sec_strength))})

    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = Headers(vt)
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            be.decode(p.frames, 0)
    return facts


def test_the_8k_bench_stream_holds_2x2_tiles():
    """The 8K bench stream is what its configuration says: 7680x4320,
    10-bit, 8 frames (a key frame first), 128x128 SBs and the 2x2 tiles
    of level 6.0 on every frame, LR and CDEF on every frame, deblocking on
    frames 0 and 3."""
    facts = _headers(BENCH_8K)
    assert [f["intra"] for f in facts] == [True] + [False] * 7
    tiles = (2, 2, [0, 30, 60], [0, 17, 34])
    for f in facts:
        assert (f["size"], f["bitdepth"], f["sb"], f["tiles"]) == \
            ((7680, 4320), 10, 128, tiles)
        assert f["lr"] and f["cdef"]
    assert [k for k, f in enumerate(facts) if f["deblock"]] == [0, 3]
    assert [f["tiles"][:2] for f in _headers(SMOKE / NAME)] == \
        [(2, 2)] * FRAMES
