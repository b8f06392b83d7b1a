"""The port's device residual composer (`recon/itx_torch.py`, the kernel
`csrc/itx.cu`) against the JAX package's, on the CPU, tolerance 0.

- `itx_batch_plain` against the reference's int64 oracle
  `recon_ref.inverse_transform` on every legal (tx_size, tx_type) pair
  at 8 bits, with the sparse and extreme blocks of
  tests/test_itx_jax.py, on a spread of pairs at 10 and 12 bits, and
  against `itx_jax.itx_batch` itself on a few small pairs;
- `compose_residual_plain` against the port's host C composer
  (`records.compose_residual_host`) on the records of real frames and on
  seeded random programs, and against `jax_exec.apply_residuals_fused` on
  a small frame;
- the packed input of the device composer: the decoder's nonzero box
  holds every nonzero coefficient of real frames; `records.
  pack_coeff_rows` (C) equals its numpy twin on real frames and random
  programs, each record once, classes contiguous, offsets on the
  16-byte grid; `compose_residual_packed_plain` equals the dense plain
  composer, the host C composer and `apply_residuals_fused`; the
  DC-only chain (`itx_dc_plain`) equals `itx_batch_plain` and the
  reference's oracle on every size and bit depth; `check_txs` refuses
  packed records it must;
- the slice end to end: `EasyAV1(device="cpu", host_residual=False)` on
  the committed 8-, 10- and 12-bit streams equal to `api.native_session`
  with no fallback, the reference's setting `EASYAV1_HOST_RESID=0`, the
  stage clock's "compose" mark in both modes, and the declines (a
  lossless frame, a palette frame), each one counted fallback, on the
  same frames as the JAX pallas pipe under `EASYAV1_HOST_RESID=0`;
- the kernel's tables against the port's, read from its source (its
  class table against `records.tx_class`);
- `cuda`-marked tests of the kernel against its plain version and of
  the main path on the card, which skip here.

Fixtures made by a JAX test helper go through `test_torch_fixtures.steady`;
the tests that decode with the reference's native path set
`EASYAV1_FRAME_PARALLEL=0`.
"""

import os
import re

import numpy as np
import pytest
import torch

import easyav1_tpu_torch
from easyav1_tpu.video.av1.recon_ref import inverse_transform
from easyav1_tpu.video.av1.tile import TxBlock
from easyav1_tpu_torch import api, trace
from easyav1_tpu_torch.container.webm import TrackType, WebMDemuxer
from easyav1_tpu_torch.unit_programs import (random_tx_program,
                                             shaped_tx_program)
from easyav1_tpu_torch.video.av1 import constants as C
from easyav1_tpu_torch.video.av1 import tables as T
from easyav1_tpu_torch.video.av1.backend import AV1Backend
from easyav1_tpu_torch.video.av1.itx_ref import _ROW_SHIFT, _TX_1D, _COS
from easyav1_tpu_torch.video.av1.recon import itx_torch
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.recon.records import (
    ITX_CLASSES, coded_box, compose_residual_host, narrow_residual,
    pack_coeff_rows, pack_coeff_rows_plain, tx_class)

from test_torch_fixtures import steady

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "tests", "data", "smoke")
BENCH = os.path.join(REPO, "tests", "data", "bench")
CASES = itx_torch.legal_pairs()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blocks(tx_size, bd, seed, n=5):
    """Seeded coefficient blocks [n, adj_h, adj_w] in +-2^(bd+7), with
    tests/test_itx_jax.py's sparse and extreme blocks."""
    rng = np.random.default_rng(seed)
    adj = T.ADJUSTED_TX_SIZE[tx_size]
    aw, ah = T.TX_WIDTH[adj], T.TX_HEIGHT[adj]
    lim = 1 << (bd + 7)
    co = rng.integers(-lim, lim, size=(n, ah, aw)).astype(np.int32)
    co[1] = 0
    co[1, 0, 0] = lim - 1
    co[2] = np.where(rng.random((ah, aw)) < 0.9, 0, co[2])
    co[3] = lim - 1
    co[4] = -lim
    return co


def _oracle(co, tx_size, tx_type, bd):
    return np.stack([inverse_transform(
        TxBlock(plane=0, x=0, y=0, tx_size=tx_size, tx_type=tx_type,
                eob=c.size, coeffs=c.astype(np.int64)), bd) for c in co])


def test_legal_pairs():
    """The 208 pairs of tests/test_itx_jax.py."""
    assert len(CASES) == 208
    assert (C.TX_64X64, C.DCT_DCT) in CASES
    assert (C.TX_32X32, C.ADST_ADST) not in CASES
    assert (C.TX_16X16, C.FLIPADST_FLIPADST) in CASES


@pytest.mark.parametrize("tx_size,tx_type", CASES)
def test_itx_batch_plain_vs_oracle(tx_size, tx_type):
    """Every legal pair at 8 bits, bit for bit."""
    co = _blocks(tx_size, 8, tx_size * 100 + tx_type)
    got = itx_torch.itx_batch_plain(torch.from_numpy(co), tx_size, tx_type, 8)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _oracle(co, tx_size, tx_type, 8))


# every 1-D kind and length: DCT 4 to 64, ADST and flipADST 4 to 16,
# identity 4 to 64, square and rectangular (2:1 and 4:1)
HBD_PAIRS = [(C.TX_4X4, C.ADST_ADST), (C.TX_8X8, C.FLIPADST_DCT),
             (C.TX_16X16, C.DCT_FLIPADST), (C.TX_32X32, C.DCT_DCT),
             (C.TX_64X64, C.DCT_DCT), (C.TX_16X64, C.IDTX),
             (C.TX_4X16, C.V_ADST), (C.TX_32X8, C.H_DCT),
             (C.TX_64X16, C.V_DCT), (C.TX_8X32, C.IDTX),
             (C.TX_16X8, C.FLIPADST_ADST), (C.TX_4X8, C.H_FLIPADST)]


@pytest.mark.parametrize("bd", [10, 12])
@pytest.mark.parametrize("tx_size,tx_type", HBD_PAIRS)
def test_itx_batch_plain_high_bit_depth(tx_size, tx_type, bd):
    co = _blocks(tx_size, bd, 1000 * bd + tx_size * 16 + tx_type)
    got = itx_torch.itx_batch_plain(torch.from_numpy(co), tx_size, tx_type,
                                    bd)
    assert np.array_equal(got.numpy(), _oracle(co, tx_size, tx_type, bd))


@pytest.mark.parametrize("tx_size,tx_type", [
    (C.TX_4X4, C.DCT_DCT), (C.TX_8X4, C.ADST_FLIPADST), (C.TX_4X8, C.IDTX),
    (C.TX_16X8, C.FLIPADST_ADST), (C.TX_8X8, C.V_ADST)])
def test_itx_batch_plain_vs_itx_jax(tx_size, tx_type):
    """Against the jitted int32 JAX kernel itself, on small pairs (each
    pays one XLA compile; tests/test_itx_jax.py is xslow)."""
    from easyav1_tpu.video.av1.recon.itx_jax import itx_batch
    co = _blocks(tx_size, 8, 7 * tx_size + tx_type)
    got = itx_torch.itx_batch_plain(torch.from_numpy(co), tx_size, tx_type, 8)
    assert np.array_equal(got.numpy(), itx_batch(co, tx_size, tx_type, 8))


def _assert_planes_equal(got, want):
    assert len(got) == len(want)
    for p, (a, b) in enumerate(zip(got, want)):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape and a.dtype == b.dtype, (p, a.dtype, b.dtype)
        assert np.array_equal(a, b), (
            f"plane {p}: {int((a != b).sum())} samples differ")


# (seed, plane dims, bit depth): odd sizes crop at the edges; 4:2:0 and
# 4:4:4
RANDOM = [(1, [(133, 201), (67, 101), (67, 101)], 8),
          (2, [(96, 160)] * 3, 10), (3, [(131, 197), (66, 99), (66, 99)], 12),
          (4, [(100, 150)], 8)]


@pytest.mark.parametrize("seed,dims,bd", RANDOM)
def test_compose_plain_vs_host_c_random(seed, dims, bd):
    """Seeded random programs, extremes included: the host C itx
    (`av1_itx.h`) and itx_ref's butterflies agree."""
    prog = random_tx_program(seed, dims, bd)
    got = itx_torch.compose_residual_plain(prog["txs"], prog["coeffs"], dims,
                                           bd, "cpu")
    want = compose_residual_host(prog["txs"], prog["coeffs"], dims, bd)
    _assert_planes_equal(got, want)


def _records(path, monkeypatch, packets=None):
    """(txs, coeffs, dims, bit depth) of each frame of a stream (its first
    `packets` packets), as the port's pipe hands them to its recons;
    the frames themselves go to the C recon."""
    got = []

    def capture(self, units, txs, coeffs, *a, **k):
        got.append((txs.copy(), coeffs.copy(), list(self.dims), self.bd))
        return None

    monkeypatch.setattr(IntraRecon, "prepare", capture)
    dmx = WebMDemuxer(path)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = AV1Backend(vt, torch.device("cpu"))
    n = 0
    while (p := dmx.read_packet()) is not None and (packets is None
                                                    or n < packets):
        if p.track == vt.number:
            be.decode(p.frames, 0)
            n += 1
    assert got
    return got


@pytest.mark.parametrize("path,packets", [
    (os.path.join(SMOKE, "hbd_10i.webm"), None),
    (os.path.join(SMOKE, "hbd_12i.webm"), None),
    (os.path.join(SMOKE, "hbd_444x10.webm"), None),
    (os.path.join(SMOKE, "inter_modes_96x96.webm"), None),
    (os.path.join(SMOKE, "lreal_mix_e8bf32ba.webm"), None),
    (os.path.join(BENCH, "bench_av1_intra_1920x1080_30.webm"), 1)])
def test_compose_plain_vs_host_c_real_frames(path, packets, monkeypatch):
    """The records of real frames (8-bit intra, 8-bit inter, 10- and
    12-bit intra, 10-bit 4:4:4): the plain composer equals the host C
    composer on every frame."""
    for txs, coeffs, dims, bd in _records(path, monkeypatch, packets):
        assert txs.shape[0] > 0
        _assert_planes_equal(
            itx_torch.compose_residual_plain(txs, coeffs, dims, bd, "cpu"),
            compose_residual_host(txs, coeffs, dims, bd))


def test_compose_plain_vs_apply_residuals_fused(monkeypatch):
    """One small 8-bit frame against the reference's device composer
    (`group_txs` + `apply_residuals_fused`, its scatter dropping what
    falls outside the planes)."""
    import jax.numpy as jnp
    from easyav1_tpu.video.av1.recon import jax_exec as JX
    txs, coeffs, dims, bd = _records(
        os.path.join(SMOKE, "superres_lr_88x64.webm"), monkeypatch)[0]
    groups = JX.group_txs(txs, coeffs)
    planes = [jnp.zeros(d, jnp.int32) for d in dims]
    want = JX.apply_residuals_fused(planes, groups, bd, len(dims), 0, 0)
    got = itx_torch.compose_residual_plain(txs, coeffs, dims, bd, "cpu")
    _assert_planes_equal([g.to(torch.int32) for g in got],
                         [np.asarray(w) for w in want])


# the real frames of the packed input's tests: 10- and 12-bit intra,
# 10-bit 4:4:4, 8-bit inter, LR, and the 1080p intra key frame
REAL = [(os.path.join(SMOKE, "hbd_10i.webm"), None),
        (os.path.join(SMOKE, "hbd_12i.webm"), None),
        (os.path.join(SMOKE, "hbd_444x10.webm"), None),
        (os.path.join(SMOKE, "inter_modes_96x96.webm"), None),
        (os.path.join(SMOKE, "lreal_mix_e8bf32ba.webm"), None),
        (os.path.join(BENCH, "bench_av1_intra_1920x1080_30.webm"), 1)]
REAL_IDS = ["hbd_10i", "hbd_12i", "hbd_444x10", "inter_modes", "lreal_mix",
            "intra_1080p"]


def _dense_blocks(txs, coeffs):
    """Each record's dense block [ah, aw] of coeffs."""
    for rec in txs:
        adj = T.ADJUSTED_TX_SIZE[rec[3]]
        ah, aw = T.TX_HEIGHT[adj], T.TX_WIDTH[adj]
        yield coeffs[rec[6]:rec[6] + ah * aw].reshape(ah, aw)


@pytest.mark.parametrize("path,packets", REAL, ids=REAL_IDS)
def test_nonzero_box_holds_every_coefficient(path, packets, monkeypatch):
    """The decoder invariant the packed input rests on: on every frame,
    no nonzero coefficient of a record lies at or past row nzh or column
    nzw of the box packed into rec[5], and the box is not empty."""
    for txs, coeffs, _dims, _bd in _records(path, monkeypatch, packets):
        nzh, nzw = coded_box(txs)
        assert (nzh >= 1).all() and (nzw >= 1).all()
        for (h, w), block in zip(zip(nzh, nzw), _dense_blocks(txs, coeffs)):
            assert not block[h:].any() and not block[:, w:].any()


def _assert_packed(txs, coeffs):
    """`pack_coeff_rows` against its numpy twin, and the packed layout:
    every record once, classes contiguous and in order, offsets on the
    16-byte grid, each record's coded rows its dense block's prefix."""
    got = pack_coeff_rows(txs, coeffs)
    want = pack_coeff_rows_plain(txs, coeffs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ptxs, pco, off = got
    key = lambda t: sorted(map(tuple, np.delete(t, 6, axis=1).tolist()))
    assert ptxs.shape == txs.shape and key(ptxs) == key(txs)
    cls = np.array([tx_class(t) for t in ptxs[:, 3]], np.int64)
    assert off.shape == (ITX_CLASSES + 1,) and off[0] == 0
    assert off[-1] == txs.shape[0]
    for c in range(ITX_CLASSES):
        assert (cls[off[c]:off[c + 1]] == c).all()
    assert (ptxs[:, 6] % 4 == 0).all()
    nzh, _ = coded_box(ptxs)
    aw = np.array([T.TX_WIDTH[T.ADJUSTED_TX_SIZE[t]] for t in ptxs[:, 3]])
    assert pco.shape[0] == int((nzh * aw).sum())
    assert np.array_equal(ptxs[1:, 6], np.cumsum(nzh * aw)[:-1])
    return got


@pytest.mark.parametrize("path,packets", REAL, ids=REAL_IDS)
def test_pack_coeff_rows_real_frames(path, packets, monkeypatch):
    """The C packer on real frames equals its numpy twin, in the packed
    layout."""
    for txs, coeffs, _dims, _bd in _records(path, monkeypatch, packets):
        _assert_packed(txs, coeffs)


@pytest.mark.parametrize("seed,dims,bd", RANDOM + [
    (11, [(133, 201), (67, 101), (67, 101)], 10),
    (12, [(96, 160)] * 3, 12)])
def test_pack_coeff_rows_random_programs(seed, dims, bd):
    """The C packer on seeded random programs (boxes packed by
    `unit_programs._eob_pack`, as the decoder packs them)."""
    prog = random_tx_program(seed, dims, bd)
    _assert_packed(prog["txs"], prog["coeffs"])


def test_pack_coeff_rows_refuses():
    """A record whose box is empty or leaves its block, whose tx size is
    out of range or whose block leaves the coefficients is refused with
    its index; an empty frame packs to nothing."""
    prog = random_tx_program(5, [(64, 64)], 8)
    txs, co = prog["txs"], prog["coeffs"]
    k = int(np.flatnonzero(txs[:, 3] == txs[0, 3])[-1])
    box = lambda h, w: 2 | (h << 12) | (w << 18)
    adj = T.ADJUSTED_TX_SIZE[int(txs[k, 3])]
    ah, aw = T.TX_HEIGHT[adj], T.TX_WIDTH[adj]
    for field, value in ((itx_torch.R_EOB, box(0, 1)),
                         (itx_torch.R_EOB, box(1, 0)),
                         (itx_torch.R_EOB, box(ah + 1, 1)),
                         (itx_torch.R_EOB, box(1, aw + 1)),
                         (itx_torch.R_SIZE, 19),
                         (itx_torch.R_OFF, co.shape[0] - 1)):
        bad = txs.copy()
        bad[k, field] = value
        with pytest.raises(ValueError, match=f"record {k} "):
            pack_coeff_rows(bad, co)
    ptxs, pco, off = pack_coeff_rows(txs[:0], co)
    assert ptxs.shape == (0, 8) and pco.shape == (0,)
    assert off.tolist() == [0] * (ITX_CLASSES + 1)


@pytest.mark.parametrize("path,packets", REAL, ids=REAL_IDS)
def test_packed_plain_vs_dense_and_host_c(path, packets, monkeypatch):
    """The packed plain composer on the packed records of real frames
    equals the dense plain composer and the host C composer on the
    decoder's own records, tolerance 0."""
    for txs, coeffs, dims, bd in _records(path, monkeypatch, packets):
        ptxs, pco, _ = pack_coeff_rows(txs, coeffs)
        got = itx_torch.compose_residual_packed_plain(ptxs, pco, dims, bd,
                                                      "cpu")
        _assert_planes_equal(got, compose_residual_host(txs, coeffs, dims,
                                                        bd))
        _assert_planes_equal(got, itx_torch.compose_residual_plain(
            txs, coeffs, dims, bd, "cpu"))


@pytest.mark.parametrize("seed,dims,bd", RANDOM)
def test_packed_plain_vs_dense_random(seed, dims, bd):
    """The same on seeded random programs, extremes included, and on a
    DC-heavy program."""
    for prog in (random_tx_program(seed, dims, bd),
                 shaped_tx_program(seed, dims, bd, dc_share=0.8)):
        ptxs, pco, _ = pack_coeff_rows(prog["txs"], prog["coeffs"])
        _assert_planes_equal(
            itx_torch.compose_residual_packed_plain(ptxs, pco, dims, bd,
                                                    "cpu"),
            compose_residual_host(prog["txs"], prog["coeffs"], dims, bd))


def test_packed_plain_vs_apply_residuals_fused(monkeypatch):
    """The packed plain composer against the reference's device composer
    on test_compose_plain_vs_apply_residuals_fused's frame."""
    import jax.numpy as jnp
    from easyav1_tpu.video.av1.recon import jax_exec as JX
    txs, coeffs, dims, bd = _records(
        os.path.join(SMOKE, "superres_lr_88x64.webm"), monkeypatch)[0]
    groups = JX.group_txs(txs, coeffs)
    planes = [jnp.zeros(d, jnp.int32) for d in dims]
    want = JX.apply_residuals_fused(planes, groups, bd, len(dims), 0, 0)
    ptxs, pco, _ = pack_coeff_rows(txs, coeffs)
    got = itx_torch.compose_residual_packed_plain(ptxs, pco, dims, bd, "cpu")
    _assert_planes_equal([g.to(torch.int32) for g in got],
                         [np.asarray(w) for w in want])


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("tx_size", range(len(T.TX_WIDTH)))
def test_dc_only_chain(tx_size, bd):
    """A DC-only DCT_DCT block is one value at every size and bit depth:
    `itx_batch_plain` and the reference's oracle give a constant block
    equal to `itx_dc_plain` (the kernel's DC-only path), for DC values at
    the extremes, +-1, 0 and seeded ones."""
    lim = 1 << (bd + 7)
    rng = np.random.default_rng(97 * tx_size + bd)
    dcs = np.concatenate([[-lim, lim - 1, -1, 1, 0],
                          rng.integers(-lim, lim, 11)]).astype(np.int32)
    adj = T.ADJUSTED_TX_SIZE[tx_size]
    co = np.zeros((dcs.size, T.TX_HEIGHT[adj], T.TX_WIDTH[adj]), np.int32)
    co[:, 0, 0] = dcs
    want = itx_torch.itx_dc_plain(torch.from_numpy(dcs), tx_size, bd).numpy()
    blocks = itx_torch.itx_batch_plain(torch.from_numpy(co), tx_size,
                                       C.DCT_DCT, bd).numpy()
    oracle = _oracle(co, tx_size, C.DCT_DCT, bd)
    h, w = T.TX_HEIGHT[tx_size], T.TX_WIDTH[tx_size]
    assert blocks.shape == oracle.shape == (dcs.size, h, w)
    assert np.array_equal(blocks, oracle)
    assert np.array_equal(blocks, np.broadcast_to(want[:, None, None],
                                                  blocks.shape))


def test_check_txs_refuses():
    prog = random_tx_program(5, [(64, 64)], 8)
    txs, n = prog["txs"], prog["coeffs"].shape[0]
    itx_torch.check_txs(txs, n, 1)
    for field, value in ((itx_torch.R_LOSSLESS, 1), (itx_torch.R_PLANE, 1),
                         (itx_torch.R_SIZE, 19), (itx_torch.R_OFF, n),
                         (itx_torch.R_X, -4)):
        bad = txs.copy()
        bad[0, field] = value
        with pytest.raises(ValueError, match="record 0"):
            itx_torch.check_txs(bad, n, 1)
    bad = txs.copy()
    bad[0, itx_torch.R_SIZE], bad[0, itx_torch.R_TYPE] = C.TX_32X32, C.ADST_DCT
    with pytest.raises(ValueError):
        itx_torch.check_txs(bad, n, 1)


@pytest.mark.parametrize("case", ["nzh_0", "nzw_0", "nzh_past", "nzw_past",
                                  "rows_past_end", "off_grid", "lossless"])
def test_check_txs_refuses_packed(case):
    """In packed mode `check_txs` refuses a record whose box is empty or
    leaves its block, or whose coded rows leave the array or start off
    the 16-byte grid; the packed records of a program pass."""
    prog = random_tx_program(5, [(64, 64)], 8)
    txs, co, _ = pack_coeff_rows(prog["txs"], prog["coeffs"])
    itx_torch.check_txs(txs, co.shape[0], 1, packed=True)
    k = txs.shape[0] - 1
    adj = T.ADJUSTED_TX_SIZE[int(txs[k, 3])]
    ah, aw = T.TX_HEIGHT[adj], T.TX_WIDTH[adj]
    nzh, nzw = (int(v[k]) for v in coded_box(txs))
    box = {"nzh_0": (0, nzw), "nzw_0": (nzh, 0), "nzh_past": (ah + 1, nzw),
           "nzw_past": (nzh, aw + 1)}
    bad = txs.copy()
    if case in box:
        bad[k, 5] = 2 | (box[case][0] << 12) | (box[case][1] << 18)
    elif case == "rows_past_end":
        bad[k, 6] = co.shape[0] - nzh * aw + 4
    elif case == "off_grid":
        bad[k, 6] -= 2
    else:
        bad[k, itx_torch.R_LOSSLESS] = 1
    with pytest.raises(ValueError, match=f"record {k} "):
        itx_torch.check_txs(bad, co.shape[0], 1, packed=True)


def test_compose_residual_wrapper_checks():
    """The wrapper takes packed contiguous int32 records and coded rows on
    one device with their class offsets, and on the CPU gives the plain
    version's planes."""
    prog = random_tx_program(6, [(64, 96), (32, 48), (32, 48)], 10)
    ptxs, pco, off = pack_coeff_rows(prog["txs"], prog["coeffs"])
    txs, co = torch.from_numpy(ptxs), torch.from_numpy(pco)
    got = itx_torch.compose_residual(txs, co, off, prog["dims"], 10)
    assert [tuple(g.shape) for g in got] == prog["dims"]
    assert all(g.dtype == torch.int16 for g in got)
    _assert_planes_equal(got, itx_torch.compose_residual_plain(
        prog["txs"], prog["coeffs"], prog["dims"], 10, "cpu"))
    for bad in (dict(txs=txs.long()), dict(coeffs=co[::2]),
                dict(txs=txs.t().contiguous().t())):
        args = dict(txs=txs, coeffs=co) | bad
        with pytest.raises(ValueError):
            itx_torch.compose_residual(args["txs"], args["coeffs"], off,
                                       prog["dims"], 10)
    with pytest.raises(ValueError):
        itx_torch.compose_residual(txs, co, off, prog["dims"], 9)
    # class offsets that do not start at 0, end at n or rise
    n = txs.shape[0]
    for bad_off in ([1, 1, 1, 1, 1, n], [0, 0, 0, 0, 0, n - 1],
                    [0, 5, 2, 2, 2, n], [0, n]):
        with pytest.raises(ValueError, match="class offsets"):
            itx_torch.compose_residual(txs, co, bad_off, prog["dims"], 10)


def test_narrow_residual_on_the_device_side():
    """12-bit planes narrow to int16 when they fit, else the frame is
    declined (None): never truncated; as `records.narrow_residual`."""
    fits = [torch.tensor([[-32768, 32767]], dtype=torch.int32),
            torch.zeros((0, 4), dtype=torch.int32)]
    got = itx_torch.narrow_residual(fits)
    assert [g.dtype for g in got] == [torch.int16] * 2
    assert got[0].tolist() == [[-32768, 32767]]
    for v in (32768, -32769):
        planes = [torch.zeros((2, 2), dtype=torch.int32),
                  torch.tensor([[0, v]], dtype=torch.int32)]
        assert itx_torch.narrow_residual(planes) is None
        assert narrow_residual([p.numpy() for p in planes]) is None
    i16 = [torch.ones((2, 2), dtype=torch.int16)]
    assert itx_torch.narrow_residual(i16) is i16


def _cu_array(src, name):
    body = re.search(name + r"\[[^]]*\](?:\[[^]]*\])?\s*=\s*\{(.*?)\};", src,
                     re.S)
    return [int(v) for v in re.findall(r"-?\d+", body.group(1))]


def test_kernel_tables_match_the_port():
    """The constant tables of csrc/itx.cu against the port's: tx sizes,
    row shifts, 1-D kinds, the cosine table."""
    with open(os.path.join(REPO, "easyav1_tpu_torch", "csrc",
                           "itx.cu")) as f:
        src = f.read()
    assert _cu_array(src, "kLogW") == [w.bit_length() - 1
                                       for w in T.TX_WIDTH]
    assert _cu_array(src, "kLogH") == [h.bit_length() - 1
                                       for h in T.TX_HEIGHT]
    assert _cu_array(src, "kRowShift") == _ROW_SHIFT
    kinds = {"dct": 0, "adst": 1, "flipadst": 2, "identity": 3}
    assert _cu_array(src, "kKinds") == [kinds[k] for t in range(16)
                                        for k in _TX_1D[t]]
    assert _cu_array(src, "kCos") == [int(c) for c in _COS]
    assert _cu_array(src, "kClassOf") == [tx_class(t)
                                          for t in range(len(T.TX_WIDTH))]


def _hashes(make):
    av = make()
    out = []
    try:
        for _ in range(256):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                out.append(api.frame_hash(av.get_video_frame().data))
    finally:
        av.close()
    return out


def _spy_compose(monkeypatch):
    """The record count of each frame the recons hand to the device
    composer."""
    calls = []
    compose = IntraRecon.compose

    def spy(recon, resid):
        if isinstance(resid, tuple):
            calls.append(resid[0].shape[0])
        return compose(recon, resid)

    monkeypatch.setattr(IntraRecon, "compose", spy)
    return calls


@pytest.mark.parametrize("name", [
    "inter_modes_96x96", "comp_masked_320x192", "lreal_interlr_863022fc",
    "hbd_10i", "hbd_10p", "hbd_12i", "hbd_12p", "hbd_444x10", "hbd_12fg"])
def test_device_composer_streams_vs_native(name, monkeypatch):
    """The committed 8-, 10- and 12-bit streams through
    `EasyAV1(device="cpu", host_residual=False)`: every frame's hash
    equals the native C session's, no fallback, and the device composer
    ran once a frame (a frame without transforms too: it launches
    nothing there)."""
    path = os.path.join(SMOKE, f"{name}.webm")
    calls = _spy_compose(monkeypatch)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = _hashes(lambda: easyav1_tpu_torch.EasyAV1(
        path, device="cpu", host_residual=False))
    stats = dict(easyav1_tpu_torch.stats)
    assert got == _hashes(lambda: api.native_session(path)) and got
    assert stats["fallbacks"] == 0
    assert len(calls) == stats["frames"] and any(calls)


@pytest.mark.parametrize("setting,device_composer", [
    (None, False), ("1", False), ("0", True)])
def test_reference_setting_picks_the_composer(setting, device_composer,
                                              monkeypatch):
    """`EASYAV1_HOST_RESID=0` selects the device composer where the
    keyword is not given; the host C composer stays the default."""
    if setting is None:
        monkeypatch.delenv("EASYAV1_HOST_RESID", raising=False)
    else:
        monkeypatch.setenv("EASYAV1_HOST_RESID", setting)
    assert api.host_residual_default() is not device_composer
    calls = _spy_compose(monkeypatch)
    path = os.path.join(SMOKE, "hbd_10i.webm")
    av = easyav1_tpu_torch.EasyAV1(path, device="cpu")
    assert av.host_residual is not device_composer
    av.close()
    got = _hashes(lambda: easyav1_tpu_torch.EasyAV1(path, device="cpu"))
    assert got == _hashes(lambda: api.native_session(path))
    assert bool(calls) is device_composer
    # the keyword wins over the setting
    calls.clear()
    _hashes(lambda: easyav1_tpu_torch.EasyAV1(
        path, device="cpu", host_residual=device_composer))
    assert bool(calls) is not device_composer


@pytest.mark.parametrize("host_residual", [True, False])
def test_stage_clock_marks_compose(host_residual):
    """Every frame's stage spans carry "compose" beside "prepare" and
    "upload", in both modes, and "pack" with the device composer."""
    trace.start()
    try:
        _hashes(lambda: easyav1_tpu_torch.EasyAV1(
            os.path.join(SMOKE, "hbd_10p.webm"), device="cpu",
            host_residual=host_residual))
    finally:
        spans = trace.stop()
    frames = [sp for sp in spans if sp.name == "frame"]
    assert len(frames) == 4
    for f in frames:
        d = {c.name for c in spans if c.parent == f.id}
        assert {"entropy", "prepare", "compose", "upload", "intra"} <= d
        assert ("pack" in d) is not host_residual
    assert all(sp.end_ns >= sp.start_ns for sp in spans)


def _lossless_stream():
    from test_av1_lossless import _fixture
    return steady(_fixture, 64, 64, 1, 1)


def _palette_tu():
    """tests/test_torch_pipe.py's palette frame: one temporal unit."""
    from test_av1_palette_synth import W, H, _fillers
    from easyav1_tpu.video.av1 import constants as RC
    from easyav1_tpu.video.av1.av1_enc import EncBlock, encode_frame

    m = np.random.default_rng(3).integers(0, 4, (16, 16)).astype(np.int32)
    blk = EncBlock(r=0, c=0, bsize=RC.BLOCK_16X16, skip=False,
                   palette_y=([40, 90, 160, 220], m),
                   luma_coeffs=[[(3, 0), (2, 1), (1, 0)]])
    blocks = [blk] + _fillers({(r, c) for r in (0, 2) for c in (0, 2)})
    return encode_frame(W, H, 60, blocks, adapt=True, screen=True)


def _plain_tu():
    """The palette frame's fillers alone: a frame the device composer
    takes."""
    from test_av1_palette_synth import W, H, _fillers
    from easyav1_tpu.video.av1.av1_enc import encode_frame
    return encode_frame(W, H, 60, _fillers(set()), adapt=True, screen=True)


def test_lossless_frame_declines_once(monkeypatch):
    """A lossless frame (WHT transforms) is one counted fallback under the
    device composer, and still equals the native session."""
    path = str(_lossless_stream())
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = _hashes(lambda: easyav1_tpu_torch.EasyAV1(
        path, device="cpu", host_residual=False))
    assert dict(easyav1_tpu_torch.stats) == {"frames": 1, "fallbacks": 1}
    assert got == _hashes(lambda: api.native_session(path))
    # with the host composer the frame runs on the device
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    assert got == _hashes(lambda: easyav1_tpu_torch.EasyAV1(path,
                                                            device="cpu"))
    assert dict(easyav1_tpu_torch.stats) == {"frames": 1, "fallbacks": 0}


def _port_frames(tus, host_residual):
    """Each temporal unit through the port's backend on the CPU: (planes,
    whether the frame was declined) a unit."""
    from easyav1_tpu_torch.container.webm import TrackInfo
    out = []
    for tu in tus:
        be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"),
                        torch.device("cpu"), host_residual=host_residual)
        before = easyav1_tpu_torch.stats["fallbacks"]
        frames = be.decode([tu], 0)
        out.append(([np.array(p, copy=True) for f in frames for p in f.data],
                    easyav1_tpu_torch.stats["fallbacks"] - before))
    return out


def _reference_frames(tus, pipe_name, monkeypatch):
    """The same through the reference's backend and pipe, with its own
    fallback count."""
    from easyav1_tpu.container.webm import TrackInfo as RefTrackInfo
    from easyav1_tpu.native import _PIPE_STATS
    from easyav1_tpu.video.av1.backend import AV1Backend as RefBackend
    monkeypatch.setenv("EASYAV1_PIPE", pipe_name)
    monkeypatch.setenv("EASYAV1_FRAME_PARALLEL", "0")
    out = []
    for tu in tus:
        be = RefBackend(RefTrackInfo(number=1, type=None, codec_id="V_AV1"))
        before = _PIPE_STATS["fallbacks"]
        frames = be.decode([tu], 0)
        out.append(([np.array(p, copy=True) for f in frames for p in f.data],
                    _PIPE_STATS["fallbacks"] - before))
    return out


def test_palette_frame_declines_as_the_jax_pipe(monkeypatch):
    """A palette frame and a plain one: under the device composer the
    port declines the palette frame alone (one counted fallback), as the
    JAX pallas pipe does under `EASYAV1_HOST_RESID=0`; every frame equals
    the native decode."""
    tus = [_palette_tu(), _plain_tu()]
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    port = _port_frames(tus, host_residual=False)
    assert [d for _, d in port] == [1, 0]
    assert dict(easyav1_tpu_torch.stats) == {"frames": 2, "fallbacks": 1}
    native = _reference_frames(tus, "native", monkeypatch)
    monkeypatch.setenv("EASYAV1_HOST_RESID", "0")
    jax_pipe = _reference_frames(tus, "pallas", monkeypatch)
    assert [d for _, d in jax_pipe] == [d for _, d in port]
    for (a, _), (b, _), (c, _) in zip(port, native, jax_pipe):
        assert len(a) == len(b) == len(c) == 3
        for pa, pb, pc in zip(a, b, c):
            assert np.array_equal(pa, pb) and np.array_equal(pa, pc)


# ---- on the card -------------------------------------------------------


def _special_program(kind):
    """(txs, coeffs, dims, bit depth) of a DC-heavy program (80% DC-only
    DCT_DCT, odd 4:4:4 size, 10 bits) or of one of 4x4 and 8x8
    transforms only (4:2:0, 12 bits)."""
    if kind == "dc_heavy":
        dims, bd = [(445, 637)] * 3, 10
        prog = shaped_tx_program(51, dims, bd, dc_share=0.8)
    else:
        dims, bd = [(200, 264), (100, 132), (100, 132)], 12
        prog = shaped_tx_program(52, dims, bd, sizes=(C.TX_4X4, C.TX_8X8))
    return prog["txs"], prog["coeffs"], dims, bd


@pytest.mark.cuda
@pytest.mark.parametrize("seed,dims,bd", RANDOM + [
    (7, [(445, 637)] * 3, 8), (8, [(445, 637)] * 3, 10),
    (9, [(445, 637)] * 3, 12)])
def test_kernel_vs_plain(seed, dims, bd, cuda_device):
    """The kernel on packed records against its plain version on the
    card, bit for bit, one launch; the 4:4:4 programs hold every legal
    pair."""
    prog = random_tx_program(seed, dims, bd, tile_pairs=seed < 7)
    ptxs, pco, off = pack_coeff_rows(prog["txs"], prog["coeffs"])
    txs = torch.from_numpy(ptxs).to(cuda_device)
    co = torch.from_numpy(pco).to(cuda_device)
    before = trace.counters()
    got = itx_torch.compose_residual(txs, co, off, dims, bd)
    torch.cuda.synchronize()
    assert trace.counters()["launches.itx_kernel"] \
        == before["launches.itx_kernel"] + 1
    _assert_planes_equal(got, itx_torch.compose_residual_packed_plain(
        txs, co, dims, bd, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dc_heavy", "small_only"])
def test_kernel_dc_heavy_and_small_programs(kind, cuda_device):
    """The kernel on a program of mostly DC-only records and on one of
    4x4 and 8x8 records only (classes 0 and 1, many records a warp),
    against the packed plain version, bit for bit."""
    txs, co, dims, bd = _special_program(kind)
    ptxs, pco, off = pack_coeff_rows(txs, co)
    t = torch.from_numpy(ptxs).to(cuda_device)
    c = torch.from_numpy(pco).to(cuda_device)
    got = itx_torch.compose_residual(t, c, off, dims, bd)
    torch.cuda.synchronize()
    _assert_planes_equal(got, itx_torch.compose_residual_packed_plain(
        t, c, dims, bd, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["inter_modes_96x96", "hbd_12p",
                                  "hbd_444x10"])
def test_device_composer_streams_on_the_card(name, cuda_device,
                                            monkeypatch):
    """The main path with the device composer: hash-equal to the native
    session, no fallback, one launch a frame that has transforms."""
    path = os.path.join(SMOKE, f"{name}.webm")
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    launches = trace.counters()["launches.itx_kernel"]
    calls = _spy_compose(monkeypatch)
    got = _hashes(lambda: easyav1_tpu_torch.EasyAV1(
        path, device="cuda", host_residual=False))
    assert got == _hashes(lambda: api.native_session(path))
    assert easyav1_tpu_torch.stats["fallbacks"] == 0
    assert len(calls) == easyav1_tpu_torch.stats["frames"]
    assert trace.counters()["launches.itx_kernel"] - launches \
        == sum(n > 0 for n in calls)
