"""The port's film grain (`recon/fg_torch.py`) against the JAX package's
device path (`fg_jax.DeviceFilmGrain`) and its host reference
(`fg_ref.FilmGrain`), on seeded planes: the cases of
tests/test_fg_jax.py.  Tolerance 0: the arithmetic is integer."""

import numpy as np
import pytest
import torch

from easyav1_tpu.video.av1 import fg_ref
from easyav1_tpu.video.av1.recon.fg_jax import DeviceFilmGrain
from easyav1_tpu_torch.video.av1.recon import fg_torch

from test_fg_jax import _Seq, _params


def _chroma(fg):
    fg.num_cb_points = 2
    fg.point_cb_value = [0, 255]
    fg.point_cb_scaling = [48, 80]
    fg.num_cr_points = 3
    fg.point_cr_value = [0, 128, 255]
    fg.point_cr_scaling = [40, 60, 90]
    fg.cb_mult, fg.cb_luma_mult, fg.cb_offset = 140, 120, 300
    fg.cr_mult, fg.cr_luma_mult, fg.cr_offset = 110, 135, 220
    return fg


def _from_luma(fg):
    fg.chroma_scaling_from_luma = True
    return fg


def _restricted(fg):
    fg.clip_to_restricted_range = True
    return _chroma(fg)


def _libaom_like(fg):
    """Grain parameters shaped like libaom's denoiser's."""
    fg.num_y_points = 6
    fg.point_y_value = [0, 40, 90, 140, 200, 255]
    fg.point_y_scaling = [30, 45, 60, 55, 40, 20]
    fg.num_cb_points = 2
    fg.point_cb_value = [0, 255]
    fg.point_cb_scaling = [20, 28]
    fg.num_cr_points = 2
    fg.point_cr_value = [0, 255]
    fg.point_cr_scaling = [18, 30]
    fg.cb_mult, fg.cb_luma_mult, fg.cb_offset = 128, 192, 256
    fg.cr_mult, fg.cr_luma_mult, fg.cr_offset = 134, 190, 260
    return fg


def _ten_bit(fg):
    fg.grain_scaling = 10
    return fg


CASES = {
    "luma_only": (_params, {}, {}),
    "no_overlap": (_params, {"overlap": False}, {}),
    "lag0": (_params, {"lag": 0}, {}),
    "chroma": (_chroma, {}, {}),
    "chroma_no_overlap_odd": (_chroma, {"overlap": False},
                              {"w": 75, "h": 41}),
    "chroma_from_luma": (_from_luma, {}, {}),
    "restricted_range": (_restricted, {}, {}),
    "block_multiple_dims": (_params, {}, {"w": 128, "h": 64}),
    "odd_tail": (_chroma, {}, {"w": 33, "h": 97}),
    "444": (_chroma, {}, {"ssx": 0, "ssy": 0}),
    "422": (_chroma, {}, {"ssx": 1, "ssy": 0}),
    "mono": (_params, {}, {"mono": True}),
    "10bit": (_ten_bit, {}, {"bd": 10}),
    "libaom_like": (_libaom_like, {"lag": 3, "seed": 43962},
                    {"w": 190, "h": 130}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_grain_equals_reference_and_jax(case):
    shape, kw, dims = CASES[case]
    fg = _params(**kw)
    if shape is not _params:
        fg = shape(fg)
    w, h, bd = dims.get("w", 97), dims.get("h", 66), dims.get("bd", 8)
    ssx, ssy = dims.get("ssx", 1), dims.get("ssy", 1)
    mono = dims.get("mono", False)
    seq = _Seq(ssx=ssx, ssy=ssy, mono=mono)
    rng = np.random.default_rng(5)
    dt = np.uint8 if bd == 8 else np.uint16
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    planes = [rng.integers(0, 1 << bd, (h, w)).astype(dt)]
    if not mono:
        planes += [rng.integers(0, 1 << bd, (ch, cw)).astype(dt)
                   for _ in range(2)]
    want = fg_ref.FilmGrain(fg, seq, bd).apply(planes)
    jax_got = DeviceFilmGrain(fg, seq, bd).apply(planes)
    # torch has no uint16 arithmetic: 10-bit planes travel as int32
    tdt = torch.uint8 if bd == 8 else torch.int32
    tin = [torch.from_numpy(p.astype(np.int32)).to(tdt) for p in planes]
    kept = [t.clone() for t in tin]
    got = fg_torch.FilmGrain(fg, seq, bd, "cpu").apply(tin)
    for i, (a, j, b) in enumerate(zip(want, jax_got, got)):
        assert b.dtype == tdt and tuple(b.shape) == a.shape
        d = np.abs(a.astype(int) - b.numpy().astype(int))
        assert d.max() == 0, (f"plane {i}: maxdiff {d.max()} at "
                              f"{np.argwhere(d > 0)[:4].tolist()}")
        assert np.array_equal(np.asarray(j).astype(int),
                              b.numpy().astype(int)), f"plane {i} vs jax"
        # grain is output only: the reference planes stay as they were
        assert torch.equal(tin[i], kept[i])
    assert any(not torch.equal(a, b) for a, b in zip(got, tin))


@pytest.mark.parametrize("lag,ssx,ssy,mono,bd", [
    (0, 1, 1, False, 8), (2, 1, 1, False, 8), (3, 0, 0, False, 8),
    (3, 1, 0, False, 10), (1, 1, 1, True, 8)])
def test_host_tables_are_the_reference_copies(lag, ssx, ssy, mono, bd):
    """The LFSR, the grain templates, the scaling LUT and the per-block
    random values equal fg_ref's and fg_jax's."""
    from easyav1_tpu.video.av1.recon.fg_jax import _block_randvals
    fg = _libaom_like(_params(lag=lag, seed=1234 + lag))
    for a, b in zip(fg_ref.generate_grain(fg, bd, ssx, ssy, mono),
                    fg_torch.generate_grain(fg, bd, ssx, ssy, mono)):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert np.array_equal(
        fg_ref.scaling_lut(fg.point_y_value, fg.point_y_scaling, bd),
        fg_torch.scaling_lut(fg.point_y_value, fg.point_y_scaling, bd))
    assert np.array_equal(_block_randvals(fg.grain_seed, 5, 9),
                          fg_torch.block_randvals(fg.grain_seed, 5, 9))
    s = 0xACE1
    for bits in (8, 11, 8):
        assert fg_ref._rand(s, bits) == fg_torch._rand(s, bits)
        s = fg_ref._rand(s, bits)[0]
