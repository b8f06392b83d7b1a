"""The port's superres upscale (`recon/sr_torch.py`, an integer 8-tap
gather) against the JAX package's (`sr_jax.upscale_plane_device`, an f32
tap matrix product) and its numpy reference
(`superres_ref.upscale_plane`), on seeded planes.  Tolerance 0: the
arithmetic is integer."""

import numpy as np
import pytest
import torch

from easyav1_tpu.video.av1.recon.sr_jax import upscale_plane_device
from easyav1_tpu.video.av1.superres_ref import UPSCALE_FILTER, upscale_plane
from easyav1_tpu_torch.video.av1.recon import sr_torch


def _hold(src_w, dst_w, aw, bd, rows=24, seed=0):
    rng = np.random.default_rng(1000 * src_w + dst_w + seed)
    plane = rng.integers(0, 1 << bd, (rows, aw)).astype(np.int32)
    got = sr_torch.upscale_plane(torch.from_numpy(plane), src_w, dst_w, bd)
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows, dst_w)
    got = got.numpy()
    assert np.array_equal(got, np.asarray(
        upscale_plane_device(plane, src_w, dst_w, bd)))
    assert np.array_equal(got, upscale_plane(plane, src_w, dst_w, bd))


def test_filter_table_is_the_reference_copy():
    assert np.array_equal(sr_torch.UPSCALE_FILTER, UPSCALE_FILTER)


@pytest.mark.parametrize("denom", range(9, 17))
def test_denominators_luma_and_chroma(denom):
    """Coded width 64 upscaled to 8 * denom, and its 4:2:0 chroma."""
    _hold(64, 8 * denom, 64, 8)
    _hold(32, 4 * denom, 32, 8)


@pytest.mark.parametrize("src_w,dst_w,aw", [
    (57, 64, 64),      # coded width below the stored, mi-aligned width
    (29, 32, 32),      # its chroma
    (81, 97, 88),      # odd upscaled width
    (41, 49, 44),
])
def test_taps_clamp_at_the_stored_width(src_w, dst_w, aw):
    """Taps past src_w read the decoded pixels of the mi-aligned area;
    only past the stored width do they repeat the last column."""
    _hold(src_w, dst_w, aw, 8)


@pytest.mark.parametrize("bd", [8, 10])
def test_extreme_values_clip(bd):
    """Flat and alternating extremes: the filter overshoots and clips."""
    mx = (1 << bd) - 1
    plane = np.zeros((4, 64), np.int32)
    plane[1] = mx
    plane[2, ::2] = mx
    plane[3, 1::3] = mx
    got = sr_torch.upscale_plane(torch.from_numpy(plane), 64, 88, bd).numpy()
    assert got.min() == 0 and got.max() == mx
    assert np.array_equal(got, upscale_plane(plane, 64, 88, bd))
    assert np.array_equal(got, np.asarray(
        upscale_plane_device(plane, 64, 88, bd)))


def test_ten_bit_wide():
    _hold(960, 1920, 960, 10, rows=4)


def test_uint8_and_int16_planes_are_taken():
    """The pipe hands int32; any integer type upscales the same."""
    rng = np.random.default_rng(4)
    plane = rng.integers(0, 256, (8, 64)).astype(np.uint8)
    want = upscale_plane(plane.astype(np.int32), 64, 104, 8)
    for dt in (torch.uint8, torch.int16, torch.int64):
        got = sr_torch.upscale_plane(torch.from_numpy(plane).to(dt), 64, 104,
                                     8)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
