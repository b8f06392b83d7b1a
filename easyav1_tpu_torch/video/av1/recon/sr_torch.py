"""Superres horizontal upscale on the device (spec 7.16): the
counterpart of `sr_jax.upscale_plane_device` (`sr_jax.py:41-88`).

The reference multiplies the plane by an f32 tap matrix, which is exact
only in full f32.  Here each output column gathers its 8 source columns
(clamped to the plane's stored width) and sums them against its phase's
taps in int32: the same integers, with no float in between.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

RS_SUBPEL_BITS = 14
RS_SUBPEL_MASK = (1 << RS_SUBPEL_BITS) - 1
RS_EXTRA_BITS = 8
RS_EXTRA_OFF = 1 << (RS_EXTRA_BITS - 1)
SR_FILTER_BITS = 7

# Copy of easyav1_tpu/video/av1/superres_ref.py::UPSCALE_FILTER, the
# normative Upscale_Filter of spec 7.16: 64 phases of 8 taps.
UPSCALE_FILTER = np.array((
    (0, 0, 0, 128, 0, 0, 0, 0), (0, 0, -1, 128, 2, -1, 0, 0),
    (0, 1, -3, 127, 4, -2, 1, 0), (0, 1, -4, 127, 6, -3, 1, 0),
    (0, 2, -6, 126, 8, -3, 1, 0), (0, 2, -7, 125, 11, -4, 1, 0),
    (-1, 2, -8, 125, 13, -5, 2, 0), (-1, 3, -9, 124, 15, -6, 2, 0),
    (-1, 3, -10, 123, 18, -6, 2, -1), (-1, 3, -11, 122, 20, -7, 3, -1),
    (-1, 4, -12, 121, 22, -8, 3, -1), (-1, 4, -13, 120, 25, -9, 3, -1),
    (-1, 4, -14, 118, 28, -9, 3, -1), (-1, 4, -15, 117, 30, -10, 4, -1),
    (-1, 5, -16, 116, 32, -11, 4, -1), (-1, 5, -16, 114, 35, -12, 4, -1),
    (-1, 5, -17, 112, 38, -12, 4, -1), (-1, 5, -18, 111, 40, -13, 5, -1),
    (-1, 5, -18, 109, 43, -14, 5, -1), (-1, 6, -19, 107, 45, -14, 5, -1),
    (-1, 6, -19, 105, 48, -15, 5, -1), (-1, 6, -19, 103, 51, -16, 5, -1),
    (-1, 6, -20, 101, 53, -16, 6, -1), (-1, 6, -20, 99, 56, -17, 6, -1),
    (-1, 6, -20, 97, 58, -17, 6, -1), (-1, 6, -20, 95, 61, -18, 6, -1),
    (-2, 7, -20, 93, 64, -18, 6, -2), (-2, 7, -20, 91, 66, -19, 6, -1),
    (-2, 7, -20, 88, 69, -19, 6, -1), (-2, 7, -20, 86, 71, -19, 6, -1),
    (-2, 7, -20, 84, 74, -20, 7, -2), (-2, 7, -20, 81, 76, -20, 7, -1),
    (-2, 7, -20, 79, 79, -20, 7, -2), (-1, 7, -20, 76, 81, -20, 7, -2),
    (-2, 7, -20, 74, 84, -20, 7, -2), (-1, 6, -19, 71, 86, -20, 7, -2),
    (-1, 6, -19, 69, 88, -20, 7, -2), (-1, 6, -19, 66, 91, -20, 7, -2),
    (-2, 6, -18, 64, 93, -20, 7, -2), (-1, 6, -18, 61, 95, -20, 6, -1),
    (-1, 6, -17, 58, 97, -20, 6, -1), (-1, 6, -17, 56, 99, -20, 6, -1),
    (-1, 6, -16, 53, 101, -20, 6, -1), (-1, 5, -16, 51, 103, -19, 6, -1),
    (-1, 5, -15, 48, 105, -19, 6, -1), (-1, 5, -14, 45, 107, -19, 6, -1),
    (-1, 5, -14, 43, 109, -18, 5, -1), (-1, 5, -13, 40, 111, -18, 5, -1),
    (-1, 4, -12, 38, 112, -17, 5, -1), (-1, 4, -12, 35, 114, -16, 5, -1),
    (-1, 4, -11, 32, 116, -16, 5, -1), (-1, 4, -10, 30, 117, -15, 4, -1),
    (-1, 3, -9, 28, 118, -14, 4, -1), (-1, 3, -9, 25, 120, -13, 4, -1),
    (-1, 3, -8, 22, 121, -12, 4, -1), (-1, 3, -7, 20, 122, -11, 3, -1),
    (-1, 2, -6, 18, 123, -10, 3, -1), (0, 2, -6, 15, 124, -9, 3, -1),
    (0, 2, -5, 13, 125, -8, 2, -1), (0, 1, -4, 11, 125, -7, 2, 0),
    (0, 1, -3, 8, 126, -6, 2, 0), (0, 1, -3, 6, 127, -4, 1, 0),
    (0, 1, -2, 4, 127, -3, 1, 0), (0, 0, -1, 2, 128, -1, 0, 0),
), np.int32)


def _trunc_div(a: int, b: int) -> int:
    """C-style integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def column_taps(src_w: int, dst_w: int, aw: int):
    """Per output column, (idx [8, dst_w] int64, taps [8, dst_w] int32):
    the 8 source columns, clamped to [0, aw - 1] (the plane's stored,
    mi-aligned width: taps past the visible width read decoded pixels),
    and the filter taps of the column's phase."""
    x_step = _trunc_div((src_w << RS_SUBPEL_BITS) + dst_w // 2, dst_w)
    err = x_step * dst_w - (src_w << RS_SUBPEL_BITS)
    x0 = (_trunc_div(-((dst_w - src_w) << (RS_SUBPEL_BITS - 1))
                     + dst_w // 2, dst_w)
          + RS_EXTRA_OFF - _trunc_div(err, 2)) & RS_SUBPEL_MASK
    x_qn = (x0 - (1 << RS_SUBPEL_BITS)
            + np.arange(dst_w, dtype=np.int64) * x_step)
    base = (x_qn >> RS_SUBPEL_BITS) - 3
    phase = (x_qn & RS_SUBPEL_MASK) >> RS_EXTRA_BITS
    idx = np.clip(base[None, :] + np.arange(8)[:, None], 0, aw - 1)
    return idx.astype(np.int64), np.ascontiguousarray(UPSCALE_FILTER[phase].T)


@functools.lru_cache(maxsize=16)
def _device_taps(src_w: int, dst_w: int, aw: int, device: torch.device):
    idx, taps = column_taps(src_w, dst_w, aw)
    return torch.from_numpy(idx).to(device), torch.from_numpy(taps).to(device)


def upscale_plane(plane: torch.Tensor, src_w: int, dst_w: int,
                  bd: int) -> torch.Tensor:
    """Upscale an integer plane [rows, aw] to [rows, dst_w] int32 on its
    device, equal to `sr_jax.upscale_plane_device` and to
    `superres_ref.upscale_plane` with aw the plane's stored width."""
    aw = int(plane.shape[1])
    idx, taps = _device_taps(src_w, dst_w, aw, plane.device)
    src = plane.to(torch.int32)
    acc = src[:, idx[0]] * taps[0]
    for k in range(1, 8):
        acc += src[:, idx[k]] * taps[k]
    acc += 1 << (SR_FILTER_BITS - 1)
    acc >>= SR_FILTER_BITS
    return acc.clamp_(0, (1 << bd) - 1)
