"""Film grain synthesis on the device (spec 7.18.3).

`FilmGrain` holds one parameter set: its grain templates from the port's
C generator (`native.fg_templates`) and its scaling LUTs, made on the
host once.  `FilmGrain.apply` is what the pipe calls: on CUDA tensors
it launches `csrc/fg.cu` (built by nvcc at first use, and only then)
once a frame for every plane that takes grain, through `fg_launch`, or
raises; on CPU tensors it takes the plain version, `apply_plain`
(`fg_plain.apply`).  Each template set made counts as "fg.templates" in
`trace.counters()`.  Grain is an output-only
transform: `apply` returns new tensors and never writes the planes it is
given, which are the reference frames.

The kernel reads one int16 table a parameter set, uploaded once: the
three templates, [73, 82] each (a chroma template in its top-left
corner), then the three 256-entry scaling LUTs.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from easyav1_tpu_torch import _build, native, trace
from easyav1_tpu_torch.video.av1.recon import fg_plain


class FilmGrain:
    """Film grain of one parameter set on `device`: the host makes the
    templates and LUTs once here and uploads them for the path that
    `device` takes; `apply` takes a frame's planes on the device and
    returns new, grained planes of the same types, equal to
    `fg_ref.FilmGrain.apply` and `fg_jax.DeviceFilmGrain.apply`."""

    def __init__(self, fg, seq, bd: int, device):
        self.fg = fg
        self.bd = bd
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y
        self.mono = getattr(seq.color, "mono_chrome", False)
        self.templates = native.fg_templates(fg, bd, self.ssx, self.ssy,
                                             self.mono)
        trace.count("fg.templates")
        self.luts = fg_plain.scaling_luts(fg, bd)
        self._plain = self._table = None
        device = torch.device(device)
        if device.type == "cuda":
            self.table(device)
        else:
            self.plain_tables(device)

    def plain_tables(self, device):
        """`fg_plain.device_tables` on `device`, made once."""
        if self._plain is None or self._plain[0] != device:
            self._plain = (device, fg_plain.device_tables(
                self.templates, self.luts, device))
        return self._plain[1]

    def table(self, device) -> torch.Tensor:
        """The kernel's table (int16: the three templates [73, 82], then
        the three LUTs [256]) on `device`, uploaded once."""
        if self._table is None or self._table.device != device:
            t = np.zeros((3 * fg_plain.GRAIN_H * fg_plain.GRAIN_W
                          + 3 * 256,), np.int16)
            tpl = t[:3 * fg_plain.GRAIN_H * fg_plain.GRAIN_W].reshape(
                3, fg_plain.GRAIN_H, fg_plain.GRAIN_W)
            for p, g in enumerate(self.templates):
                if g is not None:
                    tpl[p, :g.shape[0], :g.shape[1]] = g
            t[-3 * 256:] = np.concatenate(self.luts)
            self._table = torch.from_numpy(t).to(device)
        return self._table

    def apply(self, planes: List[torch.Tensor]) -> List[torch.Tensor]:
        """`fg_launch`: the kernel on CUDA tensors, `apply_plain` on CPU
        tensors."""
        return fg_launch(self, planes)

    def apply_plain(self, planes: List[torch.Tensor]) -> List[torch.Tensor]:
        """`apply` as plain torch ops on the planes' device
        (`fg_plain.apply`)."""
        grain, lut = self.plain_tables(planes[0].device)
        return fg_plain.apply(self.fg, self.bd, self.ssx, self.ssy,
                              self.mono, grain, lut, planes)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_FG = _build.Kernel("fg", "fg_frame_launch",
                    [ctypes.POINTER(_VP), ctypes.POINTER(_CI), _CI,
                     ctypes.POINTER(_CI), _VP], "fg_frame_kernel")


def launch_args(grain: FilmGrain, planes: List[torch.Tensor]):
    """`fg_frame_launch`'s dims (h, w and whether it takes grain, for each
    of the 1 or 3 planes) and parameters, from the planes' shapes and the
    parameter set; raises unless the planes are what the kernel takes:
    2-D, of the bit depth's sample type (uint8 at 8 bits, uint16 above),
    the chroma planes of the subsampled size."""
    fg, bd = grain.fg, grain.bd
    n = len(planes)
    want = torch.uint8 if bd == 8 else torch.uint16
    if bd not in (8, 10, 12) or n != (1 if grain.mono else 3):
        raise ValueError(f"want 3 planes (1 monochrome) at 8, 10 or 12 "
                         f"bits, got {n} at {bd}")
    h, w = planes[0].shape if planes[0].dim() == 2 else (0, 0)
    sizes = [(h, w)] + [((h + grain.ssy) >> grain.ssy,
                         (w + grain.ssx) >> grain.ssx)] * (n - 1)
    for p, (x, size) in enumerate(zip(planes, sizes)):
        if x.dtype != want or x.dim() != 2 or tuple(x.shape) != size \
                or min(size) < 1:
            raise ValueError(
                f"plane {p}: want {want} {size}, got {x.dtype} "
                f"{tuple(x.shape)}")
    on = fg_plain.planes_grained(fg, grain.mono, n)
    dims = []
    for p, (ph, pw) in enumerate(sizes):
        dims += [ph, pw, int(p in on)]
    if fg.clip_to_restricted_range:
        lo, hi_y, hi_c = (v << (bd - 8) for v in (16, 235, 240))
    else:
        lo, hi_y, hi_c = 0, (1 << bd) - 1, (1 << bd) - 1
    params = [bd, grain.ssx, grain.ssy, fg.grain_seed,
              int(bool(fg.overlap_flag)), fg.grain_scaling,
              int(bool(fg.chroma_scaling_from_luma)), lo, hi_y, hi_c,
              fg.cb_mult, fg.cb_luma_mult, fg.cb_offset, fg.cr_mult,
              fg.cr_luma_mult, fg.cr_offset]
    return on, dims, params


def fg_launch(grain: FilmGrain, planes: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Film grain of a frame's cropped display planes (1 or 3), as `grain`
    (a `FilmGrain`) says.  CUDA tensors (contiguous, uint8 at 8 bits,
    uint16 above) launch `csrc/fg.cu` once for every plane that takes
    grain, into new planes, or raise; CPU tensors take
    `grain.apply_plain`.  A plane that takes no grain is returned as it
    is; no input is written."""
    if not _build.on_card(planes[0], planes):
        return grain.apply_plain(planes)
    on, dims, params = launch_args(grain, planes)
    if not on:
        return list(planes)
    dev = planes[0].device
    out, ptrs = list(planes), []
    for p, x in enumerate(planes):
        if p in on:
            out[p] = torch.empty_like(x)
        ptrs += [x.data_ptr(), out[p].data_ptr() if p in on else 0]
    _FG.launch(dev, (_VP * len(ptrs))(*ptrs), (_CI * len(dims))(*dims),
               len(planes), (_CI * len(params))(*params),
               grain.table(dev).data_ptr())
    return out
