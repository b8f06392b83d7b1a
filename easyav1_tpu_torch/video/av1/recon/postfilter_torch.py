"""One luma postfilter step (LF vertical, LF horizontal, CDEF) and its
stream-axis batch: the counterparts of `postfilter_jax.make_postfilter`
(`postfilter_jax.py:22-55`) and `MultiStreamPostfilter` (`:58-87`).

The JAX package vmaps the step over streams and shards the stream axis
over a mesh's `dp` axis.  One card has no mesh: the port's step takes a
leading stream axis directly (`lf_torch.lf_launch`,
`cdef_torch.filter_launch`: on the card one launch of
`csrc/loopfilter.cu` and one of `csrc/cdef.cu` a step, the deblocking
maps one row a pixel line), so S streams run on the launches of one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from easyav1_tpu_torch import convert
from easyav1_tpu_torch.api import resolve_device
from easyav1_tpu_torch.video.av1.recon import cdef_torch, lf_torch


@functools.lru_cache(maxsize=None)
def make_postfilter(H: int, W: int, bd: int = 8, damping: int = 5):
    """Returns (fn, example_args): fn is the luma postfilter step, LF
    vertical pass, LF horizontal pass, CDEF, over [..., H, W] int32
    planes with every parameter map an input (the limits broadcast);
    example_args are the JAX package's seeded numpy arguments."""

    def fn(plane, size_v, size_h, limit, blimit, thresh,
           dir_u, var_u, pri_u, sec_u, filt_u):
        # the per-line size maps (map-row shift 0) with level 0 everywhere
        # and the shared limits as the LUT's every entry
        lead = plane.shape[:-2]
        lut = torch.stack([torch.as_tensor(t, dtype=torch.int32,
                                           device=plane.device)
                           .expand(*lead, 64) for t in (limit, blimit,
                                                        thresh)], -2)
        sv, sh = (s.to(torch.uint8).contiguous() for s in (size_v, size_h))
        x, = lf_torch.lf_launch([plane], [{
            "sv": sv, "lv": torch.zeros_like(sv), "sh": sh,
            "lh": torch.zeros_like(sh), "lut": lut.contiguous()}], bd)
        return cdef_torch.filter_launch([x], dir_u, var_u, [pri_u], [sec_u],
                                        filt_u, 0, 0, bd, damping,
                                        convert.tables(plane.device))[0]

    rng = np.random.default_rng(0)
    nev = (W + 3) // 4 - 1
    neh = (H + 3) // 4 - 1
    uh, uw = (H + 7) // 8, (W + 7) // 8
    mx = (1 << bd) - 1
    args = (
        rng.integers(0, mx + 1, (H, W)).astype(np.int32),
        rng.choice([0, 4, 8, 14], (H, nev)).astype(np.int32),
        rng.choice([0, 4, 8, 14], (W, neh)).astype(np.int32),
        np.int32(3), np.int32(13), np.int32(0),
        rng.integers(0, 8, (uh, uw)).astype(np.int32),
        rng.integers(0, 1 << 14, (uh, uw)).astype(np.int32),
        rng.integers(0, 16, (uh, uw)).astype(np.int32),
        rng.integers(0, 4, (uh, uw)).astype(np.int32),
        rng.integers(0, 2, (uh, uw)).astype(np.int32),
    )
    return fn, args


# the arguments shared by every stream (`in_axes` None at
# postfilter_jax.py:71-72): limit, blimit, thresh
SHARED = (3, 4, 5)


class MultiStreamPostfilter:
    """The postfilter step over `streams` independent streams on one
    device: every argument but the shared limits carries a leading
    stream axis."""

    def __init__(self, streams: int, H: int, W: int, bd: int = 8,
                 device="cuda"):
        self.device = resolve_device(device)
        self.streams = streams
        self._fn, self._example = make_postfilter(H, W, bd)

    def step(self, *args) -> torch.Tensor:
        """[S, H, W] int32 filtered planes from `example_inputs`-shaped
        arguments (numpy or tensors)."""
        t = [torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                             else a).to(self.device) for a in args]
        if any(t[i].shape[:1] != (self.streams,) for i in range(len(t))
               if i not in SHARED):
            raise ValueError(f"every per-stream argument needs a leading "
                             f"axis of {self.streams}")
        return self._fn(*t)

    def example_inputs(self):
        n = self.streams
        out = []
        for i, a in enumerate(self._example):
            if i in SHARED:
                out.append(a)
            else:
                out.append(np.broadcast_to(a, (n,) + a.shape).copy())
        return tuple(out)
