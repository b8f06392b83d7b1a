"""Multi-stream Vorbis synthesis on one card: the counterpart of
`easyav1_tpu/parallel/mesh.py` (`MultiStreamVorbisSynth`, `:38-126`).

The JAX package shards S streams over a mesh's `dp` axis and splits the
IMDCT's contraction over its `tp` axis, joined by a `psum`.  One card has
no mesh: the port synthesises all S streams' chunks in one step, the
IMDCT over the whole contraction (`device.imdct`), so neither the `tp`
split with its `psum` nor `make_mesh` is ported.
"""

from __future__ import annotations

import numpy as np
import torch

from easyav1_tpu_torch.api import resolve_device
from easyav1_tpu_torch.audio.vorbis.decoder import imdct_matrix
from easyav1_tpu_torch.audio.vorbis.device import imdct, windows_table


class MultiStreamVorbisSynth:
    """S concurrent streams, each a chunk of B long blocks, synthesised in
    one step on `device`."""

    def __init__(self, streams: int, channels: int, n0: int, n1: int,
                 chunk: int = 16, device="cuda"):
        self.device = resolve_device(device)
        self.S = streams
        self.ch = channels
        self.n0 = n0
        self.n1 = n1
        self.B = chunk
        self.P_pad = n1
        self.BUF = self.P_pad + chunk * (n1 // 2) + n1
        self._windows = torch.from_numpy(windows_table(n0, n1)).to(
            self.device)
        self._imdct1 = torch.from_numpy(
            imdct_matrix(n1).astype(np.float32)).to(self.device)
        self._cols = torch.arange(n1, device=self.device)

    def step(self, spec, floor, window_ids, offsets, cache) -> torch.Tensor:
        """One synthesis step (`mesh.py:80-108`). spec/floor: (S, B, ch,
        n1//2) float32; window_ids/offsets: (S, B) int32; cache: (S, ch,
        n1//2); numpy or tensors.  Returns (S, ch, BUF) on the device:
        the cache at P_pad, then each block added at its offset, block
        after block."""
        S, B, ch, n1 = self.S, self.B, self.ch, self.n1
        spec, floor, cache = (torch.as_tensor(a, dtype=torch.float32).to(
            self.device) for a in (spec, floor, cache))
        window_ids, offsets = (torch.as_tensor(a).to(self.device).long()
                               for a in (window_ids, offsets))
        pcm = imdct((spec * floor).reshape(S * B * ch, n1 // 2),
                    self._imdct1).reshape(S, B, ch, n1)
        pcm *= self._windows[window_ids][:, :, None, :]
        buf = torch.zeros((S, ch, self.BUF), dtype=torch.float32,
                          device=self.device)
        buf[:, :, self.P_pad:self.P_pad + n1 // 2] = cache
        # the sequential overlap-add of `mesh.py:100-107`: one block of
        # every stream at a time, no index twice within one add
        for k in range(B):
            idx = (offsets[:, k, None] + self._cols[None, :])[:, None, :]
            buf.scatter_add_(2, idx.expand(S, ch, n1), pcm[:, k])
        return buf

    def example_inputs(self, rng: np.random.Generator):
        S, B, ch, n2 = self.S, self.B, self.ch, self.n1 // 2
        spec = rng.standard_normal((S, B, ch, n2)).astype(np.float32)
        floor = np.abs(rng.standard_normal((S, B, ch, n2))).astype(np.float32)
        wids = np.full((S, B), 1, np.int32)
        offsets = (self.P_pad + np.arange(B, dtype=np.int32) * (self.n1 // 2)
                   )[None].repeat(S, 0) - self.n1 // 2
        offsets = np.maximum(offsets, 0).astype(np.int32)
        cache = np.zeros((S, ch, n2), np.float32)
        return spec, floor, wids, offsets, cache
