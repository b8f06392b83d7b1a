"""Vorbis synthesis on the device: the counterpart of
`easyav1_tpu/audio/vorbis/device.py` (`VorbisDeviceSynth`, `:27-265`).

The host half is the JAX package's, verbatim: `_dispatch_chunk` lays a
chunk of B blocks out in fixed shapes (silent blocks pad the last one)
and does the channel decoupling and the floor multiply in float32 numpy.
The device half follows the jitted `synth` (`:99-148`): the two IMDCTs as
float32 matmuls against the dense cosine matrices, sliced to the band
limit; the short-block add into the first n0 samples; the window gather
and multiply; the carried cache written at P; the overlap-add as one
`index_add_` over the chunk's [ch, BUF] buffer (every sample has at most
two contributions that are not exact zeros, so the order of the
additions cannot change the result); the next cache sliced on the
device.  `feed` copies each chunk's samples into pinned host memory
behind a CUDA event; `finish` waits on the events.

The IMDCT runs in tiles of `IMDCT_TILE` rows by `IMDCT_TILE` bins, one
`torch.matmul` of the same shape each, the bins' partial products added
in order (`imdct`): cuBLAS and MKL pick their algorithm, and how they
split the contraction, by shape, so a plain matmul over the chunk's B x
ch rows and bl bins would round a block differently for another chunk
size or band limit.  TF32 stays off: the synth raises if
`torch.backends.cuda.matmul.allow_tf32` is set.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from easyav1_tpu_torch.api import resolve_device
from easyav1_tpu_torch.audio.vorbis.decoder import (DecodedBlock,
                                                    build_window,
                                                    imdct_matrix)

IMDCT_TILE = 128


def imdct(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """x [m, k] @ mat [k, n] in float32, in tiles of IMDCT_TILE rows and
    IMDCT_TILE bins (k is a multiple of it, or smaller), each one matmul
    of one shape, the tiles of bins added in order: a row's result depends
    on the row alone, not on m, on where the row sits, or on zero bins cut
    off its end (a band limit)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the Vorbis IMDCT runs in float32: TF32 is on "
                           "(torch.backends.cuda.matmul.allow_tf32)")
    m, k = x.shape
    mp = -(-m // IMDCT_TILE) * IMDCT_TILE
    if mp != m:
        x = torch.cat([x, x.new_zeros((mp - m, k))])
    out = x.new_empty((mp, mat.shape[1]))
    part = x.new_empty((IMDCT_TILE, mat.shape[1]))
    for r in range(0, mp, IMDCT_TILE):
        acc = out[r:r + IMDCT_TILE]
        for c in range(0, k, IMDCT_TILE):
            torch.matmul(x[r:r + IMDCT_TILE, c:c + IMDCT_TILE],
                         mat[c:c + IMDCT_TILE], out=acc if c == 0 else part)
            if c:
                acc += part
    return out[:m]


def windows_table(n0: int, n1: int) -> np.ndarray:
    """The window table padded to n1: id 0 short, 1-4 long by (prev,
    next) flag, 5 zeros (padding blocks)."""
    wins = np.zeros((6, n1), np.float64)
    wins[0, :n0] = build_window(n0, n0, n1, False, 0, 0)
    wins[1] = build_window(n1, n0, n1, True, 0, 0)
    wins[2] = build_window(n1, n0, n1, True, 0, 1)
    wins[3] = build_window(n1, n0, n1, True, 1, 0)
    wins[4] = build_window(n1, n0, n1, True, 1, 1)
    return wins.astype(np.float32)


class VorbisDeviceSynth:
    """Device synthesis engine for one stream configuration.

    Chunk layout: B blocks. Short-block spectra ride in a separate, smaller
    batch input; both IMDCTs run on the full batch.
    """

    # window_id values
    W_SHORT, W_L00, W_L01, W_L10, W_L11, W_ZERO = range(6)

    def __init__(self, channels: int, n0: int, n1: int,
                 coupling: Tuple[Tuple[int, int], ...],
                 chunk: int = 64,
                 band_limit: Tuple[int, int] = (0, 0), device="cuda"):
        """band_limit = (long_bins, short_bins): the stream's static
        residue-decode ceiling (max residue ``end`` reachable from
        long/short modes, see VorbisDecoder.spectral_band_limits).
        Spectral bins above it are identically zero for every packet,
        so the host->device upload carries only the live band.  0
        means "no limit known" (full n/2)."""
        self.device = resolve_device(device)
        self.ch = channels
        self.n0 = n0
        self.n1 = n1
        self.chunk = chunk
        self.coupling = tuple(coupling)

        def _bl(limit, half):
            if not limit or limit >= half:
                return half
            return min(half, max(128, -(-limit // 128) * 128))

        self.bl1 = _bl(band_limit[0], n1 // 2)  # live long-block bins
        self.bl0 = _bl(band_limit[1], n0 // 2)  # live short-block bins
        self._state_cache = np.zeros((channels, n1 // 2), np.float32)
        self._prev_n = 0  # 0 = no previous block yet
        dev = self.device
        self._windows = torch.from_numpy(windows_table(n0, n1)).to(dev)
        self._imdct0 = torch.from_numpy(
            imdct_matrix(n0)[:self.bl0].astype(np.float32)).to(dev)
        self._imdct1 = torch.from_numpy(
            imdct_matrix(n1)[:self.bl1].astype(np.float32)).to(dev)
        self._pad = n1  # headroom for negative block offsets
        self._buf_len = self._pad + chunk * (n1 // 2) + n1
        self._cols = torch.arange(n1, device=dev)
        self._cache_dev = None     # device-resident carried tail
        self._pend: list = []      # (host samples, event) awaiting fetch
        self._hold: List[DecodedBlock] = []   # sub-chunk backlog

    def reset(self) -> None:
        self._state_cache = np.zeros((self.ch, self.n1 // 2), np.float32)
        self._prev_n = 0
        self._cache_dev = None
        self._pend = []
        self._hold = []

    # ------------------------------------------------------------------

    def synth(self, spec: torch.Tensor, wids: torch.Tensor,
              offsets: torch.Tensor, emit: int, cache: torch.Tensor):
        """spec: (B*ch*(bl1 + bl0),) float32, the long-block spectra then
        the short-block spectra, decoupled and floor-multiplied; wids,
        offsets: (B,) int64 window ids and buffer offsets; emit: the
        samples the chunk completes; cache: (ch, n1//2) carried tail.
        Returns (buf, next_cache), both on the device."""
        B, ch, n0, n1 = self.chunk, self.ch, self.n0, self.n1
        P = self._pad
        bl0, bl1 = self.bl0, self.bl1
        nl = B * ch * bl1
        # rows of the IMDCT matrices above the band limit multiply bins
        # that are identically zero: slicing them off is exact
        pcm = imdct(spec[:nl].reshape(B * ch, bl1),
                    self._imdct1).reshape(B, ch, n1)
        pcm[:, :, :n0] += imdct(spec[nl:].reshape(B * ch, bl0),
                                self._imdct0).reshape(B, ch, n0)
        pcm *= self._windows[wids][:, None, :]
        buf = torch.zeros((ch, self._buf_len), dtype=torch.float32,
                          device=spec.device)
        buf[:, P:P + n1 // 2] = cache
        idx = (offsets[:, None] + self._cols[None, :]).reshape(-1)
        buf.index_add_(1, idx, pcm.transpose(0, 1).reshape(ch, B * n1))
        return buf, buf[:, P + emit:P + emit + n1 // 2].clone()

    # ------------------------------------------------------------------

    def process(self, blocks: List[DecodedBlock]) -> np.ndarray:
        """Synthesize a list of blocks (any count; internally chunked).
        Returns (samples, ch) float32 PCM."""
        self.begin()
        self.feed(blocks)
        return self.finish()

    # -- streaming interface -------------------------------------------
    #
    # begin() / feed() / finish() let the caller interleave host symbol
    # decode with device synthesis: feed() dispatches full chunks
    # asynchronously (device->host copies start immediately and overlap
    # both later chunks and the caller's own work); finish() pads and
    # dispatches the remainder and fetches every pending buffer once.

    def begin(self) -> None:
        self._pend = []
        self._hold: List[DecodedBlock] = []

    def feed(self, blocks: List[DecodedBlock]) -> None:
        self._hold.extend(blocks)
        while len(self._hold) >= self.chunk:
            self._dispatch_async(self._hold[:self.chunk])
            self._hold = self._hold[self.chunk:]

    def finish(self) -> np.ndarray:
        if self._hold:
            self._dispatch_async(self._hold)
            self._hold = []
        pend, self._pend = self._pend, []
        if not pend:
            return np.zeros((0, self.ch), np.float32)
        out = []
        for host, event in pend:
            if event is not None:
                event.synchronize()
            out.append(host.numpy().T)
        return np.concatenate(out, axis=0)

    def _dispatch_async(self, blocks: List[DecodedBlock]) -> None:
        buf, emit = self._dispatch_chunk(blocks)
        P = self._pad
        if buf.is_cuda:
            # the chunk's samples into pinned memory, behind an event:
            # the copy overlaps later chunks and the caller's own work
            host = torch.empty((self.ch, emit), dtype=torch.float32,
                               pin_memory=True)
            host.copy_(buf[:, P:P + emit], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._pend.append((host, event))
        else:
            self._pend.append((buf[:, P:P + emit], None))

    def _dispatch_chunk(self, blocks: List[DecodedBlock]):
        B, ch, n0, n1 = self.chunk, self.ch, self.n0, self.n1
        P = self._pad
        bl0, bl1 = self.bl0, self.bl1
        nl = B * ch * bl1
        spec = np.zeros(nl + B * ch * bl0, np.float32)
        spec_l = spec[:nl].reshape(B, ch, bl1)
        spec_s = spec[nl:].reshape(B, ch, bl0)
        res_l = np.zeros((B, ch, bl1), np.float32)
        flo_l = np.zeros((B, ch, bl1), np.float32)
        res_s = np.zeros((B, ch, bl0), np.float32)
        flo_s = np.zeros((B, ch, bl0), np.float32)
        meta = np.zeros(2 * B + 1, np.int32)
        wids = meta[:B]
        wids[:] = self.W_ZERO
        offsets = meta[B:2 * B]

        prev_n = self._prev_n
        emit = 0  # emission pointer, buffer coords relative to P
        lengths = []
        for k, blk in enumerate(blocks):
            n = blk.n
            assert tuple(blk.coupling) == self.coupling, \
                "per-chunk coupling mismatch (multiple mappings)"
            if blk.long_block:
                wids[k] = 1 + (blk.prev_flag << 1) + blk.next_flag
                res_l[k] = blk.residue[:, :bl1]
                flo_l[k] = blk.floor[:, :bl1]
            else:
                wids[k] = self.W_SHORT
                res_s[k] = blk.residue[:, :bl0]
                flo_s[k] = blk.floor[:, :bl0]
            # The block's window center lands on the post-emission pointer
            # (emit + L); its buffer start is therefore center - n/2.
            L = 0 if prev_n == 0 else prev_n // 4 + n // 4
            a = emit + L - n // 2
            offsets[k] = P + a
            emit += L
            lengths.append(L)
            prev_n = n

        # Channel decoupling + floor multiply, vectorized on the host.
        # Exact same f32 elementwise ops the device kernel used to do,
        # so the result is bit-identical — but the upload shrinks 2x.
        for res, flo in ((res_l, flo_l), (res_s, flo_s)):
            for m, a in reversed(self.coupling):
                M, A = res[:, m], res[:, a]
                pm, pa = M > 0, A > 0
                newM = np.where(pm, np.where(pa, M, M + A),
                                np.where(pa, M, M - A))
                newA = np.where(pm, np.where(pa, M - A, M),
                                np.where(pa, M + A, M))
                res[:, m] = newM
                res[:, a] = newA
        np.multiply(res_l, flo_l, out=spec_l)
        np.multiply(res_s, flo_s, out=spec_s)

        dev = self.device
        if self._cache_dev is None:
            self._cache_dev = torch.from_numpy(self._state_cache).to(dev)
        meta[2 * B] = emit
        ids = torch.from_numpy(meta[:2 * B].astype(np.int64)).to(dev)
        buf, self._cache_dev = self.synth(
            torch.from_numpy(spec).to(dev), ids[:B], ids[B:], emit,
            self._cache_dev)
        self._prev_n = prev_n
        return buf, emit
