"""The device residual composer: every coded transform of a frame
inverse-transformed into the residual planes on the device.  The
counterpart of `itx_jax.py` (`_make_kernel`, `itx_batch`, `:31-102`) and
of the composer half of `jax_exec.py` (`group_txs` `:148-181`,
`_residual_multi_kernel` `:352-380`, `apply_residuals_fused`
`:434-481`), which the reference runs when `EASYAV1_HOST_RESID=0`.

The input is what the C decoder exports: the transform records
`txs` [n, 8] int32 (plane, x, y, tx_size, tx_type, eob packed with the
nonzero box, coefficient offset, lossless) and the dense dequantized
coefficients `coeffs` int32, adj_h x adj_w of them a record.  The output
is the layout of `records.compose_residual_host`, the host C composer:
one plane a `dims` entry, int16 at 8 and 10 bits and int32 at 12, zero
where no transform lies, a transform cropped at the plane's right and
bottom edges.

`compose_residual` launches the hand-written kernel `csrc/itx.cu` once
for all records of a frame (on CUDA tensors; built by nvcc at first
use) or raises; CPU tensors take `compose_residual_plain`, the same
arithmetic as torch ops in int64 (`itx_ref.transform_1d` on tensors,
`itx_batch_plain`), a batch per (tx_size, tx_type).  Neither pads its
batches: the reference's power-of-two batches, sticky 64-aligned caps
and one-jit fusion existed for XLA recompiles and the TPU's
per-dispatch cost.  Lossless (WHT) records are not taken: the recons
decline such frames, as the reference's device composer does
(`jax_exec.py:957-960`).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from easyav1_tpu_torch.video.av1 import tables as T
from easyav1_tpu_torch.video.av1.itx_ref import (_ROW_SHIFT, _TX_1D,
                                                 transform_1d)

# int32 fields of a transform record
TX_RECORD = 8
R_PLANE, R_X, R_Y, R_SIZE, R_TYPE, R_EOB, R_OFF, R_LOSSLESS = range(8)

_KIND_LIMIT = {"dct": 64, "adst": 16, "flipadst": 16, "identity": 64}


def legal(tx_size: int, tx_type: int) -> bool:
    """Whether the pair has a 1-D transform of each of its sides: ADST
    tops out at 16 points (on the coded, adjusted size), as the
    reference's tests have it."""
    adj = T.ADJUSTED_TX_SIZE[tx_size]
    vk, hk = _TX_1D[tx_type]
    return (T.TX_HEIGHT[adj] <= _KIND_LIMIT[vk]
            and T.TX_WIDTH[adj] <= _KIND_LIMIT[hk])


def legal_pairs() -> List[Tuple[int, int]]:
    """Every legal (tx_size, tx_type) pair: 208."""
    return [(s, t) for s in range(len(T.TX_WIDTH)) for t in range(16)
            if legal(s, t)]


# [tx_size, tx_type] -> legal, and the coefficients a record reads
_LEGAL = np.array([[legal(s, t) for t in range(16)]
                   for s in range(len(T.TX_WIDTH))])
_NCOEF = np.array([T.TX_WIDTH[a] * T.TX_HEIGHT[a]
                   for a in T.ADJUSTED_TX_SIZE], np.int64)


def residual_dtype(bd: int) -> torch.dtype:
    """The composed planes' type: int16 up to 10 bits, int32 at 12."""
    return torch.int16 if bd <= 10 else torch.int32


def check_txs(txs: np.ndarray, n_coeffs: int, n_planes: int) -> None:
    """Raises ValueError unless every record is one the composers take:
    a plane below n_planes, a tx size and a legal type, coordinates not
    below 0, its coefficients inside the n_coeffs exported, not
    lossless."""
    if txs.ndim != 2 or txs.shape[1] != TX_RECORD:
        raise ValueError(f"txs: want [n, {TX_RECORD}], got {txs.shape}")
    if txs.shape[0] == 0:
        return
    s, t = txs[:, R_SIZE], txs[:, R_TYPE]
    ok = ((txs[:, R_PLANE] >= 0) & (txs[:, R_PLANE] < n_planes)
          & (s >= 0) & (s < len(T.TX_WIDTH)) & (t >= 0) & (t < 16)
          & (txs[:, R_X] >= 0) & (txs[:, R_Y] >= 0)
          & (txs[:, R_LOSSLESS] == 0))
    ok[ok] &= _LEGAL[s[ok], t[ok]]
    off = txs[:, R_OFF].astype(np.int64)
    ok[ok] &= (off[ok] >= 0) & (off[ok] + _NCOEF[s[ok]] <= n_coeffs)
    if not ok.all():
        k = int(np.flatnonzero(~ok)[0])
        raise ValueError(f"transform record {k} is not one the composers "
                         f"take: {txs[k].tolist()}")


def itx_batch_plain(coeffs: torch.Tensor, tx_size: int, tx_type: int,
                    bd: int) -> torch.Tensor:
    """coeffs [N, adj_h, adj_w] (any integer type) -> residual blocks
    [N, h, w] int32, on coeffs' device: `itx_jax._make_kernel` as torch
    ops in int64 (the reference's oracle `recon_ref.inverse_transform`
    on a batch)."""
    w, h = T.TX_WIDTH[tx_size], T.TX_HEIGHT[tx_size]
    adj = T.ADJUSTED_TX_SIZE[tx_size]
    aw, ah = T.TX_WIDTH[adj], T.TX_HEIGHT[adj]
    if tuple(coeffs.shape[1:]) != (ah, aw):
        raise ValueError(f"tx size {tx_size}: want [N, {ah}, {aw}] "
                         f"coefficients, got {tuple(coeffs.shape)}")
    mn, mx = -(1 << (bd + 7)), (1 << (bd + 7)) - 1
    vkind, hkind = _TX_1D[tx_type]
    buf = torch.zeros((coeffs.shape[0], h, w), dtype=torch.int64,
                      device=coeffs.device)
    buf[:, :ah, :aw] = coeffs
    if abs(w.bit_length() - h.bit_length()) == 1:
        buf = (buf * 2896 + 2048) >> 12
    # row pass along the width: the 1-D kernels want the points on axis 0
    rows = transform_1d(hkind, buf.permute(2, 0, 1), mn, mx, xp=torch)
    shift = _ROW_SHIFT[tx_size]
    rows = ((rows + ((1 << shift) >> 1)) >> shift).clamp(mn, mx)
    # column pass along the height: (w, N, h) -> (h, N, w)
    cols = transform_1d(vkind, rows.permute(2, 1, 0), mn, mx, xp=torch)
    return ((cols + 8) >> 4).permute(1, 0, 2).to(torch.int32)


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def compose_residual_plain(txs, coeffs, dims: Sequence[Tuple[int, int]],
                           bd: int, device) -> List[torch.Tensor]:
    """The residual planes of a frame's transform records, in torch ops
    on `device`: `group_txs`, `_residual_multi_kernel` and
    `apply_residuals_fused` without their padding.  txs [n, 8] and
    coeffs int32, numpy or tensors; dims: (h, w) of each plane.  A batch
    a (tx_size, tx_type); each output pixel is scattered through indices
    masked to the plane (torch has no mode="drop"), so a transform that
    overhangs the plane is cropped."""
    device = torch.device(device)
    txs_np = (txs.cpu().numpy() if isinstance(txs, torch.Tensor)
              else np.asarray(txs)).astype(np.int32, copy=False)
    check_txs(txs_np, int(coeffs.shape[0]), len(dims))
    out = [torch.zeros(d, dtype=torch.int32, device=device) for d in dims]
    co = _as_tensor(coeffs, device)
    key = txs_np[:, R_SIZE] * 16 + txs_np[:, R_TYPE]
    for k in np.unique(key):
        sel = np.flatnonzero(key == k)
        ts, tt = int(k) >> 4, int(k) & 15
        adj = T.ADJUSTED_TX_SIZE[ts]
        ah, aw = T.TX_HEIGHT[adj], T.TX_WIDTH[adj]
        h, w = T.TX_HEIGHT[ts], T.TX_WIDTH[ts]
        idx = _as_tensor(txs_np[sel, R_OFF].astype(np.int64), device)
        block = co[idx[:, None] + torch.arange(ah * aw, device=device)]
        res = itx_batch_plain(block.view(-1, ah, aw), ts, tt, bd)
        for p, (ph, pw) in enumerate(dims):
            on = txs_np[sel, R_PLANE] == p
            if not on.any():
                continue
            ys = _as_tensor(txs_np[sel[on], R_Y].astype(np.int64), device)
            xs = _as_tensor(txs_np[sel[on], R_X].astype(np.int64), device)
            yy = ys[:, None, None] + torch.arange(h, device=device)[:, None]
            xx = xs[:, None, None] + torch.arange(w, device=device)
            keep = (yy < ph) & (xx < pw)
            out[p].view(-1)[(yy * pw + xx)[keep]] = \
                res[_as_tensor(np.flatnonzero(on), device)][keep]
    dt = residual_dtype(bd)
    return [o.to(dt) for o in out]


def _lib():
    from easyav1_tpu_torch import _build
    lib = _build.load("itx")
    fn = lib.itx_compose_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [cl, vp, vp, cl, ci, vp, vp, vp, ci, vp]
    return lib


def compose_residual(txs: torch.Tensor, coeffs: torch.Tensor,
                     dims: Sequence[Tuple[int, int]],
                     bd: int) -> List[torch.Tensor]:
    """The residual planes of a frame's transform records where they
    lie: txs [n, 8] int32 and coeffs [m] int32, contiguous, on one
    device, records as `check_txs` takes them (the kernel skips any
    other); dims: (h, w) of each of 1 to 3 planes.  CUDA tensors
    launch `csrc/itx.cu` once (none for a frame without records), or
    raise; CPU tensors take `compose_residual_plain`.  Returns
    contiguous planes of `residual_dtype(bd)`."""
    dev = txs.device
    if coeffs.device != dev:
        raise ValueError("txs and coeffs lie on different devices")
    if txs.dtype != torch.int32 or coeffs.dtype != torch.int32 \
            or txs.dim() != 2 or txs.shape[1] != TX_RECORD \
            or coeffs.dim() != 1 or not txs.is_contiguous() \
            or not coeffs.is_contiguous():
        raise ValueError(f"want contiguous int32 txs [n, {TX_RECORD}] and "
                         f"coeffs [m], got {txs.dtype} {tuple(txs.shape)}, "
                         f"{coeffs.dtype} {tuple(coeffs.shape)}")
    if not 1 <= len(dims) <= 3 or bd not in (8, 10, 12):
        raise ValueError(f"{len(dims)} planes at {bd} bits")
    if dev.type == "cpu":
        return compose_residual_plain(txs, coeffs, dims, bd, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # one fill for all planes, each plane a contiguous view of it
    sizes = [h * w for h, w in dims]
    flat = torch.zeros(sum(sizes), dtype=residual_dtype(bd), device=dev)
    planes = [v.view(d) for v, d in zip(flat.split(sizes), dims)]
    n = txs.shape[0]
    if n == 0:
        return planes
    k = len(dims)
    ints = ctypes.c_int * k
    with torch.cuda.device(dev):
        rc = _lib().itx_compose_launch(
            n, txs.data_ptr(), coeffs.data_ptr(), coeffs.shape[0], k,
            (ctypes.c_void_p * k)(*(p.data_ptr() for p in planes)),
            ints(*(h for h, _ in dims)), ints(*(w for _, w in dims)), bd,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"itx_compose launch failed: cudaError {rc}")
    compose_residual.launches += 1
    return planes


compose_residual.launches = 0


def narrow_residual(planes: List[torch.Tensor]):
    """The composed planes as int16, which the recon kernels take:
    int16 planes as they are (bit depths up to 10); int32 planes (12
    bits) cast when every value fits, else None (the frame is declined;
    never truncated).  The device counterpart of
    `records.narrow_residual`: one min and max over the planes, read
    back once."""
    if all(p.dtype == torch.int16 for p in planes):
        return planes
    live = [p for p in planes if p.numel()]
    if live:
        ext = torch.stack([torch.stack(torch.aminmax(p)) for p in live])
        lo, hi = ext[:, 0].min().item(), ext[:, 1].max().item()
        if lo < -32768 or hi > 32767:
            return None
    return [p.to(torch.int16) for p in planes]
