"""Resident decode: frames stay on the device and only a 32-bit hash of
each comes back.  The counterpart of `resident.py` of the JAX package:
`_hash_kernel` (`resident.py:31-50`), `frame_hash_device` (`:53-57`) and
`decode_resident` (`:74-130`, without its warm-up pass, which exists for
XLA compiles).

The hash is `api.frame_hash` (the reference's `frame_hash_host`):
for each plane [ph, pw] (uint8 at 8 bits, uint16 at 10 and 12),
sum(p[r, c] * (1 + r * 2654435761 + c * 40503)) in uint32, wrapping,
and h = h * 16777619 + sum over the planes from h = 2166136261.  On CUDA
tensors `frame_hash_device` launches the hand-written kernel
`csrc/frame_hash.cu` (built by nvcc at first use) or raises; CPU
tensors take the plain version, int64 masked to 32 bits, since torch
has no uint32 arithmetic.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional, Sequence

import torch

_FNV = 16777619
_RK = 2654435761
_CK = 40503
_SEED = 2166136261
_M32 = 0xFFFFFFFF


def frame_hash_plain(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The hash of integer planes in plain torch ops, on their device:
    a 0-d int64 tensor in [0, 2^32)."""
    dev = planes[0].device
    h = torch.tensor(_SEED, dtype=torch.int64, device=dev)
    for p in planes:
        ph, pw = p.shape
        r = torch.arange(ph, dtype=torch.int64, device=dev)[:, None]
        c = torch.arange(pw, dtype=torch.int64, device=dev)[None, :]
        wts = (1 + r * _RK + c * _CK) & _M32
        # each product is below 2^32 after the mask, their sum below 2^63
        s = ((p.to(torch.int64) * wts) & _M32).sum()
        h = (h * _FNV + s) & _M32
    return h


def _lib():
    from easyav1_tpu_torch import _build
    lib = _build.load("frame_hash")
    fn = lib.frame_hash_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, ctypes.c_int, vp, vp]
    return lib


def frame_hash_device(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The hash of a frame's planes (one to three, 2-D, rows contiguous,
    all uint8 or all uint16) where they lie, without waiting for it: a
    0-d tensor on their device, read with `hash_value`.  CUDA planes
    launch the kernel once, or raise; CPU planes take
    `frame_hash_plain`."""
    planes = list(planes)
    dev = planes[0].device
    if any(p.device != dev for p in planes):
        raise ValueError("the planes lie on different devices")
    if dev.type == "cpu":
        return frame_hash_plain(planes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= len(planes) <= 3:
        raise ValueError("one to three planes")
    dt = planes[0].dtype
    for k, p in enumerate(planes):
        if p.dtype not in (torch.uint8, torch.uint16) or p.dtype != dt \
                or p.dim() != 2 or (p.shape[1] > 1 and p.stride(1) != 1) \
                or p.stride(0) < p.shape[1]:
            raise ValueError(f"planes[{k}]: want 2-D uint8 or uint16, one "
                             f"type for all, with contiguous rows, got "
                             f"{p.dtype} {tuple(p.shape)} strides "
                             f"{p.stride()}")
    n = len(planes)
    words = torch.zeros(8, dtype=torch.int32, device=dev)
    ints = ctypes.c_int * n
    with torch.cuda.device(dev):
        rc = _lib().frame_hash_launch(
            n, (ctypes.c_void_p * n)(*(p.data_ptr() for p in planes)),
            ints(*(p.shape[0] for p in planes)),
            ints(*(p.shape[1] for p in planes)),
            ints(*(p.stride(0) for p in planes)), planes[0].element_size(),
            words.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"frame_hash launch failed: cudaError {rc}")
    frame_hash_device.launches += 1
    return words[4]


frame_hash_device.launches = 0


def hash_value(h) -> int:
    """The hash as a Python int in [0, 2^32); waits for the device."""
    return int(h) & _M32


def decode_resident(path: str, device="cuda",
                    max_frames: Optional[int] = None,
                    host_residual: Optional[bool] = None):
    """Decode the video track of the WebM file `path` on `device` in
    resident mode (the first `max_frames` packets of it, if given): no
    plane is downloaded, each frame is hashed where it lies and only the
    hashes come back.  host_residual: as `EasyAV1`'s.

    Returns (n_frames, wall_seconds, hashes, frames): the wall time
    covers decode and hash; `frames` are the frame objects, whose `data`
    downloads a frame's planes when first indexed.  A frame the C recon
    made (a fallback) is hashed on the host."""
    from easyav1_tpu_torch.api import (frame_hash, host_residual_default,
                                       resolve_device)
    from easyav1_tpu_torch.container.webm import TrackType, WebMDemuxer
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    device = resolve_device(device)
    if device is None:
        raise ValueError("resident decode needs a torch device")
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts: List[bytes] = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    if max_frames is not None:
        pkts = pkts[:max_frames]
    be = AV1Backend(vt, device, resident=True,
                    host_residual=(host_residual_default()
                                   if host_residual is None
                                   else bool(host_residual)))
    t0 = time.perf_counter()
    hashes, frames = [], []
    for pk in pkts:
        for f in be.decode([pk], 0):
            frames.append(f)
            pl = getattr(f.data, "device_planes", None)
            hashes.append(frame_hash_device(pl) if pl is not None
                          else frame_hash(f.data))
    # waits for all device work and brings the hashes back
    hashes = [hash_value(h) for h in hashes]
    wall = time.perf_counter() - t0
    return len(frames), wall, hashes, frames
