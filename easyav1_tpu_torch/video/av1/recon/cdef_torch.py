"""CDEF as exact torch ops: the counterparts of `cdef_jax._dirs_body`
(`cdef_jax.py:245-279`) and `cdef_jax._filter_body` (`:107-234`).

The direction search runs in int64 for every 8x8 luma unit, so it is
exact whether or not the unit grid overhangs the plane (taps outside the
plane read CDEF_VERY_LARGE); the JAX package searches on the host in
that case.  The filter gathers each tap by the per-pixel direction.
Leading dimensions are independent planes (a stream axis): a tap never
reads across them.

`dirs_launch` and `filter_launch` are what the postfilter calls: on CUDA
tensors each launches its kernel of `csrc/cdef.cu` (built by nvcc at
first use) once a frame, the filter for all its planes, or raises; on
CPU tensors they take `find_dirs` and `filter_planes`.
`dirs_launch.launches` and `filter_launch.launches` count the kernels'
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from easyav1_tpu_torch.video.av1.recon.lf_torch import on_card

# the tables below are the port's copies of cdef_jax.py:19-68
CDEF_VERY_LARGE = 0x4000

# Cdef_Directions[dir][k] = (dy, dx), primary taps k=0,1
CDEF_DIRECTIONS = np.array([
    [[-1, 1], [-2, 2]], [[0, 1], [-1, 2]], [[0, 1], [0, 2]],
    [[0, 1], [1, 2]], [[1, 1], [2, 2]], [[1, 0], [2, 1]],
    [[1, 0], [2, 0]], [[1, 0], [2, -1]]], np.int32)

DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)

CDEF_UV_DIR = np.array([
    [[0, 1, 2, 3, 4, 5, 6, 7], [1, 2, 2, 2, 3, 4, 6, 0]],
    [[7, 0, 2, 4, 5, 6, 6, 6], [0, 1, 2, 3, 4, 5, 6, 7]]], np.int32)


def _partial_indicators():
    """IND[d, k, i, j] = 1 where pixel (i,j) of an 8x8 block contributes
    to partial[d][k] (spec §7.15.2 direction search)."""
    ind = np.zeros((8, 15, 8, 8), np.int32)
    for i in range(8):
        for j in range(8):
            ind[0, i + j, i, j] = 1
            ind[1, i + (j >> 1), i, j] = 1
            ind[2, i, i, j] = 1
            ind[3, 3 + i - (j >> 1), i, j] = 1
            ind[4, 7 + i - j, i, j] = 1
            ind[5, 3 - (i >> 1) + j, i, j] = 1
            ind[6, j, i, j] = 1
            ind[7, (i >> 1) + j, i, j] = 1
    return ind


def _cost_weights():
    """W[d, k] so that cost[d] = sum_k W[d,k] * partial[d,k]^2."""
    w = np.zeros((8, 15), np.int64)
    for d in (2, 6):
        w[d, :8] = 105
    for d in (0, 4):
        for i in range(7):
            w[d, i] = DIV_TABLE[i + 1]
            w[d, 14 - i] = DIV_TABLE[i + 1]
        w[d, 7] = 105
    for d in (1, 3, 5, 7):
        for i in range(5):
            w[d, 3 + i] = 105
        for i in range(3):
            w[d, i] = DIV_TABLE[2 * i + 2]
            w[d, 10 - i] = DIV_TABLE[2 * i + 2]
    return w


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive int32 values, exactly."""
    out = torch.zeros_like(x)
    for b in range(1, 31):
        out += (x >= (1 << b)).to(x.dtype)
    return out


def find_dirs(luma: torch.Tensor, uh: int, uw: int, coeff_shift: int,
              tabs: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dir, var) int32 [..., uh, uw] per 8x8 unit of the deblocked luma
    planes [..., ph, pw], padded to the unit grid with CDEF_VERY_LARGE."""
    *lead, ph, pw = luma.shape
    pad = torch.full((*lead, uh * 8, uw * 8), CDEF_VERY_LARGE,
                     dtype=torch.int64, device=luma.device)
    pad[..., :ph, :pw] = luma
    n = uh * uw * int(np.prod(lead))
    blocks = pad.reshape(*lead, uh, 8, uw, 8).transpose(-3, -2).reshape(n, 64)
    x = (blocks >> coeff_shift) - 128
    idx = tabs["cdef_partial_index"].reshape(1, 512).expand(n, 512)
    part = torch.zeros((n, 8 * 15), dtype=torch.int64, device=luma.device)
    part.scatter_add_(1, idx, x.repeat(1, 8))
    cost = (part.reshape(n, 8, 15) ** 2
            * tabs["cdef_cost_weights"][None]).sum(-1)      # [n, 8]
    best = torch.argmax(cost, dim=-1)                   # first max wins
    bc = cost.gather(1, best[:, None])[:, 0]
    oc = cost.gather(1, ((best + 4) & 7)[:, None])[:, 0]
    # int32 as the reference's host search casts it
    var = ((bc - oc) >> 10).to(torch.int32)
    return (best.to(torch.int32).reshape(*lead, uh, uw),
            var.reshape(*lead, uh, uw))


def filter_plane(plane: torch.Tensor, dir_u: torch.Tensor,
                 var_u: torch.Tensor, pri_u: torch.Tensor,
                 sec_u: torch.Tensor, filt_u: torch.Tensor, ssx: int,
                 ssy: int, p: int, bd: int, damping: int,
                 tabs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """CDEF of plane `p` ([..., ph, pw] int32, deblocked) from the
    per-unit direction, variance, strengths (shifted by coeff_shift, 0
    where the unit is skipped) and filter flags ([..., uh, uw] int32).
    `damping` includes coeff_shift: an int, or an int32 tensor that
    broadcasts against the unit maps ([S, 1, 1], one a stream)."""
    *lead, ph, pw = plane.shape
    cs = bd - 8
    bw = 8 >> (ssx if p else 0)
    bh = 8 >> (ssy if p else 0)
    pdamp = damping - (1 if p else 0)
    zero = torch.zeros_like(pri_u)
    if p == 0:
        i = torch.clamp(_floor_log2(torch.clamp(var_u >> 6, min=1)), max=12)
        adj = torch.where(var_u != 0, (pri_u * (4 + i) + 8) >> 4, zero)
        # the direction gate reads the strength before the variance scaling
        pdir_u = torch.where(pri_u != 0, dir_u, zero)
        pri_u = torch.where(pri_u != 0, adj, zero)
    else:
        remap = tabs["cdef_uv_dir"][ssx, ssy].to(torch.int32)
        pdir_u = torch.where(pri_u != 0, remap[dir_u.long()], zero)

    def shift_for(thr):
        return torch.clamp(pdamp - _floor_log2(torch.clamp(thr, min=1)),
                           min=0)

    def up(u):
        e = u.repeat_interleave(bh, -2).repeat_interleave(bw, -1)
        return e[..., :ph, :pw]

    pri = up(pri_u)
    sec = up(sec_u)
    pri_sh = up(shift_for(pri_u))
    sec_sh = up(shift_for(sec_u))
    pdir = up(pdir_u).long()
    filt = up(filt_u)

    src = torch.full((*lead, ph + 4, pw + 4), CDEF_VERY_LARGE,
                     dtype=torch.int32, device=plane.device)
    src[..., 2:2 + ph, 2:2 + pw] = plane
    flat_src = src.reshape(-1)
    rows = torch.arange(ph, device=plane.device)[:, None]
    cols = torch.arange(pw, device=plane.device)[None, :]
    centre = (rows + 2) * (pw + 4) + cols + 2
    if lead:
        # each plane's taps index its own padded plane of flat_src
        n = int(np.prod(lead))
        centre = centre + (torch.arange(n, device=plane.device)
                           * ((ph + 4) * (pw + 4))).reshape(*lead, 1, 1)
    dirs = tabs["cdef_directions"]                        # [8, 2, 2]
    step = dirs[..., 0] * (pw + 4) + dirs[..., 1]         # [8, 2]

    def tap(d, k, sgn):
        return flat_src[centre + sgn * step[d, k]]

    def constr(diff, thr, sh):
        ad = diff.abs()
        mag = torch.minimum(ad, torch.clamp(thr - (ad >> sh), min=0))
        return torch.where(diff < 0, -mag, mag)

    px = plane
    s = torch.zeros_like(px)
    mx = px
    mn = px
    odd = (pri >> cs) & 1
    for k, (w_odd, w_even) in enumerate(((3, 4), (3, 2))):
        w_k = w_even + (w_odd - w_even) * odd
        for sgn in (1, -1):
            v = tap(pdir, k, sgn)
            s = s + torch.where(pri != 0, w_k * constr(v - px, pri, pri_sh),
                                0)
            seen = (pri != 0) & (v != CDEF_VERY_LARGE)
            mx = torch.where(seen, torch.maximum(mx, v), mx)
            mn = torch.where(seen, torch.minimum(mn, v), mn)
    for rot in (2, 6):
        sdir = (pdir + rot) & 7
        for k, st in enumerate((2, 1)):
            for sgn in (1, -1):
                v = tap(sdir, k, sgn)
                s = s + torch.where(sec != 0, st * constr(v - px, sec, sec_sh),
                                    0)
                seen = (sec != 0) & (v != CDEF_VERY_LARGE)
                mx = torch.where(seen, torch.maximum(mx, v), mx)
                mn = torch.where(seen, torch.minimum(mn, v), mn)
    val = px + ((8 + s - (s < 0).to(s.dtype)) >> 4)
    val = torch.minimum(torch.maximum(val, mn), mx)
    active = (filt != 0) & ((pri != 0) | (sec != 0))
    return torch.where(active, val, px)


def filter_planes(planes: List[torch.Tensor], dir_u: torch.Tensor,
                  var_u: torch.Tensor, pri: List[torch.Tensor],
                  sec: List[torch.Tensor], filt_u: torch.Tensor, ssx: int,
                  ssy: int, bd: int, damping,
                  tabs: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """`filter_launch` as plain torch ops on any device: `filter_plane`
    of each plane (luma first) with its strengths."""
    return [filter_plane(x, dir_u, var_u, pri[p], sec[p], filt_u, ssx, ssy,
                         p, bd, damping, tabs)
            for p, x in enumerate(planes)]


def strengths(maps: Dict, planes: int):
    """([pri], [sec]) unit maps of `planes` planes, luma first, from the
    CDEF maps of `postfilter.host_maps` or `stack_maps`."""
    return ([maps["pri_y" if p == 0 else "pri_uv"] for p in range(planes)],
            [maps["sec_y" if p == 0 else "sec_uv"] for p in range(planes)])


def _lib():
    from easyav1_tpu_torch import _build
    lib = _build.load("cdef")
    if lib.cdef_dirs_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.cdef_dirs_launch.restype = ci
        lib.cdef_dirs_launch.argtypes = [vp, vp, vp] + [ci] * 6 + [vp]
        lib.cdef_frame_launch.restype = ci
        lib.cdef_frame_launch.argtypes = [
            ctypes.POINTER(vp), ctypes.POINTER(ci), vp, vp, vp, vp] + [
            ci] * 8 + [vp]
    return lib


def dirs_launch(luma: torch.Tensor, uh: int, uw: int, coeff_shift: int,
                tabs: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dir, var) int32 [..., uh, uw] of `find_dirs` for int32 luma
    planes [..., ph, pw] (at most one leading axis).  CUDA tensors launch
    `cdef_dirs_kernel` once, or raise; CPU tensors take `find_dirs`."""
    if luma.dtype != torch.int32 or not 2 <= luma.dim() <= 3 \
            or uh < 1 or uw < 1:
        raise ValueError(f"want int32 luma planes [..., ph, pw] and a unit "
                         f"grid, got {luma.dtype} {tuple(luma.shape)}, "
                         f"{uh}x{uw}")
    if not on_card(luma, [luma]):
        return find_dirs(luma, uh, uw, coeff_shift, tabs)
    *lead, ph, pw = luma.shape
    dirs = torch.empty((*lead, uh, uw), dtype=torch.int32,
                       device=luma.device)
    var = torch.empty_like(dirs)
    with torch.cuda.device(luma.device):
        rc = _lib().cdef_dirs_launch(
            luma.data_ptr(), dirs.data_ptr(), var.data_ptr(),
            lead[0] if lead else 1, ph, pw, uh, uw, coeff_shift,
            torch.cuda.current_stream(luma.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cdef_dirs launch failed: cudaError {rc}")
    dirs_launch.launches += 1
    return dirs, var


dirs_launch.launches = 0


def filter_launch(planes: List[torch.Tensor], dir_u: torch.Tensor,
                  var_u: torch.Tensor, pri: List[torch.Tensor],
                  sec: List[torch.Tensor], filt_u: torch.Tensor, ssx: int,
                  ssy: int, bd: int, damping,
                  tabs: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """`filter_plane` of a frame's int32 planes [..., ph, pw] (1 to 3,
    luma first, at most one leading axis, samples in [0, 2^bd)) with the
    int32 unit maps [..., uh, uw] covering them: the search's direction
    and variance, each plane's strengths `pri[p]` and `sec[p]`, the
    filter flags; `damping` an int or an int32 tensor of one value a
    stream ([S, 1, 1]).  CUDA tensors launch `cdef_filter_kernel` once
    for every plane into new planes, or raise; CPU tensors take
    `filter_planes`.  No input is written."""
    planes = list(planes)
    n = len(planes)
    lead = tuple(planes[0].shape[:-2]) if planes else ()
    units = [dir_u, var_u, filt_u, *pri[:n], *sec[:n]]
    uh, uw = dir_u.shape[-2:] if dir_u.dim() >= 2 else (0, 0)
    bad = not 1 <= n <= 3 or len(pri) != n or len(sec) != n or any(
        u.dtype != torch.int32 or tuple(u.shape) != (*lead, uh, uw)
        for u in units)
    for p, x in enumerate(planes):
        bh, bw = 8 >> (ssy if p else 0), 8 >> (ssx if p else 0)
        bad = bad or x.dtype != torch.int32 or not 2 <= x.dim() <= 3 \
            or tuple(x.shape[:-2]) != lead or uh * bh < x.shape[-2] \
            or uw * bw < x.shape[-1]
    if bad:
        raise ValueError(
            f"want 1 to 3 int32 planes [..., ph, pw] and int32 unit maps "
            f"covering them, got {[(x.dtype, tuple(x.shape)) for x in planes]}"
            f" and {[(u.dtype, tuple(u.shape)) for u in units]}")
    damp = damping if isinstance(damping, torch.Tensor) else None
    if damp is not None and (damp.dtype != torch.int32
                             or damp.numel() != (lead[0] if lead else 1)):
        raise ValueError(f"want one int32 damping a stream, got "
                         f"{damp.dtype} {tuple(damp.shape)}")
    if not on_card(planes[0], planes + units
                   + ([damp] if damp is not None else [])):
        return filter_planes(planes, dir_u, var_u, pri, sec, filt_u, ssx,
                             ssy, bd, damping, tabs)
    out = [torch.empty_like(x) for x in planes]
    ptrs = [t.data_ptr() for p in range(n)
            for t in (planes[p], out[p], pri[p], sec[p])]
    dims = [d for x in planes for d in x.shape[-2:]]
    dev = planes[0].device
    with torch.cuda.device(dev):
        rc = _lib().cdef_frame_launch(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(dims))(*dims), dir_u.data_ptr(),
            var_u.data_ptr(), filt_u.data_ptr(),
            None if damp is None else damp.data_ptr(),
            0 if damp is not None else int(damping), n,
            lead[0] if lead else 1, uh, uw, ssx, ssy, bd,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cdef_filter launch failed: cudaError {rc}")
    filter_launch.launches += 1
    return out


filter_launch.launches = 0
