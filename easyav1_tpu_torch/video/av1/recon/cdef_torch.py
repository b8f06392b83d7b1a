"""CDEF as exact torch ops: the counterparts of `cdef_jax._dirs_body`
(`cdef_jax.py:245-279`) and `cdef_jax._filter_body` (`:107-234`).

The direction search runs in int64 for every 8x8 luma unit, so it is
exact whether or not the unit grid overhangs the plane (taps outside the
plane read CDEF_VERY_LARGE); the JAX package searches on the host in
that case.  The filter gathers each tap by the per-pixel direction.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from easyav1_tpu.video.av1.recon.cdef_jax import CDEF_VERY_LARGE


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive int32 values, exactly."""
    out = torch.zeros_like(x)
    for b in range(1, 31):
        out += (x >= (1 << b)).to(x.dtype)
    return out


def find_dirs(luma: torch.Tensor, uh: int, uw: int, coeff_shift: int,
              tabs: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dir, var) int32 [uh, uw] per 8x8 unit of the deblocked luma
    plane, padded to the unit grid with CDEF_VERY_LARGE."""
    ph, pw = luma.shape
    pad = torch.full((uh * 8, uw * 8), CDEF_VERY_LARGE, dtype=torch.int64,
                     device=luma.device)
    pad[:ph, :pw] = luma
    n = uh * uw
    blocks = pad.reshape(uh, 8, uw, 8).permute(0, 2, 1, 3).reshape(n, 64)
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
    return best.to(torch.int32).reshape(uh, uw), var.reshape(uh, uw)


def filter_plane(plane: torch.Tensor, dir_u: torch.Tensor,
                 var_u: torch.Tensor, pri_u: torch.Tensor,
                 sec_u: torch.Tensor, filt_u: torch.Tensor, ssx: int,
                 ssy: int, p: int, bd: int, damping: int,
                 tabs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """CDEF of plane `p` ([ph, pw] int32, deblocked) from the per-unit
    direction, variance, strengths (shifted by coeff_shift, 0 where the
    unit is skipped) and filter flags ([uh, uw] int32).  `damping`
    includes coeff_shift."""
    ph, pw = plane.shape
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
        e = u.repeat_interleave(bh, 0).repeat_interleave(bw, 1)
        return e[:ph, :pw]

    pri = up(pri_u)
    sec = up(sec_u)
    pri_sh = up(shift_for(pri_u))
    sec_sh = up(shift_for(sec_u))
    pdir = up(pdir_u).long()
    filt = up(filt_u)

    src = torch.full((ph + 4, pw + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=plane.device)
    src[2:2 + ph, 2:2 + pw] = plane
    flat_src = src.reshape(-1)
    rows = torch.arange(ph, device=plane.device)[:, None]
    cols = torch.arange(pw, device=plane.device)[None, :]
    centre = (rows + 2) * (pw + 4) + cols + 2
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
