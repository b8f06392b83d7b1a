"""Deblocking loop filter as exact int32 torch ops: the counterpart of
`lf_jax._pass_body` (`lf_jax.py:27-187`).

Within one pass every edge's read window is disjoint from every other
edge's write window, so all edges of the pass filter at once from the
pre-pass pixels.  Edges sit on the 4 px grid, so each tap is a strided
view of the padded plane.  The horizontal pass runs on the transposed
plane.
"""

from __future__ import annotations

import torch

PAD = 8


def pass_body(buf: torch.Tensor, size_m: torch.Tensor, limit: torch.Tensor,
              blimit: torch.Tensor, thresh: torch.Tensor,
              bd: int) -> torch.Tensor:
    """One vertical-edge pass over an [H, W] int32 plane.  Edge e sits at
    x = 4(e+1); size_m, limit, blimit, thresh are [H, ne] int32 maps
    (size 0 = inactive, else the filter length 4, 6, 8 or 14)."""
    H, W = buf.shape
    ne = (W + 3) // 4 - 1
    if ne <= 0:
        return buf
    F = 1 << (bd - 8)
    half = 1 << (bd - 1)
    mxv = (1 << bd) - 1
    B = torch.zeros((H, W + 2 * PAD), dtype=torch.int32, device=buf.device)
    B[:, PAD:PAD + W] = buf
    span = 4 * (ne - 1) + 1

    def lanes(off):
        s = PAD + 4 + off
        return B[:, s:s + span:4]

    # taps P[k] at x-1-k, Q[k] at x+k, snapshotted before any write
    P = [lanes(-1 - k).clone() for k in range(7)]
    Q = [lanes(k).clone() for k in range(7)]
    p0, p1, p2, p3 = P[:4]
    q0, q1, q2, q3 = Q[:4]
    a = torch.abs
    sz = size_m

    mask = ((a(p1 - p0) <= limit) & (a(q1 - q0) <= limit)
            & (a(p0 - q0) * 2 + (a(p1 - q1) >> 1) <= blimit))
    mask6 = (a(p2 - p1) <= limit) & (a(q2 - q1) <= limit)
    mask8 = (a(p3 - p2) <= limit) & (a(q3 - q2) <= limit)
    mask = mask & (mask6 | (sz < 6)) & (mask8 | (sz < 8)) & (sz > 0)

    flat = ((a(p1 - p0) <= F) & (a(q1 - q0) <= F)
            & (a(p2 - p0) <= F) & (a(q2 - q0) <= F))
    flat = flat & (((a(p3 - p0) <= F) & (a(q3 - q0) <= F)) | (sz < 8))
    flat2 = ((a(P[4] - p0) <= F) & (a(Q[4] - q0) <= F)
             & (a(P[5] - p0) <= F) & (a(Q[5] - q0) <= F)
             & (a(P[6] - p0) <= F) & (a(Q[6] - q0) <= F))

    use14 = mask & (sz == 14) & flat & flat2
    use8 = mask & (sz >= 8) & flat & ~use14
    use6 = mask & (sz == 6) & flat
    use4 = mask & ~(use14 | use8 | use6)

    pv, qv = P, Q
    f14 = {
        -6: (pv[6] * 7 + pv[5] * 2 + pv[4] * 2 + pv[3] + pv[2] + pv[1]
             + pv[0] + qv[0] + 8) >> 4,
        -5: (pv[6] * 5 + pv[5] * 2 + pv[4] * 2 + pv[3] * 2 + pv[2] + pv[1]
             + pv[0] + qv[0] + qv[1] + 8) >> 4,
        -4: (pv[6] * 4 + pv[5] + pv[4] * 2 + pv[3] * 2 + pv[2] * 2 + pv[1]
             + pv[0] + qv[0] + qv[1] + qv[2] + 8) >> 4,
        -3: (pv[6] * 3 + pv[5] + pv[4] + pv[3] * 2 + pv[2] * 2 + pv[1] * 2
             + pv[0] + qv[0] + qv[1] + qv[2] + qv[3] + 8) >> 4,
        -2: (pv[6] * 2 + pv[5] + pv[4] + pv[3] + pv[2] * 2 + pv[1] * 2
             + pv[0] * 2 + qv[0] + qv[1] + qv[2] + qv[3] + qv[4] + 8) >> 4,
        -1: (pv[6] + pv[5] + pv[4] + pv[3] + pv[2] + pv[1] * 2 + pv[0] * 2
             + qv[0] * 2 + qv[1] + qv[2] + qv[3] + qv[4] + qv[5] + 8) >> 4,
        0: (pv[5] + pv[4] + pv[3] + pv[2] + pv[1] + pv[0] * 2 + qv[0] * 2
            + qv[1] * 2 + qv[2] + qv[3] + qv[4] + qv[5] + qv[6] + 8) >> 4,
        1: (pv[4] + pv[3] + pv[2] + pv[1] + pv[0] + qv[0] * 2 + qv[1] * 2
            + qv[2] * 2 + qv[3] + qv[4] + qv[5] + qv[6] * 2 + 8) >> 4,
        2: (pv[3] + pv[2] + pv[1] + pv[0] + qv[0] + qv[1] * 2 + qv[2] * 2
            + qv[3] * 2 + qv[4] + qv[5] + qv[6] * 3 + 8) >> 4,
        3: (pv[2] + pv[1] + pv[0] + qv[0] + qv[1] + qv[2] * 2 + qv[3] * 2
            + qv[4] * 2 + qv[5] + qv[6] * 4 + 8) >> 4,
        4: (pv[1] + pv[0] + qv[0] + qv[1] + qv[2] + qv[3] * 2 + qv[4] * 2
            + qv[5] * 2 + qv[6] * 5 + 8) >> 4,
        5: (pv[0] + qv[0] + qv[1] + qv[2] + qv[3] + qv[4] * 2 + qv[5] * 2
            + qv[6] * 7 + 8) >> 4,
    }
    f8 = {
        -3: (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
        -2: (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
        -1: (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
        0: (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
        1: (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
        2: (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3,
    }
    f6 = {
        -2: (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3,
        -1: (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3,
        0: (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3,
        1: (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3,
    }

    def cl(v):
        return torch.clamp(v, -half, half - 1)

    ps1, ps0 = p1 - half, p0 - half
    qs0, qs1 = q0 - half, q1 - half
    hev = (a(p1 - p0) > thresh) | (a(q1 - q0) > thresh)
    f = torch.where(hev, cl(ps1 - qs1), torch.zeros_like(ps1))
    f = cl(f + 3 * (qs0 - ps0))
    f1 = cl(f + 4) >> 3
    f2 = cl(f + 3) >> 3
    f3 = (f1 + 1) >> 1
    f4 = {
        0: torch.clamp(cl(qs0 - f1) + half, 0, mxv),
        -1: torch.clamp(cl(ps0 + f2) + half, 0, mxv),
        1: torch.clamp(cl(qs1 - f3) + half, 0, mxv),
        -2: torch.clamp(cl(ps1 + f3) + half, 0, mxv),
    }
    f4w = {0: use4, -1: use4, 1: use4 & ~hev, -2: use4 & ~hev}

    # the lanes of neighbouring edges alias across offsets, so each write
    # is masked to the lanes a filter touches; no lane has two writers
    for off in range(-6, 6):
        v = P[-1 - off] if off < 0 else Q[off]
        wm = use14
        if off in f4:
            v = torch.where(f4w[off], f4[off], v)
            wm = wm | f4w[off]
        if off in f6:
            v = torch.where(use6, f6[off], v)
            wm = wm | use6
        if off in f8:
            v = torch.where(use8, f8[off], v)
            wm = wm | use8
        v = torch.where(use14, f14[off], v)
        cur = lanes(off)
        cur.copy_(torch.where(wm, v, cur))
    return B[:, PAD:PAD + W]
