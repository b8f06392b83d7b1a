# Copy of easyav1_tpu/video/av1/itx_ref.py, the JAX package's counterpart.
"""Bit-exact AV1 inverse transforms (numpy reference, int64 math).

Spec §7.13.2-3: integer butterfly DCT (4..32, 64 via pattern), ADST
(4/8/16), flip-ADST, identity, Walsh-Hadamard; normative rounding
(round2 at 12 bits, 181/256 for 1/sqrt2) and intermediate clamping.
1-D kernels operate on axis 0, batched over axis 1 (all rows/cols at
once). Structural correctness is self-checked against the ideal float
bases (tests), bit-exactness end-to-end against libdav1d.

The port adds `_ROW_SHIFT` and `_TX_1D` from the JAX package's
`recon_ref.py:27-48`, and runs the same butterflies on torch int64
tensors (`transform_1d(..., xp=torch)`, `recon/itx_torch.py`).
"""

from __future__ import annotations

import numpy as np

from easyav1_tpu_torch.video.av1 import constants as C


# libaom av1/common/av1_inv_txfm2d.c inv_shift_* (first entry, negated);
# note the 4:1 sizes (4X16/16X4 -> 1, 8X32/32X8 -> 2) — they are NOT 0/1
_ROW_SHIFT = [0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2]

# 1-D kinds per tx type: (vertical, horizontal)
_TX_1D = {
    C.DCT_DCT: ("dct", "dct"),
    C.ADST_DCT: ("adst", "dct"),
    C.DCT_ADST: ("dct", "adst"),
    C.ADST_ADST: ("adst", "adst"),
    C.FLIPADST_DCT: ("flipadst", "dct"),
    C.DCT_FLIPADST: ("dct", "flipadst"),
    C.FLIPADST_FLIPADST: ("flipadst", "flipadst"),
    C.ADST_FLIPADST: ("adst", "flipadst"),
    C.FLIPADST_ADST: ("flipadst", "adst"),
    C.IDTX: ("identity", "identity"),
    C.V_DCT: ("dct", "identity"),
    C.H_DCT: ("identity", "dct"),
    C.V_ADST: ("adst", "identity"),
    C.H_ADST: ("identity", "adst"),
    C.V_FLIPADST: ("flipadst", "identity"),
    C.H_FLIPADST: ("identity", "flipadst"),
}


def cos128_table():
    i = np.arange(65)
    return np.round(4096 * np.cos(i * np.pi / 128)).astype(np.int64)


_COS = cos128_table()


def cos128(angle: int) -> int:
    a = angle & 255
    if a <= 64:
        return int(_COS[a])
    if a <= 128:
        return -int(_COS[128 - a])
    if a <= 192:
        return -int(_COS[a - 128])
    return int(_COS[256 - a])


def _r12(x):
    return (x + 2048) >> 12


def _half(x):
    return (x * 181 + 128) >> 8


def _rot(a, b, phi):
    """Returns (a*cos(64-phi) - b*cos(phi), a*cos(phi) + b*cos(64-phi))
    rounded at 12 bits — the dct odd-stage rotation."""
    return (_r12(a * cos128(64 - phi) - b * cos128(phi)),
            _r12(a * cos128(phi) + b * cos128(64 - phi)))


def inv_dct4(c, cl):
    in0, in1, in2, in3 = c
    t0 = _half(in0 + in2)
    t1 = _half(in0 - in2)
    t2 = _r12(in1 * 1567 - in3 * 3784)
    t3 = _r12(in1 * 3784 + in3 * 1567)
    return [cl(t0 + t3), cl(t1 + t2), cl(t1 - t2), cl(t0 - t3)]


def inv_dct8(c, cl):
    t = inv_dct4(c[0::2], cl)  # t0..t3
    in1, in3, in5, in7 = c[1], c[3], c[5], c[7]
    t4a = _r12(in1 * 799 - in7 * 4017)
    t7a = _r12(in1 * 4017 + in7 * 799)
    t5a = _r12(in5 * 3406 - in3 * 2276)
    t6a = _r12(in5 * 2276 + in3 * 3406)
    t4 = cl(t4a + t5a)
    t5b = cl(t4a - t5a)
    t7 = cl(t7a + t6a)
    t6b = cl(t7a - t6a)
    t5 = _half(t6b - t5b)
    t6 = _half(t6b + t5b)
    o = [t4, t5, t6, t7]
    return ([cl(t[i] + o[3 - i]) for i in range(4)]
            + [cl(t[3 - i] - o[i]) for i in range(4)])


def inv_dct16(c, cl):
    t = inv_dct8(c[0::2], cl)  # t0..t7
    in1, in3, in5, in7 = c[1], c[3], c[5], c[7]
    in9, in11, in13, in15 = c[9], c[11], c[13], c[15]
    t8a, t15a = _rot(in1, in15, 4)
    t9a, t14a = _rot(in9, in7, 36)
    t10a, t13a = _rot(in5, in11, 20)
    t11a, t12a = _rot(in13, in3, 52)
    t8 = cl(t8a + t9a)
    t9 = cl(t8a - t9a)
    t10 = cl(t11a - t10a)
    t11 = cl(t11a + t10a)
    t12 = cl(t12a + t13a)
    t13 = cl(t12a - t13a)
    t14 = cl(t15a - t14a)
    t15 = cl(t15a + t14a)
    t9a = _r12(t14 * 1567 - t9 * 3784)
    t14a = _r12(t14 * 3784 + t9 * 1567)
    t10a = _r12(-(t13 * 3784 + t10 * 1567))
    t13a = _r12(t13 * 1567 - t10 * 3784)
    t8a = cl(t8 + t11)
    t9b = cl(t9a + t10a)
    t10b = cl(t9a - t10a)
    t11a = cl(t8 - t11)
    t12a = cl(t15 - t12)
    t13b = cl(t14a - t13a)
    t14b = cl(t14a + t13a)
    t15a = cl(t15 + t12)
    t10c = _half(t13b - t10b)
    t13c = _half(t13b + t10b)
    t11b = _half(t12a - t11a)
    t12b = _half(t12a + t11a)
    o = [t8a, t9b, t10c, t11b, t12b, t13c, t14b, t15a]
    return ([cl(t[i] + o[7 - i]) for i in range(8)]
            + [cl(t[7 - i] - o[i]) for i in range(8)])


def inv_dct32(c, cl):
    t = inv_dct16(c[0::2], cl)  # t0..t15
    phis = [2, 34, 18, 50, 10, 42, 26, 58]
    firsts = [1, 17, 9, 25, 5, 21, 13, 29]
    lo = [None] * 8
    hi = [None] * 8
    for j in range(8):
        lo[j], hi[j] = _rot(c[firsts[j]], c[32 - firsts[j]], phis[j])
    # ta[0..15] = t16a..t31a in natural order
    ta = [None] * 16
    for j in range(8):
        ta[j] = lo[j]
        ta[15 - j] = hi[j]
    # stage A
    t16 = cl(ta[0] + ta[1])
    t17 = cl(ta[0] - ta[1])
    t18 = cl(ta[3] - ta[2])
    t19 = cl(ta[3] + ta[2])
    t20 = cl(ta[4] + ta[5])
    t21 = cl(ta[4] - ta[5])
    t22 = cl(ta[7] - ta[6])
    t23 = cl(ta[7] + ta[6])
    t24 = cl(ta[8] + ta[9])
    t25 = cl(ta[8] - ta[9])
    t26 = cl(ta[11] - ta[10])
    t27 = cl(ta[11] + ta[10])
    t28 = cl(ta[12] + ta[13])
    t29 = cl(ta[12] - ta[13])
    t30 = cl(ta[15] - ta[14])
    t31 = cl(ta[15] + ta[14])
    # stage B rotations
    t17a = _r12(t30 * 799 - t17 * 4017)
    t30a = _r12(t30 * 4017 + t17 * 799)
    t18a = _r12(-(t29 * 4017 + t18 * 799))
    t29a = _r12(t29 * 799 - t18 * 4017)
    t21a = _r12(t26 * 3406 - t21 * 2276)
    t26a = _r12(t26 * 2276 + t21 * 3406)
    t22a = _r12(-(t25 * 2276 + t22 * 3406))
    t25a = _r12(t25 * 3406 - t22 * 2276)
    # stage C
    t16a = cl(t16 + t19)
    t17b = cl(t17a + t18a)
    t18b = cl(t17a - t18a)
    t19a = cl(t16 - t19)
    t20a = cl(t23 - t20)
    t21b = cl(t22a - t21a)
    t22b = cl(t22a + t21a)
    t23a = cl(t23 + t20)
    t24a = cl(t24 + t27)
    t25b = cl(t25a + t26a)
    t26b = cl(t25a - t26a)
    t27a = cl(t24 - t27)
    t28a = cl(t31 - t28)
    t29b = cl(t30a - t29a)
    t30b = cl(t30a + t29a)
    t31a = cl(t31 + t28)
    # stage D rotations
    t18c = _r12(t29b * 1567 - t18b * 3784)
    t29c = _r12(t29b * 3784 + t18b * 1567)
    t19b = _r12(t28a * 1567 - t19a * 3784)
    t28b = _r12(t28a * 3784 + t19a * 1567)
    t20b = _r12(-(t27a * 3784 + t20a * 1567))
    t27b = _r12(t27a * 1567 - t20a * 3784)
    t21c = _r12(-(t26b * 3784 + t21b * 1567))
    t26c = _r12(t26b * 1567 - t21b * 3784)
    # stage E
    u16 = cl(t16a + t23a)
    u17 = cl(t17b + t22b)
    u18 = cl(t18c + t21c)
    u19 = cl(t19b + t20b)
    u20 = cl(t19b - t20b)
    u21 = cl(t18c - t21c)
    u22 = cl(t17b - t22b)
    u23 = cl(t16a - t23a)
    u24 = cl(t31a - t24a)
    u25 = cl(t30b - t25b)
    u26 = cl(t29c - t26c)
    u27 = cl(t28b - t27b)
    u28 = cl(t28b + t27b)
    u29 = cl(t29c + t26c)
    u30 = cl(t30b + t25b)
    u31 = cl(t31a + t24a)
    # stage F: 1/sqrt2 averages on the middle
    v20 = _half(u27 - u20)
    v27 = _half(u27 + u20)
    v21 = _half(u26 - u21)
    v26 = _half(u26 + u21)
    v22 = _half(u25 - u22)
    v25 = _half(u25 + u22)
    v23 = _half(u24 - u23)
    v24 = _half(u24 + u23)
    o = [u16, u17, u18, u19, v20, v21, v22, v23,
         v24, v25, v26, v27, u28, u29, u30, u31]
    return ([cl(t[i] + o[15 - i]) for i in range(16)]
            + [cl(t[15 - i] - o[i]) for i in range(16)])


def inv_adst4(c, cl):
    in0, in1, in2, in3 = c
    s0 = 1321 * in0
    s1 = 2482 * in0
    s2 = 3344 * in1
    s3 = 3803 * in2
    s4 = 1321 * in2
    s5 = 2482 * in3
    s6 = 3803 * in3
    b7 = (in0 - in2) + in3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = 3344 * b7
    s0 = s0 + s5
    s1 = s1 - s6
    x0 = s0 + s3
    x1 = s1 + s3
    x2 = s2
    x3 = s0 + s1 - s3
    return [_r12(x0), _r12(x1), _r12(x2), _r12(x3)]


def inv_adst8(c, cl):
    in0, in1, in2, in3, in4, in5, in6, in7 = c
    t0a = _r12(4076 * in7 + 401 * in0)
    t1a = _r12(401 * in7 - 4076 * in0)
    t2a = _r12(3612 * in5 + 1931 * in2)
    t3a = _r12(1931 * in5 - 3612 * in2)
    t4a = _r12(2598 * in3 + 3166 * in4)
    t5a = _r12(3166 * in3 - 2598 * in4)
    t6a = _r12(1189 * in1 + 3920 * in6)
    t7a = _r12(3920 * in1 - 1189 * in6)
    t0 = cl(t0a + t4a)
    t1 = cl(t1a + t5a)
    t2 = cl(t2a + t6a)
    t3 = cl(t3a + t7a)
    t4 = cl(t0a - t4a)
    t5 = cl(t1a - t5a)
    t6 = cl(t2a - t6a)
    t7 = cl(t3a - t7a)
    t4a = _r12(3784 * t4 + 1567 * t5)
    t5a = _r12(1567 * t4 - 3784 * t5)
    t6a = _r12(-(1567 * t6) + 3784 * t7)
    t7a = _r12(3784 * t6 + 1567 * t7)
    out0 = cl(t0 + t2)
    out7 = -cl(t1 + t3)
    t2b = cl(t0 - t2)
    t3b = cl(t1 - t3)
    out1 = -cl(t4a + t6a)
    out6 = cl(t5a + t7a)
    t6b = cl(t4a - t6a)
    t7b = cl(t5a - t7a)
    out3 = -_half(t2b + t3b)
    out4 = _half(t2b - t3b)
    out2 = _half(t6b + t7b)
    out5 = -_half(t6b - t7b)
    return [out0, out1, out2, out3, out4, out5, out6, out7]


def inv_adst16(c, cl):
    x = c
    t = [None] * 16
    # stage 1 rotations: pairs (in15,in0):(4095? ) using cos128 odd angles
    t0a = _r12(4091 * x[15] + 201 * x[0])
    t1a = _r12(201 * x[15] - 4091 * x[0])
    t2a = _r12(3973 * x[13] + 995 * x[2])
    t3a = _r12(995 * x[13] - 3973 * x[2])
    t4a = _r12(3703 * x[11] + 1751 * x[4])
    t5a = _r12(1751 * x[11] - 3703 * x[4])
    t6a = _r12(3290 * x[9] + 2440 * x[6])
    t7a = _r12(2440 * x[9] - 3290 * x[6])
    t8a = _r12(2751 * x[7] + 3035 * x[8])
    t9a = _r12(3035 * x[7] - 2751 * x[8])
    t10a = _r12(2106 * x[5] + 3513 * x[10])
    t11a = _r12(3513 * x[5] - 2106 * x[10])
    t12a = _r12(1380 * x[3] + 3857 * x[12])
    t13a = _r12(3857 * x[3] - 1380 * x[12])
    t14a = _r12(601 * x[1] + 4052 * x[14])
    t15a = _r12(4052 * x[1] - 601 * x[14])
    t0 = cl(t0a + t8a)
    t1 = cl(t1a + t9a)
    t2 = cl(t2a + t10a)
    t3 = cl(t3a + t11a)
    t4 = cl(t4a + t12a)
    t5 = cl(t5a + t13a)
    t6 = cl(t6a + t14a)
    t7 = cl(t7a + t15a)
    t8 = cl(t0a - t8a)
    t9 = cl(t1a - t9a)
    t10 = cl(t2a - t10a)
    t11 = cl(t3a - t11a)
    t12 = cl(t4a - t12a)
    t13 = cl(t5a - t13a)
    t14 = cl(t6a - t14a)
    t15 = cl(t7a - t15a)
    t8a = _r12(4017 * t8 + 799 * t9)
    t9a = _r12(799 * t8 - 4017 * t9)
    t10a = _r12(2276 * t10 + 3406 * t11)
    t11a = _r12(3406 * t10 - 2276 * t11)
    t12a = _r12(-(799 * t12) + 4017 * t13)
    t13a = _r12(4017 * t12 + 799 * t13)
    t14a = _r12(-(3406 * t14) + 2276 * t15)
    t15a = _r12(2276 * t14 + 3406 * t15)
    t0b = cl(t0 + t4)
    t1b = cl(t1 + t5)
    t2b = cl(t2 + t6)
    t3b = cl(t3 + t7)
    t4b = cl(t0 - t4)
    t5b = cl(t1 - t5)
    t6b = cl(t2 - t6)
    t7b = cl(t3 - t7)
    t8b = cl(t8a + t12a)
    t9b = cl(t9a + t13a)
    t10b = cl(t10a + t14a)
    t11b = cl(t11a + t15a)
    t12b = cl(t8a - t12a)
    t13b = cl(t9a - t13a)
    t14b = cl(t10a - t14a)
    t15b = cl(t11a - t15a)
    t4c = _r12(3784 * t4b + 1567 * t5b)
    t5c = _r12(1567 * t4b - 3784 * t5b)
    t6c = _r12(-(1567 * t6b) + 3784 * t7b)
    t7c = _r12(3784 * t6b + 1567 * t7b)
    t12c = _r12(3784 * t12b + 1567 * t13b)
    t13c = _r12(1567 * t12b - 3784 * t13b)
    t14c = _r12(-(1567 * t14b) + 3784 * t15b)
    t15c = _r12(3784 * t14b + 1567 * t15b)
    # stage 6: butterflies (k, k+2) within each quartet
    x0 = cl(t0b + t2b)
    x1 = cl(t1b + t3b)
    x2 = cl(t0b - t2b)
    x3 = cl(t1b - t3b)
    x4 = cl(t4c + t6c)
    x5 = cl(t5c + t7c)
    x6 = cl(t4c - t6c)
    x7 = cl(t5c - t7c)
    x8 = cl(t8b + t10b)
    x9 = cl(t9b + t11b)
    x10 = cl(t8b - t10b)
    x11 = cl(t9b - t11b)
    x12 = cl(t12c + t14c)
    x13 = cl(t13c + t15c)
    x14 = cl(t12c - t14c)
    x15 = cl(t13c - t15c)
    # stage 7: 1/sqrt2 rotations on (2,3),(6,7),(10,11),(14,15)
    x2, x3 = _half(x2 + x3), _half(x2 - x3)
    x6, x7 = _half(x6 + x7), _half(x6 - x7)
    x10, x11 = _half(x10 + x11), _half(x10 - x11)
    x14, x15 = _half(x14 + x15), _half(x14 - x15)
    # stage 8: output permutation with alternating negation
    return [x0, -x8, x12, -x4, x6, -x14, x10, -x2,
            x3, -x11, x15, -x7, x5, -x13, x9, -x1]


def inv_identity(c, n):
    if n == 4:
        return [(x * 5793 + 2048) >> 12 for x in c]
    if n == 8:
        return [x * 2 for x in c]
    if n == 16:
        return [(x * 2 * 5793 + 2048) >> 12 for x in c]
    return [x * 4 for x in c]


def inv_wht4(c):
    a = c[0] >> 2
    cc = c[1] >> 2
    d = c[2] >> 2
    b = c[3] >> 2
    a = a + cc
    d = d - b
    e = (a - d) >> 1
    b = e - b
    cc = e - cc
    a = a - b
    d = d + cc
    return [a, b, cc, d]


_DCT = {4: inv_dct4, 8: inv_dct8, 16: inv_dct16, 32: inv_dct32}
_ADST = {4: inv_adst4, 8: inv_adst8, 16: inv_adst16}


def transform_1d(kind: str, vec, mn: int, mx: int, xp=np):
    """kind: 'dct', 'adst', 'flipadst', 'identity'. vec: (n, batch...)
    integer array (int64 numpy, or int32 under jax — products stay
    below 2^30 thanks to the normative intermediate clamps).  xp is the
    array namespace (numpy or jax.numpy); the kernels themselves are
    namespace-agnostic scalar ops over row slices."""
    n = vec.shape[0]
    rows = [vec[i] for i in range(n)]
    cl = lambda x: xp.clip(x, mn, mx)  # noqa: E731
    if kind == "dct":
        out = (_DCT[n](rows, cl) if n < 64
               else inv_dct64(rows, cl))
    elif kind == "adst":
        out = _ADST[n](rows, cl)
    elif kind == "flipadst":
        out = _ADST[n](rows, cl)[::-1]
    elif kind == "identity":
        out = inv_identity(rows, n)
    else:
        raise ValueError(kind)
    return xp.stack(out)


def _bitrev(j, bits):
    out = 0
    for _ in range(bits):
        out = (out << 1) | (j & 1)
        j >>= 1
    return out


def _odd_merge(o, cl):
    """Generic odd-part merge of the inverse DCT (derived from the
    verified 16/32-point structures): alternating add stages (group size
    doubling) and mirror-pair rotation stages with angle sets
    base_L * (1 + 4*bitrev(q))."""
    m = len(o)
    lg = m.bit_length() - 1
    s = [None] * m
    for g in range(m // 2):
        a, b = o[2 * g], o[2 * g + 1]
        if g % 2 == 0:
            s[2 * g], s[2 * g + 1] = cl(a + b), cl(a - b)
        else:
            s[2 * g], s[2 * g + 1] = cl(b - a), cl(b + a)
    for L in range(1, lg + 1):
        size = 1 << (L + 1)
        base = 1 << (L + 6 - lg)
        if base == 32:  # final level: 1/sqrt2 halves
            for i in range(m // 4, m // 2):
                a, b = s[i], s[m - 1 - i]
                s[i] = _half(b - a)
                s[m - 1 - i] = _half(b + a)
            break
        nq_bits = lg - L - 2
        for i in range(m // 2):
            q = i >> (L + 1)
            ang = base * (1 + 4 * _bitrev(q, nq_bits))
            r = i % size
            j = m - 1 - i
            a, b = s[i], s[j]
            if size // 4 <= r < size // 2:
                s[i] = _r12(b * cos128(64 - ang) - a * cos128(ang))
                s[j] = _r12(b * cos128(ang) + a * cos128(64 - ang))
            elif size // 2 <= r < 3 * size // 4:
                s[i] = _r12(-(b * cos128(ang) + a * cos128(64 - ang)))
                s[j] = _r12(b * cos128(64 - ang) - a * cos128(ang))
        t = [None] * m
        for gi in range(m // size):
            basei = gi * size
            for i in range(size // 2):
                lo_i = basei + i
                hi_i = basei + size - 1 - i
                if gi % 2 == 0:
                    t[lo_i] = cl(s[lo_i] + s[hi_i])
                    t[hi_i] = cl(s[lo_i] - s[hi_i])
                else:
                    t[lo_i] = cl(s[hi_i] - s[lo_i])
                    t[hi_i] = cl(s[hi_i] + s[lo_i])
        s = t
    return s


def inv_dct64(c, cl):
    t = inv_dct32(c[0::2], cl)
    lo = [None] * 16
    hi = [None] * 16
    for j in range(16):
        phi = 1 + 4 * _bitrev(j, 4)
        i0 = 1 + 2 * _bitrev(j, 5)
        lo[j], hi[j] = _rot(c[i0], c[64 - i0], phi)
    o = [None] * 32
    for j in range(16):
        o[j] = lo[j]
        o[31 - j] = hi[j]
    f = _odd_merge(o, cl)
    return ([cl(t[i] + f[31 - i]) for i in range(32)]
            + [cl(t[31 - i] - f[i]) for i in range(32)])
