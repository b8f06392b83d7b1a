// Copy of easyav1_tpu/native/av1_mc.h, the JAX package's counterpart.
/* Inter-frame reconstruction: subpel motion compensation, compound
 * (average / distance-weighted / wedge / difference-weighted),
 * interintra, OBMC, affine warp, sub-8x8 chroma.  Included by
 * av1_recon.c after predict_intra (interintra reuses it).
 *
 * Exact port of the verified Python reference (recon_ref.py inter
 * arms + wedge.py + warp.py warp_affine); tests assert bit-exactness
 * vs libdav1d through the backend.  Reference roles: dav1d mc_tmpl.c /
 * warp + wedge.c (cmake/dav1d.cmake:1001-1015). */
#pragma once

#include "av1_warp_shared.h"


/* MC path statistics (profiling, tools/profile_stages.py --mc):
   [0-3] pixels per path (int / h-only / v-only / 2d),
   [4-7] rdtsc cycles per path, [8-11] calls per path,
   [12] compound pixels, [13] obmc pixels,
   [14] warp pixels, [15] warp cycles. */
#if PEL_BITS == 16
uint64_t av1_mc_stat[64];
void av1_get_mc_stats(uint64_t *out) {
    for (int i = 0; i < 64; i++) {
        out[i] = av1_mc_stat[i];
        av1_mc_stat[i] = 0;
    }
}
#else
extern uint64_t av1_mc_stat[64];
#endif
#include <x86intrin.h>
#include <stdlib.h>

enum { MC_INTRA_FRAME = 0, MC_NONE_FRAME = -1 };
enum { MC_GLOBALMV = 15 };
enum { MC_MM_SIMPLE = 0, MC_MM_OBMC = 1, MC_MM_WARPED = 2 };
enum { MC_COMP_AVERAGE = 0, MC_COMP_DISTANCE = 1, MC_COMP_WEDGE = 2,
       MC_COMP_DIFFWTD = 3 };
enum { MC_FILTER_BILINEAR = 3 };
enum { MC_GM_TRANSLATION = 1 };

/* The spec's rounding (7.11.3.2): InterRound0 is 5 at 12 bits, else 3;
   a single prediction's InterRound1 is 14 - InterRound0 (11, or 9 at 12
   bits), a compound prediction's 7; the compound blends shift by
   InterPostRound = 7 - InterRound0 (4, or 2 at 12 bits) more.  The JAX
   package's decoder rounds as at 8 bits at every depth, so its 12-bit
   inter frames differ from dav1d's by a few steps. */
static inline int mc_round0(int bd) { return bd == 12 ? 5 : 3; }

/* ---- subpel filters (recon_ref._mc_filter) ------------------------ */

static const int16_t *mc_filter(int interp, int dim) {
    if (dim <= 4) {
        if (interp == MC_FILTER_BILINEAR) return &av1_mc_filter_bilinear[0][0];
        if (interp == 1) return &av1_mc_filter_smooth4[0][0];
        return &av1_mc_filter_regular4[0][0];
    }
    switch (interp) {
    case 1: return &av1_mc_filter_smooth8[0][0];
    case 2: return &av1_mc_filter_sharp8[0][0];
    case 3: return &av1_mc_filter_bilinear[0][0];
    default: return &av1_mc_filter_regular8[0][0];
    }
}
/* Subpel MC in both 8-tap passes as the spec writes them, with
 * edge-replicating clamps and the rounding of mc_round0: single
 * predictions clipped (into dst at row stride ds when dst != NULL, else
 * into out), comp keeps the InterRound1 = 7 intermediate in out.  The
 * 12-bit path and intrabc take it; the fast paths below are for the
 * 8- and 10-bit rounding. */
static void predict_inter_two_pass(const pel *ref, int rw, int rh, int rs,
                                   int ix, int iy, int w, int h,
                                   const int16_t *fh, const int16_t *fv,
                                   int bd, int comp, int32_t *out, pel *dst,
                                   int64_t ds) {
    const int r0 = mc_round0(bd);
    const int32_t mx = (1 << bd) - 1;
    int32_t mid[(128 + 7) * 128];
    for (int r = 0; r < h + 7; r++) {
        int sy = iy - 3 + r;
        sy = sy < 0 ? 0 : (sy > rh - 1 ? rh - 1 : sy);
        const pel *row = ref + (int64_t)sy * rs;
        for (int c = 0; c < w; c++) {
            int32_t acc = 0;
            for (int t = 0; t < 8; t++) {
                int sx = ix - 3 + c + t;
                sx = sx < 0 ? 0 : (sx > rw - 1 ? rw - 1 : sx);
                acc += fh[t] * row[sx];
            }
            mid[r * w + c] = (acc + (1 << (r0 - 1))) >> r0;
        }
    }
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int32_t acc = 0;
            for (int t = 0; t < 8; t++)
                acc += fv[t] * mid[(r + t) * w + c];
            if (comp) {
                out[r * w + c] = (acc + 64) >> 7;
            } else {
                int32_t v = (acc + (1 << (13 - r0))) >> (14 - r0);
                v = v < 0 ? 0 : (v > mx ? mx : v);
                if (dst) dst[r * ds + c] = (pel)v;
                else out[r * w + c] = v;
            }
        }
}

/* 8-tap separable subpel MC with edge-replicating clamps (spec
 * 7.11.3.2, no ref scaling).  comp: keep the InterRound1=7
 * compound-intermediate scale in `out` ([h][w] int32), no clipping.
 * Non-compound: when dst != NULL the final clamped pixels are stored
 * straight into the frame plane at row stride ds (fused store — no
 * intermediate int32 block buffer); otherwise into out.
 *
 * Fast paths (bit-exact by the rounding identities): integer MV is a
 * plain copy (comp: << 4); interior blocks skip the per-sample clamps
 * so the 8-tap loops vectorize. */
static void predict_inter_u16_impl(const pel *ref, int rw, int rh,
                              int rs, int x, int y, int w, int h,
                              const int32_t *mv, int ssx, int ssy,
                              const int32_t *interp, int filt_w,
                              int filt_h, int comp, int bd,
                              int32_t *out, pel *dst, int64_t ds) {
    int start_x = (x << 4) + mv[1] * (ssx ? 1 : 2);
    int start_y = (y << 4) + mv[0] * (ssy ? 1 : 2);
    int frac_x = start_x & 15, frac_y = start_y & 15;
    int ix = start_x >> 4, iy = start_y >> 4;
    int last_x = rw - 1, last_y = rh - 1;

    /* overlap the source window's line fills across rows: per-MV
       sources are scattered, and serialized demand misses dominate on
       this host's high-latency memory (same fix as cp_copy_rows) */
    {
        size_t pb = sizeof(pel) * (size_t)(w + 8);
        if (pb < 4096) {
            int py0 = iy - 3, py1 = iy + h + 4;
            if (py0 < 0) py0 = 0;
            if (py1 > last_y + 1) py1 = last_y + 1;
            int pxx = ix - 3;
            if (pxx < 0) pxx = 0;
            if (pxx > last_x) pxx = last_x;
            const char *s =
                (const char *)(ref + (int64_t)py0 * rs + pxx);
            for (int r = py0; r < py1; r++) {
                for (size_t b = 0; b < pb; b += 64)
                    __builtin_prefetch(s + b);
                s += (int64_t)rs * sizeof(pel);
            }
        }
    }

    if (frac_x == 0 && frac_y == 0) {
        /* integer motion: (128*px rounds exactly through both stages).
         * The all-inside non-compound store is the dominant MC shape on
         * typical streams; make it a straight row memcpy with a
         * next-row prefetch (the ref plane is usually cache-cold). */
        if (!comp && dst && ix >= 0 && ix + w <= rw && iy >= 0
            && iy + h <= rh) {
            uint64_t c0 =
                __builtin_expect(rc_profile, 0) ? __rdtsc() : 0;
            const pel *src = ref + (int64_t)iy * rs + ix;
            size_t row_bytes = sizeof(pel) * (size_t)w;
#if defined(__AVX512F__)
            /* Large blocks (>=64 px wide are partition-aligned, so dst
             * rows are 64B-aligned when the plane stride is): stream
             * the rows with non-temporal stores.  The copy is the
             * dominant MC shape on typical streams and both src and
             * dst are DRAM-cold at 4K; NT stores skip the
             * read-for-ownership, cutting the copy's memory traffic by
             * a third. */
            if (row_bytes >= 64 && ((uintptr_t)dst & 63) == 0
                && ((sizeof(pel) * (size_t)ds) & 63) == 0) {
                size_t nb = row_bytes & ~(size_t)63;
                for (int r = 0; r < h; r++) {
                    const char *s = (const char *)src;
                    char *d = (char *)dst;
                    __builtin_prefetch(src + 4 * rs);
                    __builtin_prefetch(src + 4 * rs + 64 / sizeof(pel));
                    for (size_t b = 0; b < nb; b += 64)
                        _mm512_stream_si512(
                            (void *)(d + b),
                            _mm512_loadu_si512((const void *)(s + b)));
                    if (nb < row_bytes)
                        memcpy(d + nb, s + nb, row_bytes - nb);
                    src += rs;
                    dst += ds;
                }
                _mm_sfence();
                if (__builtin_expect(rc_profile, 0)) {
                    av1_mc_stat[16] += (uint64_t)w * h;
                    uint64_t dc = __rdtsc() - c0;
                    av1_mc_stat[17] += dc;
                    /* per-width NT buckets: [18+k] px, [28+k] cyc */
                    int k = w >= 128 ? 4 : w >= 64 ? 3 : w >= 32 ? 2
                            : w >= 16 ? 1 : 0;
                    av1_mc_stat[18 + k] += (uint64_t)w * h;
                    av1_mc_stat[28 + k] += dc;
                    av1_mc_stat[38 + k] += 1;
                }
                return;
            }
#endif
            for (int r = 0; r < h; r++) {
                __builtin_prefetch(src + 2 * rs);
                memcpy(dst, src, row_bytes);
                src += rs;
                dst += ds;
            }
            if (__builtin_expect(rc_profile, 0)) {
                av1_mc_stat[16] += (uint64_t)w * h;
                uint64_t dc = __rdtsc() - c0;
                av1_mc_stat[17] += dc;
                /* per-width memcpy buckets: [23+k] px, [33+k] cyc */
                int k = w >= 128 ? 4 : w >= 64 ? 3 : w >= 32 ? 2
                        : w >= 16 ? 1 : 0;
                av1_mc_stat[23 + k] += (uint64_t)w * h;
                av1_mc_stat[33 + k] += dc;
                av1_mc_stat[43 + k] += 1;
            }
            return;
        }
        for (int r = 0; r < h; r++) {
            int sy = iy + r;
            sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
            const pel *row = ref + (int64_t)sy * rs;
            if (ix >= 0 && ix + w <= rw) {
                if (comp)
                    for (int c = 0; c < w; c++)
                        out[r * w + c] = row[ix + c] << (7 - mc_round0(bd));
                else if (dst) {
                    pel *restrict o = dst + r * ds;
                    for (int c = 0; c < w; c++)
                        o[c] = row[ix + c];
                } else
                    for (int c = 0; c < w; c++)
                        out[r * w + c] = row[ix + c];
            } else if (dst && !comp) {
                pel *restrict o = dst + r * ds;
                for (int c = 0; c < w; c++) {
                    int sx = ix + c;
                    sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                    o[c] = row[sx];
                }
            } else {
                for (int c = 0; c < w; c++) {
                    int sx = ix + c;
                    sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                    out[r * w + c] = comp ? (row[sx] << (7 - mc_round0(bd)))
                                          : row[sx];
                }
            }
        }
        return;
    }

    const int16_t *fh = mc_filter(interp[1], filt_w) + frac_x * 8;
    const int16_t *fv = mc_filter(interp[0], filt_h) + frac_y * 8;
    int32_t mx = (1 << bd) - 1;

    if (bd == 12) {
        predict_inter_two_pass(ref, rw, rh, rs, ix, iy, w, h, fh, fv, bd,
                               comp, out, dst, ds);
        return;
    }
    if (frac_y == 0) {
        /* horizontal-only: the vertical identity filter is a *128, so
         * the two-stage rounding collapses exactly:
         *   m = (acc+4)>>3; comp: (128m+64)>>7 == m;
         *   noncomp: (128m+1024)>>11 == (m+8)>>4 */
        int inside_x = (ix - 3 >= 0) && (ix + w + 3 < rw);
#if defined(__AVX2__) && PEL_BITS == 8
        /* same madd structure as the vertical kernel, with the 8 tap
         * inputs being shifted loads of ONE row (out[c] needs
         * src[c-3..c+4]); exact i32 accumulation */
        if (inside_x && (w & 15) == 0) {
            const __m256i c01 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fh[1] << 16) | (uint16_t)fh[0]));
            const __m256i c23 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fh[3] << 16) | (uint16_t)fh[2]));
            const __m256i c45 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fh[5] << 16) | (uint16_t)fh[4]));
            const __m256i c67 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fh[7] << 16) | (uint16_t)fh[6]));
            for (int r = 0; r < h; r++) {
                int sy = iy + r;
                sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
                const pel *src = ref + (int64_t)sy * rs + ix - 3;
                for (int c = 0; c < w; c += 16) {
                    __m256i w0 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c)));
                    __m256i w1 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c + 1)));
                    __m256i w2 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c + 2)));
                    __m256i w3 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c + 3)));
                    __m256i w4 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c + 4)));
                    __m256i w5 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c + 5)));
                    __m256i w6 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c + 6)));
                    __m256i w7 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(src + c + 7)));
                    __m256i sl = _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w0, w1), c01),
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w2, w3), c23)),
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w4, w5), c45),
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w6, w7), c67)));
                    __m256i sh = _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w0, w1), c01),
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w2, w3), c23)),
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w4, w5), c45),
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w6, w7), c67)));
                    __m256i ml = _mm256_srai_epi32(
                        _mm256_add_epi32(sl, _mm256_set1_epi32(4)), 3);
                    __m256i mh = _mm256_srai_epi32(
                        _mm256_add_epi32(sh, _mm256_set1_epi32(4)), 3);
                    if (comp) {
                        int32_t *o = out + r * w + c;
                        _mm_storeu_si128((__m128i *)o,
                                         _mm256_castsi256_si128(ml));
                        _mm_storeu_si128((__m128i *)(o + 4),
                                         _mm256_castsi256_si128(mh));
                        _mm_storeu_si128(
                            (__m128i *)(o + 8),
                            _mm256_extracti128_si256(ml, 1));
                        _mm_storeu_si128(
                            (__m128i *)(o + 12),
                            _mm256_extracti128_si256(mh, 1));
                    } else {
                        __m256i vl = _mm256_srai_epi32(
                            _mm256_add_epi32(ml, _mm256_set1_epi32(8)),
                            4);
                        __m256i vh = _mm256_srai_epi32(
                            _mm256_add_epi32(mh, _mm256_set1_epi32(8)),
                            4);
                        __m256i v16 = _mm256_packus_epi32(vl, vh);
                        __m128i v8 = _mm_packus_epi16(
                            _mm256_castsi256_si128(v16),
                            _mm256_extracti128_si256(v16, 1));
                        if (dst)
                            _mm_storeu_si128((__m128i *)(dst + r * ds
                                                         + c), v8);
                        else {
                            int32_t *o = out + r * w + c;
                            _mm256_storeu_si256(
                                (__m256i *)o, _mm256_cvtepu8_epi32(v8));
                            _mm256_storeu_si256(
                                (__m256i *)(o + 8),
                                _mm256_cvtepu8_epi32(
                                    _mm_srli_si128(v8, 8)));
                        }
                    }
                }
            }
            return;
        }
#endif
        for (int r = 0; r < h; r++) {
            int sy = iy + r;
            sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
            const pel *row = ref + (int64_t)sy * rs;
            if (inside_x) {
                const pel *restrict src = row + ix - 3;
                if (comp) {
                    int32_t *restrict o = out + r * w;
                    for (int c = 0; c < w; c++) {
                        int32_t acc = 0;
                        for (int t = 0; t < 8; t++)
                            acc += fh[t] * src[c + t];
                        o[c] = (acc + 4) >> 3;
                    }
                } else if (dst) {
                    pel *restrict o = dst + r * ds;
                    for (int c = 0; c < w; c++) {
                        int32_t acc = 0;
                        for (int t = 0; t < 8; t++)
                            acc += fh[t] * src[c + t];
                        int32_t v = (((acc + 4) >> 3) + 8) >> 4;
                        o[c] = v < 0 ? 0 : (v > mx ? mx : v);
                    }
                } else {
                    int32_t *restrict o = out + r * w;
                    for (int c = 0; c < w; c++) {
                        int32_t acc = 0;
                        for (int t = 0; t < 8; t++)
                            acc += fh[t] * src[c + t];
                        int32_t v = (((acc + 4) >> 3) + 8) >> 4;
                        o[c] = v < 0 ? 0 : (v > mx ? mx : v);
                    }
                }
            } else {
                for (int c = 0; c < w; c++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++) {
                        int sx = ix - 3 + c + t;
                        sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                        acc += fh[t] * row[sx];
                    }
                    int32_t m = (acc + 4) >> 3;
                    if (comp) {
                        out[r * w + c] = m;
                    } else {
                        int32_t v = (m + 8) >> 4;
                        v = v < 0 ? 0 : (v > mx ? mx : v);
                        if (dst) dst[r * ds + c] = (pel)v;
                        else out[r * w + c] = v;
                    }
                }
            }
        }
        return;
    }

    if (frac_x == 0) {
        /* vertical-only: the horizontal identity stage is exactly
         * m = px<<4, so feed the reference rows straight into the
         * vertical filter with a <<4 folded into the final shift. */
        int inside = (ix >= 0) && (ix + w <= rw);
        const pel *rows[8 + 128];
        for (int t = 0; t < h + 7; t++) {
            int sy = iy - 3 + t;
            sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
            rows[t] = ref + (int64_t)sy * rs;
        }
#if defined(__AVX2__) && PEL_BITS == 8
        /* 16-px madd kernel: widen 8 source rows to i16, pair-wise
         * pmaddwd with the tap pairs (exact i32 accumulation — no
         * i16 overflow concern), then the two-stage rounding folds to
         * (s+64)>>7 (noncomp) / (s+4)>>3 (comp).  ~10 cyc/px scalar
         * -> ~2.5.  Taps and pixels both fit i16. */
        if (inside && (w & 15) == 0) {
            const __m256i c01 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[1] << 16) | (uint16_t)fv[0]));
            const __m256i c23 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[3] << 16) | (uint16_t)fv[2]));
            const __m256i c45 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[5] << 16) | (uint16_t)fv[4]));
            const __m256i c67 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[7] << 16) | (uint16_t)fv[6]));
            for (int r = 0; r < h; r++) {
                for (int c = 0; c < w; c += 16) {
                    __m256i w0 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r] + ix + c)));
                    __m256i w1 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r + 1] + ix + c)));
                    __m256i w2 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r + 2] + ix + c)));
                    __m256i w3 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r + 3] + ix + c)));
                    __m256i w4 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r + 4] + ix + c)));
                    __m256i w5 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r + 5] + ix + c)));
                    __m256i w6 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r + 6] + ix + c)));
                    __m256i w7 = _mm256_cvtepu8_epi16(_mm_loadu_si128(
                        (const __m128i *)(rows[r + 7] + ix + c)));
                    __m256i sl = _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w0, w1), c01),
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w2, w3), c23)),
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w4, w5), c45),
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w6, w7), c67)));
                    __m256i sh = _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w0, w1), c01),
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w2, w3), c23)),
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w4, w5), c45),
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w6, w7), c67)));
                    if (comp) {
                        /* (16s+64)>>7 == (s+4)>>3 exactly */
                        __m256i vl = _mm256_srai_epi32(
                            _mm256_add_epi32(sl, _mm256_set1_epi32(4)),
                            3);
                        __m256i vh = _mm256_srai_epi32(
                            _mm256_add_epi32(sh, _mm256_set1_epi32(4)),
                            3);
                        int32_t *o = out + r * w + c;
                        /* unpack order: sl = px 0-3 / 8-11, sh = 4-7 /
                           12-15 per 128-bit half */
                        _mm_storeu_si128((__m128i *)o,
                                         _mm256_castsi256_si128(vl));
                        _mm_storeu_si128((__m128i *)(o + 4),
                                         _mm256_castsi256_si128(vh));
                        _mm_storeu_si128(
                            (__m128i *)(o + 8),
                            _mm256_extracti128_si256(vl, 1));
                        _mm_storeu_si128(
                            (__m128i *)(o + 12),
                            _mm256_extracti128_si256(vh, 1));
                    } else {
                        /* (16s+1024)>>11 == (s+64)>>7 exactly */
                        __m256i vl = _mm256_srai_epi32(
                            _mm256_add_epi32(sl,
                                             _mm256_set1_epi32(64)),
                            7);
                        __m256i vh = _mm256_srai_epi32(
                            _mm256_add_epi32(sh,
                                             _mm256_set1_epi32(64)),
                            7);
                        /* packus_epi32 re-interleaves the lo/hi pair
                           order back to 0..7 / 8..15 per half, and
                           saturates negatives to 0 */
                        __m256i v16 = _mm256_packus_epi32(vl, vh);
                        __m128i v8 = _mm_packus_epi16(
                            _mm256_castsi256_si128(v16),
                            _mm256_extracti128_si256(v16, 1));
                        if (dst)
                            _mm_storeu_si128((__m128i *)(dst + r * ds
                                                         + c), v8);
                        else {
                            int32_t *o = out + r * w + c;
                            __m256i z0 = _mm256_cvtepu8_epi32(v8);
                            __m256i z1 = _mm256_cvtepu8_epi32(
                                _mm_srli_si128(v8, 8));
                            _mm256_storeu_si256((__m256i *)o, z0);
                            _mm256_storeu_si256((__m256i *)(o + 8),
                                                z1);
                        }
                    }
                }
            }
            return;
        }
        if (inside && w == 8) {
            /* 8-px SSE variant of the same madd kernel */
            const __m128i c01 = _mm_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[1] << 16) | (uint16_t)fv[0]));
            const __m128i c23 = _mm_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[3] << 16) | (uint16_t)fv[2]));
            const __m128i c45 = _mm_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[5] << 16) | (uint16_t)fv[4]));
            const __m128i c67 = _mm_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[7] << 16) | (uint16_t)fv[6]));
            for (int r = 0; r < h; r++) {
                __m128i w0 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r] + ix)));
                __m128i w1 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r + 1] + ix)));
                __m128i w2 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r + 2] + ix)));
                __m128i w3 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r + 3] + ix)));
                __m128i w4 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r + 4] + ix)));
                __m128i w5 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r + 5] + ix)));
                __m128i w6 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r + 6] + ix)));
                __m128i w7 = _mm_cvtepu8_epi16(_mm_loadl_epi64(
                    (const __m128i *)(rows[r + 7] + ix)));
                __m128i sl = _mm_add_epi32(
                    _mm_add_epi32(
                        _mm_madd_epi16(_mm_unpacklo_epi16(w0, w1),
                                       c01),
                        _mm_madd_epi16(_mm_unpacklo_epi16(w2, w3),
                                       c23)),
                    _mm_add_epi32(
                        _mm_madd_epi16(_mm_unpacklo_epi16(w4, w5),
                                       c45),
                        _mm_madd_epi16(_mm_unpacklo_epi16(w6, w7),
                                       c67)));
                __m128i sh = _mm_add_epi32(
                    _mm_add_epi32(
                        _mm_madd_epi16(_mm_unpackhi_epi16(w0, w1),
                                       c01),
                        _mm_madd_epi16(_mm_unpackhi_epi16(w2, w3),
                                       c23)),
                    _mm_add_epi32(
                        _mm_madd_epi16(_mm_unpackhi_epi16(w4, w5),
                                       c45),
                        _mm_madd_epi16(_mm_unpackhi_epi16(w6, w7),
                                       c67)));
                if (comp) {
                    __m128i vl = _mm_srai_epi32(
                        _mm_add_epi32(sl, _mm_set1_epi32(4)), 3);
                    __m128i vh = _mm_srai_epi32(
                        _mm_add_epi32(sh, _mm_set1_epi32(4)), 3);
                    int32_t *o = out + r * 8;
                    _mm_storeu_si128((__m128i *)o, vl);
                    _mm_storeu_si128((__m128i *)(o + 4), vh);
                } else {
                    __m128i vl = _mm_srai_epi32(
                        _mm_add_epi32(sl, _mm_set1_epi32(64)), 7);
                    __m128i vh = _mm_srai_epi32(
                        _mm_add_epi32(sh, _mm_set1_epi32(64)), 7);
                    __m128i v16 = _mm_packus_epi32(vl, vh);
                    __m128i v8 = _mm_packus_epi16(v16, v16);
                    if (dst)
                        _mm_storel_epi64((__m128i *)(dst + r * ds),
                                         v8);
                    else {
                        int32_t *o = out + r * 8;
                        _mm_storeu_si128(
                            (__m128i *)o, _mm_cvtepu8_epi32(v8));
                        _mm_storeu_si128(
                            (__m128i *)(o + 4),
                            _mm_cvtepu8_epi32(_mm_srli_si128(v8, 4)));
                    }
                }
            }
            return;
        }
#endif
        for (int r = 0; r < h; r++) {
            if (inside) {
                const pel *r0 = rows[r] + ix, *r1 = rows[r + 1] + ix,
                               *r2 = rows[r + 2] + ix,
                               *r3 = rows[r + 3] + ix,
                               *r4 = rows[r + 4] + ix,
                               *r5 = rows[r + 5] + ix,
                               *r6 = rows[r + 6] + ix,
                               *r7 = rows[r + 7] + ix;
                if (comp) {
                    int32_t *restrict o = out + r * w;
                    for (int c = 0; c < w; c++) {
                        int32_t s = fv[0] * r0[c] + fv[1] * r1[c]
                                  + fv[2] * r2[c] + fv[3] * r3[c]
                                  + fv[4] * r4[c] + fv[5] * r5[c]
                                  + fv[6] * r6[c] + fv[7] * r7[c];
                        o[c] = ((s * 16) + 64) >> 7;
                    }
                } else if (dst) {
                    pel *restrict o = dst + r * ds;
                    for (int c = 0; c < w; c++) {
                        int32_t s = fv[0] * r0[c] + fv[1] * r1[c]
                                  + fv[2] * r2[c] + fv[3] * r3[c]
                                  + fv[4] * r4[c] + fv[5] * r5[c]
                                  + fv[6] * r6[c] + fv[7] * r7[c];
                        int32_t v = ((s * 16) + 1024) >> 11;
                        o[c] = v < 0 ? 0 : (v > mx ? mx : v);
                    }
                } else {
                    int32_t *restrict o = out + r * w;
                    for (int c = 0; c < w; c++) {
                        int32_t s = fv[0] * r0[c] + fv[1] * r1[c]
                                  + fv[2] * r2[c] + fv[3] * r3[c]
                                  + fv[4] * r4[c] + fv[5] * r5[c]
                                  + fv[6] * r6[c] + fv[7] * r7[c];
                        int32_t v = ((s * 16) + 1024) >> 11;
                        o[c] = v < 0 ? 0 : (v > mx ? mx : v);
                    }
                }
            } else {
                for (int c = 0; c < w; c++) {
                    int sx = ix + c;
                    sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                    int32_t s = 0;
                    for (int t = 0; t < 8; t++)
                        s += fv[t] * rows[r + t][sx];
                    if (comp) {
                        out[r * w + c] = ((s * 16) + 64) >> 7;
                    } else {
                        int32_t v = ((s * 16) + 1024) >> 11;
                        v = v < 0 ? 0 : (v > mx ? mx : v);
                        if (dst) dst[r * ds + c] = (pel)v;
                        else out[r * w + c] = v;
                    }
                }
            }
        }
        return;
    }

    /* both fractional: separable two-pass.  The round0 intermediate
     * fits int16 for bd<=10 (|acc| <= ~170*1023 -> >>3 <= ~21.8k),
     * which halves the mid-buffer traffic on the hot 8-bit path. */
    int inside_x = (ix - 3 >= 0) && (ix + w + 3 < rw);
    if (bd <= 10) {
        int16_t mid[(128 + 7) * 128];
        for (int r = 0; r < h + 7; r++) {
            int sy = iy - 3 + r;
            sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
            const pel *row = ref + (int64_t)sy * rs;
            int16_t *restrict m = mid + r * w;
            if (inside_x) {
                const pel *restrict src = row + ix - 3;
#if defined(__AVX2__) && PEL_BITS == 8
                /* horizontal stage via the shifted-load madd kernel,
                   packing the (acc+4)>>3 intermediate to int16 (fits:
                   |m| <= ~6k for bd 8) */
                if ((w & 15) == 0) {
                    const __m256i c01 = _mm256_set1_epi32(
                        (int)(((uint32_t)(uint16_t)fh[1] << 16) | (uint16_t)fh[0]));
                    const __m256i c23 = _mm256_set1_epi32(
                        (int)(((uint32_t)(uint16_t)fh[3] << 16) | (uint16_t)fh[2]));
                    const __m256i c45 = _mm256_set1_epi32(
                        (int)(((uint32_t)(uint16_t)fh[5] << 16) | (uint16_t)fh[4]));
                    const __m256i c67 = _mm256_set1_epi32(
                        (int)(((uint32_t)(uint16_t)fh[7] << 16) | (uint16_t)fh[6]));
                    for (int c = 0; c < w; c += 16) {
                        __m256i w0 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c)));
                        __m256i w1 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c + 1)));
                        __m256i w2 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c + 2)));
                        __m256i w3 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c + 3)));
                        __m256i w4 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c + 4)));
                        __m256i w5 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c + 5)));
                        __m256i w6 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c + 6)));
                        __m256i w7 = _mm256_cvtepu8_epi16(
                            _mm_loadu_si128(
                                (const __m128i *)(src + c + 7)));
                        __m256i sl = _mm256_add_epi32(
                            _mm256_add_epi32(
                                _mm256_madd_epi16(
                                    _mm256_unpacklo_epi16(w0, w1),
                                    c01),
                                _mm256_madd_epi16(
                                    _mm256_unpacklo_epi16(w2, w3),
                                    c23)),
                            _mm256_add_epi32(
                                _mm256_madd_epi16(
                                    _mm256_unpacklo_epi16(w4, w5),
                                    c45),
                                _mm256_madd_epi16(
                                    _mm256_unpacklo_epi16(w6, w7),
                                    c67)));
                        __m256i sh = _mm256_add_epi32(
                            _mm256_add_epi32(
                                _mm256_madd_epi16(
                                    _mm256_unpackhi_epi16(w0, w1),
                                    c01),
                                _mm256_madd_epi16(
                                    _mm256_unpackhi_epi16(w2, w3),
                                    c23)),
                            _mm256_add_epi32(
                                _mm256_madd_epi16(
                                    _mm256_unpackhi_epi16(w4, w5),
                                    c45),
                                _mm256_madd_epi16(
                                    _mm256_unpackhi_epi16(w6, w7),
                                    c67)));
                        __m256i ml = _mm256_srai_epi32(
                            _mm256_add_epi32(sl,
                                             _mm256_set1_epi32(4)), 3);
                        __m256i mh = _mm256_srai_epi32(
                            _mm256_add_epi32(sh,
                                             _mm256_set1_epi32(4)), 3);
                        /* packs re-interleaves lo/hi back to order */
                        _mm256_storeu_si256(
                            (__m256i *)(m + c),
                            _mm256_packs_epi32(ml, mh));
                    }
                    continue;
                }
#endif
                for (int c = 0; c < w; c++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++)
                        acc += fh[t] * src[c + t];
                    m[c] = (int16_t)((acc + 4) >> 3);  /* InterRound0=3 */
                }
            } else {
                for (int c = 0; c < w; c++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++) {
                        int sx = ix - 3 + c + t;
                        sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                        acc += fh[t] * row[sx];
                    }
                    m[c] = (int16_t)((acc + 4) >> 3);
                }
            }
        }
#if defined(__AVX2__) && PEL_BITS == 8
        /* vertical stage: madd directly on the int16 mid rows (no
           widening needed; |fv*m| pair sums fit i32) */
        if ((w & 15) == 0) {
            const __m256i c01 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[1] << 16) | (uint16_t)fv[0]));
            const __m256i c23 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[3] << 16) | (uint16_t)fv[2]));
            const __m256i c45 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[5] << 16) | (uint16_t)fv[4]));
            const __m256i c67 = _mm256_set1_epi32(
                (int)(((uint32_t)(uint16_t)fv[7] << 16) | (uint16_t)fv[6]));
            for (int r = 0; r < h; r++) {
                const int16_t *restrict m = mid + r * w;
                for (int c = 0; c < w; c += 16) {
                    __m256i w0 = _mm256_loadu_si256(
                        (const __m256i *)(m + c));
                    __m256i w1 = _mm256_loadu_si256(
                        (const __m256i *)(m + w + c));
                    __m256i w2 = _mm256_loadu_si256(
                        (const __m256i *)(m + 2 * w + c));
                    __m256i w3 = _mm256_loadu_si256(
                        (const __m256i *)(m + 3 * w + c));
                    __m256i w4 = _mm256_loadu_si256(
                        (const __m256i *)(m + 4 * w + c));
                    __m256i w5 = _mm256_loadu_si256(
                        (const __m256i *)(m + 5 * w + c));
                    __m256i w6 = _mm256_loadu_si256(
                        (const __m256i *)(m + 6 * w + c));
                    __m256i w7 = _mm256_loadu_si256(
                        (const __m256i *)(m + 7 * w + c));
                    __m256i sl = _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w0, w1), c01),
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w2, w3), c23)),
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w4, w5), c45),
                            _mm256_madd_epi16(
                                _mm256_unpacklo_epi16(w6, w7), c67)));
                    __m256i sh = _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w0, w1), c01),
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w2, w3), c23)),
                        _mm256_add_epi32(
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w4, w5), c45),
                            _mm256_madd_epi16(
                                _mm256_unpackhi_epi16(w6, w7), c67)));
                    if (comp) {
                        __m256i vl = _mm256_srai_epi32(
                            _mm256_add_epi32(sl,
                                             _mm256_set1_epi32(64)),
                            7);
                        __m256i vh = _mm256_srai_epi32(
                            _mm256_add_epi32(sh,
                                             _mm256_set1_epi32(64)),
                            7);
                        int32_t *o = out + r * w + c;
                        _mm_storeu_si128((__m128i *)o,
                                         _mm256_castsi256_si128(vl));
                        _mm_storeu_si128((__m128i *)(o + 4),
                                         _mm256_castsi256_si128(vh));
                        _mm_storeu_si128(
                            (__m128i *)(o + 8),
                            _mm256_extracti128_si256(vl, 1));
                        _mm_storeu_si128(
                            (__m128i *)(o + 12),
                            _mm256_extracti128_si256(vh, 1));
                    } else {
                        __m256i vl = _mm256_srai_epi32(
                            _mm256_add_epi32(sl,
                                             _mm256_set1_epi32(1024)),
                            11);
                        __m256i vh = _mm256_srai_epi32(
                            _mm256_add_epi32(sh,
                                             _mm256_set1_epi32(1024)),
                            11);
                        __m256i v16 = _mm256_packus_epi32(vl, vh);
                        __m128i v8 = _mm_packus_epi16(
                            _mm256_castsi256_si128(v16),
                            _mm256_extracti128_si256(v16, 1));
                        if (dst)
                            _mm_storeu_si128(
                                (__m128i *)(dst + r * ds + c), v8);
                        else {
                            int32_t *o = out + r * w + c;
                            _mm256_storeu_si256(
                                (__m256i *)o,
                                _mm256_cvtepu8_epi32(v8));
                            _mm256_storeu_si256(
                                (__m256i *)(o + 8),
                                _mm256_cvtepu8_epi32(
                                    _mm_srli_si128(v8, 8)));
                        }
                    }
                }
            }
            return;
        }
#endif
        for (int r = 0; r < h; r++) {
            const int16_t *restrict m = mid + r * w;
            if (comp) {
                int32_t *restrict o = out + r * w;
                for (int c = 0; c < w; c++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++)
                        acc += fv[t] * m[t * w + c];
                    o[c] = (acc + 64) >> 7;           /* InterRound1=7 */
                }
            } else if (dst) {
                pel *restrict o = dst + r * ds;
                for (int c = 0; c < w; c++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++)
                        acc += fv[t] * m[t * w + c];
                    int32_t v = (acc + 1024) >> 11;   /* InterRound1=11 */
                    o[c] = v < 0 ? 0 : (v > mx ? mx : v);
                }
            } else {
                int32_t *restrict o = out + r * w;
                for (int c = 0; c < w; c++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++)
                        acc += fv[t] * m[t * w + c];
                    int32_t v = (acc + 1024) >> 11;   /* InterRound1=11 */
                    o[c] = v < 0 ? 0 : (v > mx ? mx : v);
                }
            }
        }
        return;
    }
    int32_t mid[(128 + 7) * 128];
    for (int r = 0; r < h + 7; r++) {
        int sy = iy - 3 + r;
        sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
        const pel *row = ref + (int64_t)sy * rs;
        int32_t *m = mid + r * w;
        if (inside_x) {
            const pel *src = row + ix - 3;
            for (int c = 0; c < w; c++) {
                int32_t acc = 0;
                for (int t = 0; t < 8; t++)
                    acc += fh[t] * src[c + t];
                m[c] = (acc + 4) >> 3;                /* InterRound0=3 */
            }
        } else {
            for (int c = 0; c < w; c++) {
                int32_t acc = 0;
                for (int t = 0; t < 8; t++) {
                    int sx = ix - 3 + c + t;
                    sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                    acc += fh[t] * row[sx];
                }
                m[c] = (acc + 4) >> 3;
            }
        }
    }
    for (int r = 0; r < h; r++) {
        const int32_t *m = mid + r * w;
        for (int c = 0; c < w; c++) {
            int32_t acc = 0;
            for (int t = 0; t < 8; t++)
                acc += fv[t] * m[t * w + c];
            if (comp) {
                out[r * w + c] = (acc + 64) >> 7;     /* InterRound1=7 */
            } else {
                int32_t v = (acc + 1024) >> 11;       /* InterRound1=11 */
                v = v < 0 ? 0 : (v > mx ? mx : v);
                if (dst) dst[r * ds + c] = (pel)v;
                else out[r * w + c] = v;
            }
        }
    }
}

/* stats wrapper: classifies the call by subpel path and accumulates
 * pixel / cycle / call counts (profiling only; ~20 cycles per call) */
static void predict_inter_u16(const pel *ref, int rw, int rh,
                              int rs, int x, int y, int w, int h,
                              const int32_t *mv, int ssx, int ssy,
                              const int32_t *interp, int filt_w,
                              int filt_h, int comp, int bd,
                              int32_t *out, pel *dst, int64_t ds) {
    int fx = ((x << 4) + mv[1] * (ssx ? 1 : 2)) & 15;
    int fy = ((y << 4) + mv[0] * (ssy ? 1 : 2)) & 15;
    int path = (fx | fy) == 0 ? 0 : fy == 0 ? 1 : fx == 0 ? 2 : 3;
    /* per-call rdtsc pair gated: ~33k subpel calls per 4K frame pay
       ~60 cyc each when timed unconditionally */
    uint64_t t0 = __builtin_expect(rc_profile, 0) ? __rdtsc() : 0;
    predict_inter_u16_impl(ref, rw, rh, rs, x, y, w, h, mv, ssx, ssy,
                           interp, filt_w, filt_h, comp, bd, out, dst,
                           ds);
    if (__builtin_expect(rc_profile, 0)) {
        av1_mc_stat[path] += (uint64_t)w * h;
        av1_mc_stat[4 + path] += __rdtsc() - t0;
        av1_mc_stat[8 + path]++;
        if (comp) av1_mc_stat[12] += (uint64_t)w * h;
    }
}

/* current-plane-source variant of predict_inter (intra block copy
 * reads the partially reconstructed CURRENT planes, recon_ref intrabc
 * arm) */
static void predict_inter_i32(const pel *ref, int rw, int rh,
                              int x, int y, int w, int h,
                              const int32_t *mv, int ssx, int ssy,
                              const int32_t *interp, int filt_w,
                              int filt_h, int bd, int32_t *out) {
    int start_x = (x << 4) + mv[1] * (ssx ? 1 : 2);
    int start_y = (y << 4) + mv[0] * (ssy ? 1 : 2);
    int frac_x = start_x & 15, frac_y = start_y & 15;
    int ix = start_x >> 4, iy = start_y >> 4;
    int last_x = rw - 1, last_y = rh - 1;
    if (frac_x == 0 && frac_y == 0) {
        for (int r = 0; r < h; r++) {
            int sy = iy + r;
            sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
            const pel *row = ref + (int64_t)sy * rw;
            for (int c = 0; c < w; c++) {
                int sx = ix + c;
                sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                out[r * w + c] = row[sx];
            }
        }
        return;
    }
    const int16_t *fh = mc_filter(interp[1], filt_w) + frac_x * 8;
    const int16_t *fv = mc_filter(interp[0], filt_h) + frac_y * 8;
    predict_inter_two_pass(ref, rw, rh, rw, ix, iy, w, h, fh, fv, bd, 0, out,
                           NULL, 0);
}

/* ---- affine warp (warp.py warp_affine, spec 7.11.3.5) ------------- */

static void warp_affine_u16(const pel *ref, int rw, int rh,
                            int rs, const int32_t *mat, const int32_t *sh,
                            int x, int y, int w, int h, int ssx, int ssy,
                            int bd, int32_t *out /* [h][w] */) {
    int alpha = sh[0], beta = sh[1], gamma = sh[2], delta = sh[3];
    int last_x = rw - 1, last_y = rh - 1;
    const int r0 = mc_round0(bd);
    int64_t mxpix = (1 << bd) - 1;
    for (int i = 0; i < h; i += 8)
        for (int j = 0; j < w; j += 8) {
            int64_t src_x = (x + j + 4) << ssx;
            int64_t src_y = (y + i + 4) << ssy;
            int64_t dst_x = (int64_t)mat[2] * src_x
                            + (int64_t)mat[3] * src_y + mat[0];
            int64_t dst_y = (int64_t)mat[4] * src_x
                            + (int64_t)mat[5] * src_y + mat[1];
            int64_t x4 = dst_x >> ssx, y4 = dst_y >> ssy;
            int ix4 = (int)(x4 >> WM_PREC_BITS);
            int sx4 = (int)(x4 & ((1 << WM_PREC_BITS) - 1));
            int iy4 = (int)(y4 >> WM_PREC_BITS);
            int sy4 = (int)(y4 & ((1 << WM_PREC_BITS) - 1));
            sx4 += alpha * (-4) + beta * (-4);
            sy4 += gamma * (-4) + delta * (-4);
            sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1);
            sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1);
            int32_t tmp[15][8];
            for (int k = -7; k < 8; k++) {
                int syy = iy4 + k;
                syy = syy < 0 ? 0 : (syy > last_y ? last_y : syy);
                const pel *row = ref + (int64_t)syy * rs;
                int sx = sx4 + beta * (k + 4);
                for (int l = -4; l < 4; l++) {
                    int offs = ((sx + 512) >> 10) + 64;
                    const int16_t *co = &av1_warped_filter[offs][0];
                    int32_t s = 0;
                    for (int m = 0; m < 8; m++) {
                        int sxx = ix4 + m + l - 3;
                        sxx = sxx < 0 ? 0 : (sxx > last_x ? last_x : sxx);
                        s += row[sxx] * co[m];
                    }
                    tmp[k + 7][l + 4] = (s + (1 << (r0 - 1))) >> r0;
                    sx += alpha;
                }
            }
            for (int k = -4; k < 4; k++) {
                if (i + k + 4 >= h) break;
                int sy = sy4 + delta * (k + 4);
                for (int l = -4; l < 4; l++) {
                    if (j + l + 4 >= w) { sy += gamma; continue; }
                    int offs = ((sy + 512) >> 10) + 64;
                    const int16_t *co = &av1_warped_filter[offs][0];
                    int32_t s = 0;
                    for (int m = 0; m < 8; m++)
                        s += tmp[k + m + 4][l + 4] * co[m];
                    int64_t v = (s + (1 << (13 - r0))) >> (14 - r0);
                    out[(i + k + 4) * w + (j + l + 4)] =
                        (int32_t)(v < 0 ? 0 : (v > mxpix ? mxpix : v));
                    sy += gamma;
                }
            }
        }
}

/* ---- wedge + diffwtd masks (wedge.py) ----------------------------- */

enum { W_HORZ = 0, W_VERT = 1, W_OBL27 = 2, W_OBL63 = 3, W_OBL117 = 4,
       W_OBL153 = 5 };

static int8_t wedge_master[6][64][64];
static int wedge_master_ready = 0;

static void wedge_init(void) {
    if (wedge_master_ready) return;
    static const int8_t ODD_[8] = {1, 2, 6, 18, 37, 53, 60, 63};
    static const int8_t EVEN_[8] = {1, 4, 11, 27, 46, 58, 62, 63};
    static const int8_t VERT_[8] = {0, 2, 7, 21, 43, 57, 62, 64};
    int8_t even[64], odd[64], vert[64];
    for (int i = 0; i < 64; i++) {
        even[i] = i < 28 ? 0 : (i < 36 ? EVEN_[i - 28] : 64);
        odd[i] = i < 28 ? 0 : (i < 36 ? ODD_[i - 28] : 64);
        vert[i] = i < 28 ? 0 : (i < 36 ? VERT_[i - 28] : 64);
    }
    int shift = 16;
    for (int j = 0; j < 64; j += 2) {
        for (int i = 0; i < 64; i++) {
            int a = i - shift;
            wedge_master[W_OBL63][j][i] = even[a < 0 ? 0 : (a > 63 ? 63 : a)];
            wedge_master[W_VERT][j][i] = vert[i];
            wedge_master[W_VERT][j + 1][i] = vert[i];
        }
        shift -= 1;
        for (int i = 0; i < 64; i++) {
            int a = i - shift;
            wedge_master[W_OBL63][j + 1][i] =
                odd[a < 0 ? 0 : (a > 63 ? 63 : a)];
        }
    }
    for (int r = 0; r < 64; r++)
        for (int c = 0; c < 64; c++) {
            wedge_master[W_OBL27][r][c] = wedge_master[W_OBL63][c][r];
            wedge_master[W_OBL117][r][c] =
                64 - wedge_master[W_OBL63][r][63 - c];
        }
    for (int r = 0; r < 64; r++)
        for (int c = 0; c < 64; c++) {
            wedge_master[W_OBL153][r][c] = wedge_master[W_OBL117][c][r];
            wedge_master[W_HORZ][r][c] = wedge_master[W_VERT][c][r];
        }
    wedge_master_ready = 1;
}

/* 16-entry (direction, x_offset, y_offset) codebooks (wedge.py) */
static const int8_t WCB_HEQW[16][3] = {
    {2,4,4},{3,4,4},{4,4,4},{5,4,4},{0,4,2},{0,4,6},{1,2,4},{1,6,4},
    {2,4,2},{2,4,6},{5,4,2},{5,4,6},{3,2,4},{3,6,4},{4,2,4},{4,6,4}};
static const int8_t WCB_HLTW[16][3] = {
    {2,4,4},{3,4,4},{4,4,4},{5,4,4},{1,2,4},{1,4,4},{1,6,4},{0,4,4},
    {2,4,2},{2,4,6},{5,4,2},{5,4,6},{3,2,4},{3,6,4},{4,2,4},{4,6,4}};
static const int8_t WCB_HGTW[16][3] = {
    {2,4,4},{3,4,4},{4,4,4},{5,4,4},{0,4,2},{0,4,4},{0,4,6},{1,4,4},
    {2,4,2},{2,4,6},{5,4,2},{5,4,6},{3,2,4},{3,6,4},{4,2,4},{4,6,4}};

static const int8_t (*wedge_codebook(int bsize))[3] {
    switch (bsize) {
    case 3: case 6: case 9: return WCB_HEQW;   /* 8x8 16x16 32x32 */
    case 4: case 7: case 18: return WCB_HGTW;  /* 8x16 16x32 8x32 */
    default: return WCB_HLTW;                  /* 16x8 32x16 32x8 */
    }
}

/* (bh, bw) luma wedge mask into out, sign-normalized (wedge.py) */
static void wedge_mask_c(int bsize, int wedge_idx, int wedge_sign,
                         int8_t *out /* [bh][bw] */) {
    wedge_init();
    const int8_t (*cb)[3] = wedge_codebook(bsize);
    int dir = cb[wedge_idx][0];
    int xoff = cb[wedge_idx][1], yoff = cb[wedge_idx][2];
    int bw = av1_block_w4[bsize] * 4, bh = av1_block_h4[bsize] * 4;
    int woff = (xoff * bw) >> 3, hoff = (yoff * bh) >> 3;
    int r0 = 32 - hoff, c0 = 32 - woff;
    int64_t s = 0;
    for (int c = 0; c < bw; c++) s += wedge_master[dir][r0][c0 + c];
    for (int r = 1; r < bh; r++) s += wedge_master[dir][r0 + r][c0];
    int64_t den = bw + bh - 1;
    int avg = (int)((s + den / 2) / den);
    int flip = avg < 32;
    int inv = wedge_sign ^ flip;
    for (int r = 0; r < bh; r++)
        for (int c = 0; c < bw; c++) {
            int m = wedge_master[dir][r0 + r][c0 + c];
            out[r * bw + c] = (int8_t)(inv ? 64 - m : m);
        }
}

/* DIFFWTD mask from compound intermediates (wedge.py diffwtd_mask) */
static void diffwtd_mask_c(const int32_t *p0, const int32_t *p1, int n,
                           int mask_type, int bd, int8_t *out) {
    int sh = bd + 3 - mc_round0(bd);   /* (bd - 8) + InterPostRound + 4 */
    int rnd = 1 << (sh - 5);
    for (int i = 0; i < n; i++) {
        int d = p0[i] - p1[i];
        if (d < 0) d = -d;
        int m = 38 + ((d + rnd) >> sh);
        if (m > 64) m = 64;
        out[i] = (int8_t)(mask_type ? 64 - m : m);
    }
}

/* chroma mask via Round2 subsample (wedge.py subsample_mask) */
static void subsample_mask_c(const int8_t *m, int mw, int mh, int ssx,
                             int ssy, int8_t *out) {
    if (!ssx && !ssy) {
        memcpy(out, m, (size_t)mw * mh);
        return;
    }
    int ow = mw >> ssx, oh = mh >> ssy;
    for (int r = 0; r < oh; r++)
        for (int c = 0; c < ow; c++) {
            if (ssx && ssy)
                out[r * ow + c] = (int8_t)((m[(2 * r) * mw + 2 * c]
                                            + m[(2 * r) * mw + 2 * c + 1]
                                            + m[(2 * r + 1) * mw + 2 * c]
                                            + m[(2 * r + 1) * mw + 2 * c + 1]
                                            + 2) >> 2);
            else if (ssx)
                out[r * ow + c] = (int8_t)((m[r * mw + 2 * c]
                                            + m[r * mw + 2 * c + 1] + 1)
                                           >> 1);
            else
                out[r * ow + c] = (int8_t)((m[(2 * r) * mw + c]
                                            + m[(2 * r + 1) * mw + c] + 1)
                                           >> 1);
        }
}

/* ---- distance weights (recon_ref._dist_weights) -------------------- */

static int mc_rel_dist(const FrameParams *fp, int a, int b) {
    if (!fp->enable_order_hint) return 0;
    int d = a - b;
    int m = 1 << (fp->order_hint_bits - 1);
    return (d & (m - 1)) - (d & m);
}

static void dist_weights(const FrameParams *fp, int ref0, int ref1,
                         int *w0, int *w1) {
    static const int8_t QW[3][2] = {{2, 3}, {2, 5}, {2, 7}};
    static const int8_t QL[4][2] = {{9, 7}, {11, 5}, {12, 4}, {13, 3}};
    int cur = fp->order_hint;
    int bck = mc_rel_dist(fp, cur, fp->order_hints[ref0]);
    int fwd = mc_rel_dist(fp, fp->order_hints[ref1], cur);
    if (bck < 0) bck = -bck;
    if (fwd < 0) fwd = -fwd;
    if (bck > 31) bck = 31;
    if (fwd > 31) fwd = 31;
    /* ratio-quantized weights: the NEARER reference takes QL[i][0];
       row i from the strict ratio ladder far*2 < near*{3,5,7}
       (validated weight-by-weight against libdav1d on one-sided
       compound streams, tests/test_av1_jnt_onesided.py — the old
       rows {13,3},{15,1} and the inverted compare diverged there) */
    int order = fwd <= bck;           /* ref1 nearer (or tie) */
    int near_ = order ? fwd : bck, far_ = order ? bck : fwd;
    int i;
    for (i = 0; i < 3; i++)
        if (far_ * 2 < near_ * QW[i][1]) break;
    if (order) {
        *w1 = QL[i][0];
        *w0 = QL[i][1];
    } else {
        *w0 = QL[i][0];
        *w1 = QL[i][1];
    }
}

/* ---- interintra (recon_ref._interintra_blend) ---------------------- */

static const int8_t II_TO_MODE[4] = {DC_PRED, V_PRED, H_PRED,
                                     SMOOTH_PRED};
static const int8_t II_SIZE_SCALE[22] = {32, 16, 16, 16, 8, 8, 8, 4, 4,
                                         4, 2, 2, 2, 1, 1, 1, 8, 8, 4,
                                         4, 2, 2};

static int plane_bsize_for(int bsize, int ssx, int ssy) {
    int w4 = av1_block_w4[bsize] >> ssx;
    int h4 = av1_block_h4[bsize] >> ssy;
    if (w4 < 1) w4 = 1;
    if (h4 < 1) h4 = 1;
    for (int b = 0; b < 22; b++)
        if (av1_block_w4[b] == w4 && av1_block_h4[b] == h4) return b;
    return bsize;
}

static void interintra_blend(Recon *rc, const int32_t *b, int plane,
                             int x, int y, int w, int h, int full_w,
                             int full_h, int ssx, int ssy,
                             int32_t *inter /* [h][w], updated */) {
    int mode = II_TO_MODE[b[BLK_II_MODE]];
    int64_t intra[64 * 64];
    predict_intra(rc, b[BLK_R], b[BLK_C], plane, x, y, full_w, full_h,
                  mode, 0, intra);
    int8_t mask[128 * 128];
    if (b[BLK_II_WEDGE]) {
        int bw = av1_block_w4[b[BLK_BSIZE]] * 4;
        int bh = av1_block_h4[b[BLK_BSIZE]] * 4;
        int8_t ml[64 * 64];
        wedge_mask_c(b[BLK_BSIZE], b[BLK_II_WEDGE_IDX], 0, ml);
        if (plane == 0)
            memcpy(mask, ml, (size_t)bw * bh);
        else
            subsample_mask_c(ml, bw, bh, ssx, ssy, mask);
    } else {
        int pbsize = plane == 0 ? b[BLK_BSIZE]
                                : plane_bsize_for(b[BLK_BSIZE], ssx, ssy);
        int scale = II_SIZE_SCALE[pbsize];
        int ii = b[BLK_II_MODE];
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int m;
                if (ii == 0) {
                    m = 32;
                } else {
                    int idx = ii == 1 ? r * scale
                              : ii == 2 ? c * scale
                              : (r < c ? r : c) * scale;
                    if (idx > 127) idx = 127;
                    m = av1_ii_weights1d[idx];
                }
                mask[r * w + c] = (int8_t)m;
            }
    }
    int mw = b[BLK_II_WEDGE] ? ((av1_block_w4[b[BLK_BSIZE]] * 4) >> ssx)
                             : w;
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int m = mask[r * mw + c];
            int64_t iv = intra[r * full_w + c];
            int64_t ev = inter[r * w + c];
            inter[r * w + c] = (int32_t)((iv * m + ev * (64 - m) + 32)
                                         >> 6);
        }
}

/* ---- helpers -------------------------------------------------------- */

/* scaled-reference prediction (spec 7.11.3.3 motion vector scaling +
 * 7.11.3.4 block inter predict, scaled arm): the reference frame is
 * stored at a different resolution than the current coded frame
 * (superres inter frames, resize mode).  Positions step through the
 * reference in 1/1024-pel units. */
static void predict_inter_scaled_u16(const pel *ref, int rw,
                                     int rh, int rs,
                                     int x, int y, int w, int h,
                                     const int32_t *mv, int ssx, int ssy,
                                     int xscale, int yscale,
                                     const int32_t *interp, int filt_w,
                                     int filt_h, int comp, int bd,
                                     int32_t *out) {
    const int16_t *fh = mc_filter(interp[1], filt_w);
    const int16_t *fv = mc_filter(interp[0], filt_h);
    int last_x = rw - 1, last_y = rh - 1;
    /* motion_vector_scaling */
    int64_t orig_x = ((int64_t)x << 4) + (ssx ? mv[1] : 2 * (int64_t)mv[1])
                     + 8;
    int64_t orig_y = ((int64_t)y << 4) + (ssy ? mv[0] : 2 * (int64_t)mv[0])
                     + 8;
    int64_t base_x = orig_x * xscale - ((int64_t)8 << 14);
    int64_t base_y = orig_y * yscale - ((int64_t)8 << 14);
    int off = (1 << (10 - 4)) / 2;                      /* 32 */
    int64_t start_x = round2_signed64(base_x, 14 + 4 - 10) + off;
    int64_t start_y = round2_signed64(base_y, 14 + 4 - 10) + off;
    int step_x = (xscale + 8) >> 4;                     /* xscale >= 0 */
    int step_y = (yscale + 8) >> 4;

    int inter_h = (int)((((int64_t)(h - 1) * step_y + (1 << 10) - 1)
                         >> 10) + 8);
    static int32_t im[(2 * 128 + 16) * 128];
    int32_t mx = (1 << bd) - 1;
    const int r0 = mc_round0(bd);
    int64_t row0 = start_y >> 10;
    for (int r = 0; r < inter_h; r++) {
        int sy = (int)(row0 + r - 3);
        sy = sy < 0 ? 0 : (sy > last_y ? last_y : sy);
        const pel *row = ref + (int64_t)sy * rs;
        for (int c = 0; c < w; c++) {
            int64_t p = start_x + (int64_t)step_x * c;
            int sx0 = (int)(p >> 10);
            const int16_t *f = fh + (((int)(p >> 6)) & 15) * 8;
            int32_t acc = 0;
            for (int t = 0; t < 8; t++) {
                int sx = sx0 + t - 3;
                sx = sx < 0 ? 0 : (sx > last_x ? last_x : sx);
                acc += f[t] * row[sx];
            }
            im[r * w + c] = (acc + (1 << (r0 - 1))) >> r0;
        }
    }
    int64_t fracy0 = start_y & 1023;
    for (int r = 0; r < h; r++) {
        int64_t p = fracy0 + (int64_t)step_y * r;
        const int16_t *f = fv + (((int)(p >> 6)) & 15) * 8;
        int base_r = (int)(p >> 10);
        for (int c = 0; c < w; c++) {
            int32_t acc = 0;
            for (int t = 0; t < 8; t++)
                acc += f[t] * im[(base_r + t) * w + c];
            if (comp) {
                out[r * w + c] = (acc + 64) >> 7;       /* InterRound1 */
            } else {
                int32_t v = (acc + (1 << (13 - r0))) >> (14 - r0);
                out[r * w + c] = v < 0 ? 0 : (v > mx ? mx : v);
            }
        }
    }
}

/* per-ref scale factors (1<<14 = unscaled); cur dims are the CODED
 * (pre-superres-upscale) frame dims */
static int mc_is_scaled(const Recon *rc, int ref, int *xs, int *ys) {
    const FrameParams *fp = rc->fp;
    int slot = fp->ref_frame_idx[ref];
    int ruw = rc->refs->w[slot][0];
    int rfh = rc->refs->h[slot][0];
    int cw = fp->use_superres ? fp->downscaled_width : fp->frame_width;
    int ch = fp->frame_height;
    if (cw <= 0 || ch <= 0 || (ruw == cw && rfh == ch)) {
        *xs = 1 << 14;
        *ys = 1 << 14;
        return 0;
    }
    *xs = (int)((((int64_t)ruw << 14) + cw / 2) / cw);
    *ys = (int)((((int64_t)rfh << 14) + ch / 2) / ch);
    return *xs != (1 << 14) || *ys != (1 << 14);
}

/* dispatch: same-scale fast paths or the scaled predictor */
/* ---- deferred integer-MV copy plan (see CopyPlan in recon_tmpl) --- */

static void cp_copy_rows(pel *dst, int64_t ds, const pel *src,
                         int64_t ss, int w, int h, int nt) {
    size_t row_bytes = sizeof(pel) * (size_t)w;
    /* Small/mid bands are latency-bound, not bandwidth-bound: each
       entry's source sits at an arbitrary MV offset, so every row is
       a demand miss.  Keep a BOUNDED number of line fills in flight —
       an up-front pass over the whole window overflows the core's
       line-fill buffers (~16), the excess prefetches are dropped, and
       the copy serializes on demand misses anyway (measured 4-10
       cyc/px on mid bands at 4K vs 0.3 for the same shape hot). */
    if (row_bytes < 4096) {
        int64_t ssb = ss * (int64_t)sizeof(pel);
        const char *s0 = (const char *)src;
        int lines = (int)((row_bytes + 63) >> 6);
        int ahead = lines >= 32 ? 1 : 32 / lines;
        int pro = h < ahead ? h : ahead;
        for (int r = 0; r < pro; r++)
            for (size_t b = 0; b < row_bytes; b += 64)
                __builtin_prefetch(s0 + (int64_t)r * ssb + b);
        for (int r = 0; r < h; r++) {
            if (r + ahead < h) {
                const char *pf = s0 + (int64_t)(r + ahead) * ssb;
                for (size_t b = 0; b < row_bytes; b += 64)
                    __builtin_prefetch(pf + b);
            }
            memcpy(dst, src, row_bytes);
            src += ss;
            dst += ds;
        }
        return;
    }
#if defined(__AVX512F__)
    if (nt && row_bytes >= 64 && ((uintptr_t)dst & 63) == 0
        && ((sizeof(pel) * (size_t)ds) & 63) == 0) {
        size_t nb = row_bytes & ~(size_t)63;
        for (int r = 0; r < h; r++) {
            const char *s = (const char *)src;
            char *d = (char *)dst;
            __builtin_prefetch(src + 4 * ss);
            __builtin_prefetch(src + 4 * ss + 64 / sizeof(pel));
            for (size_t b = 0; b < nb; b += 64)
                _mm512_stream_si512((void *)(d + b),
                                    _mm512_loadu_si512((const void *)(s + b)));
            if (nb < row_bytes)
                memcpy(d + nb, s + nb, row_bytes - nb);
            src += ss;
            dst += ds;
        }
        return;
    }
#endif
    for (int r = 0; r < h; r++) {
        __builtin_prefetch(src + 2 * ss);
        memcpy(dst, src, row_bytes);
        src += ss;
        dst += ds;
    }
}

static int cp_cmp(const void *a, const void *b) {
    const CopyEnt *ea = (const CopyEnt *)a, *eb = (const CopyEnt *)b;
    if (ea->y != eb->y) return ea->y < eb->y ? -1 : 1;
    return ea->x < eb->x ? -1 : (ea->x > eb->x ? 1 : 0);
}

static void residual_add_mask(Recon *rc, const int32_t *b,
                              int plane_mask);

static int rp_cmp(const void *a, const void *b) {
    const ResidEnt *ea = (const ResidEnt *)a, *eb = (const ResidEnt *)b;
    return ea->y < eb->y ? -1 : (ea->y > eb->y ? 1 : 0);
}

static void copyplan_flush(Recon *rc) {
    uint64_t c0 = __rdtsc();
    uint64_t px = 0;
    for (int p = 0; p < 3; p++) {
        CopyPlan *cp = &rc->cplan[p];
        ResidPlan *rp_ = &rc->rplan[p];
        if (cp->n == 0 && rp_->n == 0) continue;
        /* n == 0 with a NULL base is UB for qsort (nonnull arg) */
        uint64_t q0 = __rdtsc();
        if (cp->n)
            qsort(cp->e, (size_t)cp->n, sizeof(CopyEnt), cp_cmp);
        if (rp_->n)
            qsort(rp_->e, (size_t)rp_->n, sizeof(ResidEnt), rp_cmp);
        av1_mc_stat[45] += __rdtsc() - q0;
        av1_mc_stat[46] += (uint64_t)cp->n + rp_->n;
        pel *plane = rc->planes[p];
        int64_t ds = rc->pw[p];
        /* 128-row bands (every block is size-aligned, so none spans a
           band): copy a band, then apply its residuals while the rows
           are still cache-resident */
        int i = 0, ri = 0;
        while (i < cp->n || ri < rp_->n) {
            int band = INT32_MAX;
            if (i < cp->n) band = cp->e[i].y >> 7;
            if (ri < rp_->n && (rp_->e[ri].y >> 7) < band)
                band = rp_->e[ri].y >> 7;
            while (i < cp->n && (cp->e[i].y >> 7) == band) {
                /* merge a run of x-adjacent, src-contiguous same-band
                   entries into one wide row-band copy */
                int j = i;
                const CopyEnt *e = cp->e;
                while (j + 1 < cp->n && e[j + 1].y == e[i].y
                       && e[j + 1].h == e[i].h
                       && e[j + 1].x == e[j].x + e[j].w
                       && e[j + 1].ss == e[j].ss
                       && e[j + 1].nt == e[j].nt
                       && e[j + 1].src == e[j].src + e[j].w)
                    j++;
                int mw = e[j].x + e[j].w - e[i].x;
                /* hide the next runs' FIRST source lines under this
                   copy (bounded: the line-fill buffers hold ~16
                   outstanding misses; cp_copy_rows pipelines the rest
                   of each run internally) */
                if (j + 1 < cp->n) {
                    const CopyEnt *nx = &e[j + 1];
                    const char *ns = (const char *)nx->src;
                    int64_t nss = nx->ss * (int64_t)sizeof(pel);
                    int pr = nx->h < 8 ? nx->h : 8;
                    for (int r = 0; r < pr; r++)
                        __builtin_prefetch(ns + (int64_t)r * nss);
                    for (int k = j + 2; k < cp->n && k <= j + 6; k++)
                        __builtin_prefetch(e[k].src);
                }
                uint64_t b0 =
                    __builtin_expect(rc_profile, 0) ? __rdtsc() : 0;
                cp_copy_rows(plane + (int64_t)e[i].y * ds + e[i].x, ds,
                             e[i].src, e[i].ss, mw, e[i].h, e[i].nt);
                px += (uint64_t)mw * e[i].h;
                if (__builtin_expect(rc_profile, 0)) {
                    int k = mw >= 1024 ? 4 : mw >= 256 ? 3
                            : mw >= 64 ? 2 : mw >= 16 ? 1 : 0;
                    av1_mc_stat[48 + k]++;
                    av1_mc_stat[53 + k] += (uint64_t)mw * e[i].h;
                    av1_mc_stat[59 + k] += __rdtsc() - b0;
                    av1_mc_stat[58] += (uint64_t)(j + 1 - i);
                }
                i = j + 1;
            }
            {
                uint64_t r0 =
                    __builtin_expect(rc_profile, 0) ? __rdtsc() : 0;
                while (ri < rp_->n && (rp_->e[ri].y >> 7) == band) {
                    residual_add_mask(rc, rp_->e[ri].b, 1 << p);
                    ri++;
                }
                if (__builtin_expect(rc_profile, 0))
                    av1_mc_stat[47] += __rdtsc() - r0;
            }
        }
        cp->n = 0;
        rp_->n = 0;
    }
#if defined(__AVX512F__)
    _mm_sfence();
#endif
    if (px) {
        av1_mc_stat[0] += px;
        av1_mc_stat[4] += __rdtsc() - c0;
        av1_mc_stat[8]++;
        av1_mc_stat[16] += px;
        av1_mc_stat[17] += __rdtsc() - c0;
    }
}

static void copyplan_free(Recon *rc) {
    for (int p = 0; p < 3; p++) {
        free(rc->cplan[p].e);
        rc->cplan[p].e = NULL;
        rc->cplan[p].n = rc->cplan[p].cap = 0;
        free(rc->rplan[p].e);
        rc->rplan[p].e = NULL;
        rc->rplan[p].n = rc->rplan[p].cap = 0;
    }
}

/* queue a deferred block's residual for one plane */
static int resid_defer(Recon *rc, int plane, const int32_t *b, int y) {
    ResidPlan *rp_ = &rc->rplan[plane];
    if (rp_->n == rp_->cap) {
        int ncap = rp_->cap ? rp_->cap * 2 : 1024;
        ResidEnt *ne = realloc(rp_->e, sizeof(*ne) * (size_t)ncap);
        if (ne == NULL) return 0;
        rp_->e = ne;
        rp_->cap = ncap;
    }
    rp_->e[rp_->n].b = b;
    rp_->e[rp_->n].y = y;
    rp_->n++;
    return 1;
}

/* queue the block copy if this plane's prediction is integer-MV and
 * fully inside the reference; returns 0 when the caller must predict
 * normally.  Mirrors predict_inter_u16_impl's integer-MV fast path
 * (same start_x/start_y arithmetic, spec 7.11.3.2). */
static int try_defer_copy(Recon *rc, int plane, const pel *ref,
                          int rw, int rh, int rs, int x, int y,
                          int w, int h, const int32_t *mv,
                          int ssx, int ssy, int nt) {
    int start_x = (x << 4) + mv[1] * (ssx ? 1 : 2);
    int start_y = (y << 4) + mv[0] * (ssy ? 1 : 2);
    if ((start_x & 15) || (start_y & 15)) return 0;
    int ix = start_x >> 4, iy = start_y >> 4;
    if (ix < 0 || ix + w > rw || iy < 0 || iy + h > rh) return 0;
    CopyPlan *cp = &rc->cplan[plane];
    if (cp->n == cp->cap) {
        int ncap = cp->cap ? cp->cap * 2 : 1024;
        CopyEnt *ne = realloc(cp->e, sizeof(CopyEnt) * (size_t)ncap);
        if (ne == NULL) return 0;
        cp->e = ne;
        cp->cap = ncap;
    }
    CopyEnt *e = &cp->e[cp->n++];
    e->y = y; e->x = x; e->w = w; e->h = h;
    e->src = ref + (int64_t)iy * rs + ix;
    e->ss = rs;
    e->nt = nt;
    return 1;
}

static void mc_predict(Recon *rc, int ref, const pel *rpl, int rw,
                       int rh, int rs, int px, int py, int w, int h,
                       const int32_t *mv, int ssx, int ssy,
                       const int32_t *interp, int fw, int fh, int comp,
                       int bd, int32_t *out, pel *dst, int64_t ds) {
    int xs, ys;
    if (!mc_is_scaled(rc, ref, &xs, &ys)) {
        predict_inter_u16(rpl, rw, rh, rs, px, py, w, h, mv, ssx, ssy,
                          interp, fw, fh, comp, bd, out, dst, ds);
        return;
    }
    predict_inter_scaled_u16(rpl, rw, rh, rs, px, py, w, h, mv, ssx,
                             ssy, xs, ys, interp, fw, fh, comp, bd,
                             out);
    if (dst != NULL && !comp)
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++)
                dst[(int64_t)r * ds + c] = (pel)out[r * w + c];
}

static const pel *mc_ref_plane(Recon *rc, int ref, int plane,
                                    int *rw, int *rh, int *rs) {
    int slot = rc->fp->ref_frame_idx[ref];
    const pel *p = (const pel *)rc->refs->plane[slot][plane];
    *rw = rc->refs->w[slot][plane];
    *rh = rc->refs->h[slot][plane];
    *rs = rc->refs->stride[slot][plane];
    return p;
}

/* residual add over the block's coded txs (recon_ref._residual_add);
 * plane_mask selects which planes to apply (copy-deferred planes get
 * theirs applied at copyplan_flush instead) */
static void residual_add_mask(Recon *rc, const int32_t *b,
                              int plane_mask) {
    const TileOut *o = rc->o;
    int64_t mx = (1 << rc->rp->bitdepth) - 1;
    int64_t tx_off = b[BLK_TXOFF];
    int n_tx = b[BLK_NTX];
    int32_t mx32 = (int32_t)mx;
    for (int64_t k = tx_off; k < tx_off + n_tx; k++) {
        const int32_t *rec = o->txs + k * 8;
        int plane = rec[0], x = rec[1], y = rec[2];
        if (!((plane_mask >> plane) & 1)) continue;
        int tsz = rec[3], ttyp = rec[4];
        int fw = av1_tx_w[tsz], fh = av1_tx_h[tsz];
        pel *buf = rc->planes[plane];
        int pw = rc->pw[plane], ph = rc->ph[plane];
        int w = rmin(fw, pw - x), h = rmin(fh, ph - y);
        /* DC-only DCT_DCT: the whole inverse transform is one constant
           (itx_dc_value) — add it straight to the plane, skipping the
           w*h materialization entirely */
        if (!rec[7] && ttyp == 0 && (rec[5] & 0xfff) == 1) {
            int bd = rc->rp->bitdepth;
            int64_t cmn = bd == 8 ? -(1 << 15) : -((int64_t)1 << (bd + 7));
            int64_t cmx = bd == 8 ? (1 << 15) - 1
                                  : ((int64_t)1 << (bd + 7)) - 1;
            int32_t dc = itx_dc_value(o->coeffs[rec[6]], tsz, cmn, cmx);
#if PEL_BITS == 8 && defined(__AVX2__)
            __m256i dc16 = _mm256_set1_epi16((short)(dc < -2048 ? -2048
                                             : dc > 2303 ? 2303 : dc));
            for (int r = 0; r < h; r++) {
                pel *restrict row = buf + (int64_t)(y + r) * pw + x;
                int c = 0;
                for (; c + 16 <= w; c += 16) {
                    __m256i px16 = _mm256_cvtepu8_epi16(
                        _mm_loadu_si128((const __m128i *)(row + c)));
                    __m256i sum = _mm256_add_epi16(px16, dc16);
                    __m128i o8 = _mm_packus_epi16(
                        _mm256_castsi256_si128(sum),
                        _mm256_extracti128_si256(sum, 1));
                    _mm_storeu_si128((__m128i *)(row + c), o8);
                }
                for (; c < w; c++) {
                    int32_t v = row[c] + dc;
                    row[c] = v < 0 ? 0 : (v > mx32 ? mx32 : v);
                }
            }
#else
            for (int r = 0; r < h; r++) {
                pel *restrict row = buf + (int64_t)(y + r) * pw + x;
                for (int c = 0; c < w; c++) {
                    int32_t v = row[c] + dc;
                    row[c] = v < 0 ? 0 : (v > mx32 ? mx32 : v);
                }
            }
#endif
            continue;
        }
        int32_t res[64 * 64];
        uint64_t tx0 = rc_tick();
        if (rec[7]) itx_wht4(o->coeffs + rec[6], res);
        else itx_2d(o->coeffs + rec[6], tsz, ttyp, rc->rp->bitdepth,
                    res, rec[5]);
        rc_tick_add(5, tx0);
        if (__builtin_expect(rc_profile, 0)) {
            av1_stage_ticks[0]++;                       /* tx count */
            av1_stage_ticks[1] += (uint64_t)fw * fh;    /* tx px */
            av1_stage_ticks[2] += (uint64_t)(rec[5] & 0xfff); /* eobs */
        }
#if PEL_BITS == 8 && defined(__AVX2__)
        /* residual values after the final >>4 fit int16 (the column
           pass clamps to +/-2^15), so the add + [0,255] clamp runs as
           16-lane i16 adds with an unsigned-saturating pack */
        for (int r = 0; r < h; r++) {
            pel *restrict row = buf + (int64_t)(y + r) * pw + x;
            const int32_t *restrict rr_ = res + r * fw;
            int c = 0;
            for (; c + 16 <= w; c += 16) {
                __m256i a = _mm256_loadu_si256(
                    (const __m256i *)(rr_ + c));
                __m256i b2 = _mm256_loadu_si256(
                    (const __m256i *)(rr_ + c + 8));
                __m256i s16 = _mm256_permute4x64_epi64(
                    _mm256_packs_epi32(a, b2), 0xD8);
                __m256i px16 = _mm256_cvtepu8_epi16(
                    _mm_loadu_si128((const __m128i *)(row + c)));
                __m256i sum = _mm256_add_epi16(px16, s16);
                __m128i o8 = _mm_packus_epi16(
                    _mm256_castsi256_si128(sum),
                    _mm256_extracti128_si256(sum, 1));
                _mm_storeu_si128((__m128i *)(row + c), o8);
            }
            if (c + 8 <= w) {
                __m128i a = _mm_loadu_si128((const __m128i *)(rr_ + c));
                __m128i b2 = _mm_loadu_si128(
                    (const __m128i *)(rr_ + c + 4));
                __m128i s16 = _mm_packs_epi32(a, b2);
                __m128i px16 = _mm_cvtepu8_epi16(
                    _mm_loadl_epi64((const __m128i *)(row + c)));
                __m128i sum = _mm_add_epi16(px16, s16);
                _mm_storel_epi64((__m128i *)(row + c),
                                 _mm_packus_epi16(sum, sum));
                c += 8;
            }
            for (; c < w; c++) {
                int32_t v = row[c] + rr_[c];
                row[c] = v < 0 ? 0 : (v > mx32 ? mx32 : v);
            }
        }
#else
        for (int r = 0; r < h; r++) {
            pel *restrict row = buf + (int64_t)(y + r) * pw + x;
            const int32_t *restrict rr_ = res + r * fw;
            for (int c = 0; c < w; c++) {
                int32_t v = row[c] + rr_[c];
                row[c] = v < 0 ? 0 : (v > mx32 ? mx32 : v);
            }
        }
#endif
    }
}

static void residual_add(Recon *rc, const int32_t *b) {
    residual_add_mask(rc, b, 7);
}

static void mark_decoded(Recon *rc, int plane, int x, int y, int w,
                         int h) {
    for (int rr = y >> 2; rr < (y + h + 3) >> 2 && rr < rc->dh[plane];
         rr++)
        for (int cc = x >> 2; cc < (x + w + 3) >> 2 && cc < rc->dw[plane];
             cc++)
            rc->decoded[plane][rr * rc->dw[plane] + cc] = 1;
}

/* sub-8x8 chroma (recon_ref._sub8x8_chroma, spec 7.11.3.1): returns 0
 * when a covered luma block is intra (caller predicts whole block) */
static int sub8x8_chroma(Recon *rc, const int32_t *b, int plane, int x,
                         int y, int w, int h, int ssx, int ssy) {
    const TileOut *o = rc->o;
    int mi_cols = rc->rp->mi_cols;
    int bsize = b[BLK_BSIZE];
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    int cand_r = (b[BLK_R] >> ssy) << ssy;
    int cand_c = (b[BLK_C] >> ssx) << ssx;
    int n_rows = 1 + (h4 == 1 ? ssy : 0);
    int n_cols = 1 + (w4 == 1 ? ssx : 0);
    for (int j = 0; j < n_rows; j++)
        for (int i = 0; i < n_cols; i++) {
            int64_t at = (int64_t)(cand_r + j) * mi_cols + (cand_c + i);
            if (o->ref0_g[at] <= MC_INTRA_FRAME) return 0;
        }
    pel *buf = rc->planes[plane];
    int bw = rc->pw[plane], bh = rc->ph[plane];
    int pw = w4 == 1 ? (4 >> ssx) : w;
    int ph = h4 == 1 ? (4 >> ssy) : h;
    for (int j = 0; j < n_rows; j++)
        for (int i = 0; i < n_cols; i++) {
            int64_t at = (int64_t)(cand_r + j) * mi_cols + (cand_c + i);
            int ref = o->ref0_g[at];
            int rw, rh, rs;
            const pel *rp = mc_ref_plane(rc, ref, plane, &rw, &rh,
                                              &rs);
            int32_t mv[2] = {o->mvs_g[at * 4 + 0], o->mvs_g[at * 4 + 1]};
            int32_t filt[2] = {o->interp_g[at * 2 + 0],
                               o->interp_g[at * 2 + 1]};
            int px = x + i * pw, py = y + j * ph;
            int cw = rmin(pw, bw - px), chh = rmin(ph, bh - py);
            if (cw <= 0 || chh <= 0) continue;
            int32_t pred[8 * 8];
            mc_predict(rc, ref, rp, rw, rh, rs, px, py, cw, chh, mv,
                       ssx, ssy, filt, pw, ph, 0, rc->rp->bitdepth,
                       pred, buf + (int64_t)py * bw + px, bw);
        }
    return 1;
}

/* ---- OBMC (recon_ref._apply_obmc, spec 7.11.3.9-10) ---------------- */

static const uint8_t *obmc_mask_for(int n) {
    switch (n) {
    case 2: return av1_obmc_mask_2;
    case 4: return av1_obmc_mask_4;
    case 8: return av1_obmc_mask_8;
    case 16: return av1_obmc_mask_16;
    default: return av1_obmc_mask_32;
    }
}

static void obmc_nb_pred(Recon *rc, int plane, int64_t at, int px,
                         int py, int pw, int ph, int32_t *out) {
    const TileOut *o = rc->o;
    int ssx = plane ? rc->rp->ssx : 0;
    int ssy = plane ? rc->rp->ssy : 0;
    int ref = o->ref0_g[at];
    int rw, rh, rs;
    const pel *rp = mc_ref_plane(rc, ref, plane, &rw, &rh, &rs);
    int32_t mv[2] = {o->mvs_g[at * 4 + 0], o->mvs_g[at * 4 + 1]};
    int32_t filt[2] = {o->interp_g[at * 2 + 0], o->interp_g[at * 2 + 1]};
    av1_mc_stat[13] += (uint64_t)pw * ph;
    mc_predict(rc, ref, rp, rw, rh, rs, px, py, pw, ph, mv, ssx, ssy,
               filt, pw, ph, 0, rc->rp->bitdepth, out, NULL, 0);
}

static void apply_obmc(Recon *rc, const int32_t *b) {
    static const int8_t MAX_NB[7] = {0, 1, 2, 3, 4, 4, 4};
    const TileOut *o = rc->o;
    const ReconParams *rp = rc->rp;
    int mi_cols = rp->mi_cols, mi_rows = rp->mi_rows;
    int r = b[BLK_R], c = b[BLK_C], bsize = b[BLK_BSIZE];
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    int bw = w4 * 4, bh = h4 * 4;
    int w4c = rmin(w4, mi_cols - c), h4c = rmin(h4, mi_rows - r);
    int n_planes = (b[BLK_HASCHROMA] && rp->num_planes > 1) ? 3 : 1;
    int ssx = rp->ssx, ssy = rp->ssy;
    int pw4 = rmax(1, w4 >> ssx), ph4 = rmax(1, h4 >> ssy);
    int tiny = (pw4 * 4 <= 4 && ph4 * 4 <= 8)
               || (pw4 * 4 <= 8 && ph4 * 4 <= 4);

    if (r > rc->t_rs) {             /* above pass (tile-bounded) */
        int nb_max = MAX_NB[ws_log2((uint32_t)bw) - 2];
        int count = 0, i = 0;
        while (i < w4c && count < nb_max) {
            int nbc = c + i;
            int64_t at0 = (int64_t)(r - 1) * mi_cols + nbc;
            int step = rmin(av1_block_w4[o->bsize[at0]], 16);
            int rel = i, nbc_eff = nbc;
            if (step == 1) {
                rel = (nbc & ~1) - c;
                nbc_eff = (nbc & ~1) + 1;
                step = 2;
            }
            int64_t at = (int64_t)(r - 1) * mi_cols + nbc_eff;
            if (o->ref0_g[at] > MC_INTRA_FRAME) {
                count++;
                int op_mi = rmin(w4, step);
                int overlap = rmin(bh, 64) >> 1;
                for (int plane = 0; plane < n_planes; plane++) {
                    if (plane && tiny) continue;
                    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
                    int px = ((c + rel) * 4) >> sx;
                    int py = (r * 4) >> sy;
                    int pw = (op_mi * 4) >> sx;
                    int ph = overlap >> sy;
                    pel *buf = rc->planes[plane];
                    pw = rmin(pw, rc->pw[plane] - px);
                    ph = rmin(ph, rc->ph[plane] - py);
                    if (pw <= 0 || ph <= 0) continue;
                    int32_t tmp[32 * 128];
                    obmc_nb_pred(rc, plane, at, px, py, pw, ph, tmp);
                    const uint8_t *m = obmc_mask_for(overlap >> sy);
                    for (int rr = 0; rr < ph; rr++) {
                        int mm = m[rr];
                        for (int cc = 0; cc < pw; cc++) {
                            int64_t cur = buf[(py + rr) * rc->pw[plane]
                                              + (px + cc)];
                            buf[(py + rr) * rc->pw[plane] + (px + cc)] =
                                (int32_t)((mm * cur
                                           + (64 - mm) * tmp[rr * pw + cc]
                                           + 32) >> 6);
                        }
                    }
                }
            }
            i = rel + step;
        }
    }
    if (c > rc->t_cs) {             /* left pass (tile-bounded) */
        int nb_max = MAX_NB[ws_log2((uint32_t)bh) - 2];
        int count = 0, i = 0;
        while (i < h4c && count < nb_max) {
            int nbr = r + i;
            int64_t at0 = (int64_t)nbr * mi_cols + (c - 1);
            int step = rmin(av1_block_h4[o->bsize[at0]], 16);
            int rel = i, nbr_eff = nbr;
            if (step == 1) {
                rel = (nbr & ~1) - r;
                nbr_eff = (nbr & ~1) + 1;
                step = 2;
            }
            int64_t at = (int64_t)nbr_eff * mi_cols + (c - 1);
            if (o->ref0_g[at] > MC_INTRA_FRAME) {
                count++;
                int op_mi = rmin(h4, step);
                int overlap = rmin(bw, 64) >> 1;
                for (int plane = 0; plane < n_planes; plane++) {
                    /* av1_skip_u4x4_pred_in_obmc: above pass only */
                    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
                    int px = (c * 4) >> sx;
                    int py = ((r + rel) * 4) >> sy;
                    int pw = overlap >> sx;
                    int ph = (op_mi * 4) >> sy;
                    pel *buf = rc->planes[plane];
                    pw = rmin(pw, rc->pw[plane] - px);
                    ph = rmin(ph, rc->ph[plane] - py);
                    if (pw <= 0 || ph <= 0) continue;
                    int32_t tmp[32 * 128];
                    obmc_nb_pred(rc, plane, at, px, py, pw, ph, tmp);
                    const uint8_t *m = obmc_mask_for(overlap >> sx);
                    for (int rr = 0; rr < ph; rr++)
                        for (int cc = 0; cc < pw; cc++) {
                            int mm = m[cc];
                            int64_t cur = buf[(py + rr) * rc->pw[plane]
                                              + (px + cc)];
                            buf[(py + rr) * rc->pw[plane] + (px + cc)] =
                                (int32_t)((mm * cur
                                           + (64 - mm) * tmp[rr * pw + cc]
                                           + 32) >> 6);
                        }
                }
            }
            i = rel + step;
        }
    }
}

/* ---- compound (recon_ref._recon_compound) -------------------------- */

static void recon_compound(Recon *rc, const int32_t *b) {
    const ReconParams *rp = rc->rp;
    int bsize = b[BLK_BSIZE];
    int comp_type = b[BLK_COMP_TYPE];
    int w0 = 8, w1 = 8;
    if (comp_type == MC_COMP_DISTANCE)
        dist_weights(rc->fp, b[BLK_REF0], b[BLK_REF1], &w0, &w1);
    int masked = comp_type == MC_COMP_WEDGE || comp_type == MC_COMP_DIFFWTD;
    int n_planes = (b[BLK_HASCHROMA] && rp->num_planes > 1) ? 3 : 1;
    int64_t mx = (1 << rp->bitdepth) - 1;
    const int ipr = 7 - mc_round0(rp->bitdepth);    /* InterPostRound */
    int8_t mask_luma[128 * 128];
    int32_t mv0[2] = {b[BLK_MV_R], b[BLK_MV_C]};
    int32_t mv1[2] = {b[BLK_MV2_R], b[BLK_MV2_C]};
    int32_t filt[2] = {b[BLK_INTERP0], b[BLK_INTERP1]};
    for (int plane = 0; plane < n_planes; plane++) {
        int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
        int x = (b[BLK_C] >> ssx) * 4, y = (b[BLK_R] >> ssy) * 4;
        int full_w = rmax(1, av1_block_w4[bsize] >> ssx) * 4;
        int full_h = rmax(1, av1_block_h4[bsize] >> ssy) * 4;
        pel *buf = rc->planes[plane];
        int w = rmin(full_w, rc->pw[plane] - x);
        int h = rmin(full_h, rc->ph[plane] - y);
        /* masked compound predicts the full (unclipped) block so the
           chroma mask subsample matches dav1d's padded buffers */
        int pw = masked ? full_w : w, ph = masked ? full_h : h;
        int rw0, rh0, rs0, rw1, rh1, rs1;
        const pel *r0 = mc_ref_plane(rc, b[BLK_REF0], plane, &rw0,
                                          &rh0, &rs0);
        const pel *r1 = mc_ref_plane(rc, b[BLK_REF1], plane, &rw1,
                                          &rh1, &rs1);
        int32_t p0[128 * 128], p1[128 * 128];
        mc_predict(rc, b[BLK_REF0], r0, rw0, rh0, rs0, x, y, pw, ph,
                   mv0, ssx, ssy, filt, full_w, full_h, 1, rp->bitdepth,
                   p0, NULL, 0);
        mc_predict(rc, b[BLK_REF1], r1, rw1, rh1, rs1, x, y, pw, ph,
                   mv1, ssx, ssy, filt, full_w, full_h, 1, rp->bitdepth,
                   p1, NULL, 0);
        if (masked) {
            int8_t msk[128 * 128];
            if (plane == 0) {
                if (comp_type == MC_COMP_WEDGE)
                    wedge_mask_c(bsize, b[BLK_WEDGE_IDX],
                                 b[BLK_WEDGE_SIGN], mask_luma);
                else
                    diffwtd_mask_c(p0, p1, pw * ph, b[BLK_MASK_TYPE],
                                   rp->bitdepth, mask_luma);
                memcpy(msk, mask_luma, (size_t)pw * ph);
            } else {
                int lw = av1_block_w4[bsize] * 4;
                int lh = av1_block_h4[bsize] * 4;
                subsample_mask_c(mask_luma, lw, lh, ssx, ssy, msk);
            }
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) {
                    int m = msk[r * pw + c];
                    int64_t v = ((int64_t)p0[r * pw + c] * m
                                 + (int64_t)p1[r * pw + c] * (64 - m)
                                 + (32 << ipr)) >> (ipr + 6);
                    buf[(y + r) * rc->pw[plane] + (x + c)] =
                        (int32_t)(v < 0 ? 0 : (v > mx ? mx : v));
                }
        } else {
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) {
                    int64_t v = ((int64_t)p0[r * pw + c] * w0
                                 + (int64_t)p1[r * pw + c] * w1
                                 + (8 << ipr)) >> (ipr + 4);
                    buf[(y + r) * rc->pw[plane] + (x + c)] =
                        (int32_t)(v < 0 ? 0 : (v > mx ? mx : v));
                }
        }
        mark_decoded(rc, plane, x, y, w, h);
    }
}

/* ---- single-ref / warp / interintra (recon_ref._recon_block_inter) - */

static int recon_block_inter(Recon *rc, const int32_t *b) {
    const ReconParams *rp = rc->rp;
    const FrameParams *fp = rc->fp;
    if (b[BLK_REF0] == MC_INTRA_FRAME && b[BLK_INTRABC]) {
        /* intrabc needs no reference frames (reads the current planes) */
    } else if (rc->refs == NULL || fp == NULL) {
        return 1;
    }
    if (b[BLK_REF1] > MC_INTRA_FRAME) {
        recon_compound(rc, b);
        residual_add(rc, b);
        return 0;
    }
    if (b[BLK_REF0] == MC_INTRA_FRAME) {
        /* intra block copy: integer-pel DV from the partially
           reconstructed current frame, BILINEAR chroma phases */
        int bsz = b[BLK_BSIZE];
        int n_pl = (b[BLK_HASCHROMA] && rp->num_planes > 1) ? 3 : 1;
        int32_t mvd[2] = {b[BLK_MV_R], b[BLK_MV_C]};
        int32_t filt[2] = {b[BLK_INTERP0], b[BLK_INTERP1]};
        for (int plane = 0; plane < n_pl; plane++) {
            int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
            int x = (b[BLK_C] >> ssx) * 4, y = (b[BLK_R] >> ssy) * 4;
            int full_w = rmax(1, av1_block_w4[bsz] >> ssx) * 4;
            int full_h = rmax(1, av1_block_h4[bsz] >> ssy) * 4;
            pel *buf = rc->planes[plane];
            int w = rmin(full_w, rc->pw[plane] - x);
            int h = rmin(full_h, rc->ph[plane] - y);
            int32_t pred[128 * 128];
            predict_inter_i32(buf, rc->pw[plane], rc->ph[plane], x, y,
                              w, h, mvd, ssx, ssy, filt, full_w, full_h,
                              rp->bitdepth, pred);
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++)
                    buf[(y + r) * rc->pw[plane] + (x + c)] =
                        pred[r * w + c];
            mark_decoded(rc, plane, x, y, w, h);
        }
        residual_add(rc, b);
        return 0;
    }
    int bsize = b[BLK_BSIZE];
    int ref = b[BLK_REF0];
    /* warp selection: local warp beats global; invalid -> translation */
    const int32_t *wm = NULL, *shear = NULL;
    int32_t gm_sh[4];
    if (b[BLK_MOTION_MODE] == MC_MM_WARPED && b[BLK_WARP_VALID]) {
        wm = b + BLK_WM0;
        shear = b + BLK_SH_ALPHA;
    } else if (b[BLK_MODE] == MC_GLOBALMV
               && rmin(av1_block_w4[bsize], av1_block_h4[bsize]) * 4 >= 8
               && fp->gm_type[ref] > MC_GM_TRANSLATION
               && !fp->gm_invalid[ref]) {
        if (get_shear_params(fp->gm_params[ref], gm_sh)) {
            wm = fp->gm_params[ref];
            shear = gm_sh;
        }
    }
    int n_planes = (b[BLK_HASCHROMA] && rp->num_planes > 1) ? 3 : 1;
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    int32_t mv[2] = {b[BLK_MV_R], b[BLK_MV_C]};
    int32_t filt[2] = {b[BLK_INTERP0], b[BLK_INTERP1]};
    int defer_mask = 0;
    for (int plane = 0; plane < n_planes; plane++) {
        int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
        int x = (b[BLK_C] >> ssx) * 4, y = (b[BLK_R] >> ssy) * 4;
        int full_w = rmax(1, w4 >> ssx) * 4;
        int full_h = rmax(1, h4 >> ssy) * 4;
        pel *buf = rc->planes[plane];
        int w = rmin(full_w, rc->pw[plane] - x);
        int h = rmin(full_h, rc->ph[plane] - y);
        if (plane && ((w4 == 1 && ssx) || (h4 == 1 && ssy))) {
            if (sub8x8_chroma(rc, b, plane, x, y, w, h, ssx, ssy)) {
                mark_decoded(rc, plane, x, y, w, h);
                continue;
            }
        }
        int rw, rh, rs;
        const pel *rpl = mc_ref_plane(rc, ref, plane, &rw, &rh,
                                           &rs);
        int32_t pred[128 * 128];
        int sxs, sys;
        int scaled = mc_is_scaled(rc, ref, &sxs, &sys);
        int use_warp = wm != NULL && full_w >= 8 && full_h >= 8
                       && !scaled;
        /* fused store: plain single-ref MC writes the frame plane
           directly; warp/interintra still stage through pred */
        int direct = !use_warp && b[BLK_II_MODE] < 0;
        pel *dpix = buf + (int64_t)y * rc->pw[plane] + x;
        /* plain integer-MV inside copies go to the deferred plan
           (flushed as merged row bands); the plane's residual is
           deferred with them so it lands after its copy */
        /* nt=0: non-temporal stores for residual-free bands measured
           a wash at 1080p and ~1% SLOWER at 4K on this host
           (interleaved best-of-8 A/B) — the copies are source-read
           bound, and NT forces the postfilter/display readers back to
           DRAM.  The cp_copy_rows NT path stays for hosts where plain
           stores' RFO traffic is the bottleneck. */
        if (direct && b[BLK_MOTION_MODE] == MC_MM_SIMPLE && !scaled
            && try_defer_copy(rc, plane, rpl, rw, rh, rs, x, y, w, h,
                              mv, ssx, ssy, 0)) {
            if (b[BLK_NTX] == 0 || resid_defer(rc, plane, b, y))
                defer_mask |= 1 << plane;
            else
                copyplan_flush(rc);  /* OOM: land the copy now */
            mark_decoded(rc, plane, x, y, w, h);
            continue;
        }
        if (use_warp) {
            uint64_t wt0 = __rdtsc();
            warp_affine_u16(rpl, rw, rh, rs, wm, shear, x, y, w, h,
                            ssx, ssy, rp->bitdepth, pred);
            av1_mc_stat[14] += (uint64_t)w * h;
            av1_mc_stat[15] += __rdtsc() - wt0;
        } else
            mc_predict(rc, ref, rpl, rw, rh, rs, x, y, w, h, mv, ssx,
                       ssy, filt, full_w, full_h, 0, rp->bitdepth,
                       pred, direct ? dpix : NULL, rc->pw[plane]);
        if (!direct) {
            if (b[BLK_II_MODE] >= 0)
                interintra_blend(rc, b, plane, x, y, w, h, full_w,
                                 full_h, ssx, ssy, pred);
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++)
                    buf[(y + r) * rc->pw[plane] + (x + c)] =
                        pred[r * w + c];
        }
        mark_decoded(rc, plane, x, y, w, h);
    }
    if (b[BLK_MOTION_MODE] == MC_MM_OBMC)
        apply_obmc(rc, b);
    if (defer_mask != 7)
        residual_add_mask(rc, b, 7 & ~defer_mask);
    return 0;
}
