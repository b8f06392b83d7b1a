// Copy of easyav1_tpu/native/av1_tile.c, the JAX package's counterpart.
/* AV1 tile symbol decoder — native hot path (SURVEY.md §2d/§7: the
 * sequential msac entropy decode stays on CPU and must be tight native
 * code; the dense math it feeds runs on the TPU).
 *
 * Exact port of the verified Python reference (easyav1_tpu_torch/video/av1/
 * msac.py + tile.py); tests assert bit-identical plan output between the
 * two.  Intra keyframes, one tile region per call.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "av1_common.h"
#include "av1_tables.h"

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4

/* entropy-stage internals, gated behind the shared profiling flag
   (av1_set_stage_profile): [0] decode_block ticks, [1] inter mode-info
   ticks, [2] residual-section ticks, [8] blocks, [9] inter blocks,
   [10] coded (non-skip) blocks, [11] eob sum, [12] tx count */
extern int rc_profile;
uint64_t av1_tile_stat[24];
void av1_get_tile_stats(uint64_t *out) {
    for (int i = 0; i < 24; i++) { out[i] = av1_tile_stat[i]; av1_tile_stat[i] = 0; }
}
static inline uint64_t tl_tick(void) {
    return __builtin_expect(rc_profile, 0) ? __builtin_ia32_rdtsc() : 0;
}
static inline void tl_add(int slot, uint64_t t0) {
    if (__builtin_expect(rc_profile, 0))
        av1_tile_stat[slot] += __builtin_ia32_rdtsc() - t0;
}
static inline void tl_count(int slot, uint64_t n) {
    if (__builtin_expect(rc_profile, 0)) av1_tile_stat[slot] += n;
}

/* ------------------------------------------------------------------ */
/* msac range decoder (spec §8.2; mirror of msac.py)                   */

typedef struct {
    /* dav1d-style 64-bit inverted window: the top 16 bits are the
     * arithmetic-decoder value, lower bits are future bitstream bits
     * (bits past the buffer end read as spec zero padding) */
    const uint8_t *buf_pos;
    const uint8_t *buf_end;
    uint64_t dif;
    int cnt;
    uint32_t rng;
    int allow_update;
} Msac;

#define MSAC_VAL(s) ((uint32_t)((s)->dif >> 48))

static inline int floor_log2(uint32_t x) {
    return x ? 31 - __builtin_clz(x) : -1;
}



#ifdef __AVX2__
#include <immintrin.h>
/* per-n constants for the vector symbol search: the EC_MIN_PROB ramp
 * 4*(n-1-i) and masks selecting the boundary / updatable lanes */
static uint16_t msac_ramp[17][16];
static uint16_t msac_vmask[17][16];   /* lanes i < n-1 (boundaries) */
static uint16_t msac_umask[17][16];   /* lanes i < n   (adapted)    */
static int msac_tables_ready = 0;
static void msac_tables_init(void) {
    for (int n = 2; n <= 16; n++)
        for (int i = 0; i < 16; i++) {
            msac_ramp[n][i] =
                i < n - 1 ? (uint16_t)(EC_MIN_PROB * (n - 1 - i)) : 0;
            msac_vmask[n][i] = i < n - 1 ? 0xFFFF : 0;
            msac_umask[n][i] = i < n ? 0xFFFF : 0;
        }
    msac_tables_ready = 1;
}
#endif

static void msac_refill(Msac *s) {
    int c = 64 - s->cnt - 24;          /* only entered with cnt < 0 */
    uint64_t dif = s->dif;
    const uint8_t *p = s->buf_pos;
    if (s->buf_end - p >= 8) {
        /* whole-word refill: the byte loop XORs p[i] << (c - 8i) while
           c - 8i >= 0; that equals the big-endian word shifted so its
           top byte lands at c, with the partially-out-of-range tail
           byte's bits masked off */
        uint64_t w;
        memcpy(&w, p, 8);
        w = __builtin_bswap64(w);
        dif ^= (w >> (56 - c)) & ~((1ull << (c & 7)) - 1);
        s->dif = dif;
        s->buf_pos = p + (c >> 3) + 1;
        s->cnt = 48 - (c & 7);
        return;
    }
    do {
        if (p < s->buf_end) dif ^= (uint64_t)(*p++) << c;
        c -= 8;
    } while (c >= 0);
    s->dif = dif;
    s->cnt = 64 - c - 24;
    s->buf_pos = p;
}

static void msac_init(Msac *s, const uint8_t *data, int64_t size,
                      int allow_update) {
#ifdef __AVX2__
    if (!msac_tables_ready) msac_tables_init();
#endif
    s->buf_pos = data;
    s->buf_end = data + size;
    s->dif = ((uint64_t)1 << 63) - 1;
    s->rng = 1u << 15;
    s->cnt = -15;
    s->allow_update = allow_update;
    msac_refill(s);
}

/* renorm: dif already has the chosen interval subtracted */
static inline void msac_norm(Msac *s, uint64_t dif, uint32_t rng) {
    int d = 15 ^ (31 ^ __builtin_clz(rng));
    s->cnt -= d;
    s->dif = ((dif + 1) << d) - 1;
    s->rng = rng << d;
    if (s->cnt < 0) msac_refill(s);
}


/* 2-symbol adaptive decode: one boundary, pure scalar (the SIMD
 * search costs more than it saves at n == 2; mirrors dav1d's
 * msac_decode_bool_adapt) */
static inline int msac_bool_adapt(Msac *s, uint16_t *cdf) {
    uint32_t cur = (((s->rng >> 8) * (cdf[0] >> EC_PROB_SHIFT))
                    >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB;
    uint32_t value = MSAC_VAL(s);
    int sym = value < cur;
    if (s->allow_update) {
        int count = cdf[2];
        /* general formula: 3 + (c>15) + (c>31) + min(log2(n), 2); n=2 */
        int rate = 4 + (count > 15) + (count > 31);
        if (sym) cdf[0] += (32768 - cdf[0]) >> rate;
        else cdf[0] -= cdf[0] >> rate;
        cdf[2] = count + (count < 32);
    }
    if (sym) msac_norm(s, s->dif, cur);
    else msac_norm(s, s->dif - ((uint64_t)cur << 48), s->rng - cur);
    return sym;
}

#ifdef __AVX2__
/* constant-n symbol decode with the per-n SIMD tables preloaded by
 * the caller — lets the coefficient loop keep ramp/vmask/umask in
 * registers across ~2M calls/frame instead of reloading them */
static inline __attribute__((always_inline)) int
msac_sym_pre(Msac *s, uint16_t *cdf, const int n, __m128i ramp,
             __m128i vmask, __m128i umask) {
    __m128i cdfv = _mm_loadu_si128((const __m128i *)cdf);
    __m128i c6 = _mm_slli_epi16(_mm_srli_epi16(cdfv, 6), 7);
    __m128i rv = _mm_set1_epi16((short)(s->rng & 0xff00));
    __m128i v = _mm_add_epi16(_mm_mulhi_epu16(rv, c6), ramp);
    v = _mm_and_si128(v, vmask);
    __m128i bias = _mm_set1_epi16((short)0x8000);
    __m128i gt = _mm_cmpgt_epi16(
        _mm_xor_si128(v, bias),
        _mm_set1_epi16((short)(MSAC_VAL(s) ^ 0x8000)));
    int sym = __builtin_popcount(_mm_movemask_epi8(gt)) >> 1;
    /* v is lane-decreasing, so cur = v[sym] = max over non-gt lanes
       and prev = v[sym-1] = min over gt lanes — horizontal minpos
       keeps both OFF the sym popcount chain (the store + indexed
       reload they replace cost a forwarding round-trip on the
       critical path to the next symbol's rng) */
    const __m128i ones = _mm_set1_epi8(-1);
    __m128i curv = _mm_or_si128(_mm_xor_si128(v, ones), gt);
    uint32_t cur = (uint16_t)~(uint32_t)_mm_cvtsi128_si32(
        _mm_minpos_epu16(curv));
    __m128i prevv = _mm_or_si128(v, _mm_xor_si128(gt, ones));
    uint32_t prev = sym ? (uint32_t)(uint16_t)_mm_cvtsi128_si32(
        _mm_minpos_epu16(prevv)) : s->rng;
    if (s->allow_update) {
        int count = cdf[n];
        int l2c = n >= 4 ? 2 : (n >= 2 ? 1 : 0);
        int rate = 3 + (count > 15) + (count > 31) + l2c;
        __m128i idx = _mm_setr_epi16(0, 1, 2, 3, 4, 5, 6, 7);
        __m128i lt = _mm_cmplt_epi16(idx, _mm_set1_epi16((short)sym));
        __m128i sh = _mm_cvtsi32_si128(rate);
        __m128i up = _mm_srl_epi16(_mm_sub_epi16(bias, cdfv), sh);
        __m128i dn = _mm_srl_epi16(cdfv, sh);
        __m128i delta = _mm_or_si128(
            _mm_and_si128(lt, up),
            _mm_andnot_si128(lt, _mm_sub_epi16(_mm_setzero_si128(),
                                               dn)));
        delta = _mm_and_si128(delta, umask);
        _mm_storeu_si128((__m128i *)cdf, _mm_add_epi16(cdfv, delta));
        cdf[n] = count + (count < 32);
    }
    msac_norm(s, s->dif - ((uint64_t)cur << 48), prev - cur);
    return sym;
}
#endif

/* Scalar 3/4-symbol adaptive decode for the coefficient loop.  The
 * SIMD search (msac_sym_pre) pays mulhi+movemask+popcount+minpos on
 * the serial rng/dif critical chain; at n <= 4 three scalar imuls and
 * a cmov chain resolve cur/prev in fewer cycles, and the CDF update
 * (off the critical path) stays branchless via ternaries-as-cmov.
 * Bit-exact with the vector path: v_i = ((rng>>8)*(cdf_i>>6)>>1)
 * + 4*(n-1-i), sym = #(value < v_i). */
static inline __attribute__((always_inline)) int
msac_sym4_scalar(Msac *s, uint16_t *cdf, const int n) {
    uint32_t r8 = s->rng >> 8;
    uint32_t value = MSAC_VAL(s);
    uint32_t c0 = cdf[0], c1 = cdf[1];
    uint32_t v0 = ((r8 * (c0 >> 6)) >> 1) + EC_MIN_PROB * (n - 1);
    uint32_t v1 = ((r8 * (c1 >> 6)) >> 1) + EC_MIN_PROB * (n - 2);
    uint32_t c2 = 0, v2 = 0;
    if (n == 4) {
        c2 = cdf[2];
        v2 = ((r8 * (c2 >> 6)) >> 1) + EC_MIN_PROB;
    }
    int sym = (value < v0) + (value < v1);
    if (n == 4) sym += value < v2;
    uint32_t cur = v0, prev = s->rng;
    if (sym >= 1) { cur = v1; prev = v0; }
    if (n == 4) {
        if (sym >= 2) { cur = v2; prev = v1; }
        if (sym >= 3) { cur = 0;  prev = v2; }
    } else {
        if (sym >= 2) { cur = 0;  prev = v1; }
    }
    if (s->allow_update) {
        int count = cdf[n];
        int rate = 3 + (count > 15) + (count > 31) + (n >= 4 ? 2 : 1);
        cdf[0] = (uint16_t)(sym > 0 ? c0 + ((32768 - c0) >> rate)
                                    : c0 - (c0 >> rate));
        cdf[1] = (uint16_t)(sym > 1 ? c1 + ((32768 - c1) >> rate)
                                    : c1 - (c1 >> rate));
        if (n == 4)
            cdf[2] = (uint16_t)(sym > 2 ? c2 + ((32768 - c2) >> rate)
                                        : c2 - (c2 >> rate));
        cdf[n] = (uint16_t)(count + (count < 32));
    }
    msac_norm(s, s->dif - ((uint64_t)cur << 48), prev - cur);
    return sym;
}

/* cdf: n+1 uint16 entries (n-1 boundaries, 0 terminator, counter) */
static int msac_symbol(Msac *s, uint16_t *cdf, int n) {
#ifdef __AVX2__
    /* vector search: v_i = ((rng>>8)*(cdf_i>>6)>>1) + 4*(n-1-i); the
     * mulhi trick computes ((rng&0xff00)*((cdf>>6)<<7))>>16 exactly.
     * sym = #lanes with v_i > value (v decreasing).  CdfState carries a
     * 16-lane tail pad so over-reads stay in the struct. */
    if (n <= 9) {
        __m128i cdfv = _mm_loadu_si128((const __m128i *)cdf);
        __m128i c6 = _mm_slli_epi16(_mm_srli_epi16(cdfv, 6), 7);
        __m128i rv = _mm_set1_epi16((short)(s->rng & 0xff00));
        __m128i v = _mm_add_epi16(
            _mm_mulhi_epu16(rv, c6),
            _mm_loadu_si128((const __m128i *)msac_ramp[n]));
        v = _mm_and_si128(v,
                          _mm_loadu_si128((const __m128i *)msac_vmask[n]));
        __m128i bias = _mm_set1_epi16((short)0x8000);
        __m128i gt = _mm_cmpgt_epi16(
            _mm_xor_si128(v, bias),
            _mm_set1_epi16((short)(MSAC_VAL(s) ^ 0x8000)));
        int sym = __builtin_popcount(_mm_movemask_epi8(gt)) >> 1;
        uint16_t va[9];
        va[8] = 0;                    /* terminator lane for n == 9 */
        _mm_storeu_si128((__m128i *)va, v);
        uint32_t cur = va[sym];
        uint32_t prev = sym ? va[sym - 1] : s->rng;
        uint32_t value = MSAC_VAL(s);
        if (s->allow_update) {
            int count = cdf[n];
            int l2 = floor_log2((uint32_t)n);
            int rate = 3 + (count > 15) + (count > 31) + (l2 < 2 ? l2 : 2);
            __m128i idx = _mm_setr_epi16(0, 1, 2, 3, 4, 5, 6, 7);
            __m128i lt = _mm_cmplt_epi16(idx, _mm_set1_epi16((short)sym));
            __m128i sh = _mm_cvtsi32_si128(rate);
            __m128i up = _mm_srl_epi16(
                _mm_sub_epi16(bias, cdfv), sh);        /* (32768-cdf)>>r */
            __m128i dn = _mm_srl_epi16(cdfv, sh);      /* cdf>>r */
            __m128i delta = _mm_or_si128(
                _mm_and_si128(lt, up),
                _mm_andnot_si128(lt, _mm_sub_epi16(_mm_setzero_si128(),
                                                   dn)));
            delta = _mm_and_si128(
                delta, _mm_loadu_si128((const __m128i *)msac_umask[n]));
            _mm_storeu_si128((__m128i *)cdf,
                             _mm_add_epi16(cdfv, delta));
            cdf[n] = count + (count < 32);
        }
        msac_norm(s, s->dif - ((uint64_t)cur << 48), prev - cur);
        return sym;
    }
    if (n <= 16) {
        __m256i cdfv = _mm256_loadu_si256((const __m256i *)cdf);
        __m256i c6 = _mm256_slli_epi16(_mm256_srli_epi16(cdfv, 6), 7);
        __m256i rv = _mm256_set1_epi16((short)(s->rng & 0xff00));
        __m256i v = _mm256_add_epi16(
            _mm256_mulhi_epu16(rv, c6),
            _mm256_loadu_si256((const __m256i *)msac_ramp[n]));
        v = _mm256_and_si256(
            v, _mm256_loadu_si256((const __m256i *)msac_vmask[n]));
        __m256i bias = _mm256_set1_epi16((short)0x8000);
        __m256i gt = _mm256_cmpgt_epi16(
            _mm256_xor_si256(v, bias),
            _mm256_set1_epi16((short)(MSAC_VAL(s) ^ 0x8000)));
        int sym = __builtin_popcount(
                      (unsigned)_mm256_movemask_epi8(gt)) >> 1;
        uint16_t va[16];
        _mm256_storeu_si256((__m256i *)va, v);
        uint32_t cur = va[sym];
        uint32_t prev = sym ? va[sym - 1] : s->rng;
        uint32_t value = MSAC_VAL(s);
        if (s->allow_update) {
            int count = cdf[n];
            int l2 = floor_log2((uint32_t)n);
            int rate = 3 + (count > 15) + (count > 31) + (l2 < 2 ? l2 : 2);
            __m256i idx = _mm256_setr_epi16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                            10, 11, 12, 13, 14, 15);
            __m256i lt = _mm256_cmpgt_epi16(_mm256_set1_epi16((short)sym),
                                            idx);
            __m128i sh = _mm_cvtsi32_si128(rate);
            __m256i up = _mm256_srl_epi16(_mm256_sub_epi16(bias, cdfv),
                                          sh);
            __m256i dn = _mm256_srl_epi16(cdfv, sh);
            __m256i delta = _mm256_or_si256(
                _mm256_and_si256(lt, up),
                _mm256_andnot_si256(
                    lt, _mm256_sub_epi16(_mm256_setzero_si256(), dn)));
            delta = _mm256_and_si256(
                delta,
                _mm256_loadu_si256((const __m256i *)msac_umask[n]));
            _mm256_storeu_si256((__m256i *)cdf,
                                _mm256_add_epi16(cdfv, delta));
            cdf[n] = count + (count < 32);
        }
        msac_norm(s, s->dif - ((uint64_t)cur << 48), prev - cur);
        return sym;
    }
#endif
    uint32_t rng = s->rng, value = MSAC_VAL(s);
    uint32_t cur = rng, prev;
    int sym = -1;
    uint32_t r8 = rng >> 8;
    do {
        sym++;
        prev = cur;
        cur = ((r8 * (cdf[sym] >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT))
              + EC_MIN_PROB * (n - 1 - sym);
    } while (value < cur);
    msac_norm(s, s->dif - ((uint64_t)cur << 48), prev - cur);
    if (s->allow_update) {
        int count = cdf[n];
        int l2 = floor_log2((uint32_t)n);
        int rate = 3 + (count > 15) + (count > 31) + (l2 < 2 ? l2 : 2);
        for (int i = 0; i < n - 1; i++) {
            if (i >= sym) cdf[i] -= cdf[i] >> rate;
            else cdf[i] += (32768 - cdf[i]) >> rate;
        }
        cdf[n] = count + (count < 32);
    }
    return sym;
}

static int msac_bool(Msac *s, uint32_t f) {
    uint32_t rng = s->rng, value = MSAC_VAL(s);
    uint32_t cur = ((rng >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                   + EC_MIN_PROB;
    if (value >= cur) { msac_norm(s, s->dif - ((uint64_t)cur << 48), rng - cur); return 0; }
    msac_norm(s, s->dif, cur);
    return 1;
}

/* equiprobable bit (coefficient signs): branchless — the bit is 50/50
   by construction, so selecting dif/rng via cmov beats a guaranteed-
   half-mispredicted branch */
static inline int msac_bool_equi(Msac *s) {
    uint32_t rng = s->rng, value = MSAC_VAL(s);
    uint32_t cur = ((rng >> 8) << 7) + EC_MIN_PROB;
    int bit = value < cur;
    uint64_t dif = s->dif - (bit ? 0 : (uint64_t)cur << 48);
    msac_norm(s, dif, bit ? cur : rng - cur);
    return bit;
}

static uint32_t msac_literal(Msac *s, int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) x = (x << 1) | msac_bool_equi(s);
    return x;
}

static int msac_golomb(Msac *s) {
    int length = 0;
    while (!msac_bool_equi(s)) {
        length++;
        if (length > 31) break;
    }
    int x = 1;
    int lim = length < 31 ? length : 31;
    for (int i = 0; i < lim; i++) x = (x << 1) | msac_bool_equi(s);
    return x - 1;
}

/* ------------------------------------------------------------------ */
/* CDF state: generated full-state struct (av1_cdf_state.h) covering   */
/* every adaptive table; blob-compatible with the Python CdfContext.   */

#include "av1_cdf_state.h"

/* ragged decode: CDF row stored wider than the symbol count
   (tile.py _decode_ragged) */
static int msac_ragged(Msac *s, uint16_t *row, int row_len, int nsym) {
    if (row_len == nsym + 1) return msac_symbol(s, row, nsym);
    uint16_t sub[20];
    memcpy(sub, row, (size_t)(nsym - 1) * sizeof(uint16_t));
    sub[nsym - 1] = 0;
    sub[nsym] = row[row_len - 1];
    int sym = msac_symbol(s, sub, nsym);
    memcpy(row, sub, (size_t)(nsym - 1) * sizeof(uint16_t));
    row[row_len - 1] = sub[nsym];
    return sym;
}

/* ------------------------------------------------------------------ */

typedef struct {
    const TileParams *p;
    const FrameParams *fp;
    TileOut *o;
    Msac msac;
    CdfState cdf;
    /* context arrays: above indexed by absolute mi col, left by mi row;
       all planes use full-length arrays (parity with tile.py) */
    int8_t *a_part, *l_part;
    int8_t *a_mode, *l_mode;
    int8_t *a_skip, *l_skip;
    /* skip-mode / compound-group / compound-index neighbor context:
       read only at the immediate above/left cell, so above/left span
       arrays replace the former frame-sized mi grids (O(w+h) fill per
       block instead of O(area)) */
    int8_t *a_skipmode, *l_skipmode;
    int8_t *a_compgrp, *l_compgrp;
    int8_t *a_compidx, *l_compidx;
    int8_t *a_txw, *l_txh;
    int8_t *a_lvl[3], *l_lvl[3];
    int8_t *a_sign[3], *l_sign[3];
    int32_t cur_qindex;
    int32_t read_deltas;
    int64_t cur_block;
    /* inter decode state (per av1_decode_tile call) */
    uint8_t *decoded_mi;      /* mi grid: cell decoded by THIS tile */
    int8_t *tx_types;         /* mi grid: luma tx type per 4x4 */
    int skip_mode_flag;
    int cur_partition;        /* partition type at the current node */
    /* loop-restoration predictors, reset per tile (spec decode_tile) */
    int lr_ref_wiener[3][2][3];
    int lr_ref_sgr[3][2];
    /* palette contexts (dav1d al_pal): sizes per 4px unit + colors */
    int8_t *a_pal_sz[2], *l_pal_sz[2];
    int32_t *a_pal[3], *l_pal[3];     /* [mi][8] color stores */
} Ctx;

enum { BLOCK_4X4 = 0, BLOCK_8X8 = 3, BLOCK_64X64 = 12, BLOCK_128X128 = 15 };
enum { PART_NONE = 0, PART_HORZ, PART_VERT, PART_SPLIT, PART_HORZ_A,
       PART_HORZ_B, PART_VERT_A, PART_VERT_B, PART_HORZ_4, PART_VERT_4 };
enum { DC_PRED = 0, V_PRED = 1, H_PRED = 2, D157_PRED = 6,
       D67_PRED = 8, UV_CFL = 13 };
enum { TX_4X4 = 0, TX_16X16 = 2, TX_32X32 = 3, TX_64X64 = 4 };
enum { DCT_DCT = 0 };

static int sq_index(int bsize) {
    switch (bsize) {
    case 3: return 0; case 6: return 1; case 9: return 2;
    case 12: return 3; case 15: return 4;
    }
    return -1;
}

/* spec Partition_Subsize, square parents only (tile.py partition_subsize) */
static int partition_subsize(int part, int bsize) {
    static const int8_t SPLIT_[5] = {0, 3, 6, 9, 12};
    static const int8_t HORZ_[5] = {2, 5, 8, 11, 14};
    static const int8_t VERT_[5] = {1, 4, 7, 10, 13};
    static const int8_t H4_[5] = {-1, 17, 19, 21, -1};
    static const int8_t V4_[5] = {-1, 16, 18, 20, -1};
    int i = sq_index(bsize);
    switch (part) {
    case PART_NONE: return bsize;
    case PART_SPLIT: return SPLIT_[i];
    case PART_HORZ: case PART_HORZ_A: case PART_HORZ_B: return HORZ_[i];
    case PART_VERT: case PART_VERT_A: case PART_VERT_B: return VERT_[i];
    case PART_HORZ_4: return H4_[i];
    case PART_VERT_4: return V4_[i];
    }
    return bsize;
}

static int mi_wlog2(int b) { return floor_log2((uint32_t)av1_block_w4[b]); }
static int mi_hlog2(int b) { return floor_log2((uint32_t)av1_block_h4[b]); }

static int dc_q(int qindex, int bitdepth) {
    int q = qindex < 0 ? 0 : (qindex > 255 ? 255 : qindex);
    if (bitdepth == 10) return av1_dc_qlookup_10[q];
    if (bitdepth == 12) return av1_dc_qlookup_12[q];
    return av1_dc_qlookup[q];
}

static int ac_q(int qindex, int bitdepth) {
    int q = qindex < 0 ? 0 : (qindex > 255 ? 255 : qindex);
    if (bitdepth == 10) return av1_ac_qlookup_10[q];
    if (bitdepth == 12) return av1_ac_qlookup_12[q];
    return av1_ac_qlookup[q];
}

static int imin(int a, int b) { return a < b ? a : b; }
static int imax(int a, int b) { return a > b ? a : b; }

/* refmvs stack, warp estimation, inter mode parse (same TU) */
#include "av1_inter.h"

/* ------------------------------------------------------------------ */
/* coefficient contexts (tile.py statics)                              */

static int coeff_base_eob_ctx(int ci, int tw, int th) {
    if (ci == 0) return 0;
    int n = tw * th;
    if (ci <= n / 8) return 1;
    if (ci <= n / 4) return 2;
    return 3;
}

/* coefficient neighbour contexts over a PADDED uint8 level map:
 * stride = tx_width + 4 with >=2 zero rows/cols of slack below/right,
 * so no bounds checks are needed (dav1d's levels layout) */
static inline int coeff_base_ctx(const uint8_t *lvl, int pos, int bwl,
                                 int stride, int cls,
                                 const int8_t *base_offsets) {
    int w = 1 << bwl;
    int row = pos >> bwl;
    int col = pos & (w - 1);
    const uint8_t *p = lvl + row * stride + col;
    int mag;
    if (cls == 0)
        mag = imin(p[1], 3) + imin(p[stride], 3) + imin(p[stride + 1], 3)
              + imin(p[2], 3) + imin(p[2 * stride], 3);
    else if (cls == 1)
        mag = imin(p[1], 3) + imin(p[stride], 3) + imin(p[2], 3)
              + imin(p[3], 3) + imin(p[4], 3);
    else
        mag = imin(p[1], 3) + imin(p[stride], 3)
              + imin(p[2 * stride], 3) + imin(p[3 * stride], 3)
              + imin(p[4 * stride], 3);
    int ctx = imin((mag + 1) >> 1, 4);
    if (cls == 0) {
        if (pos == 0) return 0;
        return ctx + base_offsets[pos];
    }
    int major = cls == 1 ? col : row;
    return ctx + 26 + imin(major, 2) * 5;
}

static inline int coeff_br_ctx(const uint8_t *lvl, int pos, int bwl,
                               int stride, int cls) {
    int w = 1 << bwl;
    int row = pos >> bwl;
    int col = pos & (w - 1);
    const uint8_t *p = lvl + row * stride + col;
    int mag;
    if (cls == 0)
        mag = imin(p[1], 15) + imin(p[stride], 15)
              + imin(p[stride + 1], 15);
    else if (cls == 1)
        mag = imin(p[1], 15) + imin(p[stride], 15) + imin(p[2], 15);
    else
        mag = imin(p[1], 15) + imin(p[stride], 15)
              + imin(p[2 * stride], 15);
    mag = imin((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == 0) {
        if (row < 2 && col < 2) return mag + 7;
        return mag + 14;
    }
    int major = cls == 1 ? col : row;
    if (major == 0) return mag + 7;
    return mag + 14;
}

/* ------------------------------------------------------------------ */

/* tables.py get_tx_set_intra */
static int get_tx_set_intra(int tx_size, int reduced) {
    int sqr_up = av1_tx_sqr_up[tx_size];
    if (sqr_up >= TX_32X32) return 0;
    if (reduced) return 2;
    if (av1_tx_sqr[tx_size] == TX_16X16) return 2;
    return 1;
}

static int max_tx_depth(int bsize) {
    static const int8_t D[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4,
                                 4, 4, 4, 2, 2, 3, 3, 4, 4};
    return D[bsize];
}

/* writes clip at the frame's PLANE-cell grid (libaom
 * av1_set_entropy_contexts): a bottom/right-overhanging chroma tx must
 * not leave stale state in cells past the plane grid — the arrays are
 * luma-cell sized, so an unclipped chroma write would land in a
 * valid-but-wrong slot and poison a later neighbor ctx read */
static void set_coef_ctx(Ctx *t, int plane, int x4, int y4, int w4, int h4,
                         int cul, int dc_cat) {
    const TileParams *p = t->p;
    int nc = plane ? (p->mi_cols + p->ssx) >> p->ssx : p->mi_cols;
    int nr = plane ? (p->mi_rows + p->ssy) >> p->ssy : p->mi_rows;
    for (int i = 0; i < w4 && x4 + i < nc; i++) {
        t->a_lvl[plane][x4 + i] = cul;
        t->a_sign[plane][x4 + i] = dc_cat;
    }
    for (int i = 0; i < h4 && y4 + i < nr; i++) {
        t->l_lvl[plane][y4 + i] = cul;
        t->l_sign[plane][y4 + i] = dc_cat;
    }
}

static int txb_skip_ctx(Ctx *t, int plane, int x4, int y4, int tx_size,
                        int bsize) {
    const TileParams *p = t->p;
    int tw4 = av1_tx_w4[tx_size], th4 = av1_tx_h4[tx_size];
    if (plane == 0) {
        int bw4 = av1_block_w4[bsize], bh4 = av1_block_h4[bsize];
        if (tw4 == bw4 && th4 == bh4) return 0;
        int top = 0, left = 0;
        for (int i = 0; i < tw4 && x4 + i < p->mi_cols; i++)
            top |= t->a_lvl[0][x4 + i];
        for (int i = 0; i < th4 && y4 + i < p->mi_rows; i++)
            left |= t->l_lvl[0][y4 + i];
        top &= 63;
        left &= 63;
        int mx = imin(top | left, 4);
        int mn = imin(imin(top, left), 4);
        static const int8_t TAB[5][5] = {
            {1, 2, 2, 2, 3}, {1, 4, 4, 4, 5}, {1, 4, 4, 4, 5},
            {1, 4, 4, 4, 5}, {1, 4, 4, 4, 6}};
        return TAB[mn][mx];
    }
    int above = 0, left_nz = 0;
    for (int i = 0; i < tw4; i++)
        if (x4 + i < p->mi_cols && t->a_lvl[plane][x4 + i]) above = 1;
    for (int i = 0; i < th4; i++)
        if (y4 + i < p->mi_rows && t->l_lvl[plane][y4 + i]) left_nz = 1;
    int bw4 = imax(1, av1_block_w4[bsize] >> p->ssx);
    int bh4 = imax(1, av1_block_h4[bsize] >> p->ssy);
    /* libaom av1_get_txb_ctx: offset 10 when the chroma plane block is
     * LARGER than the tx (multi-tx chroma, e.g. lossless >=16x16) */
    int ctx = (bw4 * bh4 > tw4 * th4 ? 10 : 7) + above + left_nz;
    return ctx;
}

static int dc_sign_ctx(Ctx *t, int plane, int x4, int y4, int w4, int h4) {
    const TileParams *p = t->p;
    int total = 0;
    for (int i = 0; i < w4; i++) {
        if (x4 + i >= p->mi_cols) continue;
        int s = t->a_sign[plane][x4 + i];
        total += s == 1 ? 1 : (s == 2 ? -1 : 0);
    }
    for (int i = 0; i < h4; i++) {
        if (y4 + i >= p->mi_rows) continue;
        int s = t->l_sign[plane][y4 + i];
        total += s == 1 ? 1 : (s == 2 ? -1 : 0);
    }
    if (total == 0) return 0;
    return total < 0 ? 1 : 2;
}

static uint16_t *eob_row(Ctx *t, int area, int ptype, int cls2d, int *len) {
    CdfState *c = &t->cdf;
    switch (area) {
    case 16: *len = 6; return c->eob_multi16[ptype][cls2d];
    case 32: *len = 7; return c->eob_multi32[ptype][cls2d];
    case 64: *len = 8; return c->eob_multi64[ptype][cls2d];
    case 128: *len = 9; return c->eob_multi128[ptype][cls2d];
    case 256: *len = 10; return c->eob_multi256[ptype][cls2d];
    case 512: *len = 11; return c->eob_multi512[ptype][cls2d];
    default: *len = 12; return c->eob_multi1024[ptype][cls2d];
    }
}

static int read_eob(Ctx *t, int tx_size, int ptype, int cls) {
    int adj = av1_adj_tx[tx_size];
    int area = av1_tx_w[adj] * av1_tx_h[adj];
    int cls2d = cls == 0 ? 0 : 1;
    int len;
    uint16_t *row = eob_row(t, area, ptype, cls2d, &len);
    int eob_pt = msac_symbol(&t->msac, row, len - 1) + 1;
    if (eob_pt < 3) return eob_pt;
    int eob_shift = eob_pt - 2;
    int eob = (1 << (eob_pt - 2)) + 1;
    int tx_ctx = (av1_tx_sqr[tx_size] + av1_tx_sqr_up[tx_size] + 1) >> 1; /* get_txsize_entropy_ctx */
    int bit = msac_symbol(&t->msac,
                          t->cdf.eob_extra[tx_ctx][ptype][eob_pt - 3], 2);
    if (bit) eob += 1 << (eob_shift - 1);
    for (int i = 1; i < eob_shift; i++)
        if (msac_bool_equi(&t->msac)) eob += 1 << (eob_shift - 1 - i);
    return eob;
}

/* tile.py _uv_tx_size; lossless forces 4x4 on every plane */
static int uv_tx_size_for(const TileParams *p, int bsize) {
    if (p->coded_lossless) return TX_4X4;
    int w4 = imax(1, av1_block_w4[bsize] >> p->ssx);
    int h4 = imax(1, av1_block_h4[bsize] >> p->ssy);
    for (int b = 0; b < 22; b++) {
        if (av1_block_w4[b] == w4 && av1_block_h4[b] == h4) {
            int tx = av1_max_tx_rect[b];
            while (av1_tx_w[tx] > 32 || av1_tx_h[tx] > 32)
                tx = av1_split_tx[tx];
            return tx;
        }
    }
    return TX_4X4;
}

static int uv_tx_type_for(Ctx *t, int tx_size, int uv_mode) {
    if (t->p->coded_lossless) return DCT_DCT;
    int mode = uv_mode == UV_CFL ? DC_PRED : uv_mode;
    int set = get_tx_set_intra(tx_size, t->p->reduced_tx_set);
    int tt = av1_intra_mode_to_tx[mode];
    if (set == 0) return DCT_DCT;
    const int8_t *lst = set == 1 ? av1_tx_set_intra_1 : av1_tx_set_intra_2;
    int n = set == 1 ? 7 : 5;
    for (int i = 0; i < n; i++) if (lst[i] == tt) return tt;
    return DCT_DCT;
}

static int read_tx_type(Ctx *t, int tx_size, int y_mode, int filter_intra) {
    if (t->p->coded_lossless) return DCT_DCT;
    int set = get_tx_set_intra(tx_size, t->p->reduced_tx_set);
    if (set == 0) return DCT_DCT;
    static const int FI_TO_DIR[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED,
                                     DC_PRED};
    int intra_dir = filter_intra >= 0 ? FI_TO_DIR[filter_intra] : y_mode;
    int sq = av1_tx_sqr[tx_size];
    if (set == 1) {
        int sym = msac_ragged(&t->msac, t->cdf.intra_ext_tx_set1[sq][intra_dir],
                              17, 7);
        return av1_tx_set_intra_1[sym];
    }
    int sym = msac_ragged(&t->msac, t->cdf.intra_ext_tx_set2[sq][intra_dir], 17, 5);
    return av1_tx_set_intra_2[sym];
}

/* tables.py get_tx_set_inter (spec get_ext_tx_set) */
static int get_tx_set_inter(int tx_size, int reduced) {
    int sqr_up = av1_tx_sqr_up[tx_size];
    if (sqr_up > TX_32X32) return 0;
    if (sqr_up == TX_32X32) return 3;
    if (reduced) return 3;
    if (av1_tx_sqr[tx_size] == TX_16X16) return 2;
    return 1;
}

/* tile.py _read_tx_type inter arm */
static int read_tx_type_inter(Ctx *t, int tx_size) {
    if (t->p->coded_lossless) return DCT_DCT;
    int set = get_tx_set_inter(tx_size, t->p->reduced_tx_set);
    if (set == 0) return DCT_DCT;
    int sq = av1_tx_sqr[tx_size];
    if (set == 1)
        return av1_tx_set_inter_1[msac_ragged(
            &t->msac, t->cdf.inter_ext_tx_set1[sq], 17, 16)];
    if (set == 2)
        return av1_tx_set_inter_2[msac_ragged(
            &t->msac, t->cdf.inter_ext_tx_set2[sq], 17, 12)];
    return av1_tx_set_inter_3[msac_ragged(
        &t->msac, t->cdf.inter_ext_tx_set3[sq], 17, 2)];
}

/* tile.py _uv_tx_type inter arm: co-located luma type clamped by set */
static int uv_tx_type_inter(Ctx *t, int tx_size, int blk_r, int blk_c) {
    if (t->p->coded_lossless) return DCT_DCT;
    int tt = t->tx_types[(int64_t)blk_r * t->p->mi_cols + blk_c];
    int set = get_tx_set_inter(tx_size, t->p->reduced_tx_set);
    if (set == 0) return DCT_DCT;
    const int8_t *lst;
    int n;
    if (set == 1) { lst = av1_tx_set_inter_1; n = 16; }
    else if (set == 2) { lst = av1_tx_set_inter_2; n = 12; }
    else { lst = av1_tx_set_inter_3; n = 2; }
    for (int i = 0; i < n; i++)
        if (lst[i] == tt) return tt;
    return DCT_DCT;
}

/* ------------------------------------------------------------------ */

static void transform_block(Ctx *t, int plane, int x, int y, int tx_size,
                            int bsize, int y_mode, int uv_mode,
                            int filter_intra, int is_inter, int blk_r,
                            int blk_c) {
    const TileParams *p = t->p;
    TileOut *o = t->o;
    int adj = av1_adj_tx[tx_size];
    int tw = av1_tx_w[adj], th = av1_tx_h[adj];
    int full_w = av1_tx_w[tx_size], full_h = av1_tx_h[tx_size];
    int x4 = x >> 2, y4 = y >> 2;
    int ptype = plane ? 1 : 0;
    int tx_ctx = (av1_tx_sqr[tx_size] + av1_tx_sqr_up[tx_size] + 1) >> 1; /* get_txsize_entropy_ctx */

    if (o->n_lf >= o->max_lf) { o->error = 1; return; }
    int32_t *lf = o->lf_txs + o->n_lf * 4;
    lf[0] = plane; lf[1] = x; lf[2] = y; lf[3] = tx_size;
    o->n_lf++;

    int ctx = txb_skip_ctx(t, plane, x4, y4, tx_size, bsize);
    int all_zero = msac_bool_adapt(&t->msac, t->cdf.txb_skip[tx_ctx][ctx]);
    int w4 = full_w >> 2, h4 = full_h >> 2;
    if (all_zero) {
        set_coef_ctx(t, plane, x4, y4, w4, h4, 0, 0);
        return;
    }

    int tx_type;
    if (plane == 0) {
        tx_type = is_inter ? read_tx_type_inter(t, tx_size)
                           : read_tx_type(t, tx_size, y_mode, filter_intra);
        int tw4g = imin(av1_tx_w4[tx_size], p->mi_cols - x4);
        int th4g = imin(av1_tx_h4[tx_size], p->mi_rows - y4);
        for (int i = 0; i < th4g; i++)
            for (int j = 0; j < tw4g; j++)
                t->tx_types[(int64_t)(y4 + i) * p->mi_cols + (x4 + j)] =
                    (int8_t)tx_type;
    } else {
        tx_type = is_inter ? uv_tx_type_inter(t, tx_size, blk_r, blk_c)
                           : uv_tx_type_for(t, tx_size, uv_mode);
    }
    int cls = av1_tx_type_class[tx_type];
    const int16_t *scan = av1_scans[tx_size][cls];

    int eob = read_eob(t, tx_size, ptype, cls);
    tl_count(11, (uint64_t)eob);
    tl_count(12, 1);

    int bwl = floor_log2((uint32_t)tw);
    int stride = tw + 4;
    /* clamped uint8 level map with 4 rows/cols of zero slack so the
     * neighbour context reads need no bounds checks; exact levels go
     * to the nzbuf pair list for the dequant pass */
    uint8_t lvl[(32 + 4) * (32 + 4)];
    memset(lvl, 0, (size_t)stride * (th + 4));
    /* nonzero (pos, level) pairs, written back-to-front by the
       reverse-scan level pass so the sign/dequant pass reads them in
       forward scan order without re-walking the zero positions
       (pos <= 1023 in 10 bits, pre-golomb level <= 15 above) */
    uint16_t nzbuf[32 * 32];
    int nztail = eob;
    const int8_t *base_offsets = av1_base_ctx_offsets[tx_size];

#define MSAC_SYM3(cdfrow) msac_sym4_scalar(MS, cdfrow, 3)
#define MSAC_SYM4(cdfrow) msac_sym4_scalar(MS, cdfrow, 4)
    uint16_t (*cb_rows)[5] = t->cdf.coeff_base[tx_ctx][ptype];
    int br_tx = imin(tx_ctx, TX_32X32);
    uint16_t (*br_rows)[5] = t->cdf.coeff_br[br_tx][ptype];
    /* register-resident entropy state across the whole coefficient +
       sign/dequant stretch: a local Msac copy lets the compiler keep
       dif/rng/cnt/buf_pos in registers instead of reloading the
       struct around every cdf store (~2M symbols per dense frame) */
    Msac mloc = t->msac;
#define MS (&mloc)
    uint64_t lv0 = tl_tick();
    for (int ci = eob - 1; ci >= 0; ci--) {
        int pos = scan[ci];
        int level;
        if (ci == eob - 1) {
            int c2 = coeff_base_eob_ctx(ci, tw, th);
            level = MSAC_SYM3(
                t->cdf.coeff_base_eob[tx_ctx][ptype][c2]) + 1;
        } else {
            int bctx = coeff_base_ctx(lvl, pos, bwl, stride, cls,
                                      base_offsets);
            level = MSAC_SYM4(cb_rows[bctx]);
            tl_count(16, 1);
        }
        if (level > 2) {
            int brctx = coeff_br_ctx(lvl, pos, bwl, stride, cls);
            for (int it = 0; it < 4; it++) {
                int k = MSAC_SYM4(br_rows[brctx]);
                tl_count(17, 1);
                level += k;
                if (k < 3) break;
            }
        }
        lvl[(pos >> bwl) * stride + (pos & (tw - 1))] =
            (uint8_t)(level < 255 ? level : 255);
        if (level)
            nzbuf[--nztail] = (uint16_t)(pos | (level << 10));
    }
    tl_add(20, lv0);
#undef MSAC_SYM3
#undef MSAC_SYM4

    /* signs + dequant (spec §7.13.3: dqDenom by square-up size, result
       clipped to the signed (bitdepth+8)-bit range) */
    int qidx = t->cur_qindex;
    int dqd, dqa;
    if (plane == 0) {
        dqd = dc_q(qidx + p->dq_y_dc, p->bitdepth);
        dqa = ac_q(qidx, p->bitdepth);
    } else if (plane == 1) {
        dqd = dc_q(qidx + p->dq_u_dc, p->bitdepth);
        dqa = ac_q(qidx + p->dq_u_ac, p->bitdepth);
    } else {
        dqd = dc_q(qidx + p->dq_v_dc, p->bitdepth);
        dqa = ac_q(qidx + p->dq_v_ac, p->bitdepth);
    }
    int pels = full_w * full_h;  /* libaom av1_get_tx_scale: by area */
    int shift = (pels > 256) + (pels > 1024);
    int64_t lim = 1ll << (p->bitdepth + 7);

    if (o->n_txs >= o->max_txs ||
        o->coeffs_used + tw * th > o->coeffs_cap) {
        t->msac = mloc;
        o->error = 1;
        return;
    }
    int32_t *co = o->coeffs + o->coeffs_used;
    memset(co, 0, sizeof(int32_t) * (size_t)(tw * th));

    int culp = 0, dc_cat = 0;
    int maxr = 0, maxc = 0;   /* nonzero-coefficient bounding box */
    uint64_t sg0 = tl_tick();
    for (int k = nztail; k < eob; k++) {
        int pos = nzbuf[k] & 1023;
        int level = nzbuf[k] >> 10;
        int pr_ = pos >> bwl, pc_ = pos & (tw - 1);
        if (pr_ > maxr) maxr = pr_;
        if (pc_ > maxc) maxc = pc_;
        int sign;
        if (pos == 0) {
            int sctx = dc_sign_ctx(t, plane, x4, y4, w4, h4);
            sign = msac_bool_adapt(MS, t->cdf.dc_sign[ptype][sctx]);
        } else {
            sign = msac_bool_equi(MS);
            tl_count(18, 1);
        }
        if (level == 15) { level += msac_golomb(MS); tl_count(19, 1); }
        int64_t v = ((int64_t)level * (pos == 0 ? dqd : dqa)) & 0xFFFFFF;
        v >>= shift;
        co[pos] = (int32_t)(sign ? -(v < lim ? v : lim)
                                 : (v < lim - 1 ? v : lim - 1));
        if (pos == 0) dc_cat = sign ? 2 : 1;
        culp += level;
    }
    tl_add(21, sg0);
    t->msac = mloc;
#undef MS
    culp = imin(culp, 63);
    set_coef_ctx(t, plane, x4, y4, w4, h4, culp, dc_cat);

    int32_t *rec = o->txs + o->n_txs * 8;
    rec[0] = plane; rec[1] = x; rec[2] = y; rec[3] = tx_size;
    /* rec[5] packs eob (<=1024, bits 0-11) with the nonzero bounding
       box in the dense tw x th layout: nzh = maxr+1 (bits 12-17),
       nzw = maxc+1 (bits 18-23) — the itx uses these to skip the
       all-zero tail rows without rescanning the coefficients */
    rec[4] = tx_type;
    rec[5] = eob | ((maxr + 1) << 12) | ((maxc + 1) << 18);
    rec[6] = (int32_t)o->coeffs_used;
    rec[7] = p->coded_lossless;
    o->n_txs++;
    o->coeffs_used += tw * th;
    o->blocks[t->cur_block * BLK_FIELDS + BLK_NTX]++;
}

/* ------------------------------------------------------------------ */

static void read_deltas(Ctx *t, int bsize, int skip) {
    const TileParams *p = t->p;
    int sb = p->sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (bsize == sb && skip) return;
    if (p->delta_q_present) {
        int abs_ = msac_symbol(&t->msac, t->cdf.delta_q[0], 4);
        if (abs_ == 3) {
            int rem_bits = (int)msac_literal(&t->msac, 3) + 1;
            abs_ = (int)msac_literal(&t->msac, rem_bits)
                   + (1 << rem_bits) + 1;
        }
        if (abs_) {
            int sign = msac_bool_equi(&t->msac);
            int delta = sign ? -abs_ : abs_;
            int q = t->cur_qindex + delta * (1 << p->delta_q_res);
            t->cur_qindex = imax(1, imin(255, q));
        }
    }
    if (p->delta_lf_present) {
        int count = p->delta_lf_multi ? (p->num_planes > 1 ? 4 : 2) : 1;
        for (int i = 0; i < count; i++) {
            uint16_t *row = p->delta_lf_multi ? t->cdf.delta_lf_multi[i]
                                              : t->cdf.delta_lf[0];
            int v = msac_symbol(&t->msac, row, 4);
            if (v == 3) {
                int rem_bits = (int)msac_literal(&t->msac, 3) + 1;
                v = (int)msac_literal(&t->msac, rem_bits)
                    + (1 << rem_bits) + 1;
            }
            if (v) msac_bool_equi(&t->msac);   /* sign; lf deltas unused */
        }
    }
}

/* tile.py _txfm_split_ctx */
static int txfm_split_ctx(Ctx *t, int r, int c, int bsize, int tx_size) {
    int txw = av1_tx_w[tx_size], txh = av1_tx_h[tx_size];
    int above = r > t->p->row_start && t->a_txw[c] < txw;
    int left = c > t->p->col_start && t->l_txh[r] < txh;
    int max_rect = av1_max_tx_rect[bsize];
    int max_sq = av1_tx_sqr_up[max_rect];
    int cat = (av1_tx_sqr_up[tx_size] != max_sq && max_sq > 1 /*TX_8X8*/)
              + (5 /*TX_SIZES*/ - 1 - max_sq) * 2;
    return cat * 3 + above + left;
}

/* tile.py _var_tx_node (spec read_var_tx_size) */
static void var_tx_node(Ctx *t, int r, int c, int bsize, int xx, int yy,
                        int tx_size, int depth, int32_t (*leaves)[3],
                        int *n) {
    /* spec read_var_tx_size: nodes past the frame edge read NOTHING
     * (split subnodes of a straddling unit can land out of frame) */
    if (r + yy >= t->p->mi_rows || c + xx >= t->p->mi_cols)
        return;
    int split = 0;
    if (depth < 2 && tx_size != TX_4X4) {
        int ctx = txfm_split_ctx(t, r + yy, c + xx, bsize, tx_size);
        split = msac_symbol(&t->msac, t->cdf.txfm_partition[ctx], 2);
    }
    if (split) {
        int sub = av1_split_tx[tx_size];
        int sw = av1_tx_w4[sub], sh = av1_tx_h4[sub];
        for (int dy = 0; dy < av1_tx_h4[tx_size]; dy += sh)
            for (int dx = 0; dx < av1_tx_w4[tx_size]; dx += sw)
                var_tx_node(t, r, c, bsize, xx + dx, yy + dy, sub,
                            depth + 1, leaves, n);
    } else {
        leaves[*n][0] = xx;
        leaves[*n][1] = yy;
        leaves[*n][2] = tx_size;
        (*n)++;
        int tw4 = av1_tx_w4[tx_size], th4 = av1_tx_h4[tx_size];
        for (int i = 0; i < tw4 && c + xx + i < t->p->mi_cols; i++)
            t->a_txw[c + xx + i] = av1_tx_w[tx_size];
        for (int i = 0; i < th4 && r + yy + i < t->p->mi_rows; i++)
            t->l_txh[r + yy + i] = av1_tx_h[tx_size];
    }
}

/* ---- loop-restoration syntax (tile.py _read_lr, spec 5.11.57-58) --- */

static int msac_decode_ns(Msac *s, int n) {
    int w = floor_log2((uint32_t)n) + 1;
    int m = (1 << w) - n;
    int v = w > 1 ? (int)msac_literal(s, w - 1) : 0;
    if (v < m) return v;
    int extra = msac_bool_equi(s);
    return (v << 1) - m + extra;
}

static int msac_subexp(Msac *s, int num_syms, int k) {
    int i = 0, mk = 0;
    for (;;) {
        int b2 = i ? k + i - 1 : k;
        int a = 1 << b2;
        if (num_syms <= mk + 3 * a)
            return msac_decode_ns(s, num_syms - mk) + mk;
        if (msac_bool_equi(s)) {
            i++;
            mk += a;
        } else {
            return (int)msac_literal(s, b2) + mk;
        }
    }
}

static int inv_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
}

static int msac_signed_subexp(Msac *s, int low, int high, int r, int k) {
    int mx = high - low;
    int ref = r - low;
    int v = msac_subexp(s, mx, k);
    int out = (ref << 1) <= mx ? inv_recenter(ref, v)
                               : mx - 1 - inv_recenter(mx - 1 - ref, v);
    return out + low;
}

static const int8_t WIENER_MIN[3] = {-5, -23, -17};
static const int8_t WIENER_MAX[3] = {10, 8, 46};
static const int8_t WIENER_K[3] = {1, 2, 3};
static const int8_t WIENER_MID[3] = {3, -7, 15};
static const int8_t SGR_XQD_MIN[2] = {-96, -32};
static const int8_t SGR_XQD_MAX[2] = {31, 95};
static const int8_t SGR_XQD_MID[2] = {-32, 31};
/* per-set pass radii (lr_ref.SGR_RADII) */
static const int8_t SGR_R0[16] = {2,2,2,2,2,2,2,2,2,2,0,0,0,0,2,2};
static const int8_t SGR_R1[16] = {1,1,1,1,1,1,1,1,1,1,1,1,1,1,0,0};

enum { RESTORE_NONE = 0, RESTORE_SWITCHABLE = 1, RESTORE_WIENER = 2,
       RESTORE_SGRPROJ = 3 };

static void read_lr_unit(Ctx *t, int plane, int urow, int ucol) {
    const FrameParams *fp = t->fp;
    TileOut *o = t->o;
    Msac *ms = &t->msac;
    int frt = fp->lr_frame_type[plane];
    int rtype;
    if (frt == RESTORE_WIENER)
        rtype = msac_symbol(ms, t->cdf.wiener_restore[0], 2)
                ? RESTORE_WIENER : RESTORE_NONE;
    else if (frt == RESTORE_SGRPROJ)
        rtype = msac_symbol(ms, t->cdf.sgrproj_restore[0], 2)
                ? RESTORE_SGRPROJ : RESTORE_NONE;
    else {
        static const int8_t SW_MAP[3] = {RESTORE_NONE, RESTORE_WIENER,
                                         RESTORE_SGRPROJ};
        rtype = SW_MAP[msac_symbol(ms, t->cdf.switchable_restore[0], 3)];
    }
    if (o->n_lr_units >= o->max_lr_units) { o->error = 1; return; }
    int32_t *u = o->lr_units + o->n_lr_units * 13;
    o->n_lr_units++;
    memset(u, 0, 13 * sizeof(int32_t));
    u[0] = plane; u[1] = urow; u[2] = ucol; u[3] = rtype;
    if (rtype == RESTORE_WIENER) {
        for (int pass = 0; pass < 2; pass++) {
            int first = plane ? 1 : 0;
            for (int j = first; j < 3; j++) {
                int ref = t->lr_ref_wiener[plane][pass][j];
                int v = msac_signed_subexp(ms, WIENER_MIN[j],
                                           WIENER_MAX[j] + 1, ref,
                                           WIENER_K[j]);
                u[4 + pass * 3 + j] = v;
                t->lr_ref_wiener[plane][pass][j] = v;
            }
        }
    } else if (rtype == RESTORE_SGRPROJ) {
        int sgr_set = (int)msac_literal(ms, 4);
        u[10] = sgr_set;
        for (int i = 0; i < 2; i++) {
            int radius = i == 0 ? SGR_R0[sgr_set] : SGR_R1[sgr_set];
            int ref = t->lr_ref_sgr[plane][i];
            int v;
            if (radius) {
                v = msac_signed_subexp(ms, SGR_XQD_MIN[i],
                                       SGR_XQD_MAX[i] + 1, ref, 4);
            } else {
                v = 0;
                if (i == 1) {
                    v = 128 - t->lr_ref_sgr[plane][0];
                    if (v < SGR_XQD_MIN[i]) v = SGR_XQD_MIN[i];
                    if (v > SGR_XQD_MAX[i]) v = SGR_XQD_MAX[i];
                }
            }
            u[11 + i] = v;
            t->lr_ref_sgr[plane][i] = v;
        }
    }
}

static void read_lr(Ctx *t, int r, int c) {
    const FrameParams *fp = t->fp;
    const TileParams *p = t->p;
    if (!fp->lr_uses || p->allow_intrabc) return;
    int w4 = p->sb128 ? 32 : 16;
    for (int plane = 0; plane < p->num_planes; plane++) {
        if (fp->lr_frame_type[plane] == RESTORE_NONE) continue;
        int ssx = plane ? p->ssx : 0;
        int ssy = plane ? p->ssy : 0;
        int unit_size = fp->lr_unit_size[plane];
        int ph = (fp->frame_height + ssy) >> ssy;
        int pw = (fp->frame_width + ssx) >> ssx;
        int unit_rows = imax((ph + (unit_size >> 1)) / unit_size, 1);
        int unit_cols = imax((pw + (unit_size >> 1)) / unit_size, 1);
        int num = 4 >> ssy, den = unit_size;
        int ur0 = (r * num + den - 1) / den;
        int ur1 = imin(unit_rows, ((r + w4) * num + den - 1) / den);
        /* unit columns live in the upscaled frame: a superblock's range
           scales by SuperresDenom / SUPERRES_NUM (spec 5.11.57).  The
           JAX package's decoder counts in coded pixels, which is right
           only for one unit column. */
        num = 4 >> ssx;
        if (fp->use_superres) { num *= fp->superres_denom; den *= 8; }
        int uc0 = (c * num + den - 1) / den;
        int uc1 = imin(unit_cols, ((c + w4) * num + den - 1) / den);
        for (int urow = ur0; urow < ur1; urow++)
            for (int ucol = uc0; ucol < uc1; ucol++)
                read_lr_unit(t, plane, urow, ucol);
    }
}

/* palette + intrabc syntax (uses find_mv_stack / msac helpers) */
#include "av1_pal.h"

/* Fill n bytes at dst with the repeating 8-byte pattern pat using a
   handful of inlined (possibly overlapping) stores.  Rows here are
   1..256 bytes with n always a multiple of the pattern period, so the
   overlapping tail store stays pattern-aligned. */
static inline void mi_row_fill(void *dst, uint64_t pat, int n) {
    uint8_t *q = (uint8_t *)dst;
    if (n >= 8) {
        int i = 0;
        do { memcpy(q + i, &pat, 8); i += 8; } while (i + 8 <= n);
        if (i < n) memcpy(q + n - 8, &pat, 8);
    } else if (n >= 4) {
        uint32_t p4 = (uint32_t)pat;
        memcpy(q, &p4, 4);
        memcpy(q + n - 4, &p4, 4);
    } else if (n >= 2) {
        uint16_t p2 = (uint16_t)pat;
        memcpy(q, &p2, 2);
        memcpy(q + n - 2, &p2, 2);
    } else if (n == 1) {
        q[0] = (uint8_t)pat;
    }
}

static void decode_block(Ctx *t, int r, int c, int bsize) {
    uint64_t blk0 = tl_tick();
    tl_count(8, 1);
    const TileParams *p = t->p;
    const FrameParams *fp = t->fp;
    TileOut *o = t->o;
    int full_w4 = av1_block_w4[bsize], full_h4 = av1_block_h4[bsize];
    int w4 = imin(full_w4, p->col_end - c);
    int h4 = imin(full_h4, p->row_end - r);
    int avail_u = r > p->row_start, avail_l = c > p->col_start;

    int has_chroma = p->num_planes > 1;
    if (has_chroma) {
        if (p->ssy && full_h4 == 1 && (r & 1) == 0) has_chroma = 0;
        if (p->ssx && full_w4 == 1 && (c & 1) == 0) has_chroma = 0;
    }

    /* skip mode (spec read_skip_mode), then skip */
    t->skip_mode_flag = 0;
    if (!fp->frame_is_intra && fp->skip_mode_present && full_w4 * 4 >= 8
        && full_h4 * 4 >= 8) {
        int sm_ctx = 0;
        if (avail_u) sm_ctx += t->a_skipmode[c];
        if (avail_l) sm_ctx += t->l_skipmode[r];
        t->skip_mode_flag = msac_symbol(&t->msac,
                                        t->cdf.skip_mode[sm_ctx], 2);
    }
    int skip;
    if (t->skip_mode_flag) {
        skip = 1;
    } else {
        int skip_ctx = (avail_u ? t->a_skip[c] : 0)
                     + (avail_l ? t->l_skip[r] : 0);
        skip = msac_symbol(&t->msac, t->cdf.skip[skip_ctx], 2);
    }

    /* cdef idx: one literal per 64x64 unit at the first non-skip block */
    if (!skip && p->enable_cdef && !p->coded_lossless && !p->allow_intrabc) {
        /* spec read_cdef: ONE literal at the block's anchor 64x64 unit,
         * copied to every unit the block covers (a 128px block reads a
         * single cdef_idx, not four) */
        int ucols = (p->mi_cols + 15) / 16;
        int ar = r & ~15, ac = c & ~15;
        int8_t *anchor = &o->cdef_idx[(ar / 16) * ucols + (ac / 16)];
        if (*anchor == -1) {
            int v = msac_literal(&t->msac, p->cdef_bits);
            for (int rr = ar; rr < r + full_h4; rr += 16)
                for (int cc = ac; cc < c + full_w4; cc += 16)
                    o->cdef_idx[(rr / 16) * ucols + (cc / 16)] =
                        (int8_t)v;
        }
    }

    if (t->read_deltas) read_deltas(t, bsize, skip);
    t->read_deltas = 0;

    /* is_inter (spec read_is_inter) / intra block copy */
    int is_inter = 0;
    int use_intrabc = 0;
    if (fp->frame_is_intra) {
        if (p->allow_intrabc)
            use_intrabc = msac_symbol(&t->msac, t->cdf.intrabc[0], 2);
    } else {
        if (t->skip_mode_flag) {
            is_inter = 1;
        } else {
            int ctx;
            if (avail_u && avail_l) {
                int ai = REF0_AT(t, r - 1, c) == INTRA_FRAME;
                int li = REF0_AT(t, r, c - 1) == INTRA_FRAME;
                ctx = (ai && li) ? 3 : (ai || li);
            } else if (avail_u || avail_l) {
                int ni = avail_u ? REF0_AT(t, r - 1, c) == INTRA_FRAME
                                 : REF0_AT(t, r, c - 1) == INTRA_FRAME;
                ctx = 2 * ni;
            } else {
                ctx = 0;
            }
            is_inter = msac_symbol(&t->msac, t->cdf.intra_inter[ctx], 2);
        }
    }

    int y_mode = DC_PRED;
    int angle_y = 0;
    InterInfo ii;
    memset(&ii, 0, sizeof(ii));
    ii.compound_idx = 1;
    ii.ii_mode = -1;
    ii.rf[0] = INTRA_FRAME;
    ii.rf[1] = NONE_FRAME;
    ii.interp[0] = ii.interp[1] = FILTER_EIGHTTAP;

    if (use_intrabc) {
        /* intra block copy (spec 5.11.19): DC modes, BILINEAR filter,
           DV from the INTRA_FRAME mv stack at forced integer precision */
        is_inter = 1;
        ii.mode = NEWMV;
        ii.interp[0] = ii.interp[1] = FILTER_BILINEAR;
        read_intrabc_dv(t, r, c, bsize, ii.mv);
    } else if (is_inter) {
        uint64_t im0 = tl_tick();
        inter_mode_info(t, r, c, bsize, avail_u, avail_l, &ii);
        tl_add(1, im0);
        tl_count(9, 1);
    } else if (fp->frame_is_intra) {
        int above_mode = avail_u ? t->a_mode[c] : DC_PRED;
        int left_mode = avail_l ? t->l_mode[r] : DC_PRED;
        y_mode = msac_symbol(
            &t->msac,
            t->cdf.kf_y_mode[av1_intra_mode_ctx[above_mode]]
                            [av1_intra_mode_ctx[left_mode]], 13);
    } else {
        y_mode = msac_symbol(&t->msac,
                             t->cdf.y_mode[av1_size_group[bsize]], 13);
    }
    if (!is_inter && bsize >= BLOCK_8X8 && y_mode >= V_PRED
        && y_mode <= D67_PRED)
        angle_y = msac_symbol(&t->msac, t->cdf.angle_delta[y_mode - V_PRED],
                              7) - 3;

    int uv_mode = DC_PRED, angle_uv = 0;
    int cfl_u = 0, cfl_v = 0;
    if (!is_inter && has_chroma) {
        /* lossless: CfL only when the chroma plane block is 4x4
         * (libaom is_cfl_allowed; spec get_plane_residual_size) */
        int cfl_allowed = t->p->coded_lossless
            ? (imax(1, full_w4 >> t->p->ssx) == 1 &&
               imax(1, full_h4 >> t->p->ssy) == 1)
            : (full_w4 * 4 <= 32 && full_h4 * 4 <= 32);
        int nsym = cfl_allowed ? 14 : 13;
        uv_mode = msac_ragged(&t->msac,
                              t->cdf.uv_mode[cfl_allowed ? 1 : 0][y_mode],
                              15, nsym);
        if (uv_mode == UV_CFL) {
            /* joint sign: 8 symbols = 3*3-1; ZERO=0 NEG=1 POS=2 */
            int joint = msac_symbol(&t->msac, t->cdf.cfl_sign[0], 8);
            int su = (joint + 1) / 3, sv = (joint + 1) % 3;
            if (su) {
                int idx = msac_symbol(&t->msac,
                    t->cdf.cfl_alpha[(su == 2 ? 3 : 0) + sv], 16) + 1;
                cfl_u = su == 1 ? -idx : idx;
            }
            if (sv) {
                int idx = msac_symbol(&t->msac,
                    t->cdf.cfl_alpha[(sv == 2 ? 3 : 0) + su], 16) + 1;
                cfl_v = sv == 1 ? -idx : idx;
            }
        }
        if (bsize >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
            angle_uv = msac_symbol(&t->msac,
                                   t->cdf.angle_delta[uv_mode - V_PRED],
                                   7) - 3;
    }

    /* palette (spec palette_mode_info, dav1d read_pal_plane/uv) */
    int32_t pal_y[8], pal_cb[8], pal_cr[8];
    int n_pal_y = 0, n_pal_uv = 0;
    if (!is_inter && p->allow_screen && bsize >= BLOCK_8X8
        && full_w4 * 4 <= 64 && full_h4 * 4 <= 64) {
        int sz_ctx = mi_wlog2(bsize) + mi_hlog2(bsize) - 2;
        if (y_mode == DC_PRED) {
            int pctx = (t->a_pal_sz[0][c] > 0) + (t->l_pal_sz[0][r] > 0);
            if (msac_symbol(&t->msac,
                            t->cdf.palette_y_mode[sz_ctx][pctx], 2)) {
                n_pal_y = msac_symbol(&t->msac,
                                      t->cdf.palette_y_size[sz_ctx],
                                      7) + 2;
                read_palette_colors(t, 0, r, c, n_pal_y, pal_y);
            }
        }
        if (has_chroma && uv_mode == DC_PRED) {
            int pctx = n_pal_y > 0;
            if (msac_symbol(&t->msac, t->cdf.palette_uv_mode[pctx], 2)) {
                n_pal_uv = msac_symbol(&t->msac,
                                       t->cdf.palette_uv_size[sz_ctx],
                                       7) + 2;
                read_palette_colors(t, 1, r, c, n_pal_uv, pal_cb);
                read_palette_cr(t, n_pal_uv, pal_cr);
            }
        }
    }

    int filter_intra = -1;
    if (!is_inter && p->enable_filter_intra && y_mode == DC_PRED
        && n_pal_y == 0
        && full_w4 * 4 <= 32 && full_h4 * 4 <= 32) {
        int use = msac_symbol(&t->msac, t->cdf.filter_intra_use[bsize], 2);
        if (use)
            filter_intra = msac_symbol(&t->msac,
                                       t->cdf.filter_intra_mode[0], 5);
    }

    /* palette index maps (spec: right after mode info) */
    int pal_idx = 0;
    if (n_pal_y || n_pal_uv) {
        if (o->n_pal_units >= o->max_pal_units) { o->error = 1; return; }
        int32_t *u = o->pal_units + o->n_pal_units * 32;
        pal_idx = (int)++o->n_pal_units;
        memset(u, 0, 32 * sizeof(int32_t));
        int on_w4 = imin(full_w4, p->mi_cols - c);
        int on_h4 = imin(full_h4, p->mi_rows - r);
        u[0] = n_pal_y;
        u[1] = n_pal_uv;
        for (int k = 0; k < n_pal_y; k++) u[8 + k] = pal_y[k];
        for (int k = 0; k < n_pal_uv; k++) {
            u[16 + k] = pal_cb[k];
            u[24 + k] = pal_cr[k];
        }
        if (n_pal_y) {
            int mw = on_w4 * 4, mh = on_h4 * 4;
            if (o->pal_maps_used + mw * mh > o->pal_maps_cap) {
                o->error = 1;
                return;
            }
            u[2] = (int32_t)o->pal_maps_used;
            u[4] = mw;
            u[5] = mh;
            read_palette_map(t, n_pal_y, mw, mh, 0,
                             o->pal_maps + o->pal_maps_used);
            o->pal_maps_used += mw * mh;
        }
        if (n_pal_uv) {
            int cw4 = imax(1, (on_w4 + p->ssx) >> p->ssx);
            int ch4 = imax(1, (on_h4 + p->ssy) >> p->ssy);
            int mw = cw4 * 4, mh = ch4 * 4;
            if (o->pal_maps_used + mw * mh > o->pal_maps_cap) {
                o->error = 1;
                return;
            }
            u[3] = (int32_t)o->pal_maps_used;
            u[6] = mw;
            u[7] = mh;
            read_palette_map(t, n_pal_uv, mw, mh, 1,
                             o->pal_maps + o->pal_maps_used);
            o->pal_maps_used += mw * mh;
        }
    }

    /* block_mode for the modes grid: y_mode for intra, inter mode else */
    int block_mode = is_inter ? ii.mode : y_mode;

    /* mi grids (written before residual; clipped at the tile edge).
       All fields are constant across the block, so fill per-array rows
       (memset / wide pattern stores) instead of 18 interleaved byte
       stores per cell — the cell loop was ~9.5k cycles per block */
    uint64_t gr0 = tl_tick();
    {
        uint64_t mv_pat;
        {
            uint16_t q[4] = {(uint16_t)(int16_t)ii.mv[0],
                             (uint16_t)(int16_t)ii.mv[1],
                             (uint16_t)(int16_t)ii.mv2[0],
                             (uint16_t)(int16_t)ii.mv2[1]};
            memcpy(&mv_pat, q, 8);
        }
        uint16_t mode_pat = (uint16_t)(int16_t)block_mode;
        uint16_t interp_pat;
        {
            uint8_t q[2] = {(uint8_t)(int8_t)ii.interp[0],
                            (uint8_t)(int8_t)ii.interp[1]};
            memcpy(&interp_pat, q, 2);
        }
        /* array-major fill with inline overlap stores: rows are tiny
           (1-32 cells), so libc memset's per-call dispatch dominated —
           mi_row_fill is a handful of inlined 8-byte stores instead */
        int64_t at0 = (int64_t)r * p->mi_cols + c;
        int64_t stride = p->mi_cols;
#define MI_FILL8(arr, val) do {                                        \
            uint64_t p8_ = 0x0101010101010101ull * (uint8_t)(val);     \
            uint8_t *q_ = (uint8_t *)(arr) + at0;                      \
            for (int i_ = 0; i_ < h4; i_++, q_ += stride)              \
                mi_row_fill(q_, p8_, w4);                              \
        } while (0)
        /* inter blocks carry y_mode == uv_mode == DC_PRED (0), and the
           plan grids arrive zero-allocated per frame — skipping the
           fill leaves the correct value while keeping those pages
           untouched (their only reader is filter_type's smooth-mode
           probe) */
        if (!is_inter) {
            MI_FILL8(o->y_mode, (int8_t)y_mode);
            MI_FILL8(o->uv_mode, (int8_t)uv_mode);
        }
        /* angle grids have no C readers (recon takes angles from the
           block records); filled only for the Python plan export */
        if (p->fill_aux) {
            MI_FILL8(o->angle_y, (int8_t)angle_y);
            MI_FILL8(o->angle_uv, (int8_t)angle_uv);
        }
        MI_FILL8(o->skip, skip);
        MI_FILL8(o->bsize, bsize);
        /* intrabc grid is read only under rf[0]==INTRA_FRAME mv
           prediction, which requires allow_intrabc */
        if (p->allow_intrabc)
            MI_FILL8(o->intrabc_g, use_intrabc);
        MI_FILL8(t->decoded_mi, 1);
        /* The five mv-prediction grids (ref0/ref1/mvs/modes/interp)
           are only ever read at
             - the bottom <=6 rows / right <=6 cols of a block (the
               mv-ref scans reach delta -5 plus the odd-start +1
               adjust; OBMC/warp-sample/sub-8x8-chroma probes stay at
               -1), and
             - odd/odd global mi coordinates (av1_save_tmvs samples
               (2r+1, 2c+1); the clamped frame-edge samples land on
               the last row/col, which the bottom/right band covers).
           For large blocks the interior even cells are dead stores,
           so fill the bottom/right 8-deep bands (margin 2 over the
           worst-case reach) + the odd/odd interior only.  bsize /
           skip / decoded_mi stay dense (partition, coef-ctx and
           availability walk arbitrary cells), and the Python plan
           export (fill_aux) keeps dense grids.  Cuts the mi-grid
           fill volume ~40% on 128px-partition (static/4K) content. */
        int sp_rows = h4 - 8, sp_cols = w4 - 8;
        int sparse = !p->fill_aux && sp_rows > 0 && sp_cols > 0;
#define MI_FILLG(arr, val) do {                                        \
            uint64_t p8_ = 0x0101010101010101ull * (uint8_t)(val);     \
            uint8_t *q_ = (uint8_t *)(arr) + at0;                      \
            for (int i_ = 0; i_ < h4; i_++, q_ += stride) {            \
                if (!sparse || i_ >= sp_rows) {                        \
                    mi_row_fill(q_, p8_, w4);                          \
                } else {                                               \
                    mi_row_fill(q_ + sp_cols, p8_, 8);                 \
                    if ((r + i_) & 1)                                  \
                        for (int j_ = 1 - (c & 1); j_ < sp_cols;       \
                             j_ += 2)                                  \
                            q_[j_] = (uint8_t)(val);                   \
                }                                                      \
            }                                                          \
        } while (0)
        MI_FILLG(o->ref0_g, (int8_t)ii.rf[0]);
        MI_FILLG(o->ref1_g, (int8_t)ii.rf[1]);
#undef MI_FILLG
#undef MI_FILL8
#define MI_FILLW(base, esz, pat) do {                                  \
            char *q = (char *)(base);                                  \
            int64_t bs = stride * (esz);                               \
            for (int i = 0; i < h4; i++, q += bs) {                    \
                if (!sparse || i >= sp_rows) {                         \
                    mi_row_fill(q, pat, w4 * (esz));                   \
                } else {                                               \
                    mi_row_fill(q + sp_cols * (esz), pat, 8 * (esz));  \
                    if ((r + i) & 1)                                   \
                        for (int j = 1 - (c & 1); j < sp_cols; j += 2) \
                            memcpy(q + (int64_t)j * (esz), &(pat),     \
                                   (esz));                             \
                }                                                      \
            }                                                          \
        } while (0)
        MI_FILLW(o->mvs_g + at0 * 4, 8, mv_pat);
        {
            uint64_t md_pat = 0x0001000100010001ull * mode_pat;
            MI_FILLW(o->modes_g + at0, 2, md_pat);
        }
        {
            uint64_t ip_pat = 0x0001000100010001ull * interp_pat;
            MI_FILLW(o->interp_g + at0 * 2, 2, ip_pat);
        }
#undef MI_FILLW
    }

    tl_add(3, gr0);
    uint64_t tp0 = tl_tick();
    int tx_size = av1_max_tx_rect[bsize];
    int uv_tx = has_chroma ? uv_tx_size_for(p, bsize) : 0;
    int32_t leaves[1024][3];
    int n_leaves = 0;

    if (!is_inter) {
        /* tx size (depth symbol coded even for intra skip blocks) */
        if (p->coded_lossless) {
            tx_size = TX_4X4;
        } else if (bsize == BLOCK_4X4) {
            tx_size = TX_4X4;
        } else if (p->tx_mode == 2) {
            int maxd = max_tx_depth(bsize);
            int cat = imax(0, imin(av1_tx_sqr_up[tx_size] - 1, 3));
            int max_tx_w = av1_tx_w[tx_size];
            int max_tx_h = av1_tx_h[tx_size];
            int above = t->a_txw[c] >= max_tx_w;
            int left = t->l_txh[r] >= max_tx_h;
            /* libaom get_tx_size_context: INTER neighbors contribute
               their BLOCK dims, not their published leaf-tx dims */
            if (avail_u && REF0_AT(t, r - 1, c) > INTRA_FRAME)
                above = av1_block_w4[BSIZE_AT(t, r - 1, c)] * 4
                        >= max_tx_w;
            if (avail_l && REF0_AT(t, r, c - 1) > INTRA_FRAME)
                left = av1_block_h4[BSIZE_AT(t, r, c - 1)] * 4
                       >= max_tx_h;
            int actx = above + left;
            int nsym = imin(maxd, 2) + 1;
            int depth = msac_ragged(&t->msac, t->cdf.tx_size[cat][actx],
                                    4, cat == 0 ? 2 : nsym);
            for (int i = 0; i < depth; i++)
                tx_size = av1_split_tx[tx_size];
        }
    } else {
        if (p->coded_lossless) tx_size = TX_4X4;
        if (skip || p->tx_mode != 2 || p->coded_lossless) {
            /* uniform max tx over the clipped extent */
            int sw = av1_tx_w4[tx_size], sh = av1_tx_h4[tx_size];
            for (int yy = 0; yy < h4; yy += sh)
                for (int xx = 0; xx < w4; xx += sw) {
                    leaves[n_leaves][0] = xx;
                    leaves[n_leaves][1] = yy;
                    leaves[n_leaves][2] = tx_size;
                    n_leaves++;
                }
            if (skip) {
                /* skipped inter blocks publish BLOCK dims to the
                   txfm-split contexts (libaom set_txfm_ctxs) */
                for (int i = 0; i < w4; i++)
                    t->a_txw[c + i] = full_w4 * 4;
                for (int i = 0; i < h4; i++)
                    t->l_txh[r + i] = full_h4 * 4;
            } else {
                for (int i = 0; i < w4; i++)
                    t->a_txw[c + i] = av1_tx_w[tx_size];
                for (int i = 0; i < h4; i++)
                    t->l_txh[r + i] = av1_tx_h[tx_size];
            }
        } else {
            /* spec read_var_tx_size over max-tx units in raster order */
            int sw = av1_tx_w4[tx_size], sh = av1_tx_h4[tx_size];
            for (int yy = 0; yy < h4; yy += sh)
                for (int xx = 0; xx < w4; xx += sw)
                    var_tx_node(t, r, c, bsize, xx, yy, tx_size, 0,
                                leaves, &n_leaves);
        }
    }

    tl_add(4, tp0);
    if (o->n_blocks >= o->max_blocks) { o->error = 1; return; }
    t->cur_block = o->n_blocks;
    int32_t *b = o->blocks + o->n_blocks * BLK_FIELDS;
    b[BLK_R] = r; b[BLK_C] = c; b[BLK_BSIZE] = bsize;
    b[BLK_YMODE] = y_mode; b[BLK_UVMODE] = uv_mode;
    b[BLK_ANGLE_Y] = angle_y; b[BLK_ANGLE_UV] = angle_uv;
    b[BLK_SKIP] = skip; b[BLK_TXSZ] = tx_size; b[BLK_UVTX] = uv_tx;
    b[BLK_HASCHROMA] = has_chroma; b[BLK_CFL_U] = cfl_u;
    b[BLK_CFL_V] = cfl_v; b[BLK_FI] = filter_intra;
    b[BLK_TXOFF] = (int32_t)o->n_txs; b[BLK_NTX] = 0;
    b[BLK_IS_INTER] = is_inter;
    b[BLK_REF0] = ii.rf[0]; b[BLK_REF1] = ii.rf[1];
    b[BLK_MV_R] = ii.mv[0]; b[BLK_MV_C] = ii.mv[1];
    b[BLK_MV2_R] = ii.mv2[0]; b[BLK_MV2_C] = ii.mv2[1];
    b[BLK_MODE] = is_inter ? ii.mode : 0;
    b[BLK_REFMVIDX] = ii.ref_mv_idx;
    b[BLK_INTERP0] = ii.interp[0]; b[BLK_INTERP1] = ii.interp[1];
    b[BLK_MOTION_MODE] = ii.motion_mode;
    b[BLK_WARP_VALID] = ii.warp_valid;
    for (int k = 0; k < 6; k++) b[BLK_WM0 + k] = ii.wm[k];
    for (int k = 0; k < 4; k++) b[BLK_SH_ALPHA + k] = ii.sh[k];
    b[BLK_COMP_TYPE] = ii.comp_type; b[BLK_COMP_IDX] = ii.compound_idx;
    b[BLK_WEDGE_IDX] = ii.wedge_idx; b[BLK_WEDGE_SIGN] = ii.wedge_sign;
    b[BLK_MASK_TYPE] = ii.mask_type;
    b[BLK_II_MODE] = ii.ii_mode; b[BLK_II_WEDGE] = ii.ii_wedge;
    b[BLK_II_WEDGE_IDX] = ii.ii_wedge_idx;
    b[BLK_SKIP_MODE] = t->skip_mode_flag;
    b[BLK_PARTITION] = t->cur_partition;
    b[BLK_PAL] = pal_idx;
    b[BLK_INTRABC] = use_intrabc;
    b[BLK_FIELDS - 1] = 0;
    o->n_blocks++;

    if (!skip) {
        uint64_t rs0 = tl_tick();
        tl_count(10, 1);
        /* spec 5.11.34 residual(): blocks wider/taller than 64px are
         * split into 64x64 chunks with the planes (and var-tx leaves)
         * interleaved PER CHUNK */
        for (int cy4 = 0; cy4 < h4; cy4 += 16)
        for (int cx4 = 0; cx4 < w4; cx4 += 16) {
            int cw4 = imin(16, w4 - cx4), ch4 = imin(16, h4 - cy4);
            int rr = r + cy4, cc = c + cx4;
        if (!is_inter) {
            int n_pl = has_chroma ? p->num_planes : 1;
            for (int plane = 0; plane < n_pl; plane++) {
                int tx, px, py, pw4, ph4;
                if (plane == 0) {
                    tx = tx_size;
                    px = cc * 4; py = rr * 4;
                    pw4 = cw4; ph4 = ch4;
                } else {
                    tx = uv_tx;
                    px = (cc >> p->ssx) * 4; py = (rr >> p->ssy) * 4;
                    pw4 = imax(1, cw4 >> p->ssx);
                    ph4 = imax(1, ch4 >> p->ssy);
                }
                int sx = av1_tx_w4[tx], sy = av1_tx_h4[tx];
                for (int yy = 0; yy < ph4; yy += sy)
                    for (int xx = 0; xx < pw4; xx += sx)
                        transform_block(t, plane, px + xx * 4,
                                        py + yy * 4, tx, bsize, y_mode,
                                        uv_mode, filter_intra, 0, r, c);
            }
        } else {
            /* luma var-tx leaves inside this chunk, then its chroma */
            for (int k = 0; k < n_leaves; k++) {
                int xx = leaves[k][0], yy = leaves[k][1];
                int tx = leaves[k][2];
                if (xx < cx4 || xx >= cx4 + cw4 || yy < cy4
                    || yy >= cy4 + ch4)
                    continue;
                if (r + yy >= p->row_end || c + xx >= p->col_end)
                    continue;
                transform_block(t, 0, (c + xx) * 4, (r + yy) * 4, tx,
                                bsize, y_mode, uv_mode, filter_intra, 1,
                                r, c);
            }
            if (has_chroma && p->num_planes > 1) {
                int tx = uv_tx;
                int pw4 = imax(1, cw4 >> p->ssx);
                int ph4 = imax(1, ch4 >> p->ssy);
                int cx = (cc >> p->ssx) * 4, cy = (rr >> p->ssy) * 4;
                int sx = av1_tx_w4[tx], sy = av1_tx_h4[tx];
                for (int plane = 1; plane < 3; plane++)
                    for (int yy = 0; yy < ph4; yy += sy)
                        for (int xx = 0; xx < pw4; xx += sx)
                            transform_block(t, plane, cx + xx * 4,
                                            cy + yy * 4, tx, bsize,
                                            y_mode, uv_mode,
                                            filter_intra, 1, r, c);
            }
        }
        }
        tl_add(2, rs0);
    } else {
        /* clear coef ctx over the full (unclipped) block extent */
        set_coef_ctx(t, 0, c, r, full_w4, full_h4, 0, 0);
        if (has_chroma) {
            int cx = c >> p->ssx, cy = r >> p->ssy;
            int cw = imax(1, full_w4 >> p->ssx);
            int chh = imax(1, full_h4 >> p->ssy);
            for (int plane = 1; plane < 3; plane++)
                set_coef_ctx(t, plane, cx, cy, cw, chh, 0, 0);
        }
    }

    for (int i = 0; i < w4; i++) {
        t->a_mode[c + i] = is_inter ? DC_PRED : y_mode;
        t->a_skip[c + i] = skip;
        t->a_skipmode[c + i] = t->skip_mode_flag;
        t->a_compgrp[c + i] = ii.comp_group_idx;
        t->a_compidx[c + i] = ii.compound_idx;
        if (!is_inter) t->a_txw[c + i] = av1_tx_w[tx_size];
    }
    for (int i = 0; i < h4; i++) {
        t->l_mode[r + i] = is_inter ? DC_PRED : y_mode;
        t->l_skip[r + i] = skip;
        t->l_skipmode[r + i] = t->skip_mode_flag;
        t->l_compgrp[r + i] = ii.comp_group_idx;
        t->l_compidx[r + i] = ii.compound_idx;
        if (!is_inter) t->l_txh[r + i] = av1_tx_h[tx_size];
    }
    /* palette size/color contexts (sizes zeroed for non-palette) */
    for (int i = 0; i < w4; i++) {
        t->a_pal_sz[0][c + i] = n_pal_y;
        t->a_pal_sz[1][c + i] = n_pal_uv;
    }
    for (int i = 0; i < h4; i++) {
        t->l_pal_sz[0][r + i] = n_pal_y;
        t->l_pal_sz[1][r + i] = n_pal_uv;
    }
    if (n_pal_y)
        for (int i = 0; i < w4; i++) {
            memcpy(t->a_pal[0] + (int64_t)(c + i) * 8, pal_y,
                   8 * sizeof(int32_t));
        }
    if (n_pal_y)
        for (int i = 0; i < h4; i++)
            memcpy(t->l_pal[0] + (int64_t)(r + i) * 8, pal_y,
                   8 * sizeof(int32_t));
    if (n_pal_uv)
        for (int i = 0; i < w4; i++) {
            memcpy(t->a_pal[1] + (int64_t)(c + i) * 8, pal_cb,
                   8 * sizeof(int32_t));
            memcpy(t->a_pal[2] + (int64_t)(c + i) * 8, pal_cr,
                   8 * sizeof(int32_t));
        }
    if (n_pal_uv)
        for (int i = 0; i < h4; i++) {
            memcpy(t->l_pal[1] + (int64_t)(r + i) * 8, pal_cb,
                   8 * sizeof(int32_t));
            memcpy(t->l_pal[2] + (int64_t)(r + i) * 8, pal_cr,
                   8 * sizeof(int32_t));
        }
    tl_add(0, blk0);
}

/* edge-partition split probability (tile.py edge_split_prob) */
static int gather(const uint16_t *row, const int8_t *syms, int cnt,
                  int nsym) {
    int total = 0;
    for (int k = 0; k < cnt; k++) {
        int s = syms[k];
        int hi = s == 0 ? 32768 : row[s - 1];
        int lo = s >= nsym - 1 ? 0 : row[s];
        total += hi - lo;
    }
    return total;
}

static int edge_split_prob(const uint16_t *row, int bsize, int horz) {
    int8_t parts[4];
    int cnt = 0;
    parts[cnt++] = PART_NONE;
    parts[cnt++] = horz ? PART_HORZ : PART_VERT;
    int nsym;
    if (bsize == BLOCK_8X8) {
        nsym = 4;
    } else if (bsize == BLOCK_128X128) {
        nsym = 8;
        parts[cnt++] = horz ? PART_HORZ_B : PART_VERT_B;
    } else {
        nsym = 10;
        parts[cnt++] = horz ? PART_HORZ_B : PART_VERT_B;
        parts[cnt++] = horz ? PART_HORZ_4 : PART_VERT_4;
    }
    return 32768 - gather(row, parts, cnt, nsym);
}

/* part ctx uses the FULL block extent, clipped only at the mi array */
static void update_part_ctx(Ctx *t, int r, int c, int subsize, int bsize) {
    const TileParams *p = t->p;
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    for (int i = 0; i < w4 && c + i < p->mi_cols; i++)
        t->a_part[c + i] = av1_part_above[subsize];
    for (int i = 0; i < h4 && r + i < p->mi_rows; i++)
        t->l_part[r + i] = av1_part_left[subsize];
}

static void decode_partition(Ctx *t, int r, int c, int bsize) {
    const TileParams *p = t->p;
    if (r >= p->row_end || c >= p->col_end || t->o->error) return;
    int w4 = av1_block_w4[bsize];
    int half = w4 >> 1;
    int has_rows = (r + half) < p->row_end;
    int has_cols = (c + half) < p->col_end;
    int bsl = mi_wlog2(bsize);
    int part;

    if (bsize == BLOCK_4X4) {
        part = PART_NONE;
    } else if (has_rows && has_cols) {
        int above = (t->a_part[c] >> bsl) & 1;
        int left = (t->l_part[r] >> bsl) & 1;
        int row_idx = (bsl - 1) * 4 + left * 2 + above;
        int nsym = bsize == BLOCK_8X8 ? 4
                   : (bsize == BLOCK_128X128 ? 8 : 10);
        part = msac_ragged(&t->msac, t->cdf.partition[row_idx], 11, nsym);
    } else if (has_cols || has_rows) {
        int horz = has_cols;
        int above = (t->a_part[c] >> bsl) & 1;
        int left = (t->l_part[r] >> bsl) & 1;
        int row_idx = (bsl - 1) * 4 + left * 2 + above;
        int psplit = edge_split_prob(t->cdf.partition[row_idx], bsize, horz);
        int is_split = msac_bool(&t->msac, psplit);
        part = is_split ? PART_SPLIT : (horz ? PART_HORZ : PART_VERT);
    } else {
        part = PART_SPLIT;
    }

    t->cur_partition = part;
    int sub = bsize >= BLOCK_8X8 ? partition_subsize(part, bsize) : bsize;
    int q = half >> 1;

    switch (part) {
    case PART_NONE:
        decode_block(t, r, c, sub);
        break;
    case PART_HORZ:
        decode_block(t, r, c, sub);
        if (has_rows) decode_block(t, r + half, c, sub);
        break;
    case PART_VERT:
        decode_block(t, r, c, sub);
        if (has_cols) decode_block(t, r, c + half, sub);
        break;
    case PART_SPLIT:
        decode_partition(t, r, c, sub);
        decode_partition(t, r, c + half, sub);
        decode_partition(t, r + half, c, sub);
        decode_partition(t, r + half, c + half, sub);
        break;
    case PART_HORZ_A: {
        int sq = partition_subsize(PART_SPLIT, bsize);
        decode_block(t, r, c, sq);
        decode_block(t, r, c + half, sq);
        decode_block(t, r + half, c, sub);
        break;
    }
    case PART_HORZ_B: {
        int sq = partition_subsize(PART_SPLIT, bsize);
        decode_block(t, r, c, sub);
        decode_block(t, r + half, c, sq);
        decode_block(t, r + half, c + half, sq);
        break;
    }
    case PART_VERT_A: {
        int sq = partition_subsize(PART_SPLIT, bsize);
        decode_block(t, r, c, sq);
        decode_block(t, r + half, c, sq);
        decode_block(t, r, c + half, sub);
        break;
    }
    case PART_VERT_B: {
        int sq = partition_subsize(PART_SPLIT, bsize);
        decode_block(t, r, c, sub);
        decode_block(t, r, c + half, sq);
        decode_block(t, r + half, c + half, sq);
        break;
    }
    case PART_HORZ_4:
        for (int i = 0; i < 4; i++) {
            int rr = r + i * q;
            if (rr >= p->row_end) break;
            decode_block(t, rr, c, sub);
        }
        break;
    case PART_VERT_4:
        for (int i = 0; i < 4; i++) {
            int cc = c + i * q;
            if (cc >= p->col_end) break;
            decode_block(t, r, cc, sub);
        }
        break;
    }

    /* partition context update (libaom update_ext_partition_context) */
    if (bsize >= BLOCK_8X8) {
        if (part == PART_SPLIT && bsize != BLOCK_8X8) {
            /* handled by recursion */
        } else if (part == PART_HORZ_A || part == PART_HORZ_B
                   || part == PART_VERT_A || part == PART_VERT_B) {
            int sq = partition_subsize(PART_SPLIT, bsize);
            if (part == PART_HORZ_A) {
                update_part_ctx(t, r, c, sq, sub);
                update_part_ctx(t, r + half, c, sub, sub);
            } else if (part == PART_HORZ_B) {
                update_part_ctx(t, r, c, sub, sub);
                update_part_ctx(t, r + half, c, sq, sub);
            } else if (part == PART_VERT_A) {
                update_part_ctx(t, r, c, sq, sub);
                update_part_ctx(t, r, c + half, sub, sub);
            } else {
                update_part_ctx(t, r, c, sub, sub);
                update_part_ctx(t, r, c + half, sq, sub);
            }
        } else {
            update_part_ctx(t, r, c, sub, bsize);
        }
    }
}

/* ------------------------------------------------------------------ */

#include <time.h>
double av1_tile_time;
static double tile_now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}
double av1_get_tile_time(void) {
    double v = av1_tile_time;
    av1_tile_time = 0.0;
    return v;
}
static int av1_decode_tile_impl(const TileParams *p, const FrameParams *fp,
                    const uint8_t *data, int64_t size, TileOut *o) {
    Ctx t;
    memset(&t, 0, sizeof(t));
    t.p = p;
    t.fp = fp;
    t.o = o;
    /* counters accumulate across tiles; the caller zeroes them per
       frame (multi-tile frames call once per tile) */
    o->error = 0;

    if (fp->cdf_in != NULL)
        memcpy(&t.cdf, fp->cdf_in, CDF_BLOB_SIZE);
    else
        cdf_init(&t.cdf, p->qctx);
    msac_init(&t.msac, data, size, p->allow_update_cdf);

    int mc = p->mi_cols, mr = p->mi_rows;
    t.decoded_mi = calloc((size_t)mc * mr, 1);
    t.tx_types = calloc((size_t)mc * mr, 1);
    if (!t.decoded_mi || !t.tx_types) {
        free(t.decoded_mi);
        free(t.tx_types);
        o->error = 2;
        return 2;
    }
    /* byte-wide above/left context arrays (every value fits int8:
       modes <= 24, lvl <= 63, sign <= 2, tx dims <= 64, pal sizes
       <= 8) — quarters the context cache footprint, which dominated
       the per-block parse tail at 4K.  Palette COLORS stay int32. */
    int8_t *mem8 = calloc((size_t)(mc + mr) * 15, 1);
    int32_t *mem = calloc((size_t)(mc + mr) * 24, sizeof(int32_t));
    if (!mem || !mem8) {
        free(mem8);
        free(mem);
        free(t.decoded_mi);
        free(t.tx_types);
        o->error = 2;
        return 2;
    }
    int8_t *q8 = mem8;
    t.a_part = q8; q8 += mc; t.l_part = q8; q8 += mr;
    t.a_mode = q8; q8 += mc; t.l_mode = q8; q8 += mr;
    t.a_skip = q8; q8 += mc; t.l_skip = q8; q8 += mr;
    t.a_skipmode = q8; q8 += mc; t.l_skipmode = q8; q8 += mr;
    t.a_compgrp = q8; q8 += mc; t.l_compgrp = q8; q8 += mr;
    t.a_compidx = q8; q8 += mc; t.l_compidx = q8; q8 += mr;
    t.a_txw = q8; q8 += mc; t.l_txh = q8; q8 += mr;
    for (int pl = 0; pl < 3; pl++) {
        t.a_lvl[pl] = q8; q8 += mc;
        t.l_lvl[pl] = q8; q8 += mr;
    }
    for (int pl = 0; pl < 3; pl++) {
        t.a_sign[pl] = q8; q8 += mc;
        t.l_sign[pl] = q8; q8 += mr;
    }
    for (int pl = 0; pl < 2; pl++) {
        t.a_pal_sz[pl] = q8; q8 += mc;
        t.l_pal_sz[pl] = q8; q8 += mr;
    }
    int32_t *q = mem;
    for (int pl = 0; pl < 3; pl++) {
        t.a_pal[pl] = q; q += (int64_t)mc * 8;
        t.l_pal[pl] = q; q += (int64_t)mr * 8;
    }
    for (int i = 0; i < mc; i++) t.a_mode[i] = DC_PRED;
    for (int i = 0; i < mr; i++) t.l_mode[i] = DC_PRED;
    /* compound_index context defaults to 1 (tile.py _init_tile) */
    for (int i = 0; i < mc; i++) t.a_compidx[i] = 1;
    for (int i = 0; i < mr; i++) t.l_compidx[i] = 1;

    t.cur_qindex = p->base_q_idx;

    /* loop-restoration predictors reset per tile (spec decode_tile) */
    for (int pl = 0; pl < 3; pl++) {
        for (int pass = 0; pass < 2; pass++)
            for (int j = 0; j < 3; j++)
                t.lr_ref_wiener[pl][pass][j] = WIENER_MID[j];
        for (int i = 0; i < 2; i++)
            t.lr_ref_sgr[pl][i] = SGR_XQD_MID[i];
    }

    int sb_mi = p->sb128 ? 32 : 16;
    int sb_bsize = p->sb128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int r = p->row_start; r < p->row_end && !o->error; r += sb_mi)
        for (int c = p->col_start; c < p->col_end && !o->error; c += sb_mi) {
            t.read_deltas = p->delta_q_present;
            read_lr(&t, r, c);
            decode_partition(&t, r, c, sb_bsize);
        }
    /* end-of-tile entropy state for frame chaining (spec save_cdfs;
       probabilities carry, adaptation counts do not) */
    if (fp->cdf_out != NULL && !o->error) {
        memcpy(fp->cdf_out, &t.cdf, CDF_BLOB_SIZE);
        cdf_reset_counters((CdfState *)fp->cdf_out);
    }
    free(mem8);
    free(mem);
    free(t.decoded_mi);
    free(t.tx_types);
    return o->error;
}

/* packed CdfState blob size (Python asserts == cdf_layout.CDF_BLOB_BYTES,
   guarding struct-layout drift between the two sides) */
int av1_cdf_blob_size(void) { return CDF_BLOB_SIZE; }


int av1_decode_tile(const TileParams *p, const FrameParams *fp,
                    const uint8_t *data, int64_t size, TileOut *o) {
    double t0 = tile_now();
    int rc = av1_decode_tile_impl(p, fp, data, size, o);
    av1_tile_time += tile_now() - t0;
    return rc;
}

/* ------------------------------------------------------------------ */
/* Tile-parallel entropy decode (dav1d thread_task.c role, reference
 * cmake/dav1d.cmake:993; auto thread count analog easyav1.c:1401-1408).
 *
 * AV1 tiles are fully independent for entropy + mode parse (the
 * decoder's context arrays, CDF state and refmvs scans are already
 * tile-scoped — see the tile clamps in av1_inter.h:75,313), so each
 * worker decodes whole tiles into a PRIVATE TileOut (its own
 * blocks/txs/coeffs/lf/pal/lr append buffers; the frame-sized mi
 * grids are shared because tile writes are disjoint).  The merge
 * concatenates the per-tile buffers in tile order — identical to the
 * sequential decode's append order — relocating the cross-references:
 * block.BLK_TXOFF (+tx base), block.BLK_PAL (+pal-unit base),
 * tx.coef_off (+coeff base), pal-unit map offsets (+map base). */

#include <pthread.h>

typedef struct {
    const uint8_t *data;
    int64_t size;
    int32_t col_start, col_end, row_start, row_end;
    uint8_t *cdf_out;   /* non-NULL only for the context-update tile */
} TileDesc;

typedef struct {
    const TileParams *base;
    const FrameParams *fp;
    const TileDesc *descs;
    int n_tiles;
    TileOut *outs;
    pthread_mutex_t mu;
    int next;
    int rc;
} MtCtx;

static void *mt_worker(void *arg) {
    MtCtx *m = (MtCtx *)arg;
    for (;;) {
        pthread_mutex_lock(&m->mu);
        int i = m->next < m->n_tiles ? m->next++ : -1;
        pthread_mutex_unlock(&m->mu);
        if (i < 0) return NULL;
        const TileDesc *d = &m->descs[i];
        TileParams p = *m->base;
        p.col_start = d->col_start;
        p.col_end = d->col_end;
        p.row_start = d->row_start;
        p.row_end = d->row_end;
        FrameParams fp = *m->fp;
        fp.cdf_out = d->cdf_out;
        int rc = av1_decode_tile_impl(&p, &fp, d->data, d->size,
                                      &m->outs[i]);
        if (rc) {
            pthread_mutex_lock(&m->mu);
            m->rc = rc;
            pthread_mutex_unlock(&m->mu);
        }
    }
}

static int mt_alloc_out(TileOut *dst, const TileOut *master) {
    *dst = *master;       /* shared grid pointers + caps */
    dst->n_blocks = dst->n_txs = dst->coeffs_used = 0;
    dst->n_lf = dst->n_lr_units = dst->n_pal_units = 0;
    dst->pal_maps_used = 0;
    dst->error = 0;
    dst->blocks = malloc(sizeof(int32_t) * (size_t)BLK_FIELDS
                         * (size_t)master->max_blocks);
    dst->txs = malloc(sizeof(int32_t) * 8u * (size_t)master->max_txs);
    dst->coeffs = malloc(sizeof(int32_t) * (size_t)master->coeffs_cap);
    dst->lf_txs = malloc(sizeof(int32_t) * 4u * (size_t)master->max_lf);
    dst->lr_units = malloc(sizeof(int32_t) * 13u
                           * (size_t)master->max_lr_units);
    dst->pal_units = malloc(sizeof(int32_t) * 32u
                            * (size_t)master->max_pal_units);
    dst->pal_maps = malloc((size_t)master->pal_maps_cap);
    return dst->blocks && dst->txs && dst->coeffs && dst->lf_txs
           && dst->lr_units && dst->pal_units && dst->pal_maps;
}

static void mt_free_out(TileOut *t) {
    free(t->blocks); free(t->txs); free(t->coeffs); free(t->lf_txs);
    free(t->lr_units); free(t->pal_units); free(t->pal_maps);
}

int av1_decode_tiles_mt(const TileParams *base, const FrameParams *fp,
                        const TileDesc *descs, int n_tiles,
                        int n_threads, TileOut *o) {
    double t0 = tile_now();
    if (n_threads > n_tiles) n_threads = n_tiles;
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n_tiles == 1) {
        for (int i = 0; i < n_tiles; i++) {
            const TileDesc *d = &descs[i];
            TileParams p = *base;
            p.col_start = d->col_start;
            p.col_end = d->col_end;
            p.row_start = d->row_start;
            p.row_end = d->row_end;
            FrameParams f2 = *fp;
            f2.cdf_out = d->cdf_out;
            int rc = av1_decode_tile_impl(&p, &f2, d->data, d->size, o);
            if (rc) {
                av1_tile_time += tile_now() - t0;
                return rc;
            }
        }
        av1_tile_time += tile_now() - t0;
        return 0;
    }
#ifdef __AVX2__
    if (!msac_tables_ready) msac_tables_init();  /* once, pre-spawn */
#endif
    MtCtx m;
    m.base = base;
    m.fp = fp;
    m.descs = descs;
    m.n_tiles = n_tiles;
    m.next = 0;
    m.rc = 0;
    m.outs = malloc(sizeof(TileOut) * (size_t)n_tiles);
    if (!m.outs) return 2;
    int ok = 1;
    for (int i = 0; i < n_tiles; i++)
        ok &= mt_alloc_out(&m.outs[i], o);
    if (!ok) {
        for (int i = 0; i < n_tiles; i++) mt_free_out(&m.outs[i]);
        free(m.outs);
        return 2;
    }
    pthread_mutex_init(&m.mu, NULL);
    pthread_t th[64];
    if (n_threads > 64) n_threads = 64;
    int spawned = 0;
    for (; spawned < n_threads - 1; spawned++)
        if (pthread_create(&th[spawned], NULL, mt_worker, &m) != 0)
            break;
    mt_worker(&m);           /* caller thread joins the pool */
    for (int i = 0; i < spawned; i++)
        pthread_join(th[i], NULL);
    pthread_mutex_destroy(&m.mu);
    int rc = m.rc;
    /* merge in tile order: byte-identical append order to the
       sequential path, with index relocation */
    for (int i = 0; i < n_tiles && rc == 0; i++) {
        TileOut *s = &m.outs[i];
        if (s->error) { rc = s->error; break; }
        if (o->n_blocks + s->n_blocks > o->max_blocks
            || o->n_txs + s->n_txs > o->max_txs
            || o->coeffs_used + s->coeffs_used > o->coeffs_cap
            || o->n_lf + s->n_lf > o->max_lf
            || o->n_lr_units + s->n_lr_units > o->max_lr_units
            || o->n_pal_units + s->n_pal_units > o->max_pal_units
            || o->pal_maps_used + s->pal_maps_used > o->pal_maps_cap) {
            rc = 1;
            break;
        }
        int64_t tx_base = o->n_txs, co_base = o->coeffs_used;
        int64_t pal_base = o->n_pal_units, map_base = o->pal_maps_used;
        int32_t *bdst = o->blocks + o->n_blocks * BLK_FIELDS;
        memcpy(bdst, s->blocks,
               sizeof(int32_t) * (size_t)(s->n_blocks * BLK_FIELDS));
        for (int64_t k = 0; k < s->n_blocks; k++) {
            bdst[k * BLK_FIELDS + BLK_TXOFF] += (int32_t)tx_base;
            if (bdst[k * BLK_FIELDS + BLK_PAL])
                bdst[k * BLK_FIELDS + BLK_PAL] += (int32_t)pal_base;
        }
        int32_t *tdst = o->txs + o->n_txs * 8;
        memcpy(tdst, s->txs, sizeof(int32_t) * (size_t)(s->n_txs * 8));
        for (int64_t k = 0; k < s->n_txs; k++)
            tdst[k * 8 + 6] += (int32_t)co_base;
        memcpy(o->coeffs + o->coeffs_used, s->coeffs,
               sizeof(int32_t) * (size_t)s->coeffs_used);
        memcpy(o->lf_txs + o->n_lf * 4, s->lf_txs,
               sizeof(int32_t) * (size_t)(s->n_lf * 4));
        memcpy(o->lr_units + o->n_lr_units * 13, s->lr_units,
               sizeof(int32_t) * (size_t)(s->n_lr_units * 13));
        int32_t *pdst = o->pal_units + o->n_pal_units * 32;
        memcpy(pdst, s->pal_units,
               sizeof(int32_t) * (size_t)(s->n_pal_units * 32));
        for (int64_t k = 0; k < s->n_pal_units; k++) {
            if (pdst[k * 32 + 0]) pdst[k * 32 + 2] += (int32_t)map_base;
            if (pdst[k * 32 + 1]) pdst[k * 32 + 3] += (int32_t)map_base;
        }
        memcpy(o->pal_maps + o->pal_maps_used, s->pal_maps,
               (size_t)s->pal_maps_used);
        o->n_blocks += s->n_blocks;
        o->n_txs += s->n_txs;
        o->coeffs_used += s->coeffs_used;
        o->n_lf += s->n_lf;
        o->n_lr_units += s->n_lr_units;
        o->n_pal_units += s->n_pal_units;
        o->pal_maps_used += s->pal_maps_used;
    }
    for (int i = 0; i < n_tiles; i++) mt_free_out(&m.outs[i]);
    free(m.outs);
    av1_tile_time += tile_now() - t0;
    return rc;
}
