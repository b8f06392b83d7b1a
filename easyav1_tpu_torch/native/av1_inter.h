// Copy of easyav1_tpu/native/av1_inter.h, the JAX package's counterpart.
/* Inter-frame symbol decode: refmvs stack, warp estimation, inter mode
 * info.  Included by av1_tile.c after the Ctx definition (same
 * translation unit; everything static).
 *
 * Exact port of the verified Python reference (refmvs.py, warp.py,
 * tile.py inter paths); tests assert bit-identical plan output.
 * Reference roles: dav1d refmvs.c / warpmv.c / decode.c inter arms
 * (cmake/dav1d.cmake:970-996). */
#pragma once

#include "av1_warp_shared.h"

/* frame-level constants (constants.py) */
enum {
    INTRA_FRAME = 0, LAST_FRAME = 1, LAST2_FRAME = 2, LAST3_FRAME = 3,
    GOLDEN_FRAME = 4, BWDREF_FRAME = 5, ALTREF2_FRAME = 6,
    ALTREF_FRAME = 7, NONE_FRAME = -1
};
enum {
    NEARESTMV = 13, NEARMV = 14, GLOBALMV = 15, NEWMV = 16,
    NEAREST_NEARESTMV = 17, NEAR_NEARMV = 18, NEAREST_NEWMV = 19,
    NEW_NEARESTMV = 20, NEAR_NEWMV = 21, NEW_NEARMV = 22,
    GLOBAL_GLOBALMV = 23, NEW_NEWMV = 24
};
enum { MM_SIMPLE = 0, MM_OBMC = 1, MM_WARPED = 2 };
enum { COMP_AVERAGE = 0, COMP_DISTANCE = 1, COMP_WEDGE = 2,
       COMP_DIFFWTD = 3 };
enum { FILTER_EIGHTTAP = 0, FILTER_SMOOTH = 1, FILTER_SHARP = 2,
       FILTER_BILINEAR = 3, FILTER_SWITCHABLE = 4 };
enum { GM_IDENTITY = 0, GM_TRANSLATION = 1, GM_ROTZOOM = 2,
       GM_AFFINE = 3 };

#define MV_BORDER 128
#define REF_CAT_LEVEL 640
#define MAX_FRAME_DISTANCE 31
#define LS_MV_MAX 256

/* mfmv.py DIV_MULT */
static const int16_t DIV_MULT[32] = {
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638,
    1489, 1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744,
    712, 682, 655, 630, 606, 585, 564, 546, 528};

typedef struct {
    int32_t mv[12][2][2];     /* [idx][list][row,col] */
    int32_t weights[12];
    int n_mvs;                /* len(st.mvs) incl. global-mv padding */
    int num_found;
    int new_mv_count;
    int num_nearest;
    int new_mv_ctx, ref_mv_ctx, zero_mv_ctx;
    int32_t gmv[2][2];        /* [list][row,col] */
} MvStack;

/* grid accessors over TileOut inter-state pointers */
#define GIDX(t, r, c) ((int64_t)(r) * (t)->p->mi_cols + (c))
#define REF0_AT(t, r, c) ((t)->o->ref0_g[GIDX(t, r, c)])
#define REF1_AT(t, r, c) ((t)->o->ref1_g[GIDX(t, r, c)])
#define BSIZE_AT(t, r, c) ((t)->o->bsize[GIDX(t, r, c)])
#define MODE_AT(t, r, c) ((t)->o->modes_g[GIDX(t, r, c)])
#define MV_AT(t, r, c, l, k) ((t)->o->mvs_g[(GIDX(t, r, c) * 2 + (l)) * 2 \
                                            + (k)])
#define INTERP_AT(t, r, c, d) ((t)->o->interp_g[GIDX(t, r, c) * 2 + (d)])

static int is_newmv_mode(int m) {
    return m == NEWMV || m == NEW_NEWMV || m == NEAR_NEWMV
        || m == NEW_NEARMV || m == NEAREST_NEWMV || m == NEW_NEARESTMV;
}

static int is_global_mode(int m) {
    return m == GLOBALMV || m == GLOBAL_GLOBALMV;
}

static int is_inside(Ctx *t, int r, int c) {
    return t->p->row_start <= r && r < t->p->row_end
        && t->p->col_start <= c && c < t->p->col_end
        && t->decoded_mi[GIDX(t, r, c)];
}

static int has_tr(Ctx *t, int r, int c, int bsize) {
    int rr = r - 1, cc = c + av1_block_w4[bsize];
    if (rr < 0 || cc >= t->p->mi_cols) return 0;
    return t->decoded_mi[GIDX(t, rr, cc)];
}

/* refmvs.py _rel_dist */
static int rel_dist(Ctx *t, int a, int b) {
    const FrameParams *fp = t->fp;
    if (!fp->enable_order_hint) return 0;
    int d = a - b;
    int m = 1 << (fp->order_hint_bits - 1);
    return (d & (m - 1)) - (d & m);
}

/* refmvs.py _lower_precision */
static void lower_precision(Ctx *t, int32_t *mv) {
    const FrameParams *fp = t->fp;
    for (int k = 0; k < 2; k++) {
        int v = mv[k];
        if (fp->force_integer_mv) {
            int a = v < 0 ? -v : v;
            int a2 = ((a + 3) >> 3) << 3;
            v = v >= 0 ? a2 : -a2;
        } else if (!fp->allow_high_precision_mv) {
            if (v & 1) v += v > 0 ? -1 : 1;
        }
        mv[k] = v;
    }
}


/* refmvs.py setup_global_mv (spec 7.10.2.1) */
static void setup_global_mv(Ctx *t, int ref, int r, int c, int bsize,
                            int32_t *mv) {
    const FrameParams *fp = t->fp;
    mv[0] = mv[1] = 0;
    if (ref <= INTRA_FRAME) return;
    int typ = fp->gm_type[ref];
    if (typ == GM_IDENTITY) return;
    const int32_t *p = fp->gm_params[ref];
    if (typ == GM_TRANSLATION) {
        mv[0] = p[0] >> 13;
        mv[1] = p[1] >> 13;
    } else {
        int bw = av1_block_w4[bsize] * 4, bh = av1_block_h4[bsize] * 4;
        int64_t x = c * 4 + bw / 2 - 1;
        int64_t y = r * 4 + bh / 2 - 1;
        int64_t xc = (int64_t)(p[2] - (1 << 16)) * x + (int64_t)p[3] * y
                     + p[0];
        int64_t yc = (int64_t)p[4] * x + (int64_t)(p[5] - (1 << 16)) * y
                     + p[1];
        mv[0] = (int32_t)round2_signed64(yc, 13);
        mv[1] = (int32_t)round2_signed64(xc, 13);
    }
    lower_precision(t, mv);
}

/* refmvs.py _add_candidate (spec add_ref_mv_candidate) */
static void add_candidate(Ctx *t, MvStack *st, int mv_r, int mv_c,
                          int weight, const int *rf, int is_compound,
                          int *found) {
    int cr0 = REF0_AT(t, mv_r, mv_c);
    int cr1 = REF1_AT(t, mv_r, mv_c);
    int mode = MODE_AT(t, mv_r, mv_c);
    if (cr0 <= INTRA_FRAME) {
        if (!(rf[0] == INTRA_FRAME && cr0 == INTRA_FRAME
              && t->o->intrabc_g[GIDX(t, mv_r, mv_c)]))
            return;
    }
    int glob = is_global_mode(mode);
    if (!is_compound) {
        for (int j = 0; j < 2; j++) {
            int cref = j == 0 ? cr0 : cr1;
            if (cref != rf[0]) continue;
            int32_t mv[2];
            if (glob) { mv[0] = st->gmv[0][0]; mv[1] = st->gmv[0][1]; }
            else {
                mv[0] = MV_AT(t, mv_r, mv_c, j, 0);
                mv[1] = MV_AT(t, mv_r, mv_c, j, 1);
            }
            *found = 1;
            if (is_newmv_mode(mode)) st->new_mv_count++;
            for (int i = 0; i < st->num_found; i++)
                if (st->mv[i][0][0] == mv[0] && st->mv[i][0][1] == mv[1]) {
                    st->weights[i] += weight;
                    return;
                }
            if (st->num_found < 8) {
                int i = st->num_found;
                st->mv[i][0][0] = mv[0]; st->mv[i][0][1] = mv[1];
                st->mv[i][1][0] = 0; st->mv[i][1][1] = 0;
                st->weights[i] = weight;
                st->num_found++;
                st->n_mvs = st->num_found;
            }
            return;
        }
    } else {
        if (cr0 == rf[0] && cr1 == rf[1]) {
            int32_t mv0[2], mv1[2];
            if (glob) {
                mv0[0] = st->gmv[0][0]; mv0[1] = st->gmv[0][1];
                mv1[0] = st->gmv[1][0]; mv1[1] = st->gmv[1][1];
            } else {
                mv0[0] = MV_AT(t, mv_r, mv_c, 0, 0);
                mv0[1] = MV_AT(t, mv_r, mv_c, 0, 1);
                mv1[0] = MV_AT(t, mv_r, mv_c, 1, 0);
                mv1[1] = MV_AT(t, mv_r, mv_c, 1, 1);
            }
            *found = 1;
            if (is_newmv_mode(mode)) st->new_mv_count++;
            for (int i = 0; i < st->num_found; i++)
                if (st->mv[i][0][0] == mv0[0] && st->mv[i][0][1] == mv0[1]
                    && st->mv[i][1][0] == mv1[0]
                    && st->mv[i][1][1] == mv1[1]) {
                    st->weights[i] += weight;
                    return;
                }
            if (st->num_found < 8) {
                int i = st->num_found;
                st->mv[i][0][0] = mv0[0]; st->mv[i][0][1] = mv0[1];
                st->mv[i][1][0] = mv1[0]; st->mv[i][1][1] = mv1[1];
                st->weights[i] = weight;
                st->num_found++;
                st->n_mvs = st->num_found;
            }
        }
    }
}

/* refmvs.py _scan_row (libaom scan_row_mbmi) */
static int scan_row(Ctx *t, MvStack *st, int r, int c, int bsize,
                    int delta_row, const int *rf, int is_compound,
                    int max_row_offset, int *processed) {
    int bw4 = av1_block_w4[bsize];
    int end4 = imin(imin(bw4, t->p->mi_cols - c), 16);
    int d_row = delta_row, d_col = 0;
    if (delta_row < -1 || delta_row > 1) {
        d_row += r & 1;
        d_col = 1 - (c & 1);
    }
    int found = 0;
    int i = 0;
    while (i < end4) {
        int mv_r = r + d_row, mv_c = c + d_col + i;
        if (!is_inside(t, mv_r, mv_c)) break;
        int cand_bs = BSIZE_AT(t, mv_r, mv_c);
        int cand_w4 = av1_block_w4[cand_bs];
        int length = imin(bw4, cand_w4);
        if (bw4 >= 16) length = imax(length, 4);
        else if (d_row < -1 || d_row > 1) length = imax(length, 2);
        int weight = 2;
        if (2 <= bw4 && bw4 <= cand_w4) {
            int inc = imin(-max_row_offset + d_row + 1,
                           av1_block_h4[cand_bs]);
            weight = imax(weight, inc);
            if (processed) *processed = inc - d_row - 1;
        }
        add_candidate(t, st, mv_r, mv_c, length * weight, rf,
                      is_compound, &found);
        i += length;
    }
    return found;
}

/* refmvs.py _scan_col */
static int scan_col(Ctx *t, MvStack *st, int r, int c, int bsize,
                    int delta_col, const int *rf, int is_compound,
                    int max_col_offset, int *processed) {
    int bh4 = av1_block_h4[bsize];
    int end4 = imin(imin(bh4, t->p->mi_rows - r), 16);
    int d_col = delta_col, d_row = 0;
    if (delta_col < -1 || delta_col > 1) {
        d_col += c & 1;
        d_row = 1 - (r & 1);
    }
    int found = 0;
    int i = 0;
    while (i < end4) {
        int mv_r = r + d_row + i, mv_c = c + d_col;
        if (!is_inside(t, mv_r, mv_c)) break;
        int cand_bs = BSIZE_AT(t, mv_r, mv_c);
        int cand_h4 = av1_block_h4[cand_bs];
        int length = imin(bh4, cand_h4);
        if (bh4 >= 16) length = imax(length, 4);
        else if (d_col < -1 || d_col > 1) length = imax(length, 2);
        int weight = 2;
        if (2 <= bh4 && bh4 <= cand_h4) {
            int inc = imin(-max_col_offset + d_col + 1,
                           av1_block_w4[cand_bs]);
            weight = imax(weight, inc);
            if (processed) *processed = inc - d_col - 1;
        }
        add_candidate(t, st, mv_r, mv_c, length * weight, rf,
                      is_compound, &found);
        i += length;
    }
    return found;
}

static int scan_point(Ctx *t, MvStack *st, int r, int c, int delta_row,
                      int delta_col, const int *rf, int is_compound) {
    int mv_r = r + delta_row, mv_c = c + delta_col;
    if (!is_inside(t, mv_r, mv_c)) return 0;
    if (REF0_AT(t, mv_r, mv_c) == NONE_FRAME) return 0;
    int found = 0;
    add_candidate(t, st, mv_r, mv_c, 4, rf, is_compound, &found);
    return found;
}

/* mfmv.py mv_projection */
static void mv_projection(int mv_row, int mv_col, int num, int den,
                          int32_t *out) {
    den = imin(den, MAX_FRAME_DISTANCE);
    num = num > 0 ? imin(num, MAX_FRAME_DISTANCE)
                  : imax(num, -MAX_FRAME_DISTANCE);
    int32_t src[2] = {mv_row, mv_col};
    for (int k = 0; k < 2; k++) {
        int64_t tv = (int64_t)src[k] * num * DIV_MULT[den];
        int64_t r = tv >= 0 ? (tv + 8192) >> 14 : -((-tv + 8192) >> 14);
        int lim = (1 << 14) - 1;
        out[k] = (int32_t)(r < -lim ? -lim : (r > lim ? lim : r));
    }
}

/* refmvs.py _add_tpl (libaom add_tpl_ref_mv) */
static int add_tpl(Ctx *t, MvStack *st, int r, int c, int br, int bc,
                   const int *rf, int is_compound) {
    const FrameParams *fp = t->fp;
    int pos_r = (r & 1) ? br : br + 1;
    int pos_c = (c & 1) ? bc : bc + 1;
    int mv_r = r + pos_r, mv_c = c + pos_c;
    if (!(t->p->row_start <= mv_r && mv_r < t->p->row_end
          && t->p->col_start <= mv_c && mv_c < t->p->col_end))
        return 0;
    int y8 = mv_r >> 1, x8 = mv_c >> 1;
    int off = fp->tpl_off[(int64_t)y8 * fp->w8 + x8];
    if (off == 0) return 0;
    int fr = fp->tpl_mv[((int64_t)y8 * fp->w8 + x8) * 2 + 0];
    int fc = fp->tpl_mv[((int64_t)y8 * fp->w8 + x8) * 2 + 1];
    int cur0 = rel_dist(t, fp->order_hint, fp->order_hints[rf[0]]);
    int32_t mv0[2];
    mv_projection(fr, fc, cur0, off, mv0);
    lower_precision(t, mv0);
    if (!is_compound) {
        if (br == 0 && bc == 0) {
            int dr = mv0[0] - st->gmv[0][0], dc = mv0[1] - st->gmv[0][1];
            st->zero_mv_ctx = (dr >= 16 || dr <= -16 || dc >= 16
                               || dc <= -16) ? 1 : 0;
        }
        for (int i = 0; i < st->num_found; i++)
            if (st->mv[i][0][0] == mv0[0] && st->mv[i][0][1] == mv0[1]) {
                st->weights[i] += 2;
                return 1;
            }
        if (st->num_found < 8) {
            int i = st->num_found;
            st->mv[i][0][0] = mv0[0]; st->mv[i][0][1] = mv0[1];
            st->mv[i][1][0] = 0; st->mv[i][1][1] = 0;
            st->weights[i] = 2;
            st->num_found++;
            st->n_mvs = st->num_found;
        }
        return 1;
    }
    int cur1 = rel_dist(t, fp->order_hint, fp->order_hints[rf[1]]);
    int32_t mv1[2];
    mv_projection(fr, fc, cur1, off, mv1);
    lower_precision(t, mv1);
    if (br == 0 && bc == 0) {
        int d0r = mv0[0] - st->gmv[0][0], d0c = mv0[1] - st->gmv[0][1];
        int d1r = mv1[0] - st->gmv[1][0], d1c = mv1[1] - st->gmv[1][1];
        st->zero_mv_ctx = (d0r >= 16 || d0r <= -16 || d0c >= 16
                           || d0c <= -16 || d1r >= 16 || d1r <= -16
                           || d1c >= 16 || d1c <= -16) ? 1 : 0;
    }
    for (int i = 0; i < st->num_found; i++)
        if (st->mv[i][0][0] == mv0[0] && st->mv[i][0][1] == mv0[1]
            && st->mv[i][1][0] == mv1[0] && st->mv[i][1][1] == mv1[1]) {
            st->weights[i] += 2;
            return 1;
        }
    if (st->num_found < 8) {
        int i = st->num_found;
        st->mv[i][0][0] = mv0[0]; st->mv[i][0][1] = mv0[1];
        st->mv[i][1][0] = mv1[0]; st->mv[i][1][1] = mv1[1];
        st->weights[i] = 2;
        st->num_found++;
        st->n_mvs = st->num_found;
    }
    return 1;
}

/* refmvs.py _temporal_scan */
static void temporal_scan(Ctx *t, MvStack *st, int r, int c, int bsize,
                          const int *rf, int is_compound) {
    /* spec 7.10.2: the temporal scan covers at most 16 units (64px)
     * in each direction — 128px blocks do NOT scan their lower/right
     * halves */
    int bw4 = imin(imin(av1_block_w4[bsize], t->p->col_end - c), 16);
    int bh4 = imin(imin(av1_block_h4[bsize], t->p->row_end - r), 16);
    int step_h = av1_block_h4[bsize] >= 16 ? 4 : 2;
    int step_w = av1_block_w4[bsize] >= 16 ? 4 : 2;
    int found00 = 0;
    for (int br = 0; br < bh4; br += step_h)
        for (int bc = 0; bc < bw4; bc += step_w) {
            int ret = add_tpl(t, st, r, c, br, bc, rf, is_compound);
            if (br == 0 && bc == 0) found00 = ret;
        }
    if (!found00) st->zero_mv_ctx = 1;
    int full_h4 = av1_block_h4[bsize], full_w4 = av1_block_w4[bsize];
    int allow_ext = (2 <= full_h4 && full_h4 < 16)
        && (2 <= full_w4 && full_w4 < 16);
    if (allow_ext) {
        int voff = imax(2, full_h4), hoff = imax(2, full_w4);
        const int offs[3][2] = {{voff, -2}, {voff, hoff},
                                {voff - 2, hoff}};
        for (int k = 0; k < 3; k++) {
            int row = (r & 15) + offs[k][0];
            int col = (c & 15) + offs[k][1];
            if (!(0 <= row && row < 16 && 0 <= col && col < 16)) continue;
            add_tpl(t, st, r, c, offs[k][0], offs[k][1], rf, is_compound);
        }
    }
}

/* refmvs.py _extra_search_comp */
static void extra_search_comp(Ctx *t, MvStack *st, int r, int c,
                              int bsize, const int *rf) {
    const FrameParams *fp = t->fp;
    int32_t ref_id[2][2][2], ref_diff[2][2][2];
    int n_id[2] = {0, 0}, n_diff[2] = {0, 0};

    int bw4 = av1_block_w4[bsize], bh4 = av1_block_h4[bsize];
    for (int pass = 0; pass < 2; pass++) {
        int lim = pass == 0 ? imin(bw4, t->p->mi_cols - c)
                            : imin(bh4, t->p->mi_rows - r);
        int i = 0;
        while (i < lim) {
            int mv_r = pass == 0 ? r - 1 : r + i;
            int mv_c = pass == 0 ? c + i : c - 1;
            if (!is_inside(t, mv_r, mv_c)) break;
            int cref[2] = {REF0_AT(t, mv_r, mv_c),
                           REF1_AT(t, mv_r, mv_c)};
            for (int j = 0; j < 2; j++) {
                int can_rf = cref[j];
                for (int k = 0; k < 2; k++) {
                    if (can_rf == rf[k] && n_id[k] < 2) {
                        ref_id[k][n_id[k]][0] = MV_AT(t, mv_r, mv_c, j, 0);
                        ref_id[k][n_id[k]][1] = MV_AT(t, mv_r, mv_c, j, 1);
                        n_id[k]++;
                    } else if (can_rf > INTRA_FRAME && n_diff[k] < 2) {
                        int32_t mv[2] = {MV_AT(t, mv_r, mv_c, j, 0),
                                         MV_AT(t, mv_r, mv_c, j, 1)};
                        if (fp->sign_bias[can_rf]
                            != fp->sign_bias[rf[k]]) {
                            mv[0] = -mv[0];
                            mv[1] = -mv[1];
                        }
                        ref_diff[k][n_diff[k]][0] = mv[0];
                        ref_diff[k][n_diff[k]][1] = mv[1];
                        n_diff[k]++;
                    }
                }
            }
            int cand_bs = BSIZE_AT(t, mv_r, mv_c);
            i += pass == 0 ? av1_block_w4[cand_bs]
                           : av1_block_h4[cand_bs];
        }
    }
    int32_t comp_list[2][2][2];
    for (int k = 0; k < 2; k++) {
        for (int idx = 0; idx < 2; idx++) {
            if (idx < n_id[k]) {
                comp_list[idx][k][0] = ref_id[k][idx][0];
                comp_list[idx][k][1] = ref_id[k][idx][1];
            } else if (idx < n_id[k] + n_diff[k]) {
                comp_list[idx][k][0] = ref_diff[k][idx - n_id[k]][0];
                comp_list[idx][k][1] = ref_diff[k][idx - n_id[k]][1];
            } else {
                comp_list[idx][k][0] = st->gmv[k][0];
                comp_list[idx][k][1] = st->gmv[k][1];
            }
        }
    }
    if (st->num_found) {
        int use = 0;
        if (comp_list[0][0][0] == st->mv[0][0][0]
            && comp_list[0][0][1] == st->mv[0][0][1]
            && comp_list[0][1][0] == st->mv[0][1][0]
            && comp_list[0][1][1] == st->mv[0][1][1])
            use = 1;
        int i = st->num_found;
        st->mv[i][0][0] = comp_list[use][0][0];
        st->mv[i][0][1] = comp_list[use][0][1];
        st->mv[i][1][0] = comp_list[use][1][0];
        st->mv[i][1][1] = comp_list[use][1][1];
        st->weights[i] = 2;
        st->num_found++;
        st->n_mvs = st->num_found;
    } else {
        for (int idx = 0; idx < 2; idx++) {
            int i = st->num_found;
            st->mv[i][0][0] = comp_list[idx][0][0];
            st->mv[i][0][1] = comp_list[idx][0][1];
            st->mv[i][1][0] = comp_list[idx][1][0];
            st->mv[i][1][1] = comp_list[idx][1][1];
            st->weights[i] = 2;
            st->num_found++;
            st->n_mvs = st->num_found;
        }
    }
}

/* refmvs.py _extra_search (single-ref) */
static void extra_search_single(Ctx *t, MvStack *st, int r, int c,
                                int bsize, const int *rf) {
    const FrameParams *fp = t->fp;
    int bw4 = av1_block_w4[bsize], bh4 = av1_block_h4[bsize];
    int mi_w = imin(imin(16, bw4), t->p->mi_cols - c);
    int mi_h = imin(imin(16, bh4), t->p->mi_rows - r);
    int end = imin(mi_w, mi_h);
    for (int pass = 0; pass < 2; pass++) {
        int i = 0;
        while (i < end && st->num_found < 2) {
            int mv_r = pass == 0 ? r - 1 : r + i;
            int mv_c = pass == 0 ? c + i : c - 1;
            if (!is_inside(t, mv_r, mv_c)) break;
            int cref[2] = {REF0_AT(t, mv_r, mv_c),
                           REF1_AT(t, mv_r, mv_c)};
            if (rf[0] == INTRA_FRAME) {
                if (cref[0] == INTRA_FRAME
                    && t->o->intrabc_g[GIDX(t, mv_r, mv_c)]) {
                    int32_t mv[2] = {MV_AT(t, mv_r, mv_c, 0, 0),
                                     MV_AT(t, mv_r, mv_c, 0, 1)};
                    int dup = 0;
                    for (int k = 0; k < st->num_found; k++)
                        if (st->mv[k][0][0] == mv[0]
                            && st->mv[k][0][1] == mv[1]) dup = 1;
                    if (!dup) {
                        int ii = st->num_found;
                        st->mv[ii][0][0] = mv[0];
                        st->mv[ii][0][1] = mv[1];
                        st->mv[ii][1][0] = 0; st->mv[ii][1][1] = 0;
                        st->weights[ii] = 2;
                        st->num_found++;
                        st->n_mvs = st->num_found;
                    }
                }
            } else if (cref[0] > INTRA_FRAME) {
                for (int j = 0; j < 2; j++) {
                    if (cref[j] <= INTRA_FRAME) continue;
                    int32_t mv[2] = {MV_AT(t, mv_r, mv_c, j, 0),
                                     MV_AT(t, mv_r, mv_c, j, 1)};
                    if (fp->sign_bias[cref[j]] != fp->sign_bias[rf[0]]) {
                        mv[0] = -mv[0];
                        mv[1] = -mv[1];
                    }
                    int dup = 0;
                    for (int k = 0; k < st->num_found; k++)
                        if (st->mv[k][0][0] == mv[0]
                            && st->mv[k][0][1] == mv[1]) dup = 1;
                    if (!dup) {
                        int ii = st->num_found;
                        st->mv[ii][0][0] = mv[0];
                        st->mv[ii][0][1] = mv[1];
                        st->mv[ii][1][0] = 0; st->mv[ii][1][1] = 0;
                        st->weights[ii] = 2;
                        st->num_found++;
                        st->n_mvs = st->num_found;
                    }
                }
            }
            int cand_bs = BSIZE_AT(t, mv_r, mv_c);
            i += pass == 0 ? av1_block_w4[cand_bs]
                           : av1_block_h4[cand_bs];
        }
    }
}

static void clamp_mv(Ctx *t, int32_t *mv, int r, int c, int bsize) {
    int bw4 = av1_block_w4[bsize], bh4 = av1_block_h4[bsize];
    int row_border = MV_BORDER + bh4 * 4 * 8;
    int col_border = MV_BORDER + bw4 * 4 * 8;
    int mn_row = -(r * 4 * 8) - row_border;
    int mx_row = (t->p->mi_rows - bh4 - r) * 4 * 8 + row_border;
    int mn_col = -(c * 4 * 8) - col_border;
    int mx_col = (t->p->mi_cols - bw4 - c) * 4 * 8 + col_border;
    mv[0] = imax(mn_row, imin(mx_row, mv[0]));
    mv[1] = imax(mn_col, imin(mx_col, mv[1]));
}

/* refmvs.py find (spec 7.10.2 find_mv_stack) */
static void find_mv_stack(Ctx *t, int r, int c, int bsize, const int *rf,
                          int is_compound, MvStack *st) {
    memset(st, 0, sizeof(*st));
    int bw4 = av1_block_w4[bsize], bh4 = av1_block_h4[bsize];

    int32_t g0[2], g1[2];
    setup_global_mv(t, rf[0], r, c, bsize, g0);
    st->gmv[0][0] = g0[0]; st->gmv[0][1] = g0[1];
    if (is_compound) {
        setup_global_mv(t, rf[1], r, c, bsize, g1);
        st->gmv[1][0] = g1[0]; st->gmv[1][1] = g1[1];
    }

    int row_adj = (bh4 < 2 && (r & 1)) ? 1 : 0;
    int col_adj = (bw4 < 2 && (c & 1)) ? 1 : 0;
    int max_row_offset = 0;
    if (is_inside(t, r - 1, c)) {
        max_row_offset = bh4 < 2 ? (-4 + row_adj) : -6;
        max_row_offset = imax(max_row_offset, t->p->row_start - r);
    }
    int max_col_offset = 0;
    if (is_inside(t, r, c - 1)) {
        max_col_offset = bw4 < 2 ? (-4 + col_adj) : -6;
        max_col_offset = imax(max_col_offset, t->p->col_start - c);
    }
    int processed_rows = 0, processed_cols = 0;

    int found_above = scan_row(t, st, r, c, bsize, -1, rf, is_compound,
                               max_row_offset, &processed_rows);
    int found_left = scan_col(t, st, r, c, bsize, -1, rf, is_compound,
                              max_col_offset, &processed_cols);
    if (imax(bw4, bh4) <= 16 && has_tr(t, r, c, bsize))
        if (scan_point(t, st, r, c, -1, bw4, rf, is_compound))
            found_above = 1;

    int close_matches = found_above + found_left;
    st->num_nearest = st->num_found;
    int num_new = st->new_mv_count;

    for (int i = 0; i < st->num_nearest; i++)
        st->weights[i] += REF_CAT_LEVEL;

    if (t->fp->use_tpl) {
        temporal_scan(t, st, r, c, bsize, rf, is_compound);
    } else {
        int gr = st->gmv[0][0], gc = st->gmv[0][1];
        st->zero_mv_ctx = (gr >= 8 || gr <= -8 || gc >= 8 || gc <= -8)
                          ? 1 : 0;
    }

    if (scan_point(t, st, r, c, -1, -1, rf, is_compound))
        found_above = 1;
    for (int idx = 2; idx <= 3; idx++) {
        int eff_ro = -(idx << 1) + 1 + row_adj;
        int eff_co = -(idx << 1) + 1 + col_adj;
        int aro = eff_ro < 0 ? -eff_ro : eff_ro;
        int aco = eff_co < 0 ? -eff_co : eff_co;
        int amr = max_row_offset < 0 ? -max_row_offset : max_row_offset;
        int amc = max_col_offset < 0 ? -max_col_offset : max_col_offset;
        if (aro <= amr && aro > processed_rows)
            if (scan_row(t, st, r, c, bsize, -(idx << 1) + 1, rf,
                         is_compound, max_row_offset, &processed_rows))
                found_above = 1;
        if (aco <= amc && aco > processed_cols)
            if (scan_col(t, st, r, c, bsize, -(idx << 1) + 1, rf,
                         is_compound, max_col_offset, &processed_cols))
                found_left = 1;
    }

    int total_matches = found_above + found_left;

    /* stable sort by descending weight, two segments */
    for (int seg = 0; seg < 2; seg++) {
        int lo = seg == 0 ? 0 : st->num_nearest;
        int hi = seg == 0 ? st->num_nearest : st->num_found;
        for (int i = lo + 1; i < hi; i++) {
            int32_t w = st->weights[i];
            int32_t m[2][2];
            memcpy(m, st->mv[i], sizeof(m));
            int j = i - 1;
            while (j >= lo && st->weights[j] < w) {
                st->weights[j + 1] = st->weights[j];
                memcpy(st->mv[j + 1], st->mv[j], sizeof(m));
                j--;
            }
            st->weights[j + 1] = w;
            memcpy(st->mv[j + 1], m, sizeof(m));
        }
    }

    if (close_matches == 0) {
        st->new_mv_ctx = imin(total_matches, 1);
        st->ref_mv_ctx = total_matches;
    } else if (close_matches == 1) {
        st->new_mv_ctx = 3 - imin(num_new, 1);
        st->ref_mv_ctx = 2 + total_matches;
    } else {
        st->new_mv_ctx = 5 - imin(num_new, 1);
        st->ref_mv_ctx = 5;
    }

    if (st->num_found < 2) {
        if (is_compound) extra_search_comp(t, st, r, c, bsize, rf);
        else extra_search_single(t, st, r, c, bsize, rf);
    }

    /* global-mv pad to 2 entries (not counted in num_found) */
    while (st->n_mvs < 2) {
        int i = st->n_mvs;
        st->mv[i][0][0] = st->gmv[0][0];
        st->mv[i][0][1] = st->gmv[0][1];
        if (is_compound) {
            st->mv[i][1][0] = st->gmv[1][0];
            st->mv[i][1][1] = st->gmv[1][1];
        } else {
            st->mv[i][1][0] = 0; st->mv[i][1][1] = 0;
        }
        st->weights[i] = 2;
        st->n_mvs++;
    }

    for (int i = 0; i < st->n_mvs; i++) {
        clamp_mv(t, st->mv[i][0], r, c, bsize);
        clamp_mv(t, st->mv[i][1], r, c, bsize);
    }
    clamp_mv(t, st->gmv[0], r, c, bsize);
    if (is_compound) clamp_mv(t, st->gmv[1], r, c, bsize);
}

/* ------------------------------------------------------------------ */
/* warp parameter estimation (warp.py)                                 */




/* warp.py find_affine_int: cands [(sx8, sy8, dx8, dy8)] */
static int find_affine_int(const int32_t (*cands)[4], int n_cands,
                           int mi_r, int mi_c, int bsize,
                           const int32_t *mv, int32_t *wm /* [6] */) {
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    int mid_x = mi_c * 4 + w4 * 2 - 1;
    int mid_y = mi_r * 4 + h4 * 2 - 1;
    int su_x = mid_x * 8, su_y = mid_y * 8;
    int du_x = su_x + mv[1], du_y = su_y + mv[0];

    int64_t a00 = 0, a01 = 0, a11 = 0;
    int64_t bx0 = 0, bx1 = 0, by0 = 0, by1 = 0;
    for (int k = 0; k < n_cands; k++) {
        int sx = cands[k][0] - su_x, sy = cands[k][1] - su_y;
        int dx = cands[k][2] - du_x, dy = cands[k][3] - du_y;
        int adx = sx - dx < 0 ? dx - sx : sx - dx;
        int ady = sy - dy < 0 ? dy - sy : sy - dy;
        if (adx >= LS_MV_MAX || ady >= LS_MV_MAX) continue;
        a00 += ((sx * sx) >> 2) + 2 * sx + 8;
        a01 += ((sy * sx) >> 2) + sx + sy + 4;
        a11 += ((sy * sy) >> 2) + 2 * sy + 8;
        bx0 += ((sx * dx) >> 2) + sx + dx + 8;
        bx1 += ((sy * dx) >> 2) + sy + dx + 4;
        by0 += ((sx * dy) >> 2) + sx + dy + 4;
        by1 += ((sy * dy) >> 2) + sy + dy + 8;
    }
    int64_t det = a00 * a11 - a01 * a01;
    if (det == 0) return 0;
    int idet_i, shift;
    resolve_divisor64(det < 0 ? -det : det, &idet_i, &shift);
    int64_t idet = apply_sign64(idet_i, det);
    shift -= WM_PREC_BITS;
    if (shift < 0) {
        idet *= (int64_t)1 << -shift;
        shift = 0;
    }

#define RND_WM(v) \
    (shift == 0 ? (v) * idet \
                : apply_sign64((((v) * idet < 0 ? -((v) * idet) \
                                                : (v) * idet) \
                                + ((int64_t)1 << (shift - 1))) >> shift, \
                               (v) * idet))

    int64_t diag_lo = (1 << WM_PREC_BITS) - (1 << 13) + 1;
    int64_t diag_hi = (1 << WM_PREC_BITS) + (1 << 13) - 1;
    int64_t nd = (1 << 13) - 1;
    int m2 = ws_iclip(RND_WM(a11 * bx0 - a01 * bx1), diag_lo, diag_hi);
    int m3 = ws_iclip(RND_WM(a00 * bx1 - a01 * bx0), -nd, nd);
    int m4 = ws_iclip(RND_WM(a11 * by0 - a01 * by1), -nd, nd);
    int m5 = ws_iclip(RND_WM(a00 * by1 - a01 * by0), diag_lo, diag_hi);
#undef RND_WM

    int64_t tclamp = (1 << 23) - 1;
    int tx = ws_iclip((int64_t)mv[1] * 8192
                   - ((int64_t)mid_x * (m2 - (1 << 16))
                      + (int64_t)mid_y * m3), -tclamp, tclamp);
    int ty = ws_iclip((int64_t)mv[0] * 8192
                   - ((int64_t)mid_x * m4
                      + (int64_t)mid_y * (m5 - (1 << 16))),
                   -tclamp, tclamp);
    wm[0] = tx; wm[1] = ty; wm[2] = m2; wm[3] = m3; wm[4] = m4;
    wm[5] = m5;
    return 1;
}

/* warp.py get_shear_params -> (alpha, beta, gamma, delta) in sh[4] */

/* tile.py _find_warp_samples (spec 7.10.4 / libaom av1_findSamples) */
static int find_warp_samples(Ctx *t, int r, int c, int bsize, int ref,
                             int avail_u, int avail_l,
                             int32_t (*cands)[4]) {
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    int n = 0;
    int do_tl = 1, do_tr = 1;

#define WS_MATCH(rr, cc) \
    (REF0_AT(t, rr, cc) == ref && REF1_AT(t, rr, cc) == NONE_FRAME)
#define WS_REC(rr, cc, row_off, sign_r, col_off, sign_c) do { \
        int nb_ = BSIZE_AT(t, rr, cc); \
        int bw_ = av1_block_w4[nb_] * 4, bh_ = av1_block_h4[nb_] * 4; \
        int x_ = (c + (col_off)) * 4 + (sign_c) * (bw_ >> 1) - 1; \
        int y_ = (r + (row_off)) * 4 + (sign_r) * (bh_ >> 1) - 1; \
        int mvr_ = MV_AT(t, rr, cc, 0, 0); \
        int mvc_ = MV_AT(t, rr, cc, 0, 1); \
        cands[n][0] = x_ * 8; cands[n][1] = y_ * 8; \
        cands[n][2] = x_ * 8 + mvc_; cands[n][3] = y_ * 8 + mvr_; \
        n++; \
    } while (0)

    if (avail_u) {
        int src_w = av1_block_w4[BSIZE_AT(t, r - 1, c)];
        if (w4 <= src_w) {
            int col_off = -(c % src_w);
            if (col_off < 0) do_tl = 0;
            if (col_off + src_w > w4) do_tr = 0;
            if (WS_MATCH(r - 1, c)) WS_REC(r - 1, c, 0, -1, col_off, 1);
        } else {
            int i = 0;
            int lim = imin(w4, t->p->col_end - c);
            while (i < lim && n < 8) {
                src_w = av1_block_w4[BSIZE_AT(t, r - 1, c + i)];
                if (WS_MATCH(r - 1, c + i))
                    WS_REC(r - 1, c + i, 0, -1, i, 1);
                i += imin(w4, src_w);
            }
        }
    }
    if (avail_l && n < 8) {
        int src_h = av1_block_h4[BSIZE_AT(t, r, c - 1)];
        if (h4 <= src_h) {
            int row_off = -(r % src_h);
            if (row_off < 0) do_tl = 0;
            if (WS_MATCH(r, c - 1)) WS_REC(r, c - 1, row_off, 1, 0, -1);
        } else {
            int i = 0;
            int lim = imin(h4, t->p->row_end - r);
            while (i < lim && n < 8) {
                src_h = av1_block_h4[BSIZE_AT(t, r + i, c - 1)];
                if (WS_MATCH(r + i, c - 1))
                    WS_REC(r + i, c - 1, i, 1, 0, -1);
                i += imin(h4, src_h);
            }
        }
    }
    if (do_tl && avail_u && avail_l && n < 8 && WS_MATCH(r - 1, c - 1))
        WS_REC(r - 1, c - 1, 0, -1, 0, -1);
    if (do_tr && n < 8 && imax(w4, h4) <= 16 && has_tr(t, r, c, bsize)
        && c + w4 < t->p->col_end && WS_MATCH(r - 1, c + w4))
        WS_REC(r - 1, c + w4, 0, -1, w4, 1);
#undef WS_MATCH
#undef WS_REC
    return n;
}

/* tile.py _has_overlappable (spec 5.11.27) */
static int has_overlappable(Ctx *t, int r, int c, int bsize, int avail_u,
                            int avail_l) {
    if (avail_u) {
        int lim = imin(av1_block_w4[bsize], t->p->col_end - c);
        for (int i = 0; i < lim; i += 2) {
            int cc = imin((c + i) | 1, t->p->col_end - 1);
            if (REF0_AT(t, r - 1, cc) > INTRA_FRAME) return 1;
        }
    }
    if (avail_l) {
        int lim = imin(av1_block_h4[bsize], t->p->row_end - r);
        for (int i = 0; i < lim; i += 2) {
            int rr = imin((r + i) | 1, t->p->row_end - 1);
            if (REF0_AT(t, rr, c - 1) > INTRA_FRAME) return 1;
        }
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* inter mode info (tile.py _inter_mode_info and helpers)              */

static void count_refs(Ctx *t, int r, int c, int avail_u, int avail_l,
                       int *counts /* [8] */) {
    memset(counts, 0, 8 * sizeof(int));
    for (int k = 0; k < 2; k++) {
        int rr = k == 0 ? r - 1 : r;
        int cc = k == 0 ? c : c - 1;
        int av = k == 0 ? avail_u : avail_l;
        if (!av) continue;
        int f0 = REF0_AT(t, rr, cc), f1 = REF1_AT(t, rr, cc);
        if (f0 > INTRA_FRAME) counts[f0]++;
        if (f1 > INTRA_FRAME) counts[f1]++;
    }
}

static int ref_ctx(int c0, int c1) {
    if (c0 == c1) return 1;
    return c0 < c1 ? 0 : 2;
}

static int is_backward(int ref) {
    return BWDREF_FRAME <= ref && ref <= ALTREF_FRAME;
}

/* (ref0, ref1, is_inter, has2, uni) of a neighbor */
static void nb_info(Ctx *t, int rr, int cc, int *f0, int *f1,
                    int *is_int, int *has2, int *uni) {
    *f0 = REF0_AT(t, rr, cc);
    *f1 = REF1_AT(t, rr, cc);
    *is_int = *f0 > INTRA_FRAME;
    *has2 = *f1 > INTRA_FRAME;
    *uni = *has2 && !(is_backward(*f0) ^ is_backward(*f1));
}

/* libaom av1_get_reference_mode_context */
static int comp_mode_ctx(Ctx *t, int r, int c, int avail_u, int avail_l) {
    if (avail_u && avail_l) {
        int a0, a1, ai, a2, au, l0, l1, li, l2, lu;
        nb_info(t, r - 1, c, &a0, &a1, &ai, &a2, &au);
        nb_info(t, r, c - 1, &l0, &l1, &li, &l2, &lu);
        if (!a2 && !l2) return is_backward(a0) ^ is_backward(l0);
        if (!a2) return 2 + (is_backward(a0) || !ai);
        if (!l2) return 2 + (is_backward(l0) || !li);
        return 4;
    }
    if (avail_u || avail_l) {
        int e0, e1, ei, e2, eu;
        nb_info(t, avail_u ? r - 1 : r, avail_u ? c : c - 1,
                &e0, &e1, &ei, &e2, &eu);
        if (!e2) return is_backward(e0);
        return 3;
    }
    return 1;
}

/* libaom av1_get_comp_reference_type_context */
static int comp_ref_type_ctx(Ctx *t, int r, int c, int avail_u,
                             int avail_l) {
    if (avail_u && avail_l) {
        int a0, a1, ai, a2, au, l0, l1, li, l2, lu;
        nb_info(t, r - 1, c, &a0, &a1, &ai, &a2, &au);
        nb_info(t, r, c - 1, &l0, &l1, &li, &l2, &lu);
        if (!ai && !li) return 2;
        if (!ai || !li) {
            int i0, i1, ii, i2, iu;
            if (!ai) nb_info(t, r, c - 1, &i0, &i1, &ii, &i2, &iu);
            else nb_info(t, r - 1, c, &i0, &i1, &ii, &i2, &iu);
            if (!i2) return 2;
            return 1 + 2 * iu;
        }
        int a_sg = !a2, l_sg = !l2;
        if (a_sg && l_sg)
            return 1 + 2 * !(is_backward(a0) ^ is_backward(l0));
        if (a_sg || l_sg) {
            int cuni = a_sg ? lu : au;   /* the compound neighbor's uni */
            if (!cuni) return 1;
            return 3 + !(is_backward(a0) ^ is_backward(l0));
        }
        if (!au && !lu) return 0;
        if (!au || !lu) return 2;
        return 3 + ((a0 == BWDREF_FRAME) == (l0 == BWDREF_FRAME));
    }
    if (avail_u || avail_l) {
        int e0, e1, ei, e2, eu;
        nb_info(t, avail_u ? r - 1 : r, avail_u ? c : c - 1,
                &e0, &e1, &ei, &e2, &eu);
        if (!ei) return 2;
        if (!e2) return 2;
        return 4 * eu;
    }
    return 2;
}

/* libaom get_comp_group_idx_context */
static int comp_group_ctx(Ctx *t, int r, int c, int avail_u, int avail_l) {
    int above = 0, left = 0;
    if (avail_u) {
        if (REF1_AT(t, r - 1, c) > INTRA_FRAME)
            above = t->a_compgrp[c];
        else if (REF0_AT(t, r - 1, c) == ALTREF_FRAME)
            above = 3;
    }
    if (avail_l) {
        if (REF1_AT(t, r, c - 1) > INTRA_FRAME)
            left = t->l_compgrp[r];
        else if (REF0_AT(t, r, c - 1) == ALTREF_FRAME)
            left = 3;
    }
    return imin(5, above + left);
}

/* libaom get_comp_index_context */
static int comp_index_ctx(Ctx *t, int r, int c, const int *rf,
                          int avail_u, int avail_l) {
    const FrameParams *fp = t->fp;
    int fwd = rel_dist(t, fp->order_hints[rf[1]], fp->order_hint);
    int bck = rel_dist(t, fp->order_hint, fp->order_hints[rf[0]]);
    if (fwd < 0) fwd = -fwd;
    if (bck < 0) bck = -bck;
    int above = 0, left = 0;
    if (avail_u) {
        if (REF1_AT(t, r - 1, c) > INTRA_FRAME)
            above = t->a_compidx[c];
        else if (REF0_AT(t, r - 1, c) == ALTREF_FRAME)
            above = 1;
    }
    if (avail_l) {
        if (REF1_AT(t, r, c - 1) > INTRA_FRAME)
            left = t->l_compidx[r];
        else if (REF0_AT(t, r, c - 1) == ALTREF_FRAME)
            left = 1;
    }
    return above + left + 3 * (fwd == bck);
}

/* tile.py _read_comp_refs */
static void read_comp_refs(Ctx *t, int r, int c, int avail_u, int avail_l,
                           int *rf) {
    Msac *ms = &t->msac;
    int cnt[8];
    count_refs(t, r, c, avail_u, avail_l, cnt);
    int fwd = cnt[LAST_FRAME] + cnt[LAST2_FRAME] + cnt[LAST3_FRAME]
              + cnt[GOLDEN_FRAME];
    int bwd = cnt[BWDREF_FRAME] + cnt[ALTREF2_FRAME] + cnt[ALTREF_FRAME];
    int tctx = comp_ref_type_ctx(t, r, c, avail_u, avail_l);
    int uni = msac_symbol(ms, t->cdf.comp_ref_type[tctx], 2) == 0;
    if (uni) {
        if (msac_symbol(ms, t->cdf.uni_comp_ref[ref_ctx(fwd, bwd)][0],
                        2)) {
            rf[0] = BWDREF_FRAME; rf[1] = ALTREF_FRAME;
            return;
        }
        int ctx1 = ref_ctx(cnt[LAST2_FRAME],
                           cnt[LAST3_FRAME] + cnt[GOLDEN_FRAME]);
        if (msac_symbol(ms, t->cdf.uni_comp_ref[ctx1][1], 2)) {
            int ctx2 = ref_ctx(cnt[LAST3_FRAME], cnt[GOLDEN_FRAME]);
            if (msac_symbol(ms, t->cdf.uni_comp_ref[ctx2][2], 2)) {
                rf[0] = LAST_FRAME; rf[1] = GOLDEN_FRAME;
            } else {
                rf[0] = LAST_FRAME; rf[1] = LAST3_FRAME;
            }
            return;
        }
        rf[0] = LAST_FRAME; rf[1] = LAST2_FRAME;
        return;
    }
    int ctx0 = ref_ctx(cnt[LAST_FRAME] + cnt[LAST2_FRAME],
                       cnt[LAST3_FRAME] + cnt[GOLDEN_FRAME]);
    if (msac_symbol(ms, t->cdf.comp_ref[ctx0][0], 2)) {
        int ctx2 = ref_ctx(cnt[LAST3_FRAME], cnt[GOLDEN_FRAME]);
        rf[0] = msac_symbol(ms, t->cdf.comp_ref[ctx2][2], 2)
                ? GOLDEN_FRAME : LAST3_FRAME;
    } else {
        int ctx1 = ref_ctx(cnt[LAST_FRAME], cnt[LAST2_FRAME]);
        rf[0] = msac_symbol(ms, t->cdf.comp_ref[ctx1][1], 2)
                ? LAST2_FRAME : LAST_FRAME;
    }
    int bctx0 = ref_ctx(cnt[BWDREF_FRAME] + cnt[ALTREF2_FRAME],
                        cnt[ALTREF_FRAME]);
    if (msac_symbol(ms, t->cdf.comp_bwdref[bctx0][0], 2)) {
        rf[1] = ALTREF_FRAME;
    } else {
        int bctx1 = ref_ctx(cnt[BWDREF_FRAME], cnt[ALTREF2_FRAME]);
        rf[1] = msac_symbol(ms, t->cdf.comp_bwdref[bctx1][1], 2)
                ? ALTREF2_FRAME : BWDREF_FRAME;
    }
}

/* tile.py _read_ref_frames */
static void read_ref_frames(Ctx *t, int r, int c, int bsize,
                            int skip_mode, int avail_u, int avail_l,
                            int *rf) {
    const FrameParams *fp = t->fp;
    Msac *ms = &t->msac;
    rf[1] = NONE_FRAME;
    if (skip_mode) {
        rf[0] = fp->skip_mode_frame0;
        rf[1] = fp->skip_mode_frame1;
        return;
    }
    int comp_allowed =
        imin(av1_block_w4[bsize], av1_block_h4[bsize]) * 4 >= 8;
    if (fp->reference_select && comp_allowed) {
        int ctx = comp_mode_ctx(t, r, c, avail_u, avail_l);
        if (msac_symbol(ms, t->cdf.comp_inter[ctx], 2)) {
            read_comp_refs(t, r, c, avail_u, avail_l, rf);
            return;
        }
    }
    int cnt[8];
    count_refs(t, r, c, avail_u, avail_l, cnt);
    int fwd = cnt[LAST_FRAME] + cnt[LAST2_FRAME] + cnt[LAST3_FRAME]
              + cnt[GOLDEN_FRAME];
    int bwd = cnt[BWDREF_FRAME] + cnt[ALTREF2_FRAME] + cnt[ALTREF_FRAME];
    if (msac_symbol(ms, t->cdf.single_ref[ref_ctx(fwd, bwd)][0], 2)) {
        int ctx2 = ref_ctx(cnt[ALTREF2_FRAME] + cnt[BWDREF_FRAME],
                           cnt[ALTREF_FRAME]);
        if (msac_symbol(ms, t->cdf.single_ref[ctx2][1], 2)) {
            rf[0] = ALTREF_FRAME;
            return;
        }
        int ctx6 = ref_ctx(cnt[BWDREF_FRAME], cnt[ALTREF2_FRAME]);
        rf[0] = msac_symbol(ms, t->cdf.single_ref[ctx6][5], 2)
                ? ALTREF2_FRAME : BWDREF_FRAME;
        return;
    }
    int ctx3 = ref_ctx(cnt[LAST_FRAME] + cnt[LAST2_FRAME],
                       cnt[LAST3_FRAME] + cnt[GOLDEN_FRAME]);
    if (msac_symbol(ms, t->cdf.single_ref[ctx3][2], 2)) {
        int ctx5 = ref_ctx(cnt[LAST3_FRAME], cnt[GOLDEN_FRAME]);
        rf[0] = msac_symbol(ms, t->cdf.single_ref[ctx5][4], 2)
                ? GOLDEN_FRAME : LAST3_FRAME;
        return;
    }
    int ctx4 = ref_ctx(cnt[LAST_FRAME], cnt[LAST2_FRAME]);
    rf[0] = msac_symbol(ms, t->cdf.single_ref[ctx4][3], 2)
            ? LAST2_FRAME : LAST_FRAME;
}

/* compound_mode_ctx_map (tile.py _COMP_MODE_CTX_MAP) */
static const int8_t COMP_MODE_CTX_MAP[3][5] = {
    {0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};

static int drl_ctx(const MvStack *st, int idx) {
    if (st->weights[idx] >= 640)
        return st->weights[idx + 1] >= 640 ? 0 : 1;
    return 2;
}

static int read_inter_mode(Ctx *t, const MvStack *st) {
    Msac *ms = &t->msac;
    if (!msac_symbol(ms, t->cdf.newmv[st->new_mv_ctx], 2)) return NEWMV;
    if (!msac_symbol(ms, t->cdf.zeromv[st->zero_mv_ctx], 2))
        return GLOBALMV;
    if (!msac_symbol(ms, t->cdf.refmv[st->ref_mv_ctx], 2))
        return NEARESTMV;
    return NEARMV;
}

static int read_drl(Ctx *t, const MvStack *st, int mode) {
    Msac *ms = &t->msac;
    int ref_mv_idx = 0;
    if (mode == NEWMV || mode == NEW_NEWMV) {
        for (int idx = 0; idx < 2; idx++) {
            if (st->num_found > idx + 1) {
                if (!msac_symbol(ms, t->cdf.drl[drl_ctx(st, idx)], 2))
                    break;
                ref_mv_idx = idx + 1;
            }
        }
    } else if (mode == NEARMV || mode == NEAR_NEARMV
               || mode == NEAR_NEWMV || mode == NEW_NEARMV) {
        ref_mv_idx = 1;
        for (int idx = 1; idx < 3; idx++) {
            if (st->num_found > idx + 1) {
                if (!msac_symbol(ms, t->cdf.drl[drl_ctx(st, idx)], 2))
                    break;
                ref_mv_idx = idx + 1;
            }
        }
    }
    return ref_mv_idx;
}

/* tile.py _read_mv_component; dv = 1 selects the intrabc nmv context */
static int read_mv_component(Ctx *t, int comp, int dv, int force_int) {
    Msac *ms = &t->msac;
    CdfState *cd = &t->cdf;
    int hp_allowed = t->fp->allow_high_precision_mv && !dv;
#define MVC(name) (dv ? (comp ? cd->dv_##name##_1 : cd->dv_##name##_0) \
                      : (comp ? cd->mv_##name##_1 : cd->mv_##name##_0))
    int sign = msac_symbol(ms, MVC(sign)[0], 2);
    int mv_class = msac_symbol(ms, MVC(classes)[0], 11);
    int mag;
    if (mv_class == 0) {
        int int_bit = msac_symbol(ms, MVC(class0)[0], 2);
        int fr = force_int ? 3
                 : msac_symbol(ms, MVC(class0_fr)[int_bit], 4);
        int hp = hp_allowed ? msac_symbol(ms, MVC(class0_hp)[0], 2) : 1;
        mag = ((int_bit << 3) | (fr << 1) | hp) + 1;
    } else {
        int d = 0;
        for (int i = 0; i < mv_class; i++)
            d |= msac_symbol(ms, MVC(bits)[i], 2) << i;
        mag = 2 << (mv_class + 2);
        int fr = force_int ? 3 : msac_symbol(ms, MVC(fr)[0], 4);
        int hp = hp_allowed ? msac_symbol(ms, MVC(hp)[0], 2) : 1;
        mag += ((d << 3) | (fr << 1) | hp) + 1;
    }
#undef MVC
    return sign ? -mag : mag;
}

enum { MV_JOINT_ZERO = 0, MV_JOINT_HNZVZ = 1, MV_JOINT_HZVNZ = 2,
       MV_JOINT_HNZVNZ = 3 };

static void read_mv(Ctx *t, const int32_t *pred, int dv, int force_int,
                    int32_t *out) {
    Msac *ms = &t->msac;
    uint16_t *jrow = dv ? t->cdf.dv_joint[0] : t->cdf.mv_joint[0];
    int joint = msac_symbol(ms, jrow, 4);
    int dr = 0, dc = 0;
    if (joint == MV_JOINT_HZVNZ || joint == MV_JOINT_HNZVNZ)
        dr = read_mv_component(t, 0, dv, force_int);
    if (joint == MV_JOINT_HNZVZ || joint == MV_JOINT_HNZVNZ)
        dc = read_mv_component(t, 1, dv, force_int);
    out[0] = pred[0] + dr;
    out[1] = pred[1] + dc;
}

/* tile.py _read_interp_filter */
static void read_interp_filter(Ctx *t, int r, int c, const int *rf,
                               int avail_u, int avail_l, int *filters) {
    const FrameParams *fp = t->fp;
    if (fp->interpolation_filter != FILTER_SWITCHABLE) {
        filters[0] = filters[1] = fp->interpolation_filter;
        return;
    }
    int n_dirs = fp->enable_dual_filter ? 2 : 1;
    for (int d = 0; d < n_dirs; d++) {
        int ctx = ((d & 1) * 2 + (rf[1] > INTRA_FRAME)) * 4;
        int left_type = 3, above_type = 3;
        if (avail_l && (REF0_AT(t, r, c - 1) == rf[0]
                        || REF1_AT(t, r, c - 1) == rf[0]))
            left_type = INTERP_AT(t, r, c - 1, d);
        if (avail_u && (REF0_AT(t, r - 1, c) == rf[0]
                        || REF1_AT(t, r - 1, c) == rf[0]))
            above_type = INTERP_AT(t, r - 1, c, d);
        if (left_type == above_type) ctx += left_type;
        else if (left_type == 3) ctx += above_type;
        else if (above_type == 3) ctx += left_type;
        else ctx += 3;
        filters[d] = msac_ragged(&t->msac,
                                 t->cdf.switchable_interp[ctx], 4, 3);
    }
    if (n_dirs == 1) filters[1] = filters[0];
}

/* per-list component modes (tile.py _COMP_COMPONENTS); mode-17 based */
static const int8_t COMP_COMPONENTS[8][2] = {
    {NEARESTMV, NEARESTMV},   /* NEAREST_NEARESTMV */
    {NEARMV, NEARMV},         /* NEAR_NEARMV */
    {NEARESTMV, NEWMV},       /* NEAREST_NEWMV */
    {NEWMV, NEARESTMV},       /* NEW_NEARESTMV */
    {NEARMV, NEWMV},          /* NEAR_NEWMV */
    {NEWMV, NEARMV},          /* NEW_NEARMV */
    {GLOBALMV, GLOBALMV},     /* GLOBAL_GLOBALMV */
    {NEWMV, NEWMV},           /* NEW_NEWMV */
};

static void assign_comp_mvs(Ctx *t, int mode, const MvStack *st, int idx,
                            int32_t (*mvs)[2]) {
    for (int i = 0; i < 2; i++) {
        int m = COMP_COMPONENTS[mode - NEAREST_NEARESTMV][i];
        if (m == NEARESTMV) {
            mvs[i][0] = st->mv[0][i][0];
            mvs[i][1] = st->mv[0][i][1];
        } else if (m == NEARMV) {
            mvs[i][0] = st->mv[idx][i][0];
            mvs[i][1] = st->mv[idx][i][1];
        } else if (m == GLOBALMV) {
            mvs[i][0] = st->gmv[i][0];
            mvs[i][1] = st->gmv[i][1];
        } else {
            int32_t pred[2] = {st->mv[idx][i][0], st->mv[idx][i][1]};
            lower_precision(t, pred);
            read_mv(t, pred, 0, t->fp->force_integer_mv, mvs[i]);
        }
    }
}

/* ------------------------------------------------------------------ */
/* tile.py _inter_mode_info: full inter mode-info parse for one block  */

typedef struct {
    int mode;
    int rf[2];
    int32_t mv[2], mv2[2];
    int interp[2];
    int ref_mv_idx;
    int motion_mode;
    int warp_valid;
    int32_t wm[6], sh[4];
    int comp_group_idx, compound_idx, comp_type;
    int wedge_idx, wedge_sign, mask_type;
    int ii_mode, ii_wedge, ii_wedge_idx;
} InterInfo;

static void inter_mode_info(Ctx *t, int r, int c, int bsize, int avail_u,
                            int avail_l, InterInfo *ii) {
    const FrameParams *fp = t->fp;
    Msac *ms = &t->msac;
    memset(ii, 0, sizeof(*ii));
    ii->compound_idx = 1;
    ii->ii_mode = -1;

    read_ref_frames(t, r, c, bsize, t->skip_mode_flag, avail_u, avail_l,
                    ii->rf);
    int is_compound = ii->rf[1] > INTRA_FRAME;
    MvStack st;
    find_mv_stack(t, r, c, bsize, ii->rf, is_compound, &st);

    int mode;
    if (t->skip_mode_flag) {
        mode = NEAREST_NEARESTMV;
        ii->mv[0] = st.mv[0][0][0]; ii->mv[1] = st.mv[0][0][1];
        ii->mv2[0] = st.mv[0][1][0]; ii->mv2[1] = st.mv[0][1][1];
    } else if (is_compound) {
        int cctx = COMP_MODE_CTX_MAP[st.ref_mv_ctx >> 1]
                                    [imin(st.new_mv_ctx, 4)];
        int sym = msac_symbol(ms, t->cdf.inter_compound_mode[cctx], 8);
        mode = NEAREST_NEARESTMV + sym;
        ii->ref_mv_idx = read_drl(t, &st, mode);
        int32_t mvs[2][2];
        assign_comp_mvs(t, mode, &st, ii->ref_mv_idx, mvs);
        ii->mv[0] = mvs[0][0]; ii->mv[1] = mvs[0][1];
        ii->mv2[0] = mvs[1][0]; ii->mv2[1] = mvs[1][1];
    } else {
        mode = read_inter_mode(t, &st);
        ii->ref_mv_idx = read_drl(t, &st, mode);
        if (mode == NEWMV) {
            int32_t pred[2] = {st.mv[ii->ref_mv_idx][0][0],
                               st.mv[ii->ref_mv_idx][0][1]};
            lower_precision(t, pred);
            read_mv(t, pred, 0, fp->force_integer_mv, ii->mv);
        } else if (mode == NEARESTMV) {
            ii->mv[0] = st.mv[0][0][0]; ii->mv[1] = st.mv[0][0][1];
        } else if (mode == NEARMV) {
            ii->mv[0] = st.mv[ii->ref_mv_idx][0][0];
            ii->mv[1] = st.mv[ii->ref_mv_idx][0][1];
        } else {
            ii->mv[0] = st.gmv[0][0]; ii->mv[1] = st.gmv[0][1];
        }
    }
    ii->mode = mode;

    /* interintra (spec read_interintra_mode) */
    if (fp->enable_interintra_compound && !t->skip_mode_flag
        && ii->rf[1] == NONE_FRAME && NEARESTMV <= mode && mode <= NEWMV
        && BLOCK_8X8 <= bsize && bsize <= 9 /* BLOCK_32X32 */) {
        int szg = av1_size_group[bsize];
        if (msac_symbol(ms, t->cdf.interintra[szg], 2)) {
            ii->ii_mode = msac_symbol(ms, t->cdf.interintra_mode[szg], 4);
            ii->rf[1] = INTRA_FRAME;
            if (av1_wedge_bits[bsize] > 0) {
                ii->ii_wedge = msac_symbol(
                    ms, t->cdf.wedge_interintra[bsize], 2);
                if (ii->ii_wedge)
                    ii->ii_wedge_idx = msac_ragged(
                        ms, t->cdf.wedge_idx[bsize], 17, 16);
            }
        }
    }

    /* motion mode (spec read_motion_mode) */
    int motion_mode = MM_SIMPLE;
    if (fp->is_motion_mode_switchable && !t->skip_mode_flag
        && ii->rf[1] == NONE_FRAME) {
        int32_t cands[8][4];
        int n_cands = find_warp_samples(t, r, c, bsize, ii->rf[0],
                                        avail_u, avail_l, cands);
        int dim_min = imin(av1_block_w4[bsize], av1_block_h4[bsize]) * 4;
        int glob_block = mode == GLOBALMV && dim_min >= 8
            && fp->gm_type[ii->rf[0]] > GM_TRANSLATION
            && !fp->force_integer_mv;
        if (dim_min >= 8 && !glob_block
            && has_overlappable(t, r, c, bsize, avail_u, avail_l)) {
            int warp_ok = n_cands >= 1 && fp->allow_warped_motion
                          && !fp->force_integer_mv;
            if (warp_ok)
                motion_mode = msac_symbol(ms, t->cdf.motion_mode[bsize],
                                          3);
            else
                motion_mode = msac_symbol(ms, t->cdf.obmc[bsize], 2)
                              ? MM_OBMC : MM_SIMPLE;
        }
        if (motion_mode == MM_WARPED) {
            /* libaom av1_selectSamples: threshold trim, keep >= 1 */
            int bw = av1_block_w4[bsize] * 4, bh = av1_block_h4[bsize] * 4;
            int thresh = imax(16, imin(112, imax(bw, bh)));
            int32_t sel[8][4];
            int n_sel = 0;
            if (n_cands > 1) {
                for (int k = 0; k < n_cands; k++) {
                    int dx = cands[k][2] - cands[k][0] - ii->mv[1];
                    int dy = cands[k][3] - cands[k][1] - ii->mv[0];
                    if ((dx < 0 ? -dx : dx) + (dy < 0 ? -dy : dy)
                        <= thresh)
                        memcpy(sel[n_sel++], cands[k], sizeof(sel[0]));
                }
                if (n_sel == 0) {
                    memcpy(sel[0], cands[0], sizeof(sel[0]));
                    n_sel = 1;
                }
            } else {
                for (int k = 0; k < n_cands; k++)
                    memcpy(sel[n_sel++], cands[k], sizeof(sel[0]));
            }
            if (find_affine_int((const int32_t (*)[4])sel, n_sel, r, c,
                                bsize, ii->mv, ii->wm))
                ii->warp_valid = get_shear_params(ii->wm, ii->sh);
            /* invalid warp -> translational fallback at recon */
        }
    }
    ii->motion_mode = motion_mode;

    /* compound type (spec read_compound_type) */
    ii->comp_type = COMP_AVERAGE;
    if (ii->rf[1] > INTRA_FRAME && !t->skip_mode_flag) {
        if (fp->enable_masked_compound) {
            int gctx = comp_group_ctx(t, r, c, avail_u, avail_l);
            ii->comp_group_idx = msac_symbol(
                ms, t->cdf.comp_group_idx[gctx], 2);
        }
        if (ii->comp_group_idx == 0) {
            if (fp->enable_jnt_comp) {
                int ictx = comp_index_ctx(t, r, c, ii->rf, avail_u,
                                          avail_l);
                ii->compound_idx = msac_symbol(
                    ms, t->cdf.compound_index[ictx], 2);
                ii->comp_type = ii->compound_idx ? COMP_AVERAGE
                                                 : COMP_DISTANCE;
            }
        } else {
            if (av1_wedge_bits[bsize] > 0)
                ii->comp_type = msac_symbol(
                    ms, t->cdf.compound_type[bsize], 2) == 0
                    ? COMP_WEDGE : COMP_DIFFWTD;
            else
                ii->comp_type = COMP_DIFFWTD;
            if (ii->comp_type == COMP_WEDGE) {
                ii->wedge_idx = msac_ragged(ms, t->cdf.wedge_idx[bsize],
                                            17, 16);
                ii->wedge_sign = msac_bool_equi(ms);
            } else {
                ii->mask_type = msac_bool_equi(ms);
            }
        }
    }

    /* interp filter: not coded for warped / non-translational global
     * (spec needs_interp_filter: a large GLOBALMV block reads it ONLY
     * when GmType == TRANSLATION — IDENTITY also suppresses the read;
     * GLOBAL_GLOBALMV reads it when EITHER ref is TRANSLATION) */
    int dim_min = imin(av1_block_w4[bsize], av1_block_h4[bsize]) * 4;
    int nontrans_global = 0;
    if (dim_min >= 8) {
        if (mode == GLOBALMV)
            nontrans_global = fp->gm_type[ii->rf[0]] != GM_TRANSLATION;
        else if (mode == GLOBAL_GLOBALMV)
            nontrans_global =
                fp->gm_type[ii->rf[0]] != GM_TRANSLATION
                && fp->gm_type[ii->rf[1]] != GM_TRANSLATION;
    }
    if (t->skip_mode_flag || motion_mode == MM_WARPED
        || nontrans_global) {
        int f = fp->interpolation_filter == FILTER_SWITCHABLE
                ? FILTER_EIGHTTAP : fp->interpolation_filter;
        ii->interp[0] = ii->interp[1] = f;
    } else {
        read_interp_filter(t, r, c, ii->rf, avail_u, avail_l, ii->interp);
    }
}
