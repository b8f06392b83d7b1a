// Copy of easyav1_tpu/native/av1_lrf.h, the JAX package's counterpart.
/* AV1 loop restoration (Wiener + SGR), C port of lr_ref.py
 * (spec §7.17; dav1d looprestoration_tmpl.c / lr_apply_tmpl.c roles).
 * Included by av1_recon.c.  Operates on the visible crop of the
 * mi-aligned planes; needs the pre-CDEF deblocked planes for the
 * stripe-boundary rows (spec get_source_sample). */
#pragma once

/* SGR parameters (lr_ref.SGR_S; radii shared with av1_tile.c tables) */
static const int16_t LR_SGR_S[16][2] = {
    {140, 3236}, {112, 2158}, {93, 1618}, {80, 1438}, {70, 1295},
    {58, 1177}, {47, 1079}, {37, 996}, {30, 925}, {25, 863},
    {0, 2589}, {0, 1618}, {0, 1177}, {0, 925}, {56, 0}, {22, 0}};

#define LR_H_MAX 72          /* stripe rows + margins */
#define LR_W_MAX 400         /* 1.5 * max unit (256) + margins */
/* The stripe source rows span the whole plane and are indexed by plane
   column, so they need the widest frame (16384, level 6.x), not a unit's
   width.  The JAX package's copy sizes them LR_W_MAX, which is right
   only for planes up to 400 wide. */
#define LR_SRC_W_MAX 16384

/* scratch (single-threaded decoder) */
static int64_t lr_src[LR_H_MAX][LR_SRC_W_MAX];  /* stripe source rows */
static int64_t lr_A[LR_H_MAX][LR_W_MAX], lr_B[LR_H_MAX][LR_W_MAX];
static int64_t lr_ext[LR_H_MAX + 8][LR_W_MAX + 8];
static int64_t lr_ext_sq[LR_H_MAX + 8][LR_W_MAX + 8];
static int64_t lr_rsum[LR_H_MAX + 8][LR_W_MAX + 8];
static int64_t lr_rsq[LR_H_MAX + 8][LR_W_MAX + 8];
static int64_t lr_out[LR_H_MAX][LR_W_MAX];

/* wiener 7-tap from the 3 coded taps (lr_ref._fil7) */
static void lr_fil7(const int32_t *t3, int plane, int *f) {
    int t0 = plane ? 0 : t3[0], t1 = t3[1], t2 = t3[2];
    int center = plane ? 128 - 2 * (t1 + t2)
                       : 128 - 2 * (t0 + t1 + t2);
    f[0] = t0; f[1] = t1; f[2] = t2; f[3] = center;
    f[4] = t2; f[5] = t1; f[6] = t0;
}

/* src rows are lr_src[0] == plane row (y0-3); r0/r1 index into lr_src */
static void lr_wiener(int r0, int r1, int x0, int x1, int pw,
                      const int32_t *taps, int plane, int bd) {
    int fh[7], fv[7];
    lr_fil7(taps + 3, plane, fh);    /* hfilter from LrWiener[..][1] */
    lr_fil7(taps + 0, plane, fv);
    int round0 = 3 + (bd == 12 ? 2 : 0);
    int round1 = 11 - (bd == 12 ? 2 : 0);
    int64_t limit = ((int64_t)1 << (bd + 1 + 7 - round0)) - 1;
    int64_t bias0 = (int64_t)1 << (bd + 6);
    int64_t off1 = (int64_t)1 << (bd + round1 - 1);
    int w = x1 - x0 + 1, h = r1 - r0 + 1;
    static int64_t inter[LR_H_MAX + 6][LR_W_MAX];
    for (int r = 0; r < h + 6; r++) {
        const int64_t *row = lr_src[r0 - 3 + r];
        for (int c = 0; c < w; c++) {
            int64_t acc = bias0;
            for (int k = 0; k < 7; k++) {
                int cc = x0 - 3 + c + k;
                cc = cc < 0 ? 0 : (cc > pw - 1 ? pw - 1 : cc);
                acc += fh[k] * row[cc];
            }
            acc = (acc + (1 << (round0 - 1))) >> round0;
            inter[r][c] = acc < 0 ? 0 : (acc > limit ? limit : acc);
        }
    }
    int64_t mx = (1 << bd) - 1;
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int64_t acc = -off1;
            for (int k = 0; k < 7; k++)
                acc += fv[k] * inter[r + k][c];
            acc = (acc + (1 << (round1 - 1))) >> round1;
            lr_out[r][c] = acc < 0 ? 0 : (acc > mx ? mx : acc);
        }
}

/* spec 7.17.3 boxFilter + final weighting (lr_ref._box_filter);
 * output into lr_A-reused grid?  writes flt into `flt` [h][w] */
static void lr_box_filter(int r0, int h, int x0, int w, int pw,
                          int src_rows, int radius, int s, int pass,
                          int bd, int64_t (*flt)[LR_W_MAX]) {
    int n = (2 * radius + 1) * (2 * radius + 1);
    int one_over_n = n == 9 ? 455 : 164;      /* Round2(2^12, n) */
    int k = 2 * radius + 1;
    int er = h + 2 + 2 * radius;              /* ext rows */
    int ec = w + 2 + 2 * radius;              /* ext cols */
    for (int i = 0; i < er; i++) {
        int rr = r0 - 1 - radius + i;
        rr = rr < 0 ? 0 : (rr > src_rows - 1 ? src_rows - 1 : rr);
        for (int j = 0; j < ec; j++) {
            int cc = x0 - 1 - radius + j;
            cc = cc < 0 ? 0 : (cc > pw - 1 ? pw - 1 : cc);
            int64_t v = lr_src[rr][cc];
            lr_ext[i][j] = v;
            lr_ext_sq[i][j] = v * v;
        }
    }
    /* vertical k-window sums -> (h+2) x ec */
    for (int i = 0; i < h + 2; i++)
        for (int j = 0; j < ec; j++) {
            int64_t a = 0, b = 0;
            for (int t = 0; t < k; t++) {
                b += lr_ext[i + t][j];
                a += lr_ext_sq[i + t][j];
            }
            lr_rsum[i][j] = b;
            lr_rsq[i][j] = a;
        }
    /* horizontal k-window sums -> A/B (h+2) x (w+2), then a2/b2 */
    for (int i = 0; i < h + 2; i++) {
        if (pass == 0 && ((i - 1 + 1) & 1) != 0) continue;  /* gi: -1,1,3.. */
        for (int j = 0; j < w + 2; j++) {
            int64_t a = 0, b = 0;
            for (int t = 0; t < k; t++) {
                b += lr_rsum[i][j + t];
                a += lr_rsq[i][j + t];
            }
            if (bd > 8) {
                int sh = 2 * (bd - 8);
                a = (a + (1 << (sh - 1))) >> sh;
                b = (b + (1 << (bd - 9))) >> (bd - 8);
            }
            int64_t p = a * n - b * b;
            if (p < 0) p = 0;
            int64_t z = (p * s + (1 << 19)) >> 20;
            int64_t a2;
            if (z >= 255) a2 = 256;
            else if (z == 0) a2 = 1;
            else a2 = ((z << 8) + z / 2) / (z + 1);
            int64_t b2 = ((256 - a2) * b * one_over_n + (1 << 11)) >> 12;
            lr_A[i][j] = a2;
            lr_B[i][j] = b2;
        }
    }
    /* final weighting over the output grid */
    for (int i = 0; i < h; i++) {
        int shift;
        for (int j = 0; j < w; j++) {
            int64_t a, b;
            if (pass == 0) {
                if ((i & 1) == 0) {
                    a = 6 * (lr_A[i][j + 1] + lr_A[i + 2][j + 1])
                        + 5 * (lr_A[i][j] + lr_A[i][j + 2]
                               + lr_A[i + 2][j] + lr_A[i + 2][j + 2]);
                    b = 6 * (lr_B[i][j + 1] + lr_B[i + 2][j + 1])
                        + 5 * (lr_B[i][j] + lr_B[i][j + 2]
                               + lr_B[i + 2][j] + lr_B[i + 2][j + 2]);
                    shift = 9;
                } else {
                    a = 6 * lr_A[i + 1][j + 1]
                        + 5 * (lr_A[i + 1][j] + lr_A[i + 1][j + 2]);
                    b = 6 * lr_B[i + 1][j + 1]
                        + 5 * (lr_B[i + 1][j] + lr_B[i + 1][j + 2]);
                    shift = 8;
                }
            } else {
                a = 0; b = 0;
                for (int dy = -1; dy <= 1; dy++)
                    for (int dx = -1; dx <= 1; dx++) {
                        int wt = (dx == 0 || dy == 0) ? 4 : 3;
                        a += wt * lr_A[i + 1 + dy][j + 1 + dx];
                        b += wt * lr_B[i + 1 + dy][j + 1 + dx];
                    }
                shift = 9;
            }
            int cc = x0 + j;
            cc = cc < 0 ? 0 : (cc > pw - 1 ? pw - 1 : cc);
            int64_t dgd = lr_src[r0 + i][cc];
            int64_t v = a * dgd + b;
            flt[i][j] = (v + (1 << (shift - 1))) >> shift;
        }
    }
}

static int64_t lr_flt0[LR_H_MAX][LR_W_MAX];
static int64_t lr_flt1[LR_H_MAX][LR_W_MAX];

static void lr_sgrproj(int r0, int r1, int x0, int x1, int pw,
                       int src_rows, int sgr_set, int xqd0, int xqd1,
                       int bd) {
    int h = r1 - r0 + 1, w = x1 - x0 + 1;
    int rad0 = SGR_R0[sgr_set], rad1 = SGR_R1[sgr_set];
    if (rad0)
        lr_box_filter(r0, h, x0, w, pw, src_rows, rad0,
                      LR_SGR_S[sgr_set][0], 0, bd, lr_flt0);
    if (rad1)
        lr_box_filter(r0, h, x0, w, pw, src_rows, rad1,
                      LR_SGR_S[sgr_set][1], 1, bd, lr_flt1);
    int w0 = xqd0, w1 = xqd1;
    int w2 = (1 << 7) - w0 - w1;
    int64_t mx = (1 << bd) - 1;
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int cc = x0 + j;
            cc = cc < 0 ? 0 : (cc > pw - 1 ? pw - 1 : cc);
            int64_t u = lr_src[r0 + i][cc] << 4;
            int64_t f0 = rad0 ? lr_flt0[i][j] : u;
            int64_t f1 = rad1 ? lr_flt1[i][j] : u;
            int64_t v = (int64_t)w0 * f0 + (int64_t)w1 * u
                        + (int64_t)w2 * f1;
            int64_t sv = (v + (1 << 10)) >> 11;
            lr_out[i][j] = sv < 0 ? 0 : (sv > mx ? mx : sv);
        }
}

static void av1_loop_restoration(const ReconParams *rp,
                                 const FrameParams *fp, const TileOut *o,
                                 pel *planes[3],
                                 pel *const debl[3], const int pw[3],
                                 const int ph[3]) {
    if (fp == NULL || !fp->lr_uses) return;
    int bd = rp->bitdepth;
    for (int plane = 0; plane < rp->num_planes; plane++) {
        if (fp->lr_frame_type[plane] == RESTORE_NONE) continue;
        int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
        int vpw = (fp->frame_width + ssx) >> ssx;
        int vph = (fp->frame_height + ssy) >> ssy;
        if (vpw > LR_SRC_W_MAX) return;
        int unit_size = fp->lr_unit_size[plane];
        int unit_rows = (vph + (unit_size >> 1)) / unit_size;
        if (unit_rows < 1) unit_rows = 1;
        int unit_cols = (vpw + (unit_size >> 1)) / unit_size;
        if (unit_cols < 1) unit_cols = 1;
        /* copy the CDEF output (LR reads it while overwriting planes) */
        pel *cdef = malloc((size_t)vph * vpw * sizeof(pel));
        if (!cdef) return;
        for (int r = 0; r < vph; r++)
            memcpy(cdef + (size_t)r * vpw,
                   planes[plane] + (size_t)r * pw[plane],
                   (size_t)vpw * sizeof(pel));
        const pel *db = debl[plane];
        int stripe_h = 64 >> ssy;
        int stripe_off = 8 >> ssy;
        int n_stripes = (vph + stripe_off + stripe_h - 1) / stripe_h;
        for (int st = 0; st < n_stripes; st++) {
            int ss = st * stripe_h - stripe_off;
            int se = ss + stripe_h - 1;
            int y0 = ss < 0 ? 0 : ss;
            int y1 = se < vph - 1 ? se : vph - 1;
            if (y0 > y1) continue;
            /* stripe source rows y0-3 .. y1+3 (get_source_sample) */
            int src_rows = y1 - y0 + 7;
            for (int i = 0; i < src_rows; i++) {
                int y = y0 - 3 + i;
                int yy = y < 0 ? 0 : (y > vph - 1 ? vph - 1 : y);
                const pel *row;
                if (yy < ss)
                    row = db + (size_t)(ss - 2 > yy ? ss - 2 : yy)
                          * pw[plane];
                else if (yy > se)
                    row = db + (size_t)(se + 2 < yy ? se + 2 : yy)
                          * pw[plane];
                else
                    row = cdef + (size_t)yy * vpw;
                for (int c = 0; c < vpw; c++) lr_src[i][c] = row[c];
            }
            int urow = (ss + stripe_off) / unit_size;
            if (urow > unit_rows - 1) urow = unit_rows - 1;
            int sr0 = 3, sr1 = 3 + (y1 - y0);   /* src-row indices */
            for (int ucol = 0; ucol < unit_cols; ucol++) {
                int ux0 = ucol * unit_size;
                int ux1 = ucol < unit_cols - 1
                          ? (ucol + 1) * unit_size - 1 : vpw - 1;
                /* find the unit's params */
                int rtype = RESTORE_NONE;
                const int32_t *u = NULL;
                for (int64_t kk = 0; kk < o->n_lr_units; kk++) {
                    const int32_t *cand = o->lr_units + kk * 13;
                    if (cand[0] == plane && cand[1] == urow
                        && cand[2] == ucol) {
                        u = cand;
                        rtype = cand[3];
                        break;
                    }
                }
                if (rtype == RESTORE_WIENER)
                    lr_wiener(sr0, sr1, ux0, ux1, vpw, u + 4, plane, bd);
                else if (rtype == RESTORE_SGRPROJ)
                    lr_sgrproj(sr0, sr1, ux0, ux1, vpw, src_rows,
                               u[10], u[11], u[12], bd);
                else
                    continue;
                for (int r = 0; r <= y1 - y0; r++)
                    for (int c = 0; c <= ux1 - ux0; c++)
                        planes[plane][(size_t)(y0 + r) * pw[plane]
                                      + ux0 + c] = (pel)lr_out[r][c];
            }
        }
        free(cdef);
    }
}
