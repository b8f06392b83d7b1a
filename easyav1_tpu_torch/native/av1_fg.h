// Copy of easyav1_tpu/native/av1_fg.h, the JAX package's counterpart.
/* Film grain synthesis (spec §7.18.3), C port of fg_ref.py — applied
 * to the OUTPUT picture only (reference frames stay grain-free).
 * Reference roles: dav1d filmgrain_tmpl.c / fg_apply_tmpl.c.
 * Included by av1_recon.c. */
#pragma once

#define FG_GRAIN_W 82
#define FG_GRAIN_H 73
#define FG_BLK 32

/* mirror of headers.FilmGrainParams (ctypes _FgParams) */
typedef struct {
    int32_t grain_seed;
    int32_t num_y_points, num_cb_points, num_cr_points;
    int32_t point_y_value[15], point_y_scaling[15];
    int32_t point_cb_value[11], point_cb_scaling[11];
    int32_t point_cr_value[11], point_cr_scaling[11];
    int32_t chroma_scaling_from_luma;
    int32_t grain_scaling;           /* shift for noise */
    int32_t ar_coeff_lag;
    int32_t ar_coeffs_y[24], ar_coeffs_cb[25], ar_coeffs_cr[25];
    int32_t n_ar_y, n_ar_cb, n_ar_cr;
    int32_t ar_coeff_shift, grain_scale_shift;
    int32_t cb_mult, cb_luma_mult, cb_offset;
    int32_t cr_mult, cr_luma_mult, cr_offset;
    int32_t overlap_flag, clip_to_restricted_range;
} FgParams;

static int fg_rand(int *state, int bits) {
    int s = *state;
    int bit = ((s >> 0) ^ (s >> 1) ^ (s >> 3) ^ (s >> 12)) & 1;
    s = (s >> 1) | (bit << 15);
    *state = s;
    return (s >> (16 - bits)) & ((1 << bits) - 1);
}

static int fg_r2(int64_t x, int n) {
    return n ? (int)((x + ((int64_t)1 << (n - 1))) >> n) : (int)x;
}

typedef struct {
    int32_t luma[FG_GRAIN_H][FG_GRAIN_W];
    int32_t cb[FG_GRAIN_H][FG_GRAIN_W];
    int32_t cr[FG_GRAIN_H][FG_GRAIN_W];
    int32_t lut_y[256], lut_cb[256], lut_cr[256];
} FgState;

static void fg_scaling_lut(const int32_t *val, const int32_t *scl, int n,
                           int32_t *lut) {
    memset(lut, 0, 256 * sizeof(int32_t));
    if (n == 0) return;
    for (int i = 0; i < val[0]; i++) lut[i] = scl[0];
    for (int j = 0; j < n - 1; j++) {
        int dx = val[j + 1] - val[j];
        int dy = scl[j + 1] - scl[j];
        int64_t delta = (int64_t)dy * ((65536 + (dx >> 1)) / dx);
        for (int k = 0; k < dx; k++)
            lut[val[j] + k] =
                scl[j] + (int)(((int64_t)k * delta + 32768) >> 16);
    }
    for (int i = val[n - 1]; i < 256; i++) lut[i] = scl[n - 1];
}

/* The scaling of a sample value (scale_lut, spec 7.18.3.5): above 8
   bits the LUT's 256 entries are interpolated in the value's low bd - 8
   bits.  The JAX package's decoder clips the value to 255 instead, so its
   grain differs from dav1d's wherever a 10- or 12-bit sample exceeds
   255. */
static int fg_scale(const int32_t *lut, int v, int bd) {
    if (bd == 8) return lut[v < 0 ? 0 : (v > 255 ? 255 : v)];
    int sh = bd - 8, x = v >> sh, rem = v - (x << sh);
    if (x >= 255) return lut[255];
    return lut[x] + (((lut[x + 1] - lut[x]) * rem + (1 << (sh - 1))) >> sh);
}

/* AR neighborhood in coding order */
static int fg_ar_positions(int lag, int (*pos)[2]) {
    int n = 0;
    for (int dr = -lag; dr <= 0; dr++)
        for (int dc = -lag; dc <= lag; dc++) {
            if (dr == 0 && dc == 0) break;
            pos[n][0] = dr;
            pos[n][1] = dc;
            n++;
        }
    return n;
}

static void fg_generate(const FgParams *fg, int bd, int ssx, int ssy,
                        int mono, FgState *st) {
    int shift = 12 - bd + fg->grain_scale_shift;
    int gmin = -(128 << (bd - 8));
    int gmax = (128 << (bd - 8)) - 1;
    int pos[24][2];
    int n_pos = fg_ar_positions(fg->ar_coeff_lag, pos);

    memset(st->luma, 0, sizeof(st->luma));
    int state = fg->grain_seed;
    if (fg->num_y_points) {
        for (int y = 0; y < FG_GRAIN_H; y++)
            for (int x = 0; x < FG_GRAIN_W; x++) {
                int r = fg_rand(&state, 11);
                st->luma[y][x] = fg_r2(av1_gaussian_sequence[r], shift);
            }
        for (int y = 3; y < FG_GRAIN_H; y++)
            for (int x = 3; x < FG_GRAIN_W - 3; x++) {
                int64_t s = 0;
                for (int k = 0; k < n_pos && k < fg->n_ar_y; k++)
                    s += (int64_t)fg->ar_coeffs_y[k]
                         * st->luma[y + pos[k][0]][x + pos[k][1]];
                int v = st->luma[y][x] + fg_r2(s, fg->ar_coeff_shift);
                st->luma[y][x] = v < gmin ? gmin : (v > gmax ? gmax : v);
            }
    }
    if (mono) return;

    int cw = ssx ? 44 : FG_GRAIN_W;
    int chh = ssy ? 38 : FG_GRAIN_H;
    for (int pl = 0; pl < 2; pl++) {
        int num_pts = pl == 0 ? fg->num_cb_points : fg->num_cr_points;
        const int32_t *coeffs = pl == 0 ? fg->ar_coeffs_cb
                                        : fg->ar_coeffs_cr;
        int n_co = pl == 0 ? fg->n_ar_cb : fg->n_ar_cr;
        int32_t (*cg)[FG_GRAIN_W] = pl == 0 ? st->cb : st->cr;
        memset(cg, 0, sizeof(st->cb));
        int gen = fg->chroma_scaling_from_luma || num_pts > 0;
        state = fg->grain_seed ^ (pl == 0 ? 0xb524 : 0x49d8);
        if (!gen) continue;
        for (int y = 0; y < chh; y++)
            for (int x = 0; x < cw; x++) {
                int r = fg_rand(&state, 11);
                cg[y][x] = fg_r2(av1_gaussian_sequence[r], shift);
            }
        for (int y = 3; y < chh; y++)
            for (int x = 3; x < cw - 3; x++) {
                int64_t s = 0;
                for (int k = 0; k < n_pos && k < n_co; k++)
                    s += (int64_t)coeffs[k]
                         * cg[y + pos[k][0]][x + pos[k][1]];
                if (n_co == n_pos + 1 && fg->num_y_points) {
                    int lx = ((x - 3) << ssx) + 3;
                    int ly = ((y - 3) << ssy) + 3;
                    int lum = 0;
                    for (int i = 0; i <= ssy; i++)
                        for (int j = 0; j <= ssx; j++)
                            lum += st->luma[ly + i][lx + j];
                    lum = fg_r2(lum, ssx + ssy);
                    s += (int64_t)coeffs[n_co - 1] * lum;
                }
                int v = cg[y][x] + fg_r2(s, fg->ar_coeff_shift);
                cg[y][x] = v < gmin ? gmin : (v > gmax ? gmax : v);
            }
    }
}

/* grain sample at block grid (bxi, byi) with per-block offsets */
static int fg_g(const int32_t (*grain)[FG_GRAIN_W],
                const int offsets[2][2], int subx, int suby, int bxi,
                int byi, int x, int y) {
    int randval = offsets[bxi][byi];
    int offx = 3 + (2 >> subx) * (3 + (randval >> 4));
    int offy = 3 + (2 >> suby) * (3 + (randval & 0xF));
    return grain[offy + y + (FG_BLK >> suby) * byi]
                [offx + x + (FG_BLK >> subx) * bxi];
}

/* (bh, bw) grain block with left/top overlap blending */
static void fg_grain_block(const int32_t (*grain)[FG_GRAIN_W],
                           const int offsets[2][2], int subx, int suby,
                           int bw, int bh, int xstart, int ystart,
                           int gmin, int gmax,
                           int32_t *g /* [bh][bw] */) {
    static const int W2[2][2] = {{27, 17}, {17, 27}};
    static const int W1[1][2] = {{23, 22}};
    const int (*wx)[2] = (2 >> subx) == 2 ? W2 : W1;
    const int (*wy)[2] = (2 >> suby) == 2 ? W2 : W1;
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
            int gr = fg_g(grain, offsets, subx, suby, 0, 0, x, y);
            if (x < xstart) {
                int old = fg_g(grain, offsets, subx, suby, 1, 0, x, y);
                gr = fg_r2(old * wx[x][0] + gr * wx[x][1], 5);
                gr = gr < gmin ? gmin : (gr > gmax ? gmax : gr);
            }
            if (y < ystart) {
                int top = fg_g(grain, offsets, subx, suby, 0, 1, x, y);
                if (x < xstart) {
                    int oldt = fg_g(grain, offsets, subx, suby, 1, 1, x,
                                    y);
                    top = fg_r2(oldt * wx[x][0] + top * wx[x][1], 5);
                    top = top < gmin ? gmin : (top > gmax ? gmax : top);
                }
                gr = fg_r2(top * wy[y][0] + gr * wy[y][1], 5);
                gr = gr < gmin ? gmin : (gr > gmax ? gmax : gr);
            }
            g[y * bw + x] = gr;
        }
}

/* Apply grain in place on the cropped output planes (uint16 work
 * copies; luma plane read-only for chroma scaling indexes).
 * planes[p]: (h_p, w_p) with the LUMA dims (h, w) given.
 * Pel-independent (always uint16 work copies from Python) — compiled
 * once, in the 16-bit recon unit. */
#if PEL_BITS == 16
/* The grain templates of one parameter set (fg_generate), exported for
 * the device path: out holds 3 x FG_GRAIN_H x FG_GRAIN_W int32, luma,
 * then Cb, then Cr, each chroma template in its top-left 38 x 44 (4:2:0),
 * 73 x 44 (4:2:2) or the whole (4:4:4), zero elsewhere and in both
 * chroma templates of a monochrome stream.  Returns 0, 2 when out of
 * memory. */
int av1_fg_templates(const FgParams *fg, int bd, int ssx, int ssy,
                     int mono, int32_t *out) {
    FgState *st = malloc(sizeof(FgState));
    if (!st) return 2;
    memset(st, 0, sizeof(FgState));
    fg_generate(fg, bd, ssx, ssy, mono, st);
    size_t n = sizeof(st->luma) / sizeof(int32_t);
    memcpy(out, st->luma, sizeof(st->luma));
    memcpy(out + n, st->cb, sizeof(st->cb));
    memcpy(out + 2 * n, st->cr, sizeof(st->cr));
    free(st);
    return 0;
}

int av1_film_grain(const FgParams *fg, int bd, int ssx, int ssy,
                   int mono, int num_planes, uint16_t *const planes[3],
                   const uint16_t *luma_orig, int w, int h) {
    FgState *st = malloc(sizeof(FgState));
    if (!st) return 2;
    fg_generate(fg, bd, ssx, ssy, mono, st);
    fg_scaling_lut(fg->point_y_value, fg->point_y_scaling,
                   fg->num_y_points, st->lut_y);
    if (fg->chroma_scaling_from_luma) {
        memcpy(st->lut_cb, st->lut_y, sizeof(st->lut_y));
        memcpy(st->lut_cr, st->lut_y, sizeof(st->lut_y));
    } else {
        fg_scaling_lut(fg->point_cb_value, fg->point_cb_scaling,
                       fg->num_cb_points, st->lut_cb);
        fg_scaling_lut(fg->point_cr_value, fg->point_cr_scaling,
                       fg->num_cr_points, st->lut_cr);
    }
    int gmin = -(128 << (bd - 8));
    int gmax = (128 << (bd - 8)) - 1;
    int ymin, ymax, cmin, cmax;
    if (fg->clip_to_restricted_range) {
        ymin = 16 << (bd - 8);
        ymax = 235 << (bd - 8);
        cmin = 16 << (bd - 8);
        cmax = 240 << (bd - 8);
    } else {
        ymin = cmin = 0;
        ymax = cmax = (1 << bd) - 1;
    }
    int shift = fg->grain_scaling;
    int do_cb = fg->num_cb_points || fg->chroma_scaling_from_luma;
    int do_cr = fg->num_cr_points || fg->chroma_scaling_from_luma;
    int pw_l = w;                     /* luma stride == width (cropped) */
    int cw_p = (w + ssx) >> ssx;      /* chroma plane width */
    int ch_p = (h + ssy) >> ssy;

    for (int row = 0; row < (h + 31) / 32; row++) {
        int rows = (fg->overlap_flag && row > 0) ? 2 : 1;
        int row_seeds[2] = {0, 0};
        for (int i = 0; i < rows; i++) {
            int s = fg->grain_seed;
            s ^= (((row - i) * 37 + 178) & 0xFF) << 8;
            s ^= ((row - i) * 173 + 105) & 0xFF;
            row_seeds[i] = s;
        }
        int yoff = row * 32;
        int bh = h - yoff < FG_BLK ? h - yoff : FG_BLK;
        for (int pass = 0; pass < 3; pass++) {
            int plane;
            const int32_t (*grain)[FG_GRAIN_W];
            const int32_t *lut;
            int subx, suby;
            if (pass == 0) {
                if (!fg->num_y_points) continue;
                plane = 0; grain = st->luma; lut = st->lut_y;
                subx = suby = 0;
            } else if (pass == 1) {
                if (mono || num_planes <= 1 || !do_cb) continue;
                plane = 1; grain = st->cb; lut = st->lut_cb;
                subx = ssx; suby = ssy;
            } else {
                if (mono || num_planes <= 1 || !do_cr) continue;
                plane = 2; grain = st->cr; lut = st->lut_cr;
                subx = ssx; suby = ssy;
            }
            int seeds[2] = {row_seeds[0], row_seeds[1]};
            int offsets[2][2] = {{0, 0}, {0, 0}};
            int pb_h;
            if (plane == 0) {
                pb_h = bh;
            } else {
                int lim = ch_p - (yoff >> suby);
                pb_h = (FG_BLK >> suby) < lim ? (FG_BLK >> suby) : lim;
            }
            int pstride = plane == 0 ? pw_l : cw_p;
            for (int bx = 0; bx < w; bx += FG_BLK) {
                if (fg->overlap_flag && bx) {
                    offsets[1][0] = offsets[0][0];
                    offsets[1][1] = offsets[0][1];
                }
                for (int i = 0; i < rows; i++)
                    offsets[0][i] = fg_rand(&seeds[i], 8);
                int pb_w, px, py;
                if (plane == 0) {
                    pb_w = w - bx < FG_BLK ? w - bx : FG_BLK;
                    px = bx;
                    py = yoff;
                } else {
                    int lim = cw_p - (bx >> subx);
                    pb_w = (FG_BLK >> subx) < lim ? (FG_BLK >> subx)
                                                  : lim;
                    px = bx >> subx;
                    py = yoff >> suby;
                }
                if (pb_w <= 0 || pb_h <= 0) continue;
                int ystart = (fg->overlap_flag && row > 0)
                             ? ((2 >> suby) < pb_h ? (2 >> suby) : pb_h)
                             : 0;
                int xstart = (fg->overlap_flag && bx > 0)
                             ? ((2 >> subx) < pb_w ? (2 >> subx) : pb_w)
                             : 0;
                int32_t g[FG_BLK * FG_BLK];
                fg_grain_block(grain, (const int (*)[2])offsets, subx,
                               suby, pb_w, pb_h, xstart, ystart, gmin,
                               gmax, g);
                uint16_t *dst = planes[plane];
                for (int yy = 0; yy < pb_h; yy++)
                    for (int xx = 0; xx < pb_w; xx++) {
                        int src = dst[(py + yy) * pstride + (px + xx)];
                        int scale, vmin, vmax;
                        if (plane == 0) {
                            scale = fg_scale(lut, src, bd);
                            vmin = ymin; vmax = ymax;
                        } else {
                            int ly = (py + yy) << suby;
                            int lx = (px + xx) << subx;
                            int lx1 = lx + (subx && lx + 1 < w ? 1 : 0);
                            int ly0 = ly < h - 1 ? ly : h - 1;
                            int avg = luma_orig[ly0 * pw_l + lx];
                            if (subx) {
                                int r = luma_orig[ly0 * pw_l + lx1];
                                avg = (avg + r + 1) >> 1;
                            }
                            int val;
                            if (fg->chroma_scaling_from_luma) {
                                val = avg;
                            } else {
                                int mult = plane == 1 ? fg->cb_mult
                                                      : fg->cr_mult;
                                int lmult = plane == 1 ? fg->cb_luma_mult
                                                       : fg->cr_luma_mult;
                                int offv = plane == 1 ? fg->cb_offset
                                                      : fg->cr_offset;
                                int comb = avg * (lmult - 128)
                                           + src * (mult - 128);
                                val = (comb >> 6)
                                      + ((offv - 256) << (bd - 8));
                                if (val < 0) val = 0;
                                if (val > (1 << bd) - 1)
                                    val = (1 << bd) - 1;
                            }
                            scale = fg_scale(lut, val, bd);
                            vmin = cmin; vmax = cmax;
                        }
                        int noise = (scale * g[yy * pb_w + xx]
                                     + (1 << (shift - 1))) >> shift;
                        int v = src + noise;
                        dst[(py + yy) * pstride + (px + xx)] =
                            (uint16_t)(v < vmin ? vmin
                                       : (v > vmax ? vmax : v));
                    }
            }
        }
    }
    free(st);
    return 0;
}
#endif  /* PEL_BITS == 16: av1_film_grain compiles once */
