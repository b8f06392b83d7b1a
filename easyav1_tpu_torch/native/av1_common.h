// Copy of easyav1_tpu/native/av1_common.h, the JAX package's counterpart.
/* Shared parameter/output layouts between the native tile decoder
 * (av1_tile.c) and frame reconstruction (av1_recon.c); mirrored by the
 * ctypes wrapper in __init__.py. */
#pragma once

#include <stdint.h>

/* frame-plane sample: every stage writes clamped [0, (1<<bd)-1] pixel
 * values.  The recon body (av1_recon_tmpl.h) is compiled twice like
 * dav1d's *_tmpl.c units (cmake/dav1d.cmake:1001-1015): an 8bpc build
 * with uint8 planes and a 10/12bpc build with uint16 planes — pixel
 * memory traffic is THE constraint on the bench host (~11 GB/s), so
 * 8-bit streams get half-width planes through MC/LF/CDEF/LR/pack.
 * Residual headroom lives in per-block int32 scratch only. */
#ifndef PEL_TYPE
#define PEL_TYPE uint16_t
#define PEL_BITS 16
#endif
typedef PEL_TYPE pel;

typedef struct {
    int32_t mi_rows, mi_cols;
    int32_t sb128;
    int32_t bitdepth, num_planes, ssx, ssy;
    int32_t base_q_idx;
    int32_t dq_y_dc, dq_u_dc, dq_u_ac, dq_v_dc, dq_v_ac;
    int32_t tx_mode;              /* 0 only4x4, 1 largest, 2 select */
    int32_t reduced_tx_set;
    int32_t coded_lossless;
    int32_t allow_update_cdf;
    int32_t enable_cdef, cdef_bits;
    int32_t enable_filter_intra;
    int32_t allow_intrabc;
    int32_t delta_q_present, delta_q_res;
    int32_t delta_lf_present, delta_lf_multi;
    int32_t col_start, col_end, row_start, row_end;   /* mi units */
    int32_t qctx;
    int32_t allow_screen;         /* allow_screen_content_tools */
    int32_t fill_aux;             /* fill mode/angle mi grids (plan
                                     export path only) */
} TileParams;

/* per-frame side data: inter header fields + entropy-state chaining.
 * (headers.py FrameHeader fields the inter symbol decode consumes) */
typedef struct {
    int32_t frame_is_intra;
    int32_t reference_select;
    int32_t skip_mode_present;
    int32_t skip_mode_frame0, skip_mode_frame1;
    int32_t allow_high_precision_mv;
    int32_t force_integer_mv;
    int32_t interpolation_filter;      /* 4 = SWITCHABLE */
    int32_t enable_dual_filter;
    int32_t is_motion_mode_switchable;
    int32_t allow_warped_motion;
    int32_t enable_interintra_compound;
    int32_t enable_masked_compound;
    int32_t enable_jnt_comp;
    int32_t enable_order_hint;
    int32_t order_hint_bits;
    int32_t order_hint;
    int32_t order_hints[8];            /* per ref frame 1..7 (0 unused) */
    int32_t sign_bias[8];
    int32_t gm_type[8];
    int32_t gm_invalid[8];
    int32_t gm_params[8][6];
    int32_t ref_frame_idx[8];          /* ref frame 1..7 -> slot (recon) */
    /* loop restoration (spec 5.9.20 / 5.11.57): frame type per plane,
       unit sizes in plane pixels, visible dims for the unit counts */
    int32_t lr_uses;
    int32_t lr_frame_type[3];
    int32_t lr_unit_size[3];
    int32_t frame_width, frame_height; /* upscaled visible dims */
    int32_t use_superres;
    int32_t downscaled_width;          /* coded width pre-upscale */
    int32_t superres_denom;            /* SuperresDenom, 8 when off */
    int32_t use_tpl;                   /* temporal mv field present */
    int32_t w8, h8;                    /* tpl grid dims */
    const int16_t *tpl_mv;             /* [h8][w8][2] or NULL */
    const int8_t *tpl_off;             /* [h8][w8] or NULL */
    const uint8_t *cdf_in;             /* packed CdfState or NULL */
    uint8_t *cdf_out;                  /* end-of-tile state or NULL */
} FrameParams;

/* block record: 48 int32 each (see BLK_* indices) */
enum {
    BLK_R = 0, BLK_C, BLK_BSIZE, BLK_YMODE, BLK_UVMODE, BLK_ANGLE_Y,
    BLK_ANGLE_UV, BLK_SKIP, BLK_TXSZ, BLK_UVTX, BLK_HASCHROMA, BLK_CFL_U,
    BLK_CFL_V, BLK_FI, BLK_TXOFF, BLK_NTX,
    BLK_IS_INTER,            /* 16 */
    BLK_REF0, BLK_REF1,
    BLK_MV_R, BLK_MV_C, BLK_MV2_R, BLK_MV2_C,
    BLK_MODE, BLK_REFMVIDX,
    BLK_INTERP0, BLK_INTERP1,
    BLK_MOTION_MODE,
    BLK_WARP_VALID,          /* 28 */
    BLK_WM0, BLK_WM1, BLK_WM2, BLK_WM3, BLK_WM4, BLK_WM5,
    BLK_SH_ALPHA, BLK_SH_BETA, BLK_SH_GAMMA, BLK_SH_DELTA,
    BLK_COMP_TYPE,           /* 39 */
    BLK_COMP_IDX, BLK_WEDGE_IDX, BLK_WEDGE_SIGN, BLK_MASK_TYPE,
    BLK_II_MODE,             /* 44: interintra mode, -1 off */
    BLK_II_WEDGE, BLK_II_WEDGE_IDX,
    BLK_SKIP_MODE,           /* 47 */
    BLK_PARTITION,           /* 48: partition type at this block's node
                                (recon has_tr/has_bl table selection) */
    BLK_PAL,                 /* 49: palette-unit index + 1, 0 = none */
    BLK_INTRABC,             /* 50: intra block copy flag */
    BLK_FIELDS = 52          /* padded */
};

typedef struct {
    /* mi grids, mi_rows x mi_cols row-major int8 */
    int8_t *y_mode, *uv_mode, *angle_y, *angle_uv, *skip, *bsize;
    /* block records, BLK_FIELDS int32 each */
    int32_t *blocks;
    int64_t max_blocks, n_blocks;
    /* coded (non-all-zero) tx records, 8 int32 each:
       plane, x, y, tx_size, tx_type, eob, coef_off, lossless */
    int32_t *txs;
    int64_t max_txs, n_txs;
    int32_t *coeffs;           /* adj_h*adj_w dense values per coded tx */
    int64_t coeffs_cap, coeffs_used;
    /* every visited tx incl. all-zero, 4 int32 each: plane, x, y, tx_size */
    int32_t *lf_txs;
    int64_t max_lf, n_lf;
    /* cdef idx per 64x64 unit: ceil(mi_rows/16) x ceil(mi_cols/16),
       -1 = unset */
    int8_t *cdef_idx;
    int32_t error;
    /* inter decode-state grids (frame-sized, shared across tiles; the
       caller zero/init-fills per frame: ref0 = -1, compidx = 1) */
    int8_t *ref0_g, *ref1_g;   /* mi grids, per-4x4 reference pair */
    int16_t *mvs_g;            /* [mi_rows][mi_cols][2][2] (row,col) */
    int8_t *interp_g;          /* [mi_rows][mi_cols][2] */
    int16_t *modes_g;          /* [mi_rows][mi_cols] prediction mode */
    int8_t *intrabc_g;         /* intrabc flag grid (filled only when
                                  allow_intrabc; reads are gated the
                                  same way) */
    /* loop-restoration units, 13 int32 each: plane, urow, ucol, rtype,
       wiener[2][3], sgr_set, xqd0, xqd1 */
    int32_t *lr_units;
    int64_t max_lr_units, n_lr_units;
    /* palette units (blocks with a palette), 32 int32 each:
       n_y, n_cb, map_y_off, map_uv_off, my_w, my_h, muv_w, muv_h,
       colors y[8] cb[8] cr[8]; maps are int8 color indexes */
    int32_t *pal_units;
    int64_t max_pal_units, n_pal_units;
    int8_t *pal_maps;
    int64_t pal_maps_cap, pal_maps_used;
} TileOut;

/* frame reconstruction parameters (recon + loop filter + cdef) */
typedef struct {
    int32_t bitdepth, num_planes, ssx, ssy;
    int32_t mi_rows, mi_cols;
    int32_t enable_intra_edge_filter;
    int32_t lf_level[4];
    int32_t lf_sharpness;
    int32_t lf_delta_enabled;
    int32_t lf_ref_deltas[8];     /* per reference frame (0 = intra) */
    int32_t lf_mode_deltas[2];    /* [0] global modes, [1] other inter */
    int32_t enable_cdef, cdef_damping;
    int32_t cdef_y_pri[8], cdef_y_sec[8];
    int32_t cdef_uv_pri[8], cdef_uv_sec[8];
    int32_t coded_lossless, allow_intrabc;
    int32_t frame_width, frame_height;   /* visible (cropped) dims */
    /* tile grid in luma mi units: starts[i]..starts[i+1] spans tile i;
       neighbor availability never crosses a tile edge (spec 5.11.5
       is_inside) */
    int32_t tile_cols, tile_rows;
    int32_t tile_col_starts[65], tile_row_starts[65];
} ReconParams;

/* reference-frame planes for inter reconstruction: cropped (visible)
 * planes per slot in the frame's pel type (uint8 for the 8bpc recon
 * build, uint16 for 10/12bpc); NULL when a slot is empty.  void* so
 * the struct layout is bitdepth-independent across the two recon TUs. */
typedef struct {
    const void *plane[8][3];
    int32_t w[8][3], h[8][3];
    int32_t stride[8][3];        /* row stride in elements (>= w) */
} RefPlanes;
