// Intra pred-unit executor for Hopper (sm_90a): one launch a frame, a
// superblock wavefront.
//
// Replaces easyav1_tpu/video/av1/recon/intra_pallas.py:66-680
// (make_strip_kernel), the JAX package's only Pallas kernel.  Semantics
// are those of exec_ref.UnitExecutor._unit on the records of
// records.preprocess_units(units, dims): for each unit, fetch the
// above/left edges from the plane, fill them by availability, run the
// 5-tap edge filter and the 2x upsample for the directional classes,
// predict (DC, V, H, Paeth, the three Smooths, zones 1-3, filter-intra,
// palette-zero, and the intrabc copy of jax_exec._scan_kernel), add
// 4:2:0 CfL, blend an interintra unit with the base pixels under its
// mask (jax_exec.py:865-872), and write clip(pred + residual) into the
// plane.  The plane starts as the caller's base (an inter frame's MC
// planes) or zero; pixels outside the units keep it.  All arithmetic is
// int32, exact.
//
// What bounds it.  By bytes, the work is small: at 1080p frame 0 the
// kernel must read 6.22 MB of int16 residual and 0.37 MB of records and
// write 12.44 MB of int32 planes, 19.0 MB or 5.7 us at 3.35 TB/s.  What
// bounds it in fact is the chain of dependent units: a unit reads pixels
// that earlier units wrote, and one unit costs a few microseconds of
// __syncthreads() and dependent L2 loads whatever its size.  A plane
// walked in decode order by one CTA is one chain of every unit; the
// wavefront below cuts the chain to the SB critical path.
//
// Design: a superblock (SB) wavefront.  A unit reads only its own SB,
// the SB to its left, the SB row above from the corner to the
// above-right SB (c - 1 .. c + 1), and, for chroma CfL, the luma of the
// same SB.  So SB (r, c) may run once SB (r, c - 1) and SB (r - 1, c + 1)
// are done: the critical path is C + 2 (R - 1) SB steps instead of all
// R C SBs of a plane (31 against 135 at 1080p with 128x128 SBs).  The
// host gives each plane's units per SB as [begin, end) spans of its
// records in decode order (intra_strip.sb_schedule); one SB covering the
// whole plane is the sequential schedule.
//
// Persistent CTAs take row tickets with atomicAdd in the order Y row 0,
// U row 0, V row 0, Y row 1, ...; a row depends only on rows of lower
// tickets, so a CTA never waits on one that has not been scheduled, and
// there is no deadlock whatever the residency.  A CTA walks its row's
// SBs left to right.  Before SB (r, c) its thread 0 spins with
// ld.acquire.gpu until row r - 1 of its plane has finished SB
// min(c + 1, C - 1) and, for chroma with CfL, until luma row r has
// finished SB c; then __syncthreads().  After the SB: __syncthreads(),
// and thread 0 issues __threadfence() and a release store of the row's
// count of finished SBs.  An intrabc source may lie anywhere above its
// unit, which this order does not cover: intrabc frames take the
// sequential schedule, one SB a plane.  The scan's units (intrabc,
// interintra) are compiled into a second instantiation of the kernel,
// which the host picks for frames that may have them (a sequential
// schedule, or interintra masks): compiled into every pixel's loop,
// they cost an intra frame about 9% (tools/torch_strip_variants.py,
// PERF.md).  L1 is not coherent across SMs,
// so every pixel is read through L2 (__ldcg); only the inputs, which no
// launch writes, may be cached.  U and V run one SB behind luma in the same launch.
// So the kernel is bound by the SB critical path, each step a chain of
// units at a few microseconds each: far above the roofline bound, which
// no design that keeps AV1's unit order can reach.
//
// Inside an SB, the block's 256 threads share one unit at a time, as in
// the sequential design: the unit's edge vectors, the CfL AC block and
// the filter-intra patch buffer live in shared memory, the planes in
// global memory (L2-resident).  The SB's first RECS records and its
// residual tile are staged in shared memory by asynchronous copies
// (cp.async) issued for SB c + 1 while SB c computes, so a unit's
// record and residual reads do not wait on L2; 4-byte copies, because
// records (120 bytes) and residual rows (2 pw bytes) are not 16-byte
// aligned in general, as TMA bulk copies need.  Reading the SB's own
// reconstructed pixels from a shared-memory tile as well is left out
// (tools/torch_strip_variants.py times it; PERF.md has the numbers).
// The TPU kernel's 0/1 selection matmuls and lane rolls are plain
// indexed loads here, and DC uses integer division.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// record fields (records.F_*) and classes (records.K_*)
enum {
  F_X, F_Y, F_W, F_H, F_CLS, F_ANGLE, F_HA, F_HL, F_HTR, F_HBL,
  F_SA, F_SL, F_UA, F_UL, F_CF, F_ALPHA, F_ACX, F_ACY, F_ACW, F_ACH,
  F_DX, F_DY, F_MAXXR, F_MAXYR, F_NPXA, F_NPXL, F_NA, F_NL, F_VALID,
  F_RES, NF
};
enum {
  K_DC, K_V, K_H, K_Z1, K_Z2, K_Z3, K_SM, K_SMV, K_SMH, K_PAETH,
  K_CFL, K_ZERO, K_FILT, K_IBC
};

constexpr int THREADS = 256;
constexpr int OFF = 2;       // edge slot of the first pixel (exec_ref.OFF)
constexpr int EDGE = 272;    // >= exec_ref's edge length for w, h <= 64
constexpr int AC_MAX = 4096; // CfL AC block (ac_w * ac_h)
constexpr int W9 = 33;       // filter-intra buffer stride (w, h <= 32)
constexpr int RECS = 64;     // records of an SB staged in shared memory
constexpr int RES_MAX = 128 * 128;  // residual tile staged (int16)
// dynamic shared memory: two stages of records and of residual
constexpr int DYN_BYTES = 2 * (RECS * NF * 4 + RES_MAX * 2);

struct Plane {
  const int32_t* fields;  // [n, NF]
  const int16_t* resid;   // [ph, pw]
  int32_t* out;           // [ph, pw]
  const int32_t* spans;   // [rows * cols, 2]: each SB's [begin, end)
  const int32_t* masks;   // [n, ms, ms] interintra masks, or null
  int ph, pw;
  int sbh, sbw;           // SB extent in this plane
  int ms;                 // side of a mask
};

struct Args {
  Plane p[3];
  int np, rows, cols;
  int cfl;                // chroma CfL reads the luma plane (4:2:0)
  int* counters;          // [0] row ticket; [1 + p rows + r] SBs done
  const int32_t* sm_weights;  // [124]
  const int32_t* fi_taps;     // [5, 8, 8]
  int bd;
};

struct Smem {
  int above[EDGE];
  int left[EDGE];
  int ac[AC_MAX];
  int w9[W9 * W9];
  int red[THREADS / 32];
  int dc, avg;
  int ticket;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void wait_at_least(const int* p, int v) {
  while (ld_acquire(p) < v) __nanosleep(32);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// exec_ref._edge_filter: new value of edge[OFF - 1 + i], 1 <= i < sz
__device__ __forceinline__ int edge_tap(const int* e, int sz, int strength,
                                        int i) {
  const int k0 = strength == 3 ? 2 : 0;
  const int k1 = strength == 2 ? 5 : 4;
  const int k2 = strength == 1 ? 8 : (strength == 2 ? 6 : 4);
  const int* s = e + OFF - 1;
  int acc = k0 * s[clampi(i - 2, 0, sz - 1)] + k1 * s[clampi(i - 1, 0, sz - 1)]
          + k2 * s[i] + k1 * s[clampi(i + 1, 0, sz - 1)]
          + k0 * s[clampi(i + 2, 0, sz - 1)];
  return (acc + 8) >> 4;
}

// exec_ref._upsample_edge's dup[k]
__device__ __forceinline__ int dup_at(const int* e, int num, int k) {
  return k < 2 ? e[OFF - 1] : e[OFF + min(k - 2, num - 1)];
}

__device__ __forceinline__ int interp(const int* e, int b, int sh) {
  return (e[OFF + b] * (32 - sh) + e[OFF + b + 1] * sh + 16) >> 5;
}

// One unit of plane P, by the whole block.  Ends with __syncthreads():
// the next unit's edge fetch reads these pixels.
// f: its record (staged or in global memory); res: the SB's staged
// residual tile with origin (y0, x0) and row pitch P.sbw, or null.
// kScan: compile in the scan's units (intrabc copy, interintra blend).
template <bool kScan>
__device__ __forceinline__ void run_unit(const Args& a, const Plane& P,
                                         const int* f, const int16_t* res,
                                         int y0, int x0, Smem& sm) {
  const int ph = P.ph, pw = P.pw;
  const int mx = (1 << a.bd) - 1;
  const int base = 1 << (a.bd - 1);
  const int t = threadIdx.x;
  int32_t* buf = P.out;
  const int32_t* luma = a.p[0].out;
  const int lw = a.p[0].pw;

  const int x = f[F_X], y = f[F_Y];
  const int w = f[F_W], h = f[F_H];
  const int cls = f[F_CLS], ang = f[F_ANGLE];
  const bool ha = f[F_HA] != 0, hl = f[F_HL] != 0;
  const bool is_dir = cls == K_Z1 || cls == K_Z2 || cls == K_Z3;

  // ---- edges (exec_ref._unit: above/left/corner) ----
  int corner;
  if (ha && hl) corner = __ldcg(buf + (y - 1) * pw + x - 1);
  else if (ha) corner = __ldcg(buf + (y - 1) * pw + x);
  else if (hl) corner = __ldcg(buf + y * pw + x - 1);
  else corner = base;
  const int fill_a = hl ? __ldcg(buf + y * pw + x - 1) : base - 1;
  const int fill_l = ha ? __ldcg(buf + (y - 1) * pw + x) : base + 1;
  const int na = f[F_NA], nl = f[F_NL];
  const int esz = OFF + 2 * (2 * max(w, h) + 1) + 2;
  for (int i = t; i < esz; i += THREADS) {
    int va, vl;
    if (i == OFF - 1) {
      va = vl = corner;
    } else {
      if (ha)
        va = i < OFF ? 0
                     : __ldcg(buf + (y - 1) * pw + min(x + min(i - OFF, na - 1), pw - 1));
      else
        va = fill_a;
      if (hl)
        vl = i < OFF ? 0
                     : __ldcg(buf + min(y + min(i - OFF, nl - 1), ph - 1) * pw + x - 1);
      else
        vl = fill_l;
    }
    sm.above[i] = va;
    sm.left[i] = vl;
  }
  __syncthreads();

  // ---- directional edge prep: corner filter, edge filter, upsample ----
  const int ua = is_dir && f[F_UA] != 0;
  const int ul = is_dir && f[F_UL] != 0;
  if (is_dir) {
    if (f[F_CF]) {
      const int s = (sm.left[OFF] * 5 + sm.above[OFF - 1] * 6 + sm.above[OFF] * 5 + 8) >> 4;
      __syncthreads();
      if (t == 0) sm.above[OFF - 1] = sm.left[OFF - 1] = s;
      __syncthreads();
    }
    const int sa = f[F_SA], sl = f[F_SL];
    const int sza = f[F_NPXA], szl = f[F_NPXL];
    const bool fa = ha && sa != 0 && sza > 1 && t >= 1 && t < sza;
    const bool fl = hl && sl != 0 && szl > 1 && t >= 1 && t < szl;
    const int va = fa ? edge_tap(sm.above, sza, sa, t) : 0;
    const int vl = fl ? edge_tap(sm.left, szl, sl, t) : 0;
    __syncthreads();
    if (fa) sm.above[OFF - 1 + t] = va;
    if (fl) sm.left[OFF - 1 + t] = vl;
    __syncthreads();
    if (ua || ul) {
      const int nua = w + (ang < 90 ? h : 0);
      const int nul = h + (ang > 180 ? w : 0);
      int sa_v = 0, pa_v = 0, sl_v = 0, pl_v = 0;
      const int ca = sm.above[OFF - 1], cl = sm.left[OFF - 1];
      const bool da = ua && t < nua, dl = ul && t < nul;
      if (da) {
        sa_v = -dup_at(sm.above, nua, t) + 9 * dup_at(sm.above, nua, t + 1)
             + 9 * dup_at(sm.above, nua, t + 2) - dup_at(sm.above, nua, t + 3);
        sa_v = clampi((sa_v + 8) >> 4, 0, mx);
        pa_v = sm.above[OFF + t];
      }
      if (dl) {
        sl_v = -dup_at(sm.left, nul, t) + 9 * dup_at(sm.left, nul, t + 1)
             + 9 * dup_at(sm.left, nul, t + 2) - dup_at(sm.left, nul, t + 3);
        sl_v = clampi((sl_v + 8) >> 4, 0, mx);
        pl_v = sm.left[OFF + t];
      }
      __syncthreads();
      if (da) {
        sm.above[OFF - 1 + 2 * t] = sa_v;
        sm.above[OFF + 2 * t] = pa_v;
      }
      if (dl) {
        sm.left[OFF - 1 + 2 * t] = sl_v;
        sm.left[OFF + 2 * t] = pl_v;
      }
      if (t == 0) {
        if (ua) sm.above[OFF - 2] = ca;
        if (ul) sm.left[OFF - 2] = cl;
      }
      __syncthreads();
    }
  }

  // ---- DC average (DC and CfL) ----
  if (cls == K_DC || cls == K_CFL) {
    if (t < 32) {
      int s_a = 0, s_l = 0;
      for (int i = t; i < w; i += 32) s_a += sm.above[OFF + i];
      for (int i = t; i < h; i += 32) s_l += sm.left[OFF + i];
      s_a = warp_sum(s_a);
      s_l = warp_sum(s_l);
      if (t == 0) {
        int avg = base;
        if (ha && hl) avg = (s_a + s_l + ((w + h) >> 1)) / (w + h);
        else if (ha) avg = (s_a + (w >> 1)) / w;
        else if (hl) avg = (s_l + (h >> 1)) / h;
        sm.dc = avg;
      }
    }
  }

  // ---- CfL AC block from the finished luma (4:2:0) ----
  const int alpha = f[F_ALPHA];
  const bool cfl = cls == K_CFL && alpha != 0;
  const int acx = f[F_ACX], acy = f[F_ACY];
  const int acw = f[F_ACW], ach = f[F_ACH];
  if (cfl) {
    int part = 0;
    for (int k = t; k < acw * ach; k += THREADS) {
      const int r = k / acw, c = k - r * acw;
      const int32_t* l0 = luma + (size_t)(2 * (acy + r)) * lw + 2 * (acx + c);
      const int v = (__ldcg(l0) + __ldcg(l0 + 1) + __ldcg(l0 + lw)
                     + __ldcg(l0 + lw + 1)) << 1;
      sm.ac[k] = v;
      part += v;
    }
    part = warp_sum(part);
    if ((t & 31) == 0) sm.red[t >> 5] = part;
    __syncthreads();
    if (t < 32) {
      int tot = t < THREADS / 32 ? sm.red[t] : 0;
      tot = warp_sum(tot);
      if (t == 0) {
        const int l2 = (31 - __clz(max(acw, 1))) + (31 - __clz(max(ach, 1)));
        sm.avg = (tot + (1 << max(l2 - 1, 0))) >> l2;
      }
    }
  }

  // ---- filter-intra: 4x2 patches on anti-diagonal wavefronts ----
  if (cls == K_FILT) {
    for (int k = t; k <= w; k += THREADS) sm.w9[k] = k == 0 ? corner : sm.above[OFF + k - 1];
    for (int k = t; k < h; k += THREADS) sm.w9[(k + 1) * W9] = sm.left[OFF + k];
    __syncthreads();
    const int32_t* taps = a.fi_taps + clampi(ang, 0, 4) * 64;
    const int n_w = w >> 2, n_h = h >> 1;
    const int pi = t >> 3, k = t & 7;
    // patch (i, j) reads patches (i-1, j-1), (i-1, j) and (i, j-1):
    // every patch of the diagonal i + j = d runs at once
    for (int d = 0; d < n_w + n_h - 1; ++d) {
      const int i = max(0, d - n_w + 1) + pi;
      const int j = d - i;
      if (i <= min(d, n_h - 1) && j >= 0) {
        const int y0 = 2 * i, x0 = 4 * j;
        const int* r0 = sm.w9 + y0 * W9 + x0;
        const int32_t* tk = taps + k * 8;
        const int s = __ldg(tk) * r0[0] + __ldg(tk + 1) * r0[1]
                    + __ldg(tk + 2) * r0[2] + __ldg(tk + 3) * r0[3]
                    + __ldg(tk + 4) * r0[4] + __ldg(tk + 5) * r0[W9]
                    + __ldg(tk + 6) * r0[2 * W9];
        sm.w9[(y0 + 1 + (k >> 2)) * W9 + x0 + 1 + (k & 3)] = clampi((s + 8) >> 4, 0, mx);
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- predict, CfL, blend clip(pred + residual) into the plane ----
  const int cw = min(w, pw - x), chh = min(h, ph - y);
  const int offx = x - acx, offy = y - acy;
  const int oh = min(h, ach - offy), ow = min(w, acw - offx);
  const int ua_sh = 6 - ua, ul_sh = 6 - ul;
  const int dx = f[F_DX], dy = f[F_DY];
  // intrabc taps (across: F_SA, F_SL; down: F_UA, F_UL); interintra mask
  const int ib_h0 = f[F_SA], ib_h1 = f[F_SL], ib_v0 = f[F_UA], ib_v1 = f[F_UL];
  const int mi = f[F_RES];
  for (int k = t; k < cw * chh; k += THREADS) {
    const int i = k / cw, j = k - i * cw;
    int p;
    switch (cls) {
      case K_DC:
      case K_CFL:
        p = sm.dc;
        break;
      case K_V:
        p = sm.above[OFF + j];
        break;
      case K_H:
        p = sm.left[OFF + i];
        break;
      case K_PAETH: {
        const int bv = sm.above[OFF + j], lv = sm.left[OFF + i];
        const int pp = bv + lv - corner;
        const int pb = abs(pp - bv), pl = abs(pp - lv), pc = abs(pp - corner);
        p = (pl <= pb && pl <= pc) ? lv : (pb <= pc ? bv : corner);
        break;
      }
      case K_SM:
      case K_SMV:
      case K_SMH: {
        const int wy = __ldg(a.sm_weights + h - 4 + i);
        const int wx = __ldg(a.sm_weights + w - 4 + j);
        const int below = sm.left[OFF + h - 1], right = sm.above[OFF + w - 1];
        if (cls == K_SM)
          p = (wy * sm.above[OFF + j] + (256 - wy) * below + wx * sm.left[OFF + i]
               + (256 - wx) * right + 256) >> 9;
        else if (cls == K_SMV)
          p = (wy * sm.above[OFF + j] + (256 - wy) * below + 128) >> 8;
        else
          p = (wx * sm.left[OFF + i] + (256 - wx) * right + 128) >> 8;
        break;
      }
      case K_Z1: {
        const int max_base = (w + h - 1) << ua;
        const int idx = (i + 1) * dx;
        const int b = (idx >> ua_sh) + (j << ua);
        const int sh = ((idx << ua) >> 1) & 0x1F;
        p = b >= max_base ? sm.above[OFF + max_base] : interp(sm.above, b, sh);
        break;
      }
      case K_Z3: {
        const int max_base = (w + h - 1) << ul;
        const int idy = (j + 1) * dy;
        const int b = (idy >> ul_sh) + (i << ul);
        const int sh = ((idy << ul) >> 1) & 0x1F;
        p = b >= max_base ? sm.left[OFF + max_base] : interp(sm.left, b, sh);
        break;
      }
      case K_Z2: {
        const int idx = j * 64 - (i + 1) * dx;
        const int b = idx >> ua_sh;
        if (b >= -(1 << ua)) {
          p = interp(sm.above, max(b, -2), (idx * (1 << ua) >> 1) & 0x1F);
        } else {
          const int idy = i * 64 - (j + 1) * dy;
          p = interp(sm.left, max(idy >> ul_sh, -2), (idy * (1 << ul) >> 1) & 0x1F);
        }
        break;
      }
      case K_FILT:
        p = sm.w9[(i + 1) * W9 + j + 1];
        break;
      case K_IBC: {
        p = 0;
        if constexpr (kScan) {
          // whole-pel source (dx + 3, dy + 3) through bilinear taps 3
          // and 4: a pixel is read only under a live tap, clamped to the
          // plane
          const int sr = dy + 3 + i, sc0 = dx + 3 + j;
          const int r0 = clampi(sr, 0, ph - 1), r1 = clampi(sr + 1, 0, ph - 1);
          const int c0 = clampi(sc0, 0, pw - 1), c1 = clampi(sc0 + 1, 0, pw - 1);
          auto across = [&](int r) {
            return ((ib_h0 ? ib_h0 * __ldcg(buf + r * pw + c0) : 0)
                    + (ib_h1 ? ib_h1 * __ldcg(buf + r * pw + c1) : 0) + 4) >> 3;
          };
          const int m0 = ib_v0 ? across(r0) : 0, m1 = ib_v1 ? across(r1) : 0;
          p = clampi((ib_v0 * m0 + ib_v1 * m1 + 1024) >> 11, 0, mx);
        }
        break;
      }
      default:  // K_ZERO: palette, prediction folded into the residual
        p = 0;
        break;
    }
    if (cfl && i < oh && j < ow) {
      const int d = alpha * (sm.ac[(offy + i) * acw + offx + j] - sm.avg);
      const int sc = d < 0 ? -((-d + 32) >> 6) : ((d + 32) >> 6);
      p = clampi(p + sc, 0, mx);
    }
    const int o = (y + i) * pw + x + j;
    if (kScan && mi > 0) {  // interintra: blend with the base (MC)
      const int m = __ldg(P.masks + ((size_t)(mi - 1) * P.ms + i) * P.ms + j);
      p = (p * m + __ldcg(buf + o) * (64 - m) + 32) >> 6;
    }
    const int rv = res ? res[(y + i - y0) * P.sbw + x + j - x0] : P.resid[o];
    buf[o] = clampi(p + rv, 0, mx);
  }
  __syncthreads();
}

// Issue the asynchronous copies of SB (r, c)'s first RECS records and,
// when res is not null, of its residual tile (pitch P.sbw), as one
// committed group.  4-byte copies: records are 120 bytes and residual
// rows 2 pw bytes, so 16-byte bulk copies would not line up.
__device__ __forceinline__ void stage(const Plane& P, int r, int c, int cols,
                                      int* rec, int16_t* res) {
  const int t = threadIdx.x;
  const int32_t* sp = P.spans + 2 * (r * cols + c);
  const int u0 = __ldg(sp), n = min(__ldg(sp + 1) - u0, RECS);
  const int32_t* src = P.fields + (size_t)u0 * NF;
  for (int k = t; k < n * NF; k += THREADS)
    __pipeline_memcpy_async(rec + k, src + k, 4);
  if (res) {
    const int y0 = r * P.sbh, x0 = c * P.sbw;
    const int th = min(P.sbh, P.ph - y0), tw2 = min(P.sbw, P.pw - x0) >> 1;
    for (int k = t; k < th * tw2; k += THREADS) {
      const int i = k / tw2, j = 2 * (k - i * tw2);
      __pipeline_memcpy_async(res + i * P.sbw + j,
                              P.resid + (size_t)(y0 + i) * P.pw + x0 + j, 4);
    }
  }
  __pipeline_commit();
}

template <bool kScan>
__global__ void __launch_bounds__(THREADS) intra_wavefront_kernel(Args a) {
  __shared__ Smem sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  int* const recs = reinterpret_cast<int*>(dyn);                 // [2][RECS NF]
  int16_t* const ress = reinterpret_cast<int16_t*>(recs + 2 * RECS * NF);
  const int t = threadIdx.x;
  int* const done = a.counters + 1;
  const int n_rows = a.np * a.rows;
  for (;;) {
    if (t == 0) sm.ticket = atomicAdd(a.counters, 1);
    __syncthreads();
    const int ticket = sm.ticket;
    __syncthreads();                   // sm.ticket is rewritten next row
    if (ticket >= n_rows) return;
    const int r = ticket / a.np, pl = ticket - r * a.np;
    const Plane P = a.p[pl];
    int* const row_done = done + pl * a.rows + r;
    // a tile too large to stage (a sequential schedule's whole plane)
    // is read from global memory
    const bool tiled = P.sbh * P.sbw <= RES_MAX;
    stage(P, r, 0, a.cols, recs, tiled ? ress : nullptr);
    for (int c = 0; c < a.cols; ++c) {
      if (t == 0) {
        if (r > 0) wait_at_least(row_done - 1, min(c + 2, a.cols));
        if (a.cfl && pl > 0) wait_at_least(done + r, c + 1);
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      // SB c + 1's copies run while SB c computes
      const int b = c & 1, nb = b ^ 1;
      if (c + 1 < a.cols)
        stage(P, r, c + 1, a.cols, recs + nb * RECS * NF,
              tiled ? ress + nb * RES_MAX : nullptr);
      const int* rec = recs + b * RECS * NF;
      const int16_t* res = tiled ? ress + b * RES_MAX : nullptr;
      const int32_t* sp = P.spans + 2 * (r * a.cols + c);
      const int u0 = __ldg(sp), u1 = __ldg(sp + 1);
      for (int u = u0; u < u1; ++u)
        run_unit<kScan>(a, P, u - u0 < RECS ? rec + (u - u0) * NF
                                            : P.fields + (size_t)u * NF,
                        res, r * P.sbh, c * P.sbw, sm);
      __syncthreads();
      if (t == 0) {
        __threadfence();
        st_release(row_done, c + 1);
      }
    }
  }
}

}  // namespace

// Launch the wavefront over the np planes of one frame on `stream`:
// fields[p] [n_p, NF] int32, resid[p] [ph_p, pw_p] int16, out[p]
// [ph_p, pw_p] int32 (the base, reconstructed in place), spans[p]
// [rows * cols, 2] int32, the SB extent (sbh[p], sbw[p]) in each plane,
// masks[p] [n, ms[p], ms[p]] int32 interintra masks or null; counters
// [1 + np * rows] int32, zeroed; scan: nonzero when the frame may have
// intrabc or interintra units (the kernel without them is faster).  One
// CTA per SB row, at most one per SM.  Returns the cudaError_t of the
// launch.
extern "C" int intra_strip_frame_launch(int np, const void* const* fields,
                                        const void* const* resid,
                                        void* const* out,
                                        const void* const* spans,
                                        const int* ph, const int* pw,
                                        const int* sbh, const int* sbw,
                                        const void* const* masks,
                                        const int* ms,
                                        int rows, int cols, int cfl, int scan,
                                        void* counters, const void* sm_weights,
                                        const void* fi_taps, int bd,
                                        void* stream) {
  if (np < 1 || np > 3 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  Args a = {};
  for (int p = 0; p < np; ++p)
    a.p[p] = {static_cast<const int32_t*>(fields[p]),
              static_cast<const int16_t*>(resid[p]),
              static_cast<int32_t*>(out[p]),
              static_cast<const int32_t*>(spans[p]),
              static_cast<const int32_t*>(masks[p]), ph[p], pw[p], sbh[p],
              sbw[p], ms[p]};
  a.np = np;
  a.rows = rows;
  a.cols = cols;
  a.cfl = cfl;
  a.counters = static_cast<int*>(counters);
  a.sm_weights = static_cast<const int32_t*>(sm_weights);
  a.fi_taps = static_cast<const int32_t*>(fi_taps);
  a.bd = bd;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  void (*kernel)(Args) = scan ? intra_wavefront_kernel<true>
                              : intra_wavefront_kernel<false>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DYN_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = np * rows < sms ? np * rows : sms;
  kernel<<<grid, THREADS, DYN_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
