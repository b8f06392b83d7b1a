// Intra pred-unit executor for Hopper (sm_90a): one launch a frame, a
// superblock wavefront, and inside each superblock the units of a
// dependency level at once, a warp each.
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
// bounds it in fact is the dependency path: a unit reads pixels that
// earlier units wrote (its corner, above and above-right, left and
// below-left), and each step of the path costs a unit's latency, a
// microsecond or so, whatever its size.  The path is the SB wavefront's
// (below) times, in each SB on it, the SB's dependency levels: a unit's
// level is 1 + the highest level of the units of its own SB whose
// pixels it reads (intra_strip.sb_schedule, av1_strip_levels).  On the
// 4K 10-bit key frame the SBs on the wavefront's path hold 15,679 luma
// units in 5,528 levels; on the 1080p grain key frame 19,991 in 5,491.
// Units of one level read nothing of each other, so a level is one step
// however many units it holds: the units-in-decode-order chain of the
// earlier design was 2.8 and 3.6 times longer.  On an H100 (700 W) the
// two key frames take 10.9 and 11.4 ms, about 2.0 us a level of that
// path, against 28.0 and 38.1 ms in decode order (PERF.md).
//
// The SB wavefront.  A unit reads only its own SB, the SB to its left,
// the SB row above from the corner to the above-right SB (c - 1 ..
// c + 1), and, for chroma CfL, the luma of the same SB.  So SB (r, c)
// may run once SB (r, c - 1) and SB (r - 1, c + 1) are done: C + 2 (R -
// 1) SB steps instead of all R C SBs of a plane.  The host gives each
// plane's units per SB as [begin, end) spans of its records in decode
// order, and where the SB's level order lies (spans[4]: begin, end,
// offset into `order`, levels); one SB covering the whole plane with no
// levels is the sequential schedule, every unit in record order.
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
// count of finished SBs, the SBs without units up to the row's next SB
// with units among them.  An SB without units (an inter frame's SBs are
// mostly such) is passed over: nothing staged, no wait, no barrier; it
// counts as finished once the SB with units before it has.  That is
// exact: it writes no pixel, and its pixels are the base, final before
// the launch, so whoever waits for it reads what it would have read
// after it.  A frame without units is not launched at all
// (intra_strip.strip_exec_frame).  An intrabc source may lie anywhere
// above its unit, which this order does not cover: intrabc frames take
// the sequential schedule, one SB a plane.  The scan's units (intrabc,
// interintra) are compiled into a second instantiation of the kernel,
// which the host picks for frames that may have them (a sequential
// schedule, or interintra masks).  L1 is not coherent across SMs, so
// every pixel of the plane is read through L2 (__ldcg); only the
// inputs, which no launch writes, may be cached.  U and V run one SB
// behind luma in the same launch.
//
// Inside an SB, level by level: each of the 8 warps takes every 8th
// unit of the level that covers at most 256 pixels (and whose CfL block
// does, if it has one) and runs it alone: its edges, filter patches and
// CfL AC block in the warp's own shared memory, __syncwarp() and
// shuffles in place of barriers; a __syncthreads(); then the whole CTA
// runs the level's larger units one after another, as the earlier
// design ran every unit.  An SB whose levels hold a unit each, or whose
// units are all too large for a warp, gains nothing from its levels and
// runs its units in record order on the whole CTA, as the sequential
// schedule does.  Before its levels, an SB marks the 4x4
// cells its units write, and which of its units the CTA takes.  The
// SB's reconstructed pixels are also kept in a shared tile (uint16): an
// edge pixel in a marked cell comes from the tile (its writer, of a
// lower level, has run), any other (other SBs, the base under inter
// blocks) from the plane.  A warp taking units as soon as the cells they
// read are written, off a ready map in place of the level barriers, was
// slower: the waiting warps took the working ones' issue slots
// (tools/torch_strip_variants.py, PERF.md).  The SB's first RECS
// records, its level order and its residual tile are staged in shared
// memory by asynchronous copies (cp.async) issued for the row's next SB
// with units while SB c computes, and its further records are prefetched
// into L2; 4-byte copies, because records (120 bytes) and residual rows
// (2 pw bytes) are not 16-byte aligned in general, as TMA bulk copies
// need.  The TPU kernel's 0/1 selection matmuls and lane rolls are plain
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
constexpr int NW = THREADS / 32;   // warps
constexpr int OFF = 2;       // edge slot of the first pixel (exec_ref.OFF)
constexpr int EDGE = 272;    // >= exec_ref's edge length for w, h <= 64
constexpr int AC_MAX = 4096; // CfL AC block (ac_w * ac_h)
constexpr int RECS = 320;    // records of an SB staged in shared memory
constexpr int SB_MAX = 128;  // the largest SB side with a pixel tile
constexpr int RES_MAX = SB_MAX * SB_MAX;  // residual tile staged (int16)
// an SB's level order: its units and the end of each level, at most
// two a 4x4 cell
constexpr int ORD_MAX = 2 * RES_MAX / 16;
constexpr int UNITS_MAX = RES_MAX / 16;   // an SB's units (4x4 at least)
// a unit runs on one warp when it and its CfL AC block cover at most
// WARP_PX pixels: then its edges have at most 2 * 64 + 5 entries, and
// its filter-intra buffer (w + 1) (h + 1) <= 297 (w, h <= 32)
constexpr int WARP_PX = 256;
constexpr int SCR = 300;     // a warp's AC block or filter-intra buffer
constexpr int WARP_INTS = 2 * EDGE + SCR;
// the CTA's edges, AC block and filter-intra buffer (33 x 33) share the
// warps' scratch: the CTA runs a unit only between the warps' turns
constexpr int CTA_INTS = 2 * EDGE + AC_MAX + 33 * 33;
static_assert(CTA_INTS <= NW * WARP_INTS, "CTA scratch");
// dynamic shared memory: two stages of records, residual and level
// order, the pixel tile, the scratch
constexpr int DYN_BYTES = 2 * (RECS * NF * 4 + RES_MAX * 2 + ORD_MAX * 4)
                          + RES_MAX * 2 + NW * WARP_INTS * 4;

struct Plane {
  const int32_t* fields;  // [n, NF]
  const int16_t* resid;   // [ph, pw]
  int32_t* out;           // [ph, pw]
  const int32_t* spans;   // [rows * cols, 4]: see the note
  const int32_t* masks;   // [n, ms, ms] interintra masks, or null
  int ph, pw;
  int sbh, sbw;           // SB extent in this plane
  int ms;                 // side of a mask
};

struct Args {
  Plane p[3];
  const int32_t* order;   // every SB's level order
  int np, rows, cols;
  int cfl;                // chroma CfL reads the luma plane (4:2:0)
  int* counters;          // [0] row ticket; [1 + p rows + r] SBs done
  const int32_t* sm_weights;  // [124]
  const int32_t* fi_taps;     // [5, 8, 8]
  int bd;
};

// The SB's reconstructed pixels: px[(y - y0) * w + x - x0], where the
// bit (x - x0) / 4 of cover[(y - y0) / 4] is set (the SB's units' cells;
// the others keep the plane's pixels); px null: no tile
struct Tile {
  uint16_t* px;
  unsigned* cover;   // a bit a 4x4 cell that a unit of the SB writes
  int y0, x0, h, w;
};

// A unit's shared scratch: edges, CfL AC block, filter-intra buffer
struct Team {
  int* above;
  int* left;
  int* ac;
  int* w9;
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

// a team is one warp (NT = 32) or the whole CTA
template <int NT>
__device__ __forceinline__ void team_sync() {
  if constexpr (NT == 32) __syncwarp();
  else __syncthreads();
}

// the sum of v over the team, to every thread of it
template <int NT>
__device__ __forceinline__ int team_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (NT == 32) {
    return v;
  } else {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int k = 0; k < NT / 32; ++k) s += red[k];
    __syncthreads();                   // red is rewritten by the next sum
    return s;
  }
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

// a reconstructed pixel: the SB's tile where a unit of the SB wrote it,
// else the plane
__device__ __forceinline__ int pixel(const int32_t* buf, int pw,
                                     const Tile& tl, int yy, int xx) {
  const unsigned ty = yy - tl.y0, tx = xx - tl.x0;
  if (tl.px && ty < unsigned(tl.h) && tx < unsigned(tl.w)
      && (tl.cover[ty >> 2] >> (tx >> 2) & 1u))
    return tl.px[ty * tl.w + tx];
  return __ldcg(buf + yy * pw + xx);
}

// the team's unit: a warp's unit covers at most WARP_PX pixels, and so
// does its CfL AC block
__device__ __forceinline__ bool on_warp(const int* f) {
  return f[F_W] * f[F_H] <= WARP_PX
         && (f[F_CLS] != K_CFL || f[F_ALPHA] == 0
             || f[F_ACW] * f[F_ACH] <= WARP_PX);
}

// One unit of plane P by a team of NT threads (t: the thread's index in
// it), its scratch tm; ends with team_sync<NT>(), so that the team may
// take its next unit.
// f: its record (staged or in global memory); res: the SB's staged
// residual tile with origin (y0, x0) and row pitch P.sbw, or null; tl:
// the SB's pixel tile (origin (y0, x0) too), written beside the plane.
// kScan: compile in the scan's units (intrabc copy, interintra blend).
template <bool kScan, int NT>
__device__ __forceinline__ void run_unit(const Args& a, const Plane& P,
                                         const int* f, const int16_t* res,
                                         const Tile& tl, int y0, int x0,
                                         const Team& tm, int* red, int t) {
  // edge pixels a thread filters or upsamples: sz <= w + h + 1, at most
  // 69 on a warp's unit and 129 on the CTA's
  constexpr int PER = NT == 32 ? 3 : 1;
  const int ph = P.ph, pw = P.pw;
  const int mx = (1 << a.bd) - 1;
  const int base = 1 << (a.bd - 1);
  int32_t* buf = P.out;
  const int32_t* luma = a.p[0].out;
  const int lw = a.p[0].pw;
  int* const above = tm.above;
  int* const left = tm.left;

  const int x = f[F_X], y = f[F_Y];
  const int w = f[F_W], h = f[F_H];
  const int cls = f[F_CLS], ang = f[F_ANGLE];
  const bool ha = f[F_HA] != 0, hl = f[F_HL] != 0;
  const bool is_dir = cls == K_Z1 || cls == K_Z2 || cls == K_Z3;

  // ---- edges (exec_ref._unit: above/left/corner) ----
  // First each pixel once, all reads at the same time: the corner, the
  // na pixels above and the nl left (clamped to the plane); then the
  // repeats past them, and the fills of an edge that is not available.
  const int na = f[F_NA], nl = f[F_NL];
  const int esz = OFF + 2 * (2 * max(w, h) + 1) + 2;
  for (int i = t; i < OFF + max(na, nl); i += NT) {
    if (i == OFF - 1) {
      int c = base;
      if (ha && hl) c = pixel(buf, pw, tl, y - 1, x - 1);
      else if (ha) c = pixel(buf, pw, tl, y - 1, x);
      else if (hl) c = pixel(buf, pw, tl, y, x - 1);
      above[i] = left[i] = c;
    } else if (i < OFF) {
      above[i] = left[i] = 0;
    } else {
      if (ha && i - OFF < na)
        above[i] = pixel(buf, pw, tl, y - 1, min(x + i - OFF, pw - 1));
      if (hl && i - OFF < nl)
        left[i] = pixel(buf, pw, tl, min(y + i - OFF, ph - 1), x - 1);
    }
  }
  team_sync<NT>();
  const int corner = above[OFF - 1];
  const int fill_a = hl ? left[OFF] : base - 1;
  const int fill_l = ha ? above[OFF] : base + 1;
  const int last_a = above[OFF + na - 1], last_l = left[OFF + nl - 1];
  for (int i = t; i < esz; i += NT) {
    if (i == OFF - 1) continue;
    if (!ha) above[i] = fill_a;
    else if (i >= OFF + na) above[i] = last_a;
    if (!hl) left[i] = fill_l;
    else if (i >= OFF + nl) left[i] = last_l;
  }
  team_sync<NT>();

  // ---- directional edge prep: corner filter, edge filter, upsample ----
  const int ua = is_dir && f[F_UA] != 0;
  const int ul = is_dir && f[F_UL] != 0;
  if (is_dir) {
    if (f[F_CF]) {
      const int s = (left[OFF] * 5 + above[OFF - 1] * 6 + above[OFF] * 5 + 8) >> 4;
      team_sync<NT>();
      if (t == 0) above[OFF - 1] = left[OFF - 1] = s;
      team_sync<NT>();
    }
    const int sa = f[F_SA], sl = f[F_SL];
    const int sza = f[F_NPXA], szl = f[F_NPXL];
    const bool fa = ha && sa != 0 && sza > 1;
    const bool fl = hl && sl != 0 && szl > 1;
    if (fa || fl) {
      int va[PER], vl[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = t + k * NT;
        va[k] = fa && i >= 1 && i < sza ? edge_tap(above, sza, sa, i) : 0;
        vl[k] = fl && i >= 1 && i < szl ? edge_tap(left, szl, sl, i) : 0;
      }
      team_sync<NT>();
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = t + k * NT;
        if (fa && i >= 1 && i < sza) above[OFF - 1 + i] = va[k];
        if (fl && i >= 1 && i < szl) left[OFF - 1 + i] = vl[k];
      }
      team_sync<NT>();
    }
    if (ua || ul) {
      const int nua = w + (ang < 90 ? h : 0);
      const int nul = h + (ang > 180 ? w : 0);
      int sa_v[PER], pa_v[PER], sl_v[PER], pl_v[PER];
      const int ca = above[OFF - 1], cl = left[OFF - 1];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = t + k * NT;
        sa_v[k] = pa_v[k] = sl_v[k] = pl_v[k] = 0;
        if (ua && i < nua) {
          const int v = -dup_at(above, nua, i) + 9 * dup_at(above, nua, i + 1)
                      + 9 * dup_at(above, nua, i + 2) - dup_at(above, nua, i + 3);
          sa_v[k] = clampi((v + 8) >> 4, 0, mx);
          pa_v[k] = above[OFF + i];
        }
        if (ul && i < nul) {
          const int v = -dup_at(left, nul, i) + 9 * dup_at(left, nul, i + 1)
                      + 9 * dup_at(left, nul, i + 2) - dup_at(left, nul, i + 3);
          sl_v[k] = clampi((v + 8) >> 4, 0, mx);
          pl_v[k] = left[OFF + i];
        }
      }
      team_sync<NT>();
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = t + k * NT;
        if (ua && i < nua) {
          above[OFF - 1 + 2 * i] = sa_v[k];
          above[OFF + 2 * i] = pa_v[k];
        }
        if (ul && i < nul) {
          left[OFF - 1 + 2 * i] = sl_v[k];
          left[OFF + 2 * i] = pl_v[k];
        }
      }
      if (t == 0) {
        if (ua) above[OFF - 2] = ca;
        if (ul) left[OFF - 2] = cl;
      }
      team_sync<NT>();
    }
  }

  // ---- DC average (DC and CfL) ----
  int dc = base;
  if (cls == K_DC || cls == K_CFL) {
    int sum = 0;
    if (ha)
      for (int i = t; i < w; i += NT) sum += above[OFF + i];
    if (hl)
      for (int i = t; i < h; i += NT) sum += left[OFF + i];
    sum = team_sum<NT>(sum, red);
    const int n = (ha ? w : 0) + (hl ? h : 0);
    if (n) dc = (sum + (n >> 1)) / n;
  }

  // ---- CfL AC block from the finished luma (4:2:0) ----
  const int alpha = f[F_ALPHA];
  const bool cfl = cls == K_CFL && alpha != 0;
  const int acx = f[F_ACX], acy = f[F_ACY];
  const int acw = f[F_ACW], ach = f[F_ACH];
  int avg = 0;
  if (cfl) {
    int part = 0;
    for (int k = t; k < acw * ach; k += NT) {
      const int r = k / acw, c = k - r * acw;
      const int32_t* l0 = luma + (size_t)(2 * (acy + r)) * lw + 2 * (acx + c);
      const int v = (__ldcg(l0) + __ldcg(l0 + 1) + __ldcg(l0 + lw)
                     + __ldcg(l0 + lw + 1)) << 1;
      tm.ac[k] = v;
      part += v;
    }
    const int tot = team_sum<NT>(part, red);
    const int l2 = (31 - __clz(max(acw, 1))) + (31 - __clz(max(ach, 1)));
    avg = (tot + (1 << max(l2 - 1, 0))) >> l2;
  }

  // ---- filter-intra: 4x2 patches on anti-diagonal wavefronts ----
  const int s9 = w + 1;              // the buffer's row pitch
  if (cls == K_FILT) {
    int* const w9 = tm.w9;
    for (int k = t; k <= w; k += NT) w9[k] = k == 0 ? corner : above[OFF + k - 1];
    for (int k = t; k < h; k += NT) w9[(k + 1) * s9] = left[OFF + k];
    team_sync<NT>();
    const int n_w = w >> 2, n_h = h >> 1;
    const int k = t & 7;
    // the thread's output pixel k of a patch: its 7 taps
    const int32_t* tk = a.fi_taps + clampi(ang, 0, 4) * 64 + k * 8;
    int tap[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) tap[q] = __ldg(tk + q);
    // patch (i, j) reads patches (i-1, j-1), (i-1, j) and (i, j-1):
    // every patch of the diagonal i + j = d runs at once, NT / 8 a turn
    for (int d = 0; d < n_w + n_h - 1; ++d) {
      const int i1 = min(d, n_h - 1);
      for (int i = max(0, d - n_w + 1) + (t >> 3); i <= i1; i += NT / 8) {
        const int j = d - i;
        const int y9 = 2 * i, x9 = 4 * j;
        const int* r0 = w9 + y9 * s9 + x9;
        const int s = tap[0] * r0[0] + tap[1] * r0[1] + tap[2] * r0[2]
                    + tap[3] * r0[3] + tap[4] * r0[4] + tap[5] * r0[s9]
                    + tap[6] * r0[2 * s9];
        w9[(y9 + 1 + (k >> 2)) * s9 + x9 + 1 + (k & 3)] = clampi((s + 8) >> 4, 0, mx);
      }
      team_sync<NT>();
    }
  }
  team_sync<NT>();

  // ---- predict, CfL, blend clip(pred + residual) into the plane ----
  const int cw = min(w, pw - x), chh = min(h, ph - y);
  const int offx = x - acx, offy = y - acy;
  const int oh = min(h, ach - offy), ow = min(w, acw - offx);
  const int ua_sh = 6 - ua, ul_sh = 6 - ul;
  const int dx = f[F_DX], dy = f[F_DY];
  // intrabc taps (across: F_SA, F_SL; down: F_UA, F_UL); interintra mask
  const int ib_h0 = f[F_SA], ib_h1 = f[F_SL], ib_v0 = f[F_UA], ib_v1 = f[F_UL];
  const int mi = f[F_RES];
  // rows of a power-of-two width by a shift (all but units the plane's
  // edge clips)
  const int lg_cw = (cw & (cw - 1)) == 0 ? __ffs(cw) - 1 : -1;
#pragma unroll 2
  for (int k = t; k < cw * chh; k += NT) {
    const int i = lg_cw >= 0 ? k >> lg_cw : k / cw, j = k - i * cw;
    int p;
    switch (cls) {
      case K_DC:
      case K_CFL:
        p = dc;
        break;
      case K_V:
        p = above[OFF + j];
        break;
      case K_H:
        p = left[OFF + i];
        break;
      case K_PAETH: {
        const int bv = above[OFF + j], lv = left[OFF + i];
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
        const int below = left[OFF + h - 1], right = above[OFF + w - 1];
        if (cls == K_SM)
          p = (wy * above[OFF + j] + (256 - wy) * below + wx * left[OFF + i]
               + (256 - wx) * right + 256) >> 9;
        else if (cls == K_SMV)
          p = (wy * above[OFF + j] + (256 - wy) * below + 128) >> 8;
        else
          p = (wx * left[OFF + i] + (256 - wx) * right + 128) >> 8;
        break;
      }
      case K_Z1: {
        const int max_base = (w + h - 1) << ua;
        const int idx = (i + 1) * dx;
        const int b = (idx >> ua_sh) + (j << ua);
        const int sh = ((idx << ua) >> 1) & 0x1F;
        p = b >= max_base ? above[OFF + max_base] : interp(above, b, sh);
        break;
      }
      case K_Z3: {
        const int max_base = (w + h - 1) << ul;
        const int idy = (j + 1) * dy;
        const int b = (idy >> ul_sh) + (i << ul);
        const int sh = ((idy << ul) >> 1) & 0x1F;
        p = b >= max_base ? left[OFF + max_base] : interp(left, b, sh);
        break;
      }
      case K_Z2: {
        const int idx = j * 64 - (i + 1) * dx;
        const int b = idx >> ua_sh;
        if (b >= -(1 << ua)) {
          p = interp(above, max(b, -2), (idx * (1 << ua) >> 1) & 0x1F);
        } else {
          const int idy = i * 64 - (j + 1) * dy;
          p = interp(left, max(idy >> ul_sh, -2), (idy * (1 << ul) >> 1) & 0x1F);
        }
        break;
      }
      case K_FILT:
        p = tm.w9[(i + 1) * s9 + j + 1];
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
      const int d = alpha * (tm.ac[(offy + i) * acw + offx + j] - avg);
      const int sc = d < 0 ? -((-d + 32) >> 6) : ((d + 32) >> 6);
      p = clampi(p + sc, 0, mx);
    }
    const int o = (y + i) * pw + x + j;
    if (kScan && mi > 0) {  // interintra: blend with the base (MC)
      const int m = __ldg(P.masks + ((size_t)(mi - 1) * P.ms + i) * P.ms + j);
      p = (p * m + __ldcg(buf + o) * (64 - m) + 32) >> 6;
    }
    const int rv = res ? res[(y + i - y0) * P.sbw + x + j - x0] : P.resid[o];
    const int v = clampi(p + rv, 0, mx);
    buf[o] = v;
    if (tl.px) tl.px[(y + i - tl.y0) * tl.w + x + j - tl.x0] = v;
  }
  team_sync<NT>();
}

// The 4x4 cells of unit f on the tile: the bits of its rows r0..r1 of
// the cover map (its extent clipped to the plane)
struct Cells {
  int r0, r1;
  unsigned bits;
};

__device__ __forceinline__ Cells unit_cells(const int* f, const Plane& P,
                                            const Tile& tl) {
  const int x = f[F_X], y = f[F_Y];
  const int cw = min(f[F_W], P.pw - x), chh = min(f[F_H], P.ph - y);
  const int c0 = (x - tl.x0) >> 2, c1 = (x - tl.x0 + cw - 1) >> 2;
  return {(y - tl.y0) >> 2, (y - tl.y0 + chh - 1) >> 2,
          ((2u << (c1 - c0)) - 1u) << c0};
}

// The first SB of row r from c on that holds units (its span's end is
// past its begin), or a.cols: each warp reads 32 spans at once.  Every
// thread of the CTA calls it and gets the same answer, so the CTA takes
// one branch.
__device__ __forceinline__ int next_occupied(const Args& a, const Plane& P,
                                             int r, int c) {
  const int32_t* sp = P.spans + 4 * r * a.cols;
  for (; c < a.cols; c += 32) {
    const int k = c + (threadIdx.x & 31);
    const unsigned held = __ballot_sync(
        0xffffffffu, k < a.cols && __ldg(sp + 4 * k + 1) != __ldg(sp + 4 * k));
    if (held) return c + __ffs(held) - 1;
  }
  return a.cols;
}

// Issue the asynchronous copies of SB (r, c)'s first RECS records, of
// its level order and, when res is not null, of its residual tile
// (pitch P.sbw), as one committed group; prefetch its further records
// into L2.  4-byte copies: records are 120 bytes and residual rows 2 pw
// bytes, so 16-byte bulk copies would not line up.
__device__ __forceinline__ void stage(const Args& a, const Plane& P, int r,
                                      int c, int* rec, int16_t* res,
                                      int* ord) {
  const int t = threadIdx.x;
  const int32_t* sp = P.spans + 4 * (r * a.cols + c);
  const int u0 = __ldg(sp), n = __ldg(sp + 1) - u0;
  const int o0 = __ldg(sp + 2), nl = __ldg(sp + 3);
  const int32_t* src = P.fields + (size_t)u0 * NF;
  for (int k = t; k < min(n, RECS) * NF; k += THREADS)
    __pipeline_memcpy_async(rec + k, src + k, 4);
  const char* more = reinterpret_cast<const char*>(src + RECS * NF);
  for (int k = t; k < (max(n - RECS, 0) * NF * 4 + 127) / 128; k += THREADS)
    asm volatile("prefetch.global.L2 [%0];" :: "l"(more + 128 * k));
  if (nl)
    for (int k = t; k < min(n + nl, ORD_MAX); k += THREADS)
      __pipeline_memcpy_async(ord + k, a.order + o0 + k, 4);
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
  __shared__ int ticket;
  __shared__ int red[NW];
  __shared__ unsigned cover[SB_MAX / 4];
  __shared__ unsigned on_cta[UNITS_MAX / 32];  // by place in the order
  extern __shared__ __align__(16) unsigned char dyn[];
  int* const recs = reinterpret_cast<int*>(dyn);                 // [2][RECS NF]
  int16_t* const ress = reinterpret_cast<int16_t*>(recs + 2 * RECS * NF);
  int* const ords = reinterpret_cast<int*>(ress + 2 * RES_MAX);  // [2][ORD_MAX]
  uint16_t* const tile = reinterpret_cast<uint16_t*>(ords + 2 * ORD_MAX);
  int* const scratch = reinterpret_cast<int*>(tile + RES_MAX);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const Team cta = {scratch, scratch + EDGE, scratch + 2 * EDGE,
                    scratch + 2 * EDGE + AC_MAX};
  int* const mine = scratch + warp * WARP_INTS;
  // a warp's unit is CfL or filter-intra, not both: one scratch
  const Team wt = {mine, mine + EDGE, mine + 2 * EDGE, mine + 2 * EDGE};
  int* const done = a.counters + 1;
  const int n_rows = a.np * a.rows;
  for (;;) {
    if (t == 0) ticket = atomicAdd(a.counters, 1);
    __syncthreads();
    const int tk = ticket;
    __syncthreads();                   // ticket is rewritten next row
    if (tk >= n_rows) return;
    const int r = tk / a.np, pl = tk - r * a.np;
    const Plane P = a.p[pl];
    int* const row_done = done + pl * a.rows + r;
    // a tile too large to stage (a sequential schedule's whole plane)
    // is read from global memory
    const bool tiled = P.sbh * P.sbw <= RES_MAX;
    const bool mapped = P.sbh <= SB_MAX && P.sbw <= SB_MAX;
    // the row's first SB with units: the SBs before it are done as they
    // stand; it is staged now, each next one while the one before it
    // computes
    int c = next_occupied(a, P, r, 0);
    if (t == 0 && c > 0) st_release(row_done, c);
    if (c < a.cols) stage(a, P, r, c, recs, tiled ? ress : nullptr, ords);
    for (int b = 0; c < a.cols; b ^= 1) {
      if (t == 0) {
        if (r > 0) wait_at_least(row_done - 1, min(c + 2, a.cols));
        if (a.cfl && pl > 0) wait_at_least(done + r, c + 1);
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      // the next SB with units: its copies run while SB c computes
      const int cn = next_occupied(a, P, r, c + 1), nb = b ^ 1;
      if (cn < a.cols)
        stage(a, P, r, cn, recs + nb * RECS * NF,
              tiled ? ress + nb * RES_MAX : nullptr, ords + nb * ORD_MAX);
      const int* rec = recs + b * RECS * NF;
      const int16_t* res = tiled ? ress + b * RES_MAX : nullptr;
      const int* ord = ords + b * ORD_MAX;
      const int32_t* sp = P.spans + 4 * (r * a.cols + c);
      const int u0 = __ldg(sp), n = __ldg(sp + 1) - u0;
      const int o0 = __ldg(sp + 2), nl = __ldg(sp + 3);
      const int y0 = r * P.sbh, x0 = c * P.sbw;
      auto record = [&](int k) {
        return k < RECS ? rec + k * NF : P.fields + (size_t)(u0 + k) * NF;
      };
      const Tile tl = {mapped ? tile : nullptr, cover, y0, x0, P.sbh, P.sbw};
      auto order = [&](int k) {
        return k < ORD_MAX ? ord[k] : __ldg(a.order + o0 + k);
      };
      // Level by level where some level of the SB holds two units or more
      // and some unit fits a warp: the cells of the SB's units, and its
      // units (by place in the order) too large for a warp
      bool levels = nl > 0 && nl < n && n <= UNITS_MAX;
      if (levels) {
        if (t < SB_MAX / 4) cover[t] = 0;
        if (t < UNITS_MAX / 32) on_cta[t] = 0;
        __syncthreads();
        int big = 0;
        for (int k = t; k < n; k += THREADS) {
          const int* f = record(order(k));
          if (!on_warp(f)) {
            atomicOr(on_cta + (k >> 5), 1u << (k & 31));
            ++big;
          }
          if (tl.px) {
            const Cells cl = unit_cells(f, P, tl);
            for (int q = cl.r0; q <= cl.r1; ++q) atomicOr(cover + q, cl.bits);
          }
        }
        levels = __syncthreads_count(big) < n;
      }
      if (!levels) {                   // record order, a unit at a time
        const Tile none = {nullptr, nullptr, 0, 0, 0, 0};
        for (int k = 0; k < n; ++k)
          run_unit<kScan, THREADS>(a, P, record(k), res, none, y0, x0, cta,
                                   red, t);
      } else {
        for (int l = 0, kb = 0; l < nl; ++l) {
          const int ke = order(n + l);
          for (int k = kb + warp; k < ke; k += NW)
            if (!(on_cta[k >> 5] >> (k & 31) & 1u))
              run_unit<kScan, 32>(a, P, record(order(k)), res, tl, y0, x0, wt,
                                  red, lane);
          __syncthreads();
          for (int k = kb; k < ke; ++k)
            if (on_cta[k >> 5] >> (k & 31) & 1u)
              run_unit<kScan, THREADS>(a, P, record(order(k)), res, tl, y0, x0,
                                       cta, red, t);
          kb = ke;
        }
      }
      __syncthreads();
      if (t == 0) {
        __threadfence();
        st_release(row_done, cn);      // SB c and the SBs after it without
                                       // units
      }
      c = cn;
    }
  }
}

}  // namespace

// Launch the wavefront over the np planes of one frame on `stream`:
// fields[p] [n_p, NF] int32, resid[p] [ph_p, pw_p] int16, out[p]
// [ph_p, pw_p] int32 (the base, reconstructed in place), spans[p]
// [rows * cols, 4] int32 (each SB's records [begin, end), and the
// offset in `order` and count of its levels), order: every SB's level
// order (intra_strip.sb_schedule), the SB extent (sbh[p], sbw[p]) in
// each plane, masks[p] [n, ms[p], ms[p]] int32 interintra masks or
// null; counters [1 + np * rows] int32, zeroed; scan: nonzero when the
// frame may have intrabc or interintra units (the kernel without them
// is faster).  One CTA per SB row, at most one per SM.  Returns the
// cudaError_t of the launch.
extern "C" int intra_strip_frame_launch(int np, const void* const* fields,
                                        const void* const* resid,
                                        void* const* out,
                                        const void* const* spans,
                                        const void* order,
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
  a.order = static_cast<const int32_t*>(order);
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
