// CDEF for Hopper (sm_90a): the direction search of every 8x8 luma unit,
// and the primary and secondary filter of every plane of a frame, over
// int32 planes [S, ph, pw] (S independent streams), each in one launch.
//
// Replaces easyav1_tpu/video/av1/recon/cdef_jax.py:245-279 (_dirs_body)
// and :107-234 (_filter_body), the XLA-jitted functions that
// postfilter_fused._cdef_stage (:79-110) runs on the deblocked planes.
// Their plain versions are the port's recon/cdef_torch.py::find_dirs
// and ::filter_planes.
//
// cdef_dirs_kernel: one thread an 8x8 unit of [S, uh, uw].  A pixel
// outside the plane (the unit grid may overhang it) reads
// CDEF_VERY_LARGE; each x = (v >> coeff_shift) - 128 feeds the partial
// sum k(d, i, j) of each direction d; cost[d] = sum_k W[d, k] part^2 in
// int64 (CDEF_VERY_LARGE takes it past int32, where the JAX package's
// jitted search stops, cdef_jax.py:250-255); the first maximum wins;
// var = (cost[best] - cost[(best + 4) & 7]) >> 10, cast to int32 as the
// plain version casts it (the low 32 bits).
//
// cdef_filter_kernel: every plane of a frame in one launch.  Each pixel's
// unit (8 >> ss pixels a side in chroma) gives the strengths (already
// shifted by coeff_shift), the filter flag, the direction and the
// variance.  In luma the primary strength is scaled by the variance,
// (pri (4 + min(log2(var >> 6), 12)) + 8) >> 4, 0 where var is 0, and the
// direction gate reads the strength before that scaling; in chroma the
// direction is remapped by cdef_uv_dir[ssx][ssy].  Damping (one a
// stream, coeff_shift included) minus 1 in chroma sets the shifts
// max(damping - log2(strength), 0).  The primary taps (weights 4, 2, or
// 3, 3 where (pri >> coeff_shift) is odd) lie along the direction, the
// secondary ones (weights 2, 1) along (dir +- 2) & 7; each adds
// constrain(tap - px) and, unless it is CDEF_VERY_LARGE (a tap outside
// the plane), widens the min and max; px + ((8 + s - (s < 0)) >> 4) is
// clamped to them.  A pixel whose unit is not filtered, or has both
// strengths 0, keeps its value.  The outputs are new planes: the
// deblocked input stays for loop restoration.
//
// What bounds them on this card.  The search: bytes; it reads the luma
// plane once and writes 8 bytes a unit (8.6 MB on a 1080p frame, 2.6 us
// at 3.35 TB/s).  The filter reads each plane once and the unit maps
// once (28 bytes a unit: direction, variance, flag, two strengths a
// plane kind) and writes each plane once (26.2 MB for a 1080p 4:2:0
// frame, 7.8 us), but its integer operations, some 130 a pixel that
// takes every tap, weigh more where most units filter: 10.5 us on the
// 1080p deblocking key frame at 33.5 TOP/s.
//
// The search is the simplest design that is exact: a thread a unit,
// pixels read through the L1 cache.  The filter:
// - A CTA owns one block of 8x8 units of one plane and stream: 64x64
//   luma pixels, (64 >> ssy) x (64 >> ssx) chroma ones; the three planes'
//   blocks are sibling CTAs of one grid.
// - 64 threads, a thread a unit, first resolve the unit's parameters
//   once into shared memory, packed in 32 bytes: the strengths (luma's
//   primary scaled by the variance), the weights, both shifts and the
//   six tap offsets of its directions.
// - The block is staged with a halo of 2 rows and 4 columns (the taps
//   reach 2) in shared memory, 16 bytes at a time by cp.async where a
//   4-pixel group lies in the plane and is aligned, CDEF_VERY_LARGE
//   outside the plane: the taps then need no bound checks.  Its pitch
//   (72 words, 8 modulo 32) keeps each 4 x 8 pixels a warp reads at once
//   on 32 banks.
// - A warp filters 8 x 8 pixels, a lane two of them 4 rows apart: a luma
//   unit, so its branches (the strengths) and tap offsets are uniform in
//   luma; a warp whose pixels' units all keep their values copies them,
//   16 bytes a lane.  Minimum and maximum need no test for
//   CDEF_VERY_LARGE: it is above every sample, and its low 14 bits are
//   0.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CDEF_LAUNCH
#define CDEF_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kVeryLarge = 0x4000;
constexpr int kDirThreads = 128;
constexpr int kBlock = 64;               // luma pixels a block side
constexpr int kFilterThreads = 256;
// the pixel rows a lane filters, 4 apart: a warp's patch is 8 x 8
// pixels, a luma unit
constexpr int kRowsLane = 2;
constexpr int kPitch = 72;               // words a staged row
constexpr int kStageRows = kBlock + 4;   // 2 halo rows each side

// Cdef_Directions[d][k] = (dy, dx) of primary tap k
__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
// cdef_uv_dir[ssx][ssy][d]
__constant__ int kUvDir[2][2][8] = {
    {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
    {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};

// The partial sum of direction d that pixel (i, j) of a unit feeds.
__device__ __forceinline__ constexpr int part_index(int d, int i, int j) {
  return d == 0 ? i + j
       : d == 1 ? i + (j >> 1)
       : d == 2 ? i
       : d == 3 ? 3 + i - (j >> 1)
       : d == 4 ? 7 + i - j
       : d == 5 ? 3 - (i >> 1) + j
       : d == 6 ? j
       : (i >> 1) + j;
}

// The cost weight of partial k of direction d (cdef_torch._cost_weights).
__device__ __forceinline__ constexpr int cost_weight(int d, int k) {
  constexpr int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
  return (d == 2 || d == 6) ? (k < 8 ? 105 : 0)
       : (d == 0 || d == 4) ? (k < 7 ? kDiv[k + 1] : k == 7 ? 105
                               : kDiv[15 - k])
       : (k >= 3 && k <= 7) ? 105
       : k < 3 ? kDiv[2 * k + 2]
       : k <= 10 ? kDiv[22 - 2 * k] : 0;
}

__device__ __forceinline__ int floor_log2(int v) { return 31 - __clz(v); }

struct Dirs {
  const int* luma;   // [S, ph, pw]
  int* dir;          // [S, uh, uw]
  int* var;
  int streams, ph, pw, uh, uw, cs;
};

__global__ void __launch_bounds__(kDirThreads) cdef_dirs_kernel(Dirs a) {
  const long long u = (long long)blockIdx.x * kDirThreads + threadIdx.x;
  const long long units = (long long)a.uh * a.uw;
  if (u >= units * a.streams) return;
  const int st = (int)(u / units);
  const int rem = (int)(u - st * units);
  const int y0 = rem / a.uw * 8, x0 = rem % a.uw * 8;
  const int* src = a.luma + (size_t)st * a.ph * a.pw;
  int x[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = y0 + i, c = x0 + j;
      const int v = r < a.ph && c < a.pw ? __ldg(src + (size_t)r * a.pw + c)
                                         : kVeryLarge;
      x[i][j] = (v >> a.cs) - 128;
    }
  long long cost[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    int part[15];
#pragma unroll
    for (int k = 0; k < 15; ++k) part[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[part_index(d, i, j)] += x[i][j];
    long long c = 0;
#pragma unroll
    for (int k = 0; k < 15; ++k)
      c += (long long)cost_weight(d, k) * ((long long)part[k] * part[k]);
    cost[d] = c;
  }
  int best = 0;
  long long bc = cost[0];
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (cost[d] > bc) {
      bc = cost[d];
      best = d;
    }
  long long oc = cost[0];
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (d == ((best + 4) & 7)) oc = cost[d];
  a.dir[u] = best;
  a.var[u] = (int)(uint32_t)(uint64_t)((bc - oc) >> 10);
}

// 16-byte asynchronous copy global -> shared; the host build copies at
// once.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
#else
  memcpy(smem, gmem, 16);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

struct FPlane {
  const int* src;    // [S, ph, pw], the deblocked plane
  int* dst;
  const int* pri;    // [S, uh, uw]: this plane's strengths
  const int* sec;
  int ph, pw;
};

struct Filter {
  FPlane p[3];
  const int* dir;    // [S, uh, uw] unit maps
  const int* var;
  const int* filt;
  const int* damp;   // one a stream, or null: `damping` for all
  int damping, planes, uh, uw, blocks_x, blocks_y, ssx, ssy, bd;
};

__device__ __forceinline__ int constrain(int diff, int thr, int sh) {
  const int ad = diff < 0 ? -diff : diff;
  const int rhs = max(thr - (ad >> sh), 0);
  const int mag = min(ad, rhs);
  return diff < 0 ? -mag : mag;
}

// Two int16 in an int, and back.
__device__ __forceinline__ int pack16(int lo, int hi) {
  return (int)((uint32_t)lo & 0xffffu | (uint32_t)hi << 16);
}
__device__ __forceinline__ int lo16(int v) { return (int16_t)(v & 0xffff); }
__device__ __forceinline__ int hi16(int v) { return v >> 16; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kFilterThreads)
cdef_filter_kernel(Filter a) {
  __align__(16) __shared__ int tile[kStageRows * kPitch];
  // a unit's parameters: strengths (0, 0: it keeps its pixels), primary
  // weights, shifts, tap offsets in the tile (primary k = 0, 1; secondary
  // along dir + 2, k = 0, 1; along dir - 2, k = 0, 1)
  // a unit's parameters: {primary strength, secondary strength, shifts
  // and weights (bytes: primary shift, secondary shift, primary weights
  // of taps 0 and 1), primary tap offsets in the tile (int16 pair)},
  // {secondary tap offsets along dir + 2, along dir - 2, 0, 0}; strengths
  // (0, 0) keep the unit's pixels
  __align__(16) __shared__ int4 s_unit[64][2];
  int b = blockIdx.x;
  const int bx = b % a.blocks_x;
  b /= a.blocks_x;
  const int by = b % a.blocks_y;
  b /= a.blocks_y;
  const int pi = b % a.planes;
  const int st = b / a.planes;
  FPlane P = a.p[0];   // static indices: the parameters stay in place
  if (pi == 1) P = a.p[1];
  if (pi == 2) P = a.p[2];
  const int sx = pi ? a.ssx : 0, sy = pi ? a.ssy : 0;
  const int bw = kBlock >> sx, bh = kBlock >> sy;   // the block's pixels
  const int x0 = bx * bw, y0 = by * bh;
  const int t = threadIdx.x;
  const size_t base = (size_t)st * P.ph * P.pw;

  // 1. stage the block: 16 bytes a 4-pixel group where it lies in the
  // plane and is aligned, else a pixel at a time
  const int groups = bw / 4 + 2;
  const int* src = P.src + base;
  for (int i = t; i < (bh + 4) * groups; i += kFilterThreads) {
    const int r = i / groups, g = i % groups;
    const int y = y0 - 2 + r, x = x0 - 4 + 4 * g;
    int* s = tile + r * kPitch + 4 * g;
    const int* row = src + (size_t)y * P.pw;
    if (y >= 0 && y < P.ph && x >= 0 && x + 3 < P.pw
        && aligned16(row + x)) {
      cp_async16(s, row + x);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[k] = y >= 0 && y < P.ph && x + k >= 0 && x + k < P.pw
                   ? __ldg(row + x + k) : kVeryLarge;
    }
  }

  // 2. each unit's parameters, a thread a unit
  if (t < 64) {
    const int uy = by * 8 + t / 8, ux = bx * 8 + t % 8;
    int pri = 0, sec = 0, pdir = 0, pdamp = 0;
    if (uy < a.uh && ux < a.uw) {
      const size_t u = ((size_t)st * a.uh + uy) * a.uw + ux;
      if (__ldg(a.filt + u) != 0) {
        pri = __ldg(P.pri + u);
        sec = __ldg(P.sec + u);
      }
      const int dir = __ldg(a.dir + u) & 7;
      if (pi == 0) {
        const int var = __ldg(a.var + u);
        const int i = min(floor_log2(max(var >> 6, 1)), 12);
        const int adj = var != 0 ? (pri * (4 + i) + 8) >> 4 : 0;
        pdir = pri != 0 ? dir : 0;   // the strength before the scaling
        pri = pri != 0 ? adj : 0;
      } else {
        pdir = pri != 0 ? kUvDir[a.ssx][a.ssy][dir] : 0;
      }
      pdamp = (a.damp ? __ldg(a.damp + st) : a.damping) - (pi ? 1 : 0);
    }
    const int odd = (pri >> (a.bd - 8)) & 1;
    const int psh = max(pdamp - floor_log2(max(pri, 1)), 0);
    const int ssh = max(pdamp - floor_log2(max(sec, 1)), 0);
    const int dirs[3] = {pdir, (pdir + 2) & 7, (pdir + 6) & 7};
    int off[6];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        off[2 * d + k] = kDirs[dirs[d]][k][0] * kPitch + kDirs[dirs[d]][k][1];
    s_unit[t][0] = make_int4(pri, sec, psh | ssh << 8 | (odd ? 3 : 4) << 16
                             | (odd ? 3 : 2) << 24, pack16(off[0], off[1]));
    s_unit[t][1] = make_int4(pack16(off[2], off[3]), pack16(off[4], off[5]),
                             0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. a warp filters 4 kRowsLane x 8 pixels at a time (lane: rows
  // lane / 8 + 4i, column lane % 8)
  const int lane = t & 31, warp = t >> 5;
  const int ux_log = 3 - sx, uy_log = 3 - sy;
  constexpr int kRows = 4 * kRowsLane;
  const int pxs = bw / 8, patches = pxs * (bh / kRows);
  int* dst = P.dst + base;
  for (int q = warp; q < patches; q += kFilterThreads / 32) {
    const int py = q / pxs * kRows, px = q % pxs * 8;   // in the block
    // the patch's units: at most 2 x 2
    const int ra = py >> uy_log, rb = (py + kRows - 1) >> uy_log;
    const int ua = px >> ux_log, ub = (px + 7) >> ux_log;
    const bool keep = (s_unit[ra * 8 + ua][0].x | s_unit[ra * 8 + ua][0].y
                       | s_unit[ra * 8 + ub][0].x | s_unit[ra * 8 + ub][0].y
                       | s_unit[rb * 8 + ua][0].x | s_unit[rb * 8 + ua][0].y
                       | s_unit[rb * 8 + ub][0].x | s_unit[rb * 8 + ub][0].y)
                      == 0;
    if (keep) {
      // every pixel keeps its value: 16 bytes a lane
      if (lane < 2 * kRows) {
        const int r = py + (lane >> 1), c = px + 4 * (lane & 1);
        const int y = y0 + r, x = x0 + c;
        const int* s = tile + (r + 2) * kPitch + c + 4;
        int* d = dst + (size_t)y * P.pw + x;
        if (y < P.ph && x + 3 < P.pw && aligned16(d)) {
          *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(s);
        } else if (y < P.ph) {
          for (int k = 0; k < 4 && x + k < P.pw; ++k) d[k] = s[k];
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < kRowsLane; ++i) {
      const int r = py + (lane >> 3) + 4 * i, c = px + (lane & 7);
      const int y = y0 + r, x = x0 + c;
      const int u = (r >> uy_log) * 8 + (c >> ux_log);
      const int* s = tile + (r + 2) * kPitch + c + 4;
      const int v = s[0];
      const int4 u0 = s_unit[u][0];
      const int pri = u0.x, sec = u0.y;
      int out = v;
      if (pri != 0 || sec != 0) {
        int sum = 0, mx = v, mn = v;
        // samples lie below CDEF_VERY_LARGE (0x4000): min passes it
        // over, and its low bits (0) leave the max as it is
        auto tap = [&](int off, int w, int thr, int sh) {
          const int tv = s[off];
          sum += w * constrain(tv - v, thr, sh);
          mx = max(mx, tv & (kVeryLarge - 1));
          mn = min(mn, tv);
        };
        if (pri != 0) {
          const int sh = u0.z & 0xff, w0 = u0.z >> 16 & 0xff;
          const int w1 = u0.z >> 24;
          const int o0 = lo16(u0.w), o1 = hi16(u0.w);
          tap(o0, w0, pri, sh);
          tap(-o0, w0, pri, sh);
          tap(o1, w1, pri, sh);
          tap(-o1, w1, pri, sh);
        }
        if (sec != 0) {
          const int2 u1 = *reinterpret_cast<const int2*>(&s_unit[u][1]);
          const int sh = u0.z >> 8 & 0xff;
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int pair = d < 2 ? u1.x : u1.y;
            const int o = d & 1 ? hi16(pair) : lo16(pair);
            const int w = d & 1 ? 1 : 2;
            tap(o, w, sec, sh);
            tap(-o, w, sec, sh);
          }
        }
        out = min(max(v + ((8 + sum - (sum < 0 ? 1 : 0)) >> 4), mn), mx);
      }
      if (y < P.ph && x < P.pw) dst[(size_t)y * P.pw + x] = out;
    }
  }
}

}  // namespace

// luma: `streams` int32 planes [ph, pw], contiguous; dir, var: int32
// [streams, uh, uw], contiguous; coeff_shift = bit depth - 8.  Returns
// cudaGetLastError().
extern "C" int cdef_dirs_launch(const void* luma, void* dir, void* var,
                                int streams, int ph, int pw, int uh, int uw,
                                int coeff_shift, void* stream) {
  if (streams < 1 || ph < 1 || pw < 1 || uh < 1 || uw < 1
      || coeff_shift < 0 || coeff_shift > 4)
    return cudaErrorInvalidValue;
  const long long n = (long long)streams * uh * uw;
  const long long grid = (n + kDirThreads - 1) / kDirThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Dirs a = {static_cast<const int*>(luma), static_cast<int*>(dir),
                  static_cast<int*>(var), streams, ph, pw, uh, uw,
                  coeff_shift};
  CDEF_LAUNCH(cdef_dirs_kernel, (int)grid, kDirThreads,
              static_cast<cudaStream_t>(stream), a);
  return cudaGetLastError();
}

// One launch filters `planes` (1 to 3; plane 0 luma) int32 planes of
// `streams` streams.  ptrs: 4 a plane, host pointers to device memory:
// src, dst ([streams, ph, pw], contiguous, not overlapping), pri, sec
// (the plane's strengths, int32 [streams, uh, uw]); dims: ph, pw a plane,
// covered by the units (uh (8 >> ssy) >= ph and uw (8 >> ssx) >= pw in
// chroma, 8 in luma); dir, var, filt: int32 [streams, uh, uw],
// contiguous; damp: `streams` int32 dampings, or null for `damping` in
// every stream.  Samples lie in [0, 2^bd).  Writes every pixel of each
// dst.  Returns cudaGetLastError().
extern "C" int cdef_frame_launch(const void* const* ptrs, const int* dims,
                                 const void* dir, const void* var,
                                 const void* filt, const void* damp,
                                 int damping, int planes, int streams,
                                 int uh, int uw, int ssx, int ssy, int bd,
                                 void* stream) {
  if (planes < 1 || planes > 3 || streams < 1 || uh < 1 || uw < 1
      || ssx < 0 || ssx > 1 || ssy < 0 || ssy > 1
      || (bd != 8 && bd != 10 && bd != 12))
    return cudaErrorInvalidValue;
  Filter a = {};
  for (int p = 0; p < planes; ++p) {
    const int ph = dims[2 * p], pw = dims[2 * p + 1];
    const int bh = 8 >> (p ? ssy : 0), bw = 8 >> (p ? ssx : 0);
    if (ph < 1 || pw < 1 || (long long)uh * bh < ph
        || (long long)uw * bw < pw)
      return cudaErrorInvalidValue;
    a.p[p] = {static_cast<const int*>(ptrs[4 * p]),
              static_cast<int*>(const_cast<void*>(ptrs[4 * p + 1])),
              static_cast<const int*>(ptrs[4 * p + 2]),
              static_cast<const int*>(ptrs[4 * p + 3]), ph, pw};
  }
  a.dir = static_cast<const int*>(dir);
  a.var = static_cast<const int*>(var);
  a.filt = static_cast<const int*>(filt);
  a.damp = static_cast<const int*>(damp);
  a.damping = damping;
  a.planes = planes;
  a.uh = uh;
  a.uw = uw;
  a.blocks_x = (uw + 7) / 8;
  a.blocks_y = (uh + 7) / 8;
  a.ssx = ssx;
  a.ssy = ssy;
  a.bd = bd;
  const long long grid =
      (long long)a.blocks_x * a.blocks_y * planes * streams;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  CDEF_LAUNCH(cdef_filter_kernel, (int)grid, kFilterThreads,
              static_cast<cudaStream_t>(stream), a);
  return cudaGetLastError();
}
