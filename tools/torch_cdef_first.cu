// The first design of easyav1_tpu_torch/csrc/cdef.cu's kernels, kept as
// the yardstick chip_smoke.py times the shipped kernels against (built
// by nvcc with their names suffixed "_first").
//
// CDEF for Hopper (sm_90a): the direction search of every 8x8 luma unit,
// and the primary and secondary filter of one plane, over int32 planes
// [S, ph, pw] (S independent streams), each in one launch.
//
// Replaces easyav1_tpu/video/av1/recon/cdef_jax.py:245-279 (_dirs_body)
// and :107-234 (_filter_body), the XLA-jitted functions that
// postfilter_fused._cdef_stage (:79-110) runs on the deblocked planes.
// Their plain versions are the port's recon/cdef_torch.py::find_dirs
// and ::filter_plane.
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
// cdef_filter_kernel: one thread a pixel.  Its unit (8 >> ss pixels a
// side in chroma) gives the strengths (already shifted by coeff_shift),
// the filter flag, the direction and the variance.  In luma the primary
// strength is scaled by the variance, (pri (4 + min(log2(var >> 6), 12))
// + 8) >> 4, 0 where var is 0, and the direction gate reads the strength
// before that scaling; in chroma the direction is remapped by
// cdef_uv_dir[ssx][ssy].  Damping (one a stream, coeff_shift included)
// minus 1 in chroma sets the shifts max(damping - log2(strength), 0).
// The primary taps (weights 4, 2, or 3, 3 where (pri >> coeff_shift) is
// odd) lie along the direction, the secondary ones (weights 2, 1) along
// (dir +- 2) & 7; each adds constrain(tap - px) and, unless it is
// CDEF_VERY_LARGE (a tap outside the plane), widens the min and max;
// px + ((8 + s - (s < 0)) >> 4) is clamped to them.  A pixel whose unit
// is not filtered, or has both strengths 0, keeps its value.  The
// output is a new plane: the deblocked input stays for loop restoration.
//
// What bounds them on this card.  The search: bytes; it reads the luma
// plane once and writes 8 bytes a unit (8.6 MB on a 1080p frame, 2.6 us
// at 3.35 TB/s).  The filter reads its plane once, 16 or 20 bytes of
// unit maps a unit, and writes the plane once (26.6 MB for the three
// planes of a 1080p 4:2:0 frame, 7.9 us), but its integer operations,
// some 130 a filtered pixel, weigh more where most units filter: 12.1 us
// on the 1080p deblocking key frame at 33.5 TOP/s.
// The design is the simplest that is exact: a thread a unit or a pixel,
// taps read through the L1 cache (a pixel's 12 taps lie within 2 rows
// and columns of it, which its neighbours read too), unit maps read by
// every pixel of the unit, no shared memory, no atomics.  Staging a tile
// with its 2-pixel halo in shared memory, vector loads in the search and
// one launch for the three planes are for a later pass at speed.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CDEF_LAUNCH
#define CDEF_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kVeryLarge = 0x4000;
constexpr int kDirThreads = 128;
constexpr int kTileW = 32, kTileH = 8;   // a filter CTA's pixels
constexpr int kFilterThreads = kTileW * kTileH;

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

struct Filter {
  const int* src;    // [S, ph, pw], the deblocked plane
  int* dst;
  const int* dir;    // [S, uh, uw] unit maps
  const int* var;
  const int* pri;
  const int* sec;
  const int* filt;
  const int* damp;   // one a stream, or null: `damping` for all
  int damping;
  int ph, pw, uh, uw, ssx, ssy, plane, bd;
};

__device__ __forceinline__ int constrain(int diff, int thr, int sh) {
  const int ad = diff < 0 ? -diff : diff;
  const int rhs = max(thr - (ad >> sh), 0);
  const int mag = min(ad, rhs);
  return diff < 0 ? -mag : mag;
}

__global__ void __launch_bounds__(kFilterThreads)
cdef_filter_kernel(Filter a) {
  const int tiles_x = (a.pw + kTileW - 1) / kTileW;
  const int tiles_y = (a.ph + kTileH - 1) / kTileH;
  int b = blockIdx.x;
  const int tx = b % tiles_x;
  b /= tiles_x;
  const int ty = b % tiles_y;
  const int st = b / tiles_y;
  const int r = ty * kTileH + threadIdx.x / kTileW;
  const int c = tx * kTileW + threadIdx.x % kTileW;
  if (r >= a.ph || c >= a.pw) return;
  const size_t base = (size_t)st * a.ph * a.pw;
  const int* src = a.src + base;
  const int px = __ldg(src + (size_t)r * a.pw + c);
  const int bh = 8 >> (a.plane ? a.ssy : 0), bw = 8 >> (a.plane ? a.ssx : 0);
  const size_t u = ((size_t)st * a.uh + r / bh) * a.uw + c / bw;
  int pri = __ldg(a.pri + u);
  const int sec = __ldg(a.sec + u);
  const int dir = __ldg(a.dir + u) & 7;
  int pdir;
  if (a.plane == 0) {
    const int var = __ldg(a.var + u);
    const int i = min(floor_log2(max(var >> 6, 1)), 12);
    const int adj = var != 0 ? (pri * (4 + i) + 8) >> 4 : 0;
    pdir = pri != 0 ? dir : 0;   // the strength before the scaling
    pri = pri != 0 ? adj : 0;
  } else {
    pdir = pri != 0 ? kUvDir[a.ssx][a.ssy][dir] : 0;
  }
  int out = px;
  if (__ldg(a.filt + u) != 0 && (pri != 0 || sec != 0)) {
    const int pdamp = (a.damp ? __ldg(a.damp + st) : a.damping)
        - (a.plane ? 1 : 0);
    const int pri_sh = max(pdamp - floor_log2(max(pri, 1)), 0);
    const int sec_sh = max(pdamp - floor_log2(max(sec, 1)), 0);
    auto tap = [&](int d, int k, int sgn) {
      const int y = r + sgn * kDirs[d][k][0], x = c + sgn * kDirs[d][k][1];
      return y >= 0 && y < a.ph && x >= 0 && x < a.pw
                 ? __ldg(src + (size_t)y * a.pw + x) : kVeryLarge;
    };
    int s = 0, mx = px, mn = px;
    if (pri != 0) {
      const int odd = (pri >> (a.bd - 8)) & 1;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int w = odd ? 3 : (k == 0 ? 4 : 2);
#pragma unroll
        for (int sgn = 1; sgn >= -1; sgn -= 2) {
          const int v = tap(pdir, k, sgn);
          s += w * constrain(v - px, pri, pri_sh);
          if (v != kVeryLarge) {
            mx = max(mx, v);
            mn = min(mn, v);
          }
        }
      }
    }
    if (sec != 0) {
#pragma unroll
      for (int rot = 2; rot <= 6; rot += 4) {
        const int sdir = (pdir + rot) & 7;
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int sgn = 1; sgn >= -1; sgn -= 2) {
            const int v = tap(sdir, k, sgn);
            s += (k == 0 ? 2 : 1) * constrain(v - px, sec, sec_sh);
            if (v != kVeryLarge) {
              mx = max(mx, v);
              mn = min(mn, v);
            }
          }
      }
    }
    out = min(max(px + ((8 + s - (s < 0 ? 1 : 0)) >> 4), mn), mx);
  }
  a.dst[base + (size_t)r * a.pw + c] = out;
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

// src, dst: `streams` int32 planes [ph, pw] of plane index `plane` (0
// luma), contiguous, not overlapping; dir, var, pri, sec, filt: int32
// [streams, uh, uw], contiguous, uh (8 >> ssy) >= ph and uw (8 >> ssx) >=
// pw in chroma (8 in luma); damp: `streams` int32 dampings, or null for
// `damping` in every stream.  Writes every pixel of dst.  Returns
// cudaGetLastError().
extern "C" int cdef_filter_launch(const void* src, void* dst, const void* dir,
                                  const void* var, const void* pri,
                                  const void* sec, const void* filt,
                                  const void* damp, int damping, int streams,
                                  int ph, int pw, int uh, int uw, int ssx,
                                  int ssy, int plane, int bd, void* stream) {
  const int bh = 8 >> (plane ? ssy : 0), bw = 8 >> (plane ? ssx : 0);
  if (streams < 1 || ph < 1 || pw < 1 || plane < 0 || plane > 2
      || ssx < 0 || ssx > 1 || ssy < 0 || ssy > 1
      || (long long)uh * bh < ph || (long long)uw * bw < pw
      || (bd != 8 && bd != 10 && bd != 12))
    return cudaErrorInvalidValue;
  const long long grid = (long long)((pw + kTileW - 1) / kTileW)
      * ((ph + kTileH - 1) / kTileH) * streams;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Filter a = {static_cast<const int*>(src), static_cast<int*>(dst),
                    static_cast<const int*>(dir), static_cast<const int*>(var),
                    static_cast<const int*>(pri), static_cast<const int*>(sec),
                    static_cast<const int*>(filt),
                    static_cast<const int*>(damp), damping, ph, pw, uh, uw,
                    ssx, ssy, plane, bd};
  CDEF_LAUNCH(cdef_filter_kernel, (int)grid, kFilterThreads,
              static_cast<cudaStream_t>(stream), a);
  return cudaGetLastError();
}
