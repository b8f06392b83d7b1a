// The first design of easyav1_tpu_torch/csrc/loopfilter.cu's kernels, kept as
// the yardstick chip_smoke.py times the shipped kernels against (built
// by nvcc with their names suffixed "_first").
//
// One deblocking pass for Hopper (sm_90a): every edge of one direction
// of int32 planes [S, H, W] filtered in one launch, out of place.
//
// Replaces easyav1_tpu/video/av1/recon/lf_jax.py:27-187 (_pass_body, an
// XLA-jitted function that postfilter_fused._lf_stage, :44-75, runs
// twice a plane: on the plane, then on its transpose).  Its plain
// version is the port's recon/lf_torch.py::pass_body.
//
// What it computes.  A vertical pass filters the edges at x = 4(e+1),
// e < ne = (W + 3) / 4 - 1, of every row; a horizontal pass the edges at
// y = 4(e+1), e < (H + 3) / 4 - 1, of every column, reading the rows of
// the plane directly (no transpose).  Below, a "line" is a row
// (vertical pass) or a column (horizontal), and "along" the position on
// it.  Each (line, edge) has a size (0: no edge, else the filter length
// 4, 6, 8 or 14) and a limit, blimit and thresh, from maps of [S, lines,
// ne] and [S, 3, lines, ne] int32.  Taps P_k at X-1-k and Q_k at X+k,
// k < 7, are read before any write of the pass; a tap outside the plane
// reads 0 (the plain version's zero padding).  The decision order is the
// plain version's: mask (with mask6 and mask8 by size), flat, flat2 (P4
// to P6 and Q4 to Q6, for every edge), then use14, use8, use6, else
// use4, whose outer taps hev gates.  An edge writes a contiguous range
// of offsets: [-6, 5] (14), [-3, 2] (8), [-2, 1] (6, and 4 without
// hev), [-1, 0] (4 with hev).  Streams are independent planes.
//
// Overlaps.  The maps the decoder makes never let two edges write one
// pixel, but the plain version defines what happens when seeded maps
// do: it writes offset by offset from -6 to 5 over all edges at once, so
// a pixel keeps the value of the leftmost (lowest X) edge that writes
// it.  Here each edge first records its range in shared memory; an edge
// then writes a pixel only when neither edge to its left (X - 4, X - 8;
// X - 12 cannot reach) writes it, so every pixel has one writer and
// every run is bit-equal, with no atomics.
//
// What bounds it on this card: bytes.  A pass reads each pixel once
// (4 bytes), its maps (16 bytes a line and edge, 4 a pixel) and writes
// each pixel once (4 bytes): 12 bytes a pixel, 74.6 MB for the six
// passes of a 1080p 4:2:0 frame, 22.3 us at 3.35 TB/s (the integer
// operations, some 64 a filtered line and edge, take less).  The design:
// - A CTA stages a tile of kLines lines by kAlong positions with its
//   halo (20 before, 12 after) in shared memory, loaded and stored in
//   coalesced order (along a row; across the columns of the tile for the
//   horizontal pass, whose shared layout is column-minor for the same
//   reason), so the out-of-place result needs no copy of the plane:
//   each pixel of the output is stored once, by the CTA that owns it.
// - One thread a (line, edge) slot of the tile; the edges in the halo
//   are computed by both CTAs that need them, the price of no second
//   pass.  The thread keeps its edge's 12 outputs in registers across
//   the barrier that publishes the ranges.
// - Not done yet: the horizontal pass reads its maps one line a thread
//   (a stride of ne words); the vertical pass's shared reads are 4-way
//   bank conflicted.  Both are for a later pass at speed.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LF_LAUNCH
#define LF_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kHaloLo = 20;   // edges to X - 12, taps to X - 19
constexpr int kHaloHi = 12;   // edges to X + 4, taps to X + 10

template <bool kHorz>
struct Tile {
  static constexpr int kLines = kHorz ? 16 : 4;
  static constexpr int kAlong = kHorz ? 64 : 128;
  static constexpr int kWidth = kAlong + kHaloLo + kHaloHi;
  static constexpr int kSlots = kWidth / 4;     // edge slots a line
  static constexpr int kThreads = kLines * kSlots;
  // shared index of (line l, tile position t)
  static __device__ __forceinline__ int at(int l, int t) {
    return kHorz ? t * kLines + l : l * kWidth + t;
  }
};

struct Pass {
  const int* src;
  int* dst;
  const int* size;  // [S, lines, ne]
  const int* lim;   // [S, 3, lines, ne]: limit, blimit, thresh
  int h, w, ne, bd;
};

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The decision and outputs of one edge from its taps: out[off + 6] for
// the offsets [lo, hi] it writes (lo > hi: none).
__device__ __forceinline__ void filter_edge(const int* P, const int* Q,
                                            int sz, int limit, int blimit,
                                            int thresh, int bd, int& lo,
                                            int& hi, int* out) {
  const int F = 1 << (bd - 8), half = 1 << (bd - 1), mxv = (1 << bd) - 1;
  const int p0 = P[0], p1 = P[1], p2 = P[2], p3 = P[3];
  const int q0 = Q[0], q1 = Q[1], q2 = Q[2], q3 = Q[3];
  bool mask = iabs(p1 - p0) <= limit && iabs(q1 - q0) <= limit
      && iabs(p0 - q0) * 2 + (iabs(p1 - q1) >> 1) <= blimit;
  const bool mask6 = iabs(p2 - p1) <= limit && iabs(q2 - q1) <= limit;
  const bool mask8 = iabs(p3 - p2) <= limit && iabs(q3 - q2) <= limit;
  mask = mask && (mask6 || sz < 6) && (mask8 || sz < 8) && sz > 0;
  bool flat = iabs(p1 - p0) <= F && iabs(q1 - q0) <= F
      && iabs(p2 - p0) <= F && iabs(q2 - q0) <= F;
  flat = flat && ((iabs(p3 - p0) <= F && iabs(q3 - q0) <= F) || sz < 8);
  const bool flat2 = iabs(P[4] - p0) <= F && iabs(Q[4] - q0) <= F
      && iabs(P[5] - p0) <= F && iabs(Q[5] - q0) <= F
      && iabs(P[6] - p0) <= F && iabs(Q[6] - q0) <= F;
  const bool use14 = mask && sz == 14 && flat && flat2;
  const bool use8 = mask && sz >= 8 && flat && !use14;
  const bool use6 = mask && sz == 6 && flat;
  lo = 1;
  hi = 0;
  if (use14) {
    const int* p = P;
    const int* q = Q;
    out[0] = (p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0]
              + q[0] + 8) >> 4;
    out[1] = (p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1]
              + p[0] + q[0] + q[1] + 8) >> 4;
    out[2] = (p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1]
              + p[0] + q[0] + q[1] + q[2] + 8) >> 4;
    out[3] = (p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2
              + p[0] + q[0] + q[1] + q[2] + q[3] + 8) >> 4;
    out[4] = (p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2
              + p[0] * 2 + q[0] + q[1] + q[2] + q[3] + q[4] + 8) >> 4;
    out[5] = (p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2
              + q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5] + 8) >> 4;
    out[6] = (p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2
              + q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6] + 8) >> 4;
    out[7] = (p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2
              + q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2 + 8) >> 4;
    out[8] = (p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2
              + q[3] * 2 + q[4] + q[5] + q[6] * 3 + 8) >> 4;
    out[9] = (p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2
              + q[4] * 2 + q[5] + q[6] * 4 + 8) >> 4;
    out[10] = (p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2
               + q[5] * 2 + q[6] * 5 + 8) >> 4;
    out[11] = (p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2
               + q[6] * 7 + 8) >> 4;
    lo = -6;
    hi = 5;
  } else if (use8) {
    out[3] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
    out[4] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
    out[5] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
    out[6] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
    out[7] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3;
    out[8] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3;
    lo = -3;
    hi = 2;
  } else if (use6) {
    out[4] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3;
    out[5] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3;
    out[6] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3;
    out[7] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3;
    lo = -2;
    hi = 1;
  } else if (mask) {
    const bool hev = iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
    const int ps1 = p1 - half, ps0 = p0 - half;
    const int qs0 = q0 - half, qs1 = q1 - half;
    int f = hev ? clampi(ps1 - qs1, -half, half - 1) : 0;
    f = clampi(f + 3 * (qs0 - ps0), -half, half - 1);
    const int f1 = clampi(f + 4, -half, half - 1) >> 3;
    const int f2 = clampi(f + 3, -half, half - 1) >> 3;
    const int f3 = (f1 + 1) >> 1;
    out[5] = clampi(clampi(ps0 + f2, -half, half - 1) + half, 0, mxv);
    out[6] = clampi(clampi(qs0 - f1, -half, half - 1) + half, 0, mxv);
    out[4] = clampi(clampi(ps1 + f3, -half, half - 1) + half, 0, mxv);
    out[7] = clampi(clampi(qs1 - f3, -half, half - 1) + half, 0, mxv);
    lo = hev ? -1 : -2;
    hi = hev ? 0 : 1;
  }
}

template <bool kHorz>
__global__ void __launch_bounds__(Tile<kHorz>::kThreads)
lf_pass_kernel(Pass a) {
  using T = Tile<kHorz>;
  constexpr int L = T::kLines, A = T::kAlong, TW = T::kWidth;
  constexpr int SLOTS = T::kSlots;
  __shared__ int s[L * TW];
  __shared__ signed char lo_s[L * SLOTS], hi_s[L * SLOTS];
  const int lines = kHorz ? a.w : a.h;
  const int along = kHorz ? a.h : a.w;
  const int tiles_a = (along + A - 1) / A;
  const int tiles_l = (lines + L - 1) / L;
  int b = blockIdx.x;
  const int a0 = (b % tiles_a) * A;
  b /= tiles_a;
  const int l0 = (b % tiles_l) * L;
  const int st = b / tiles_l;
  const size_t plane = (size_t)a.h * a.w;
  const int* src = a.src + st * plane;
  int* dst = a.dst + st * plane;

  for (int i = threadIdx.x; i < L * TW; i += T::kThreads) {
    const int l = kHorz ? i % L : i / TW;
    const int t = kHorz ? i / L : i % TW;
    const int line = l0 + l, pos = a0 - kHaloLo + t;
    int v = 0;
    if (line < lines && pos >= 0 && pos < along)
      v = __ldg(src + (kHorz ? (size_t)pos * a.w + line
                             : (size_t)line * a.w + pos));
    s[T::at(l, t)] = v;
  }
  __syncthreads();

  const int l = kHorz ? threadIdx.x % L : threadIdx.x / SLOTS;
  const int j = kHorz ? threadIdx.x / L : threadIdx.x % SLOTS;
  const int line = l0 + l;
  const int X = a0 - kHaloLo + 4 * j;   // the slot's edge, along the line
  int lo = 1, hi = 0, out[12];
  if (line < lines && j >= 2 && j <= A / 4 + 6 && X >= 4
      && X / 4 - 1 < a.ne) {
    const int e = X / 4 - 1;
    int P[7], Q[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      P[k] = s[T::at(l, 4 * j - 1 - k)];
      Q[k] = s[T::at(l, 4 * j + k)];
    }
    const size_t m = (size_t)lines * a.ne;
    const size_t cell = (size_t)line * a.ne + e;
    const int* lim = a.lim + st * 3 * m + cell;
    filter_edge(P, Q, __ldg(a.size + st * m + cell), __ldg(lim),
                __ldg(lim + m), __ldg(lim + 2 * m), a.bd, lo, hi, out);
  }
  lo_s[l * SLOTS + j] = (signed char)lo;
  hi_s[l * SLOTS + j] = (signed char)hi;
  __syncthreads();

  // the leftmost edge that writes a pixel gives its value
  const int lo1 = j >= 1 ? lo_s[l * SLOTS + j - 1] : 1;
  const int hi1 = j >= 1 ? hi_s[l * SLOTS + j - 1] : 0;
  const int lo2 = j >= 2 ? lo_s[l * SLOTS + j - 2] : 1;
  const int hi2 = j >= 2 ? hi_s[l * SLOTS + j - 2] : 0;
#pragma unroll
  for (int off = -6; off <= 5; ++off) {
    const int t = 4 * j + off;
    if (off < lo || off > hi || t < kHaloLo || t >= kHaloLo + A) continue;
    if ((lo1 <= off + 4 && off + 4 <= hi1) || (lo2 <= off + 8 && off + 8 <= hi2))
      continue;
    s[T::at(l, t)] = out[off + 6];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < L * A; i += T::kThreads) {
    const int ll = kHorz ? i % L : i / A;
    const int t = kHorz ? i / L : i % A;
    const int ln = l0 + ll, pos = a0 + t;
    if (ln < lines && pos < along)
      dst[kHorz ? (size_t)pos * a.w + ln : (size_t)ln * a.w + pos] =
          s[T::at(ll, kHaloLo + t)];
  }
}

template <bool kHorz>
int launch(const Pass& a, int streams, cudaStream_t s) {
  using T = Tile<kHorz>;
  const int lines = kHorz ? a.w : a.h, along = kHorz ? a.h : a.w;
  const long long grid = (long long)((along + T::kAlong - 1) / T::kAlong)
      * ((lines + T::kLines - 1) / T::kLines) * streams;
  if (grid < 1 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  LF_LAUNCH(lf_pass_kernel<kHorz>, (int)grid, T::kThreads, s, a);
  return cudaGetLastError();
}

}  // namespace

// src, dst: `streams` int32 planes [h, w], contiguous, not overlapping;
// size: [streams, lines, ne], lim: [streams, 3, lines, ne] int32,
// contiguous, lines = h (horizontal 0: vertical edges, one map row a
// pixel row) or w (horizontal 1: one map row a pixel column), ne = the
// pass's edges ((w + 3) / 4 - 1, or (h + 3) / 4 - 1), at least 1; bd 8,
// 10 or 12.  Writes every pixel of dst.  Returns cudaGetLastError().
extern "C" int lf_pass_launch(const void* src, void* dst, const void* size,
                              const void* lim, int streams, int h, int w,
                              int ne, int horizontal, int bd, void* stream) {
  const int along = horizontal ? h : w;
  if (streams < 1 || h < 1 || w < 1 || ne < 1 || ne != (along + 3) / 4 - 1
      || (bd != 8 && bd != 10 && bd != 12))
    return cudaErrorInvalidValue;
  const Pass a = {static_cast<const int*>(src), static_cast<int*>(dst),
                  static_cast<const int*>(size), static_cast<const int*>(lim),
                  h, w, ne, bd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return horizontal ? launch<true>(a, streams, s) : launch<false>(a, streams, s);
}
