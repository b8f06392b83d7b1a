// Deblocking for Hopper (sm_90a): both directions of every plane of a
// frame that deblocks, over int32 planes [S, H, W], in one launch, out of
// place.
//
// Replaces easyav1_tpu/video/av1/recon/lf_jax.py:27-187 (_pass_body, an
// XLA-jitted function that postfilter_fused._lf_stage, :44-75, runs
// twice a plane: on the plane, then on its transpose).  Its plain
// version is the port's recon/lf_torch.py::lf_frame_plain (pass_body on
// the maps expand_maps makes, the vertical pass then the horizontal one).
//
// What it computes.  The vertical pass filters the edges at x = 4(e+1),
// e < nev = (W + 3) / 4 - 1, of every row; then the horizontal pass the
// edges at y = 4(e+1), e < neh = (H + 3) / 4 - 1, of every column of the
// vertical pass's output.  Below, a "line" is a row (vertical edges) or a
// column (horizontal), and "along" the position on it.  Each (line, edge)
// has a size (0: no edge, else the filter length 4, 6, 8 or 14) and a
// level, from uint8 maps of [S, R, ne] whose row r covers the lines
// [r << shift, (r + 1) << shift): shift 2 for the decoder's 4x4-cell
// maps, 0 for one map row a line; the level picks (limit, blimit,
// thresh) from the plane's int32 LUT [S, 3, 64].  Taps P_k at X-1-k and
// Q_k at X+k, k < 7, are read before any write of the pass; a tap
// outside the plane reads 0 (the plain version's zero padding).  The
// decision order is the plain version's: mask (with mask6 and mask8 by
// size), flat, flat2, then use14, use8, use6, else use4, whose outer taps
// hev gates.  An edge writes a contiguous range of offsets: [-6, 5]
// (14), [-3, 2] (8), [-2, 1] (6, and 4 without hev), [-1, 0] (4 with
// hev).  Streams are independent planes.  Samples lie in [0, 2^bd): the
// tiles hold them as int16.
//
// Overlaps.  The maps the decoder makes never let two edges write one
// pixel, but the plain version defines what happens when seeded maps
// do: it writes offset by offset from -6 to 5 over all edges at once, so
// a pixel keeps the value of the leftmost (or topmost) edge that writes
// it.  Here each edge's decision (its filter, hence its range) is
// published in shared memory before any write; an edge then writes a
// pixel only when neither edge before it (X - 4, X - 8; X - 12 cannot
// reach) writes it, so every pixel has one writer and every run is
// bit-equal, with no atomics.
//
// What bounds it on this card: bytes.  Each plane is read once and
// written once (8 bytes a pixel) and the cell maps read once (2 bytes a
// cell and edge a direction): 24.9 MB plus 1.6 MB of maps on a 1080p
// 4:2:0 frame, 7.9 us at 3.35 TB/s.  The design:
// - A CTA owns a kTileH x kTileW output tile of one plane and stream.
//   It stages the tile with the halo both directions need (20 before,
//   12 after, in each direction: edges to X - 12, whose taps reach
//   X - 19; edges to X + 4, taps to X + 10) in shared memory (A), with
//   the tile's map cells (coalesced rows of bytes) and its LUT.  A
//   vertical-pass output depends only on its row within that halo, so
//   the frame-wide order (every vertical edge before any horizontal
//   one) holds inside the tile: the vertical edges run over every staged
//   row into B (the tile's columns), then the horizontal edges over the
//   tile's columns of B into C, which is stored once, coalesced.
// - Each pass is two steps between barriers: every edge decides (its
//   filter, a byte in shared memory; the outer taps read only for a
//   14-long edge), then every deciding edge computes its outputs and
//   writes the pixels it owns (its write mask less its two left
//   neighbours').  The vertical pass's threads run down the rows (lane =
//   row) and the staged tiles' pitch is an odd number of 32-bit words,
//   so their shared reads and writes are free of bank conflicts; the
//   horizontal pass's run along the columns.  Staging, the copies
//   between the tiles and the store move 2 or 4 pixels a step (16 bytes
//   from and to global memory where aligned).
// - Cost of the fused tile: the halo rows' vertical edges are computed
//   by each CTA that needs them (1.5x the vertical work at 64 x 64), and
//   the staged tile is 2.25x the tile's pixels, read through L2.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LF_LAUNCH
#define LF_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kHaloLo = 20;   // edges to X - 12, taps to X - 19
constexpr int kHaloHi = 12;   // edges to X + 4, taps to X + 10
constexpr int kTileH = 64, kTileW = 64;
constexpr int kThreads = 256;
constexpr int kAH = kTileH + kHaloLo + kHaloHi;   // staged rows
constexpr int kAW = kTileW + kHaloLo + kHaloHi;   // staged columns
// pitches in int16: an odd number of 32-bit words, so that a warp's 32
// rows fall on 32 banks and a row starts on a word
constexpr int kPA = kAW + 2;
constexpr int kPB = kTileW + 2;
static_assert(kPA % 4 == 2 && kPB % 4 == 2 && kTileW % 4 == 0, "pitches");
// edge slots a line: X from x0 - 12 to x0 + kTileW + 4; the first two
// only decide (their ranges gate the third's writes)
constexpr int kSlotsV = kTileW / 4 + 5;
constexpr int kSlotsH = kTileH / 4 + 5;
constexpr int kMaxPlanes = 3;

struct Plane {
  const int* src;         // [S, h, w]
  int* dst;
  const uint8_t* sv;      // [S, rv, nev]: vertical edges' size, level
  const uint8_t* lv;
  const uint8_t* sh;      // [S, rh, neh]: horizontal edges'
  const uint8_t* lh;
  const int* lut;         // [S, 3, 64]: limit, blimit, thresh
  int h, w, shv, shh;     // map-row shifts (0 or 2)
  int tiles_x, tiles;     // the plane's tiles a stream
};

struct Frame {
  Plane p[kMaxPlanes];
  int planes, tiles, bd;  // tiles: a stream, over the planes
};

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// An edge's filter: 0 none, 1 use4 with hev, 2 use4, 3 use6, 4 use8,
// 5 use14.
enum { kNone, kF4Hev, kF4, kF6, kF8, kF14 };

// The offsets [-6, 5] filter k writes, bit off + 6.
__device__ __forceinline__ unsigned wmask(int k) {
  return k == kF14 ? 0xfffu : k == kF8 ? 0x1f8u : k == kF4Hev ? 0x60u
       : k == kNone ? 0u : 0xf0u;
}

// The taps of the edge at position x of a line of shared memory whose
// positions are `stride` apart: P_k at x - 1 - k, Q_k at x + k, k < n.
template <int n>
__device__ __forceinline__ void taps(const int16_t* line, int stride, int x,
                                     int* P, int* Q) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    P[k] = line[(x - 1 - k) * stride];
    Q[k] = line[(x + k) * stride];
  }
}

// The decision of one edge from its taps (the plain version's order);
// the outer taps are read only for a 14-long edge, whose flat2 reads
// them.
__device__ __forceinline__ int decide(const int16_t* line, int stride,
                                      int x, int sz, int limit, int blimit,
                                      int thresh, int bd) {
  int P[7], Q[7];
  taps<4>(line, stride, x, P, Q);
  const int F = 1 << (bd - 8);
  const int p0 = P[0], p1 = P[1], p2 = P[2], p3 = P[3];
  const int q0 = Q[0], q1 = Q[1], q2 = Q[2], q3 = Q[3];
  bool mask = iabs(p1 - p0) <= limit && iabs(q1 - q0) <= limit
      && iabs(p0 - q0) * 2 + (iabs(p1 - q1) >> 1) <= blimit;
  const bool mask6 = iabs(p2 - p1) <= limit && iabs(q2 - q1) <= limit;
  const bool mask8 = iabs(p3 - p2) <= limit && iabs(q3 - q2) <= limit;
  mask = mask && (mask6 || sz < 6) && (mask8 || sz < 8) && sz > 0;
  if (!mask) return kNone;
  bool flat = iabs(p1 - p0) <= F && iabs(q1 - q0) <= F
      && iabs(p2 - p0) <= F && iabs(q2 - q0) <= F;
  flat = flat && ((iabs(p3 - p0) <= F && iabs(q3 - q0) <= F) || sz < 8);
  if (sz == 14 && flat) {
#pragma unroll
    for (int k = 4; k < 7; ++k) {
      P[k] = line[(x - 1 - k) * stride];
      Q[k] = line[(x + k) * stride];
    }
    if (iabs(P[4] - p0) <= F && iabs(Q[4] - q0) <= F
        && iabs(P[5] - p0) <= F && iabs(Q[5] - q0) <= F
        && iabs(P[6] - p0) <= F && iabs(Q[6] - q0) <= F)
      return kF14;
  }
  if (sz >= 8 && flat) return kF8;
  if (sz == 6 && flat) return kF6;
  return iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh ? kF4Hev : kF4;
}

// The outputs of an edge of filter k: out[off + 6] for off in its range.
__device__ __forceinline__ void outputs(int k, const int* p, const int* q,
                                        int bd, int* out) {
  const int half = 1 << (bd - 1), mxv = (1 << bd) - 1;
  if (k == kF14) {
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
    return;
  }
  const int p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
  const int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  if (k == kF8) {
    out[3] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
    out[4] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
    out[5] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
    out[6] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
    out[7] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3;
    out[8] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3;
  } else if (k == kF6) {
    out[4] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3;
    out[5] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3;
    out[6] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3;
    out[7] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3;
  } else {
    const bool hev = k == kF4Hev;
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
  }
}

// Edge k at position X of a staged line (`stride` apart) computes its
// outputs and writes those it owns, `own` (wmask bits), at the positions
// of `out` that fall in [lo, lo + n): out[(X + off - lo) * ostride].
__device__ __forceinline__ void apply(int k, const int16_t* line, int stride,
                                      int X, unsigned own, int lo, int n,
                                      int16_t* dst, int ostride, int bd) {
  // the offsets (bits) whose positions lie in [lo, lo + n)
  const int first = X - 6 - lo;   // the position of offset -6
  const int b0 = max(-first, 0), b1 = min(n - 1 - first, 11);
  own &= b0 > b1 ? 0u : (2u << b1) - (1u << b0);
  if (!own) return;
  int P[7], Q[7], out[12];
  if (k == kF14)
    taps<7>(line, stride, X, P, Q);
  else
    taps<4>(line, stride, X, P, Q);
  outputs(k, P, Q, bd, out);
#pragma unroll
  for (int b = 0; b < 12; ++b)
    if (own >> b & 1u) dst[(first + b) * ostride] = (int16_t)out[b];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return (uint32_t)(a & 0xffff) | (uint32_t)b << 16;
}

// The plane and stream of CTA blockIdx.x, and the tile's corner (static
// plane indices: the parameters stay in constant memory).
__device__ __forceinline__ void tile_of(const Frame& f, Plane& P, int& st,
                                        int& y0, int& x0) {
  int b = blockIdx.x;
  st = b / f.tiles;
  b -= st * f.tiles;
  P = f.p[0];
  if (b >= P.tiles && f.planes > 1) {
    b -= P.tiles;
    P = f.p[1];
    if (b >= P.tiles && f.planes > 2) {
      b -= P.tiles;
      P = f.p[2];
    }
  }
  y0 = b / P.tiles_x * kTileH;
  x0 = b % P.tiles_x * kTileW;
}

// Rows [y0 + r0, y0 + r0 + rows) and columns [x0 + c0, x0 + c0 + 4 groups)
// of src (0 outside the plane) into int16 shared memory of `pitch`, 4
// pixels a step (16 bytes where they lie in the plane and are aligned).
__device__ __forceinline__ void stage(const int* src, int h, int w, int y0,
                                      int x0, int r0, int rows, int c0,
                                      int groups, uint32_t* S32, int pitch) {
  for (int i = threadIdx.x; i < rows * groups; i += kThreads) {
    const int r = i / groups, g = i % groups;
    const int y = y0 + r0 + r, x = x0 + c0 + 4 * g;
    const int* row = src + (size_t)y * w;
    int v[4] = {0, 0, 0, 0};
    if (y >= 0 && y < h) {
      if (x >= 0 && x + 3 < w && aligned16(row + x)) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(row + x));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (x + k >= 0 && x + k < w) v[k] = __ldg(row + x + k);
      }
    }
    uint32_t* a = S32 + (r * pitch + 4 * g) / 2;
    a[0] = pack2(v[0], v[1]);
    a[1] = pack2(v[2], v[3]);
  }
}

// The tile's kTileH rows of S (int16, `pitch`) into dst, each pixel once,
// 4 a step (16 bytes where they lie in the plane and are aligned).
__device__ __forceinline__ void store(const uint32_t* S32, int pitch,
                                      int* dst, int h, int w, int y0,
                                      int x0) {
  for (int i = threadIdx.x; i < kTileH * (kTileW / 4); i += kThreads) {
    const int r = i / (kTileW / 4), g = i % (kTileW / 4);
    const int y = y0 + r, x = x0 + 4 * g;
    if (y >= h || x >= w) continue;
    const uint32_t lo = S32[(r * pitch) / 2 + 2 * g];
    const uint32_t hi = S32[(r * pitch) / 2 + 2 * g + 1];
    const int v[4] = {(int16_t)(lo & 0xffff), (int16_t)(lo >> 16),
                      (int16_t)(hi & 0xffff), (int16_t)(hi >> 16)};
    int* d = dst + (size_t)y * w + x;
    if (x + 3 < w && aligned16(d)) {
      *reinterpret_cast<int4*>(d) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k < w) d[k] = v[k];
    }
  }
}

// 6 CTAs an SM: the registers stay at 40, so that a 1080p frame's tiles
// run in one wave
__global__ void __launch_bounds__(kThreads, 6)
lf_frame_kernel(Frame f) {
  // staged input, later C (the output tile, pitch kTileW); the vertical
  // pass's result over the tile's columns
  __align__(16) __shared__ int16_t A[kAH * kPA];
  __align__(16) __shared__ int16_t B[kAH * kPB];
  __shared__ uint8_t decV[kSlotsV * kAH], decH[kSlotsH * kTileW];
  // the tile's map cells, [cell row][slot], when the maps are the
  // decoder's (shift 2); maps of one row a line are read where used
  __shared__ uint8_t mSV[kAH / 4 * kSlotsV], mLV[kAH / 4 * kSlotsV];
  __shared__ uint8_t mSH[kTileW / 4 * kSlotsH], mLH[kTileW / 4 * kSlotsH];
  __shared__ int lut[3 * 64];
  uint32_t* A32 = reinterpret_cast<uint32_t*>(A);
  uint32_t* B32 = reinterpret_cast<uint32_t*>(B);

  Plane P;
  int st, y0, x0;
  tile_of(f, P, st, y0, x0);
  const int h = P.h, w = P.w;
  const int nev = (w + 3) / 4 - 1, neh = (h + 3) / 4 - 1;
  const size_t plane = (size_t)h * w;
  const int* src = P.src + st * plane;
  const int t = threadIdx.x;

  // 1. stage: the tile and its halo, the map cells of its edges and the
  // LUT
  stage(src, h, w, y0, x0, -kHaloLo, kAH, -kHaloLo, kAW / 4, A32, kPA);
  // vertical edges: slot j at x = x0 - 12 + 4j, edge e0v + j; the map
  // cells of the staged rows
  const int e0v = x0 / 4 - 4, e0h = y0 / 4 - 4;
  const int rv = (h + (1 << P.shv) - 1) >> P.shv;
  const int rh = (w + (1 << P.shh) - 1) >> P.shh;
  const size_t mv = (size_t)rv * nev, mh = (size_t)rh * neh;
  {
    const int r0 = (y0 - kHaloLo) >> 2;   // floor: y0 - 20 >= -20
    for (int i = t; P.shv && i < kAH / 4 * kSlotsV; i += kThreads) {
      const int r = i / kSlotsV, j = i % kSlotsV;
      const int mr = r0 + r, e = e0v + j;
      uint8_t sz = 0, lv = 0;
      if (mr >= 0 && mr < rv && e >= 0 && e < nev) {
        const size_t at = st * mv + (size_t)mr * nev + e;
        sz = __ldg(P.sv + at);
        lv = __ldg(P.lv + at);
      }
      mSV[i] = sz;
      mLV[i] = lv;
    }
    for (int i = t; P.shh && i < kTileW / 4 * kSlotsH; i += kThreads) {
      const int r = i / kSlotsH, j = i % kSlotsH;
      const int mr = x0 / 4 + r, e = e0h + j;
      uint8_t sz = 0, lv = 0;
      if (mr < rh && e >= 0 && e < neh) {
        const size_t at = st * mh + (size_t)mr * neh + e;
        sz = __ldg(P.sh + at);
        lv = __ldg(P.lh + at);
      }
      mSH[i] = sz;
      mLH[i] = lv;
    }
    for (int i = t; i < 3 * 64; i += kThreads)
      lut[i] = __ldg(P.lut + st * 3 * 64 + i);
  }
  __syncthreads();

  // 2. vertical edges decide (lane = row); B takes the tile's columns
  for (int i = t; i < kAH * kSlotsV; i += kThreads) {
    const int r = i % kAH, j = i / kAH;
    const int y = y0 - kHaloLo + r, e = e0v + j;
    int sz = 0, lv = 0;
    if (y >= 0 && y < h) {
      if (P.shv) {
        sz = mSV[(r >> 2) * kSlotsV + j];
        lv = mLV[(r >> 2) * kSlotsV + j];
      } else if (e >= 0 && e < nev) {
        sz = __ldg(P.sv + st * mv + (size_t)y * nev + e);
        lv = __ldg(P.lv + st * mv + (size_t)y * nev + e);
      }
    }
    int k = kNone;
    if (sz) {
      lv &= 63;
      k = decide(A + r * kPA, 1, 8 + 4 * j, sz, lut[lv], lut[64 + lv],
                 lut[128 + lv], f.bd);
    }
    decV[j * kAH + r] = (uint8_t)k;
  }
  for (int i = t; i < kAH * (kTileW / 2); i += kThreads) {
    const int r = i / (kTileW / 2), c = i % (kTileW / 2);
    B32[r * (kPB / 2) + c] = A32[r * (kPA / 2) + kHaloLo / 2 + c];
  }
  __syncthreads();

  // 3. vertical edges write the pixels they own in the tile's columns
  for (int i = t; i < kAH * (kSlotsV - 2); i += kThreads) {
    const int r = i % kAH, j = i / kAH + 2;
    const int k = decV[j * kAH + r];
    if (k == kNone) continue;
    const unsigned own = wmask(k) & ~(wmask(decV[(j - 1) * kAH + r]) >> 4
                                      | wmask(decV[(j - 2) * kAH + r]) >> 8);
    apply(k, A + r * kPA, 1, 8 + 4 * j, own, kHaloLo, kTileW, B + r * kPB, 1,
          f.bd);
  }
  __syncthreads();

  // 4. horizontal edges decide (lane = column); C (in A) takes the
  // tile's rows
  int16_t* C = A;
  uint32_t* C32 = A32;
  for (int i = t; i < kTileW * kSlotsH; i += kThreads) {
    const int c = i % kTileW, j = i / kTileW;
    const int x = x0 + c, e = e0h + j;
    int sz = 0, lv = 0;
    if (x < w) {
      if (P.shh) {
        sz = mSH[(c >> 2) * kSlotsH + j];
        lv = mLH[(c >> 2) * kSlotsH + j];
      } else if (e >= 0 && e < neh) {
        sz = __ldg(P.sh + st * mh + (size_t)x * neh + e);
        lv = __ldg(P.lh + st * mh + (size_t)x * neh + e);
      }
    }
    int k = kNone;
    if (sz) {
      lv &= 63;
      k = decide(B + c, kPB, 8 + 4 * j, sz, lut[lv], lut[64 + lv],
                 lut[128 + lv], f.bd);
    }
    decH[j * kTileW + c] = (uint8_t)k;
  }
  for (int i = t; i < kTileH * (kTileW / 2); i += kThreads) {
    const int r = i / (kTileW / 2), c = i % (kTileW / 2);
    C32[r * (kTileW / 2) + c] = B32[(r + kHaloLo) * (kPB / 2) + c];
  }
  __syncthreads();

  // 5. horizontal edges write the pixels they own in the tile
  for (int i = t; i < kTileW * (kSlotsH - 2); i += kThreads) {
    const int c = i % kTileW, j = i / kTileW + 2;
    const int k = decH[j * kTileW + c];
    if (k == kNone) continue;
    const unsigned own = wmask(k) & ~(wmask(decH[(j - 1) * kTileW + c]) >> 4
                                      | wmask(decH[(j - 2) * kTileW + c]) >> 8);
    apply(k, B + c, kPB, 8 + 4 * j, own, kHaloLo, kTileH, C + c, kTileW,
          f.bd);
  }
  __syncthreads();

  // 6. store the tile, each pixel once
  store(C32, kTileW, P.dst + st * plane, h, w, y0, x0);
}

}  // namespace

// One launch deblocks `planes` (1 to 3) int32 planes of `streams` streams.
// ptrs: 7 a plane, host pointers to device memory: src, dst ([streams,
// h, w], contiguous, not overlapping), sv, lv ([streams, rv, nev] uint8),
// sh, lh ([streams, rh, neh] uint8), lut ([streams, 3, 64] int32); dims:
// 4 a plane: h, w, and the map-row shifts of the vertical and horizontal
// maps (0: rv = h, rh = w; 2: rv = (h + 3) / 4, rh = (w + 3) / 4); nev =
// (w + 3) / 4 - 1 and neh = (h + 3) / 4 - 1 may be 0 (a map then has no
// bytes).  Levels index the LUT modulo 64; samples lie in [0, 2^bd); bd
// 8, 10 or 12.  Writes every pixel of each dst.  Returns
// cudaGetLastError().
extern "C" int lf_frame_launch(const void* const* ptrs, const int* dims,
                               int planes, int streams, int bd,
                               void* stream) {
  if (planes < 1 || planes > kMaxPlanes || streams < 1
      || (bd != 8 && bd != 10 && bd != 12))
    return cudaErrorInvalidValue;
  Frame f = {};
  f.planes = planes;
  f.bd = bd;
  long long tiles = 0;
  for (int p = 0; p < planes; ++p) {
    Plane& q = f.p[p];
    const void* const* a = ptrs + 7 * p;
    const int* d = dims + 4 * p;
    if (d[0] < 1 || d[1] < 1 || (d[2] != 0 && d[2] != 2)
        || (d[3] != 0 && d[3] != 2))
      return cudaErrorInvalidValue;
    q = {static_cast<const int*>(a[0]), static_cast<int*>(const_cast<void*>(
             a[1])), static_cast<const uint8_t*>(a[2]),
         static_cast<const uint8_t*>(a[3]), static_cast<const uint8_t*>(a[4]),
         static_cast<const uint8_t*>(a[5]), static_cast<const int*>(a[6]),
         d[0], d[1], d[2], d[3], (d[1] + kTileW - 1) / kTileW, 0};
    q.tiles = q.tiles_x * ((d[0] + kTileH - 1) / kTileH);
    tiles += q.tiles;
  }
  f.tiles = (int)tiles;
  const long long grid = tiles * streams;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  LF_LAUNCH(lf_frame_kernel, (int)grid, kThreads,
            static_cast<cudaStream_t>(stream), f);
  return cudaGetLastError();
}
