// Film grain synthesis for Hopper (sm_90a): the grain of every plane of
// a frame that takes it, over the cropped display planes (uint8 at 8
// bits, uint16 above), into new planes, in one launch.
//
// Replaces easyav1_tpu/video/av1/recon/fg_jax.py:49-136 (_grain_plane,
// _apply_luma, _apply_chroma, XLA-jitted).  Its plain version is the
// port's recon/fg_plain.py::apply, which maps each step to the spec.
//
// What it computes (spec 7.18.3.5).  The luma plane is cut into 32x32
// blocks (32 >> ssy rows and 32 >> ssx columns in chroma).  Each block
// row r draws an LFSR stream seeded from the frame's seed and r; the
// block in column c takes its c-th 8-bit value v, which places its
// window in each plane's grain template at column 3 + (2 >> ssx)(3 +
// (v >> 4)) and row 3 + (2 >> ssy)(3 + (v & 15)).  With overlap, a
// block's first 2 >> ssx columns blend its window with the left block's
// window extended past its right edge (weights 27, 17 then 17, 27, or
// 23, 22), its first 2 >> ssy rows likewise with the block above, whose
// extension is itself blended with the upper-left block's; each blend
// is rounded by 5 bits and clamped to the grain's range.  The noise of a
// sample is (scale * grain + 2^(shift - 1)) >> shift, scale the scaling
// LUT read at the sample (luma) or at a value made from the sample and
// the average of its luma pair (chroma; or that average alone where
// chroma scales from luma); above 8 bits the LUT is interpolated in the
// value's low bd - 8 bits.  The sample plus its noise is clamped to the
// full or the restricted range.  Luma positions past the plane's edge
// are the edge's (the plain version's edge padding).
//
// What bounds it on this card: bytes.  It reads each plane that takes
// grain once and writes it once, and reads luma once where only chroma
// takes grain: 6.2 MB for a 1080p 8-bit 4:2:0 frame, 1.86 us at 3.35
// TB/s.  Its arithmetic is some 30 integer operations a sample.
//
// The design:
// - A CTA owns one 32x32 luma block and its chroma blocks, so the luma
//   a chroma block averages is the block the CTA staged: luma is read
//   from memory once, into shared memory (edge positions clamped), and
//   every plane of the block is done in one pass.
// - Two threads draw the block's random values from the LFSR streams of
//   its row and of the row above (at most one step a block column) while
//   the others stage luma and the LUTs; one barrier.
// - The templates (int16, 36 KB for a parameter set) are read through
//   the read-only cache: a block reads a window of them and its two
//   neighbours' edges, which its threads share.
// - Luma: a warp does one row of the block at a time, a lane a column,
//   so a row of 32 samples is one load and one store.  Chroma: the
//   block's samples in row order over the CTA's threads.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FG_LAUNCH
#define FG_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kBlk = 32;                   // luma rows and columns a CTA
constexpr int kThreads = 256;
constexpr int kGW = 82, kGH = 73;          // a template's columns, rows
constexpr int kTpl = kGW * kGH;            // int16 a template in the table
constexpr int kDims = 3;                   // ints a plane in `dims`
static_assert(kThreads / 32 * 4 == kBlk, "four luma rows a warp");

struct Frame {
  const void* src[3];   // the planes, [h, w] contiguous
  void* dst[3];         // the grained planes; null: the plane is not grained
  int h[3], w[3];
  const int16_t* table; // 3 templates [kGH, kGW], then 3 LUTs [256]
  int planes, cols;     // planes, block columns
  int bd, ssx, ssy, seed, overlap, shift, csfl;
  int lo, hi_y, hi_c;   // the clip: [lo, hi_y] luma, [lo, hi_c] chroma
  int mult[2], lmult[2], offset[2];   // Cb, Cr
};

// the c-th 8-bit value (c from 0) of block row r's LFSR stream, and the
// one before it (unused for c = 0).  A step shifts the 16-bit state right
// and feeds bit 0 ^ 1 ^ 3 ^ 12 in at the top; four steps at once feed in
// bits 0-3 of s ^ s >> 1 ^ s >> 3 ^ s >> 12, since each of those taps
// still lies in the state they start from.
__device__ __forceinline__ void row_values(int seed, int r, int c, int* cur,
                                           int* prev) {
  int s = seed ^ (((r * 37 + 178) & 0xFF) << 8) ^ ((r * 173 + 105) & 0xFF);
  const int n = c & ~3;
  for (int i = 0; i < n; i += 4)
    s = (s >> 4) | (((s ^ (s >> 1) ^ (s >> 3) ^ (s >> 12)) & 15) << 12);
  int v = (s >> 8) & 0xFF, p = v;
  for (int i = n; i <= c; ++i) {
    const int bit = (s ^ (s >> 1) ^ (s >> 3) ^ (s >> 12)) & 1;
    s = (s >> 1) | (bit << 15);
    p = v;
    v = (s >> 8) & 0xFF;
  }
  *cur = v;
  *prev = p;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// the blend of two grain values, old weighted wo and new wn
__device__ __forceinline__ int blend(int old, int cur, int wo, int wn,
                                     int gmin, int gmax) {
  return clampi((old * wo + cur * wn + 16) >> 5, gmin, gmax);
}

// The grain at (y, x) of a block of bh x bw samples, from template `t`
// and the windows' offsets by neighbour (0 this block, 1 left, 2 above,
// 3 above-left): the overlap blends where `left` or `top` holds there.
__device__ __forceinline__ int grain_at(const int16_t* t, const int (&ox)[4],
                                        const int (&oy)[4], int y, int x,
                                        int bh, int bw, bool left, bool top,
                                        int nx, int ny, int gmin,
                                        int gmax) {
  int g = __ldg(t + (oy[0] + y) * kGW + ox[0] + x);
  // weights by position: (old, new) for two positions, or one
  const int wxo = nx == 2 ? (x ? 17 : 27) : 23, wxn = nx == 2 ? (x ? 27 : 17)
                                                              : 22;
  const int wyo = ny == 2 ? (y ? 17 : 27) : 23, wyn = ny == 2 ? (y ? 27 : 17)
                                                              : 22;
  if (left)
    g = blend(__ldg(t + (oy[1] + y) * kGW + ox[1] + bw + x), g, wxo, wxn,
              gmin, gmax);
  if (top) {
    int a = __ldg(t + (oy[2] + bh + y) * kGW + ox[2] + x);
    if (left)
      a = blend(__ldg(t + (oy[3] + bh + y) * kGW + ox[3] + bw + x), a, wxo,
                wxn, gmin, gmax);
    g = blend(a, g, wyo, wyn, gmin, gmax);
  }
  return g;
}

// The scaling LUT at a sample value (scale_lut, spec 7.18.3.5)
__device__ __forceinline__ int scale_at(const int* lut, int v, int bd) {
  if (bd == 8) return lut[clampi(v, 0, 255)];
  const int sh = bd - 8, x = clampi(v >> sh, 0, 255), rem = v - (x << sh);
  const int lo = lut[x], hi = lut[min(x + 1, 255)];
  return lo + (((hi - lo) * rem + (1 << (sh - 1))) >> sh);
}

template <typename P>
__global__ void __launch_bounds__(kThreads) fg_frame_kernel(Frame a) {
  __shared__ uint16_t lum[kBlk][kBlk];   // the block's luma, edge-clamped
  __shared__ int lut[3][256];
  __shared__ int rv[4];                  // this, left, above, above-left

  const int t = threadIdx.x, lane = t & 31, ty = t >> 5;
  const int r = (int)blockIdx.x / a.cols, c = (int)blockIdx.x % a.cols;
  const bool ov = a.overlap != 0;
  if (t == 0) {
    row_values(a.seed, r, c, &rv[0], &rv[1]);
  } else if (t == 32) {
    int up = 0, ul = 0;
    if (ov && r > 0) row_values(a.seed, r - 1, c, &up, &ul);
    rv[2] = up;
    rv[3] = ul;
  }
  for (int i = t; i < 3 * 256; i += kThreads)
    lut[i >> 8][i & 255] = __ldg(a.table + 3 * kTpl + i);

  const int y0 = r * kBlk, x0 = c * kBlk, h = a.h[0], w = a.w[0];
  const P* src0 = static_cast<const P*>(a.src[0]);
  int own[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = ty + 8 * q;
    const int y = min(y0 + row, h - 1), x = min(x0 + lane, w - 1);
    own[q] = src0[(size_t)y * w + x];
    lum[row][lane] = (uint16_t)own[q];
  }
  __syncthreads();

  const int gmax = (128 << (a.bd - 8)) - 1, gmin = -gmax - 1;
  const int round = 1 << (a.shift - 1);
  if (a.dst[0] != nullptr) {
    int ox[4], oy[4], g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ox[k] = 3 + 2 * (3 + (rv[k] >> 4));
      oy[k] = 3 + 2 * (3 + (rv[k] & 15));
    }
    // the grain of every row first: its reads stay inside the template
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = ty + 8 * q;
      g[q] = grain_at(a.table, ox, oy, row, lane, kBlk, kBlk,
                      ov && c > 0 && lane < 2, ov && r > 0 && row < 2, 2, 2,
                      gmin, gmax);
    }
    P* __restrict__ dst = static_cast<P*>(a.dst[0]);
    const int x = x0 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = y0 + ty + 8 * q;
      if (y >= h || x >= w) continue;
      const int noise = (scale_at(lut[0], own[q], a.bd) * g[q] + round)
                        >> a.shift;
      dst[(size_t)y * w + x] = (P)clampi(own[q] + noise, a.lo, a.hi_y);
    }
  }

  const int bw = kBlk >> a.ssx, bh = kBlk >> a.ssy;
  const int nx = 2 >> a.ssx, ny = 2 >> a.ssy, maxv = (1 << a.bd) - 1;
  int ox[4], oy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ox[k] = 3 + nx * (3 + (rv[k] >> 4));
    oy[k] = 3 + ny * (3 + (rv[k] & 15));
  }
  for (int p = 1; p < a.planes; ++p) {
    if (a.dst[p] == nullptr) continue;
    const P* src = static_cast<const P*>(a.src[p]);
    P* dst = static_cast<P*>(a.dst[p]);
    const int16_t* tpl = a.table + p * kTpl;
    const int ph = a.h[p], pw = a.w[p], cy0 = r * bh, cx0 = c * bw;
    for (int i = t; i < bh * bw; i += kThreads) {
      const int yy = i / bw, xx = i % bw, y = cy0 + yy, x = cx0 + xx;
      if (y >= ph || x >= pw) continue;
      const int s = src[(size_t)y * pw + x];
      int avg = lum[yy << a.ssy][xx << a.ssx];
      if (a.ssx) avg = (avg + lum[yy << a.ssy][(xx << 1) + 1] + 1) >> 1;
      int val = avg;
      if (!a.csfl)
        val = clampi(((avg * (a.lmult[p - 1] - 128)
                       + s * (a.mult[p - 1] - 128)) >> 6)
                         + (a.offset[p - 1] - 256) * (1 << (a.bd - 8)),
                     0, maxv);
      const int g = grain_at(tpl, ox, oy, yy, xx, bh, bw,
                             ov && c > 0 && xx < nx, ov && r > 0 && yy < ny,
                             nx, ny, gmin, gmax);
      const int noise = (scale_at(lut[p], val, a.bd) * g + round) >> a.shift;
      dst[(size_t)y * pw + x] = (P)clampi(s + noise, a.lo, a.hi_c);
    }
  }
}

}  // namespace

// One launch applies film grain to the planes (1, or 3 with chroma) of a
// frame.  ptrs: 2 a plane, host pointers to device memory: the plane
// ([h, w], contiguous; uint8 at 8 bits, uint16 above) and the grained
// plane to write (of the same shape and type, not overlapping; null
// where the plane takes no grain).  dims: kDims ints a plane: h, w, and
// whether it takes grain; a chroma plane is the luma size subsampled,
// rounded up.  params (16 ints): bit depth, ssx, ssy, the grain
// seed, overlap, grain_scaling (the noise's shift), chroma scaling from
// luma, the clip's low bound and luma's and chroma's high bounds, then
// cb_mult, cb_luma_mult, cb_offset, cr_mult, cr_luma_mult, cr_offset.
// table: int16 on the device, the three templates [73, 82] (a chroma
// template in its top-left corner) then the three scaling LUTs [256].
// Writes every sample of each grained plane.  Returns cudaGetLastError().
extern "C" int fg_frame_launch(const void* const* ptrs, const int* dims,
                               int planes, const int* params,
                               const void* table, void* stream) {
  if ((planes != 1 && planes != 3) || table == nullptr)
    return cudaErrorInvalidValue;
  Frame a = {};
  const int* q = params;
  a.bd = q[0];
  a.ssx = q[1];
  a.ssy = q[2];
  a.seed = q[3] & 0xFFFF;
  a.overlap = q[4];
  a.shift = q[5];
  a.csfl = q[6];
  a.lo = q[7];
  a.hi_y = q[8];
  a.hi_c = q[9];
  for (int i = 0; i < 2; ++i) {
    a.mult[i] = q[10 + 3 * i];
    a.lmult[i] = q[11 + 3 * i];
    a.offset[i] = q[12 + 3 * i];
  }
  if ((a.bd != 8 && a.bd != 10 && a.bd != 12) || a.ssx < 0 || a.ssx > 1
      || a.ssy < 0 || a.ssy > a.ssx || a.shift < 8 || a.shift > 11)
    return cudaErrorInvalidValue;
  int any = 0;
  for (int p = 0; p < planes; ++p) {
    const int* d = dims + kDims * p;
    a.h[p] = d[0];
    a.w[p] = d[1];
    a.src[p] = ptrs[2 * p];
    a.dst[p] = d[2] ? const_cast<void*>(ptrs[2 * p + 1]) : nullptr;
    const int sx = p ? a.ssx : 0, sy = p ? a.ssy : 0;
    if (a.h[p] < 1 || a.w[p] < 1 || a.src[p] == nullptr
        || (d[2] && a.dst[p] == nullptr)
        || a.h[p] != (a.h[0] + sy) >> sy || a.w[p] != (a.w[0] + sx) >> sx)
      return cudaErrorInvalidValue;
    any |= d[2];
  }
  a.table = static_cast<const int16_t*>(table);
  a.planes = planes;
  a.cols = (a.w[0] + kBlk - 1) / kBlk;
  const long long blocks = (long long)((a.h[0] + kBlk - 1) / kBlk) * a.cols;
  if (!any) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.bd == 8)
    FG_LAUNCH(fg_frame_kernel<uint8_t>, (int)blocks, kThreads,
              static_cast<cudaStream_t>(stream), a);
  else
    FG_LAUNCH(fg_frame_kernel<uint16_t>, (int)blocks, kThreads,
              static_cast<cudaStream_t>(stream), a);
  return cudaGetLastError();
}
