// Loop restoration for Hopper (sm_90a): Wiener and self-guided (SGR)
// restoration of every plane of a frame that restores, over int32 planes,
// in one launch.
//
// Replaces easyav1_tpu/video/av1/recon/lr_jax.py:47-182 (_lr_stripes, the
// XLA-jitted stripe filter) with the host maps of _stripe_params and
// _row_sources (:266-416).  Its plain version is the port's
// recon/lr_torch.py::LoopRestoration.apply_plain (lr_stripes).
//
// What it computes (spec 7.17).  A plane is cut into stripes of 64 luma
// rows (64 >> ssy in chroma), the first starting 8 >> ssy rows above the
// plane.  An output sample at plane row y reads rows y - 3 .. y + 3,
// each clamped into the plane; a row above the stripe's first row ss
// comes from the deblocked snapshot, at max(ss - 2, row); a row below its
// last row se from the snapshot at min(se + 2, row); the others from the
// plane (after CDEF and superres).  Columns are edge-replicated.  Each
// restoration unit (by stripe and column, the last unit of a row or
// column absorbing the plane's remainder) is Wiener, SGR or none:
// - Wiener: 7 taps horizontally into (sum + 2^(round0 - 1)) >> round0,
//   clamped to [0, 2^(bd + 8 - round0) - 1], from 2^(bd + 6); then 7 taps
//   vertically from -2^(bd + round1 - 1), rounded by round1, clamped to
//   the samples' range (round0 3 and round1 11, 5 and 9 at 12 bits).
// - SGR, up to two passes (radius 2 on every other row, radius 1): box
//   sums of x and x^2 on the grid one sample around the output; above 8
//   bits the variance takes both rounded to 8 bits and b2 the raw sum;
//   p = max(a n - d^2, 0), z = (p s + 2^19) >> 20 in 32 unsigned bits
//   (it wraps, as the reference's mask does), a2 = lut[min(z, 255)],
//   b2 = ((256 - a2) b one_over_n + 2^11) >> 12 (64 bits at 12 bits only:
//   below it the product fits 31); a and b combined with weights 5, 6, 5
//   (pass 0: rows above and below on even rows of the stripe, the row
//   itself on odd ones) or 3, 4, 3 (pass 1); then the xqd blend.
// Samples outside the visible [ph, pw] and units that do not restore are
// copied through, so every sample of the output plane is written.
//
// What bounds it on this card: bytes.  It reads each plane and the four
// rows of the snapshot a stripe needs once and writes each plane once,
// some 8.3 bytes an int32 sample (a 4K 4:2:0 frame: 12.4 M samples,
// 103.6 MB, 30.9 us at 3.35 TB/s).  SGR's arithmetic, of the order of
// 100 integer operations a sample, would take about as long at 33.5
// TOP/s in a frame of SGR units alone; Wiener's takes a third of that.
//
// The design:
// - A CTA owns a tile of 32 x 32 output samples of one plane: 32
//   columns, and 32 rows of one stripe (a stripe's rows start 8 >> ssy
//   above the tile grid, and 32 divides both stripe heights).  Every unit
//   size is a multiple of 32, so a tile lies in one unit: its branches
//   (unit type, SGR radii) are uniform, and a tile that does not restore
//   is a copy.  The three planes' tiles are one grid.
// - The unit's parameters come from a table, one 20-int entry a unit
//   (type, both 7-tap Wiener filters, the SGR set, xqd0, xqd1), found
//   from the tile's stripe and column as the plain version maps them.
// - The CTA stages its 38 x 38 window (3 rows and columns of halo: the
//   Wiener taps, and the SGR grid's ring plus radius 2) once in shared
//   memory, resolving each row's source there: no gather, no padding
//   passes.
// - Wiener: the horizontal pass over the window's rows into shared
//   memory, then the vertical pass into the output.  SGR: column sums of
//   x and x^2 for the pass's radius, then the box sums and a2, b2 on the
//   34 x 34 grid (pass 0 on its even rows only, the rows it reads), then
//   the combine; each thread keeps its four outputs' filtered values in
//   registers across the passes.
// - A warp works on one row at a time, a lane a column: reads of shared
//   memory walk along rows, and the 32 outputs of a row are one 128-byte
//   store.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LR_LAUNCH
#define LR_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kTile = 32;                  // output rows and columns a CTA
constexpr int kThreads = 256;
constexpr int kHalo = 3;
constexpr int kWin = kTile + 2 * kHalo;    // the staged window's side
constexpr int kGrid = kTile + 2;           // SGR grid points a side
constexpr int kEntry = 20;                 // ints a unit's table entry
constexpr int kDims = 11;                  // ints a plane in `dims`
constexpr int kWiener = 2, kSgr = 3;       // RESTORE_WIENER, RESTORE_SGRPROJ
static_assert(kThreads == 256, "a thread an entry of the a2 table");
static_assert(kThreads / 32 * 4 == kTile, "four output rows a warp");

// Sgr_Params: radii and s of passes 0 and 1 by set
__constant__ int kSgrR[16][2] = {
    {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1},
    {2, 1}, {2, 1}, {0, 1}, {0, 1}, {0, 1}, {0, 1}, {2, 0}, {2, 0}};
__constant__ int kSgrS[16][2] = {
    {140, 3236}, {112, 2158}, {93, 1618}, {80, 1438}, {70, 1295},
    {58, 1177},  {47, 1079},  {37, 996},  {30, 925},  {25, 863},
    {0, 2589},   {0, 1618},   {0, 1177},  {0, 925},   {56, 0},
    {22, 0}};

struct Plane {
  const int* src;    // [h, w] after CDEF (and superres)
  const int* debl;   // [>= ph, dpitch] the deblocked snapshot
  int* dst;          // [h, w]
  int h, w, dpitch;  // stored rows and columns; the snapshot's columns
  int ph, pw;        // the visible size, restored
  int sh, off;       // stripe height, rows of the first stripe above 0
  int unit, urows, ucols, entry0;   // units, and the plane's first entry
  int tiles, block0;                // tiles a row, the plane's first CTA
};

struct Frame {
  Plane p[3];
  const int* table;  // [units, kEntry]
  int planes, bd;
};

union Scratch {
  int inter[kWin][kTile];              // Wiener: the horizontal pass
  struct {
    int sq[kGrid][kWin];               // SGR: column sums of x^2
    int sum[kGrid][kWin];              // and of x
  } col;
};

// One SGR pass's a2 and b2 on the grid rows it reads (every other row
// for radius 2), from the window: grid point (g, j) is centred on window
// sample (g + 2, j + 2); row i of a2s holds grid row kStep i.
template <int kR, bool kWide>
__device__ __forceinline__ void sgr_grid(const int (&win)[kWin][kWin],
                                         Scratch& sc,
                                         int (&a2s)[kGrid][kGrid],
                                         int (&b2s)[kGrid][kGrid],
                                         const int (&lut)[256], int rows,
                                         int s, int bd) {
  constexpr int kStep = kR == 2 ? 2 : 1;
  constexpr int kN = (2 * kR + 1) * (2 * kR + 1);
  constexpr int kOneOverN = kR == 2 ? 164 : 455;
  const int gn = (rows + 1) / kStep + 1;   // grid rows up to rows + 1
  for (int i = threadIdx.x; i < gn * kWin; i += kThreads) {
    const int gi = i / kWin, c = i % kWin, g = gi * kStep;
    int q = 0, m = 0;
#pragma unroll
    for (int dy = -kR; dy <= kR; ++dy) {
      const int v = win[g + 2 + dy][c];
      q += v * v;
      m += v;
    }
    sc.col.sq[gi][c] = q;
    sc.col.sum[gi][c] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * kGrid; i += kThreads) {
    const int gi = i / kGrid, j = i % kGrid;
    int a = 0, b = 0;
#pragma unroll
    for (int dx = -kR; dx <= kR; ++dx) {
      a += sc.col.sq[gi][j + 2 + dx];
      b += sc.col.sum[gi][j + 2 + dx];
    }
    int d = b;
    if (bd > 8) {
      a = (a + (1 << (2 * (bd - 8) - 1))) >> (2 * (bd - 8));
      d = (b + (1 << (bd - 9))) >> (bd - 8);
    }
    const int p = max(a * kN - d * d, 0);
    const unsigned z = ((unsigned)p * (unsigned)s + (1u << 19)) >> 20;
    const int a2 = lut[min(z, 255u)];
    int b2;
    if constexpr (kWide)
      b2 = (int)(((long long)(256 - a2) * b * kOneOverN + (1 << 11)) >> 12);
    else
      b2 = ((256 - a2) * b * kOneOverN + (1 << 11)) >> 12;
    a2s[gi][j] = a2;
    b2s[gi][j] = b2;
  }
  __syncthreads();
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads) lr_frame_kernel(Frame a) {
  __shared__ int win[kWin][kWin];
  __shared__ Scratch sc;
  __shared__ int a2s[kGrid][kGrid];
  __shared__ int b2s[kGrid][kGrid];
  __shared__ int lut[256];

  int pi = 0;
  if (a.planes > 1 && (int)blockIdx.x >= a.p[1].block0) pi = 1;
  if (a.planes > 2 && (int)blockIdx.x >= a.p[2].block0) pi = 2;
  Plane P = a.p[0];   // static indices: the parameters stay in place
  if (pi == 1) P = a.p[1];
  if (pi == 2) P = a.p[2];
  const int lb = (int)blockIdx.x - P.block0;
  const int k = lb / P.tiles, xb = lb % P.tiles * kTile;
  const int y_first = k * kTile - P.off;
  const int yb = max(y_first, 0), ye = min(y_first + kTile, P.h);
  const int rows = ye - yb, cols = min(xb + kTile, P.w) - xb;
  // the part of the tile inside the visible plane, which restores
  const int rv = min(ye, P.ph) - yb, cv = min(xb + kTile, P.pw) - xb;
  const int t = threadIdx.x, lane = t & 31, ty = t >> 5;
  const int stripe = k * kTile / P.sh;
  const int ss = stripe * P.sh - P.off, se = ss + P.sh - 1;
  const int* e = nullptr;
  int type = 0;
  if (rv > 0 && cv > 0) {
    const int urow = min(P.urows - 1, stripe * P.sh / P.unit);
    const int ucol = min(P.ucols - 1, xb / P.unit);
    e = a.table + (size_t)(P.entry0 + urow * P.ucols + ucol) * kEntry;
    type = __ldg(e);
  }
  const int maxv = (1 << a.bd) - 1;

  if (type != kWiener && type != kSgr) {
    // nothing restores here: a copy (uniform in the CTA)
    for (int i = t; i < rows * kTile; i += kThreads) {
      const int r = i / kTile, x = i % kTile;
      if (x < cols) {
        const size_t at = (size_t)(yb + r) * P.w + xb + x;
        P.dst[at] = __ldg(P.src + at);
      }
    }
    return;
  }

  // the window: plane rows yb - 3 .. yb + 34, columns xb - 3 .. xb + 34,
  // each from its source
  for (int i = t; i < kWin * kWin; i += kThreads) {
    const int r = i / kWin, c = i % kWin;
    const int y = min(max(yb - kHalo + r, 0), P.ph - 1);
    const int x = min(max(xb - kHalo + c, 0), P.pw - 1);
    const int* row = y < ss   ? P.debl + (size_t)max(ss - 2, y) * P.dpitch
                     : y > se ? P.debl + (size_t)min(se + 2, y) * P.dpitch
                              : P.src + (size_t)y * P.w;
    win[r][c] = __ldg(row + x);
  }

  int out[4];
  if (type == kWiener) {
    const int round0 = a.bd == 12 ? 5 : 3, round1 = a.bd == 12 ? 9 : 11;
    const int limit = (1 << (a.bd + 1 + 7 - round0)) - 1;
    int fh[7], fv[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      fh[j] = __ldg(e + 1 + j);
      fv[j] = __ldg(e + 8 + j);
    }
    __syncthreads();
    for (int i = t; i < (rows + 6) * kTile; i += kThreads) {
      const int r = i / kTile, x = i % kTile;
      int s = 1 << (a.bd + 6);
#pragma unroll
      for (int j = 0; j < 7; ++j) s += fh[j] * win[r][x + j];
      s = (s + (1 << (round0 - 1))) >> round0;
      sc.inter[r][x] = min(max(s, 0), limit);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = ty + 8 * q;
      if (r >= rv || lane >= cv) continue;
      int s = -(1 << (a.bd + round1 - 1));
#pragma unroll
      for (int j = 0; j < 7; ++j) s += fv[j] * sc.inter[r + j][lane];
      s = (s + (1 << (round1 - 1))) >> round1;
      out[q] = min(max(s, 0), maxv);
    }
  } else {
    const int set = __ldg(e + 15) & 15, w0 = __ldg(e + 16);
    const int w1 = __ldg(e + 17);
    lut[t] = t == 0 ? 1 : t == 255 ? 256 : ((t << 8) + t / 2) / (t + 1);
    __syncthreads();
    // centre, pass 0 and pass 1 of each output (the centre, shifted, for
    // a pass whose radius is 0)
    int c[4], f0[4], f1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q] = win[ty + 8 * q + kHalo][lane + kHalo];
      f0[q] = f1[q] = c[q] << 4;
    }
    if (kSgrR[set][0]) {
      sgr_grid<2, kWide>(win, sc, a2s, b2s, lut, rows, kSgrS[set][0], a.bd);
      const int x = lane + 1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = ty + 8 * q;
        if (r >= rv || lane >= cv) continue;
        // stripes and tiles start on even rows: r's parity is the row's
        // within its stripe
        if ((r & 1) == 0) {
          const int i = r >> 1;
          const int av = 6 * (a2s[i][x] + a2s[i + 1][x])
                         + 5 * (a2s[i][x - 1] + a2s[i][x + 1]
                                + a2s[i + 1][x - 1] + a2s[i + 1][x + 1]);
          const int bv = 6 * (b2s[i][x] + b2s[i + 1][x])
                         + 5 * (b2s[i][x - 1] + b2s[i][x + 1]
                                + b2s[i + 1][x - 1] + b2s[i + 1][x + 1]);
          f0[q] = (av * c[q] + bv + (1 << 8)) >> 9;
        } else {
          const int i = (r + 1) >> 1;
          const int av = 6 * a2s[i][x] + 5 * (a2s[i][x - 1] + a2s[i][x + 1]);
          const int bv = 6 * b2s[i][x] + 5 * (b2s[i][x - 1] + b2s[i][x + 1]);
          f0[q] = (av * c[q] + bv + (1 << 7)) >> 8;
        }
      }
      __syncthreads();   // a2s and b2s are the next pass's
    }
    if (kSgrR[set][1]) {
      sgr_grid<1, kWide>(win, sc, a2s, b2s, lut, rows, kSgrS[set][1], a.bd);
      const int x = lane + 1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = ty + 8 * q;
        if (r >= rv || lane >= cv) continue;
        const int g = r + 1;
        const int av = 4 * (a2s[g][x] + a2s[g - 1][x] + a2s[g + 1][x]
                            + a2s[g][x - 1] + a2s[g][x + 1])
                       + 3 * (a2s[g - 1][x - 1] + a2s[g - 1][x + 1]
                              + a2s[g + 1][x - 1] + a2s[g + 1][x + 1]);
        const int bv = 4 * (b2s[g][x] + b2s[g - 1][x] + b2s[g + 1][x]
                            + b2s[g][x - 1] + b2s[g][x + 1])
                       + 3 * (b2s[g - 1][x - 1] + b2s[g - 1][x + 1]
                              + b2s[g + 1][x - 1] + b2s[g + 1][x + 1]);
        f1[q] = (av * c[q] + bv + (1 << 8)) >> 9;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = c[q] << 4;
      const int v = w0 * f0[q] + w1 * u + (128 - w0 - w1) * f1[q];
      out[q] = min(max((v + (1 << 10)) >> 11, 0), maxv);
    }
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 8 * q;
    if (r >= rows || lane >= cols) continue;
    const size_t at = (size_t)(yb + r) * P.w + xb + lane;
    P.dst[at] = r < rv && lane < cv ? out[q] : __ldg(P.src + at);
  }
}

}  // namespace

// One launch restores `planes` (1 to 3) int32 planes of a frame.  ptrs: 3
// a plane, host pointers to device memory: src ([h, w], contiguous), the
// deblocked snapshot ([>= ph, dpitch], contiguous), dst ([h, w], not
// overlapping either).  dims: kDims ints a plane: h, w, dpitch, ph, pw,
// stripe height (64 or 32), its offset (8 or 4: stripe height / 8), unit
// size (a multiple of 32), unit rows, unit columns, the plane's first
// entry in `table` (int32 [units, kEntry] on the device: type, Wiener
// taps horizontal[7] and vertical[7], SGR set, xqd0, xqd1, 0, 0; row-major
// by unit row and column).  Samples lie in [0, 2^bd).  Writes every
// sample of each dst.  Returns cudaGetLastError().
extern "C" int lr_frame_launch(const void* const* ptrs, const int* dims,
                               int planes, const void* table, int bd,
                               void* stream) {
  if (planes < 1 || planes > 3 || table == nullptr
      || (bd != 8 && bd != 10 && bd != 12))
    return cudaErrorInvalidValue;
  Frame a = {};
  long long blocks = 0;
  for (int p = 0; p < planes; ++p) {
    const int* d = dims + kDims * p;
    Plane& P = a.p[p];
    P = {static_cast<const int*>(ptrs[3 * p]),
         static_cast<const int*>(ptrs[3 * p + 1]),
         static_cast<int*>(const_cast<void*>(ptrs[3 * p + 2])),
         d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9], d[10],
         0, 0};
    if (P.ph < 1 || P.ph > P.h || P.pw < 1 || P.pw > P.w || P.pw > P.dpitch
        || !((P.sh == 64 && P.off == 8) || (P.sh == 32 && P.off == 4))
        || P.unit < kTile || P.unit % kTile != 0 || P.urows < 1
        || P.ucols < 1 || P.entry0 < 0)
      return cudaErrorInvalidValue;
    P.tiles = (P.w + kTile - 1) / kTile;
    P.block0 = (int)blocks;
    blocks += (long long)(P.h + P.off + kTile - 1) / kTile * P.tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  a.table = static_cast<const int*>(table);
  a.planes = planes;
  a.bd = bd;
  if (bd == 12)
    LR_LAUNCH(lr_frame_kernel<true>, (int)blocks, kThreads,
              static_cast<cudaStream_t>(stream), a);
  else
    LR_LAUNCH(lr_frame_kernel<false>, (int)blocks, kThreads,
              static_cast<cudaStream_t>(stream), a);
  return cudaGetLastError();
}
