// Motion compensation for Hopper (sm_90a).
//
// Replaces the XLA kernels of easyav1_tpu/video/av1/recon/mc_jax.py:
// _mc_single_kernel (:636-677), _mc_pair_kernel (:816-867) and
// _mc_warp_kernel (:760-812) with kernel 6a, mc_kernel: one launch a
// frame over every plane's single, pair and warp units; and
// _obmc_overlay_kernel (:681-725) and _obmc_resid_kernel (:729-749) with
// kernel 6b, obmc_kernel: one launch a frame over its OBMC blocks.
//
// What the arithmetic is.  A prediction stages its (h + 7) x (w + 7)
// reference window, clamped to the reference's logical width and
// height, runs the horizontal 8-tap at (acc + 4) >> 3 and the vertical
// 8-tap with the reference's rounding: a single prediction at
// clip((acc + 1024) >> 11), each prediction of a pair at
// (acc + 64) >> 7, then the weight blend (p0 w0 + p1 w1 + 128) >> 8 or
// the mask blend (p0 m + p1 (64 - m) + 512) >> 10.  A warp unit takes
// per-pixel phases from warped_filter over its 15 x 15 window.  Then the
// residual is added (unless the unit's nores is set: OBMC and
// interintra blocks blend first), clipped, and stored.  Writes and
// residual reads are clipped to the unpadded, mi-aligned int32 planes.
// All arithmetic is integer, exact.  The shifts are the spec's (7.11.3.2)
// and depend on the bit depth: at 12 bits the horizontal pass rounds at
// >> 5 and a single prediction at >> 9, and the blends shift 2 less
// (InterPostRound 2, not 4); at 8 and 10 bits they are as above.
//
// Sample types.  The references are uint8 planes at 8 bits and uint16
// planes at 10 and 12 bits: each kernel is a template on the sample
// type, built once for both (inter_mc_launch and obmc_launch take
// uint8, inter_mc_launch16 and obmc_launch16 uint16).  A uint16 window
// is twice the bytes, so its instantiation runs 7 warps a CTA, not 8,
// to keep its static shared memory under 48 KB; with the spec's
// rounding the int16 intermediate holds at every depth (8 taps on
// 12-bit samples stay within -7166..23546 after the >> 5).
//
// What bounds it.  By the card's rates, bytes: a frame's units write
// each int32 pixel once and read about a byte and a half of reference
// and two of residual for it, while the taps cost some twenty
// multiply-adds a pixel.  As measured, the instructions a tile costs
// around its taps (finding the work, addresses, staging, predicates):
// the kernels run at about four times their byte bound, and taking the
// divisions out of the inner loops gained more than staging ahead did
// (PERF.md).  What the design does:
//
// - Work is found, not listed.  The host uploads the planner's unit
//   tables as they are with a bucket row for each (kind, plane, w, h)
//   (inter_mc.mc_tables); a work index is one tile of one unit.  A warp
//   finds its bucket by bisecting the buckets' first work indices (kept
//   in shared memory), then unit and tile offset by shifts: unit and
//   tile sizes are powers of two.
// - One warp a tile, eight warps a CTA, a fixed grid of three CTAs on
//   each SM (85 registers a thread: four CTAs have more warps but
//   spill, and measure slower) whose warps walk the work indices by the
//   grid's stride:
//   work comes from blockIdx alone, nothing to reset between launches.
//   A tile is at most 16 wide and 256 pixels (tile_w, tile_h), so a 4x4
//   or 8x8 unit keeps a warp, not 256 threads, and eight of them share a
//   CTA.  No barrier joins the warps after the first, so a warp whose
//   unit is invalid just goes on.
// - While a warp computes a tile, the next tile's windows are on their
//   way: cp.async in aligned 4-byte pieces (four uint8 or two uint16
//   samples) into the second of two sets of window buffers (a pair
//   stages both its windows together).  A window that crosses the
//   reference's border takes the clamped path, sample by sample.
// - Windows stay in the sample type in shared memory, the intermediate
//   is int16 (8 taps on 8-bit pixels stay within +-5865 after the >> 3).
//   A lane runs four horizontal outputs from 11 window samples in
//   registers, and up to eight vertical outputs down a column from 15
//   intermediates.
// - Only live taps.  A window is staged from its first to its last
//   nonzero tap; a pass whose filter is the single tap 128 (whole-pixel
//   motion in that direction) takes that tap alone.  What was not staged
//   meets a zero tap.
//
// Kernel 6b.  Every overlay of an OBMC block lies inside the block's
// rect and predicts from the references, never from a neighbour's
// output, so the reference's three passes (above overlays, left
// overlays, the deferred residual) depend on each other only inside one
// block.  A work index is one tile of one OBMC block: the warp reads the
// tile's bare prediction (6a's output) once, blends the part of each
// above overlay that covers it, then of each left overlay, adds the
// residual, clips and stores once.  The windows of up to four overlays
// that reach into the tile are staged together.  The host groups the
// overlays by block (inter_mc.obmc_tables).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

// The launch, as a macro so that a host build can run the kernels
// (tools/torch_mc_host_run.py).
#ifndef MC_LAUNCH
#define MC_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

// mc_plan layouts
enum { S_X, S_Y, S_SLOT, S_IX, S_IY, S_VALID, S_FH = 6, S_FV = 14,
       S_NORES = 22, NS = 23 };
enum { P_X, P_Y, P_VALID, P_PRED0 = 3, P_PRED1 = 22, P_W0 = 41, P_W1 = 42,
       P_MODE = 43, P_MIDX = 44, NPR = 45 };
enum { W_X, W_Y, W_VALID, W_SLOT, W_IX4, W_IY4, W_SX4, W_SY4, W_ALPHA,
       W_BETA, W_GAMMA, W_DELTA, NW };
// inter_mc's tables: bucket rows, 6b's block and overlay records
enum { K_SINGLE, K_PAIR, K_WARP, K_BLOCK };
enum { B_KIND, B_PLANE, B_W, B_H, B_UNIT, B_TILE, B_MASK, NB = 8 };
enum { K_X, K_Y, K_OV, K_NA, K_NL, NK };
enum { O_W = NS, O_H, NOV };

// Warps (tiles in flight) a CTA, and the samples of a window buffer: 39
// rows x 20, or 23 x 28, of uint8; 39 x 16, or 23 x 24, of uint16
// (win_pitch).  The uint16 windows are twice the bytes: 7 warps keep the
// static shared memory at 45,920 bytes, and 8 would pass the 48 KB limit.
template <typename T> constexpr int kWarps = sizeof(T) == 1 ? 8 : 7;
// CTAs an SM: 85 registers a thread; at 4 (64) both kernels spill
constexpr int kCtasPerSm = 3;
template <typename T> constexpr int kWinElems = sizeof(T) == 1 ? 784 : 624;
constexpr int MAXB = 512;        // inter_mc.MAX_BUCKETS
constexpr int MID_ELEMS = 416;   // 23 rows x 18 int16, or 39 x 10
constexpr int WF_ELEMS = 193 * 8;

template <typename T>
struct Frame {
  int32_t* out[3];          // [ph, pw] planes, written in place
  const int16_t* resid[3];  // [ph, pw]
  const T* ref[3][8];       // [rh, rw] logical reference planes per slot
  int ph[3], pw[3];
  int rw[3], rh[3];         // the references' logical dims (= row pitch)
  int bd;
};

// InterRound0: 5 at 12 bits, else 3 (a constant for uint8); a single
// prediction rounds at 14 - InterRound0, the blends InterPostRound =
// 7 - InterRound0 later than at 8 bits.
template <typename T>
__device__ __forceinline__ int round0(const Frame<T>& F) {
  return sizeof(T) == 1 ? 3 : (F.bd == 12 ? 5 : 3);
}

struct Tabs {               // the sections of the upload buffer
  const int32_t* buckets;   // [nb, NB]
  const int32_t* singles;   // 6a [n, NS]; 6b: the blocks [n, NK]
  const int32_t* pairs;     // 6a [n, NPR]; 6b: the overlays [n, NOV]
  const int32_t* warps;     // 6a [n, NW]
  const uint8_t* masks;     // 6a: the pair buckets' mask stacks
  int nb, total, n_warps;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
#else
  memcpy(smem, gmem, 4);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}

// Unit and tile sizes are powers of two, so the kernels divide by
// shifting.
__device__ __forceinline__ int lg2(int v) { return 31 - __clz(v); }

// A unit of w x h is cut into tiles of tile_w x tile_h, one a warp.
__device__ __forceinline__ int tile_w(int w) { return w < 16 ? w : 16; }
__device__ __forceinline__ int tile_h(int w, int h) {
  const int m = w < 16 ? 32 : 16;
  return h < m ? h : m;
}
// Samples a 4-byte piece holds.
template <typename T> constexpr int kPiece = 4 / sizeof(T);

// Row pitch of a window (samples) and of the intermediate (int16) of a
// tile tw wide: up to kPiece - 1 samples of alignment, tw + 7 pixels,
// and a lane's 11-sample read from the last group of four; rows start
// on 4-byte boundaries.
template <typename T>
__device__ __forceinline__ int win_pitch(int tw) {
  return sizeof(T) == 1 ? (tw < 8 ? 16 : tw + 12) : (tw < 8 ? 12 : tw + 8);
}
__device__ __forceinline__ int mid_pitch(int tw) { return tw + 2; }

// One work index: which bucket, unit and tile.
struct Item {
  int kind, pl, w, h, tw, th, ox, oy, mask;
  int unit;
};

__device__ __forceinline__ Item find(const Tabs& T, const int* first,
                                     int idx) {
  int lo = 0, hi = T.nb;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= idx) lo = mid; else hi = mid;
  }
  const int32_t* b = T.buckets + lo * NB;
  Item it;
  it.kind = __ldg(b + B_KIND);
  it.pl = __ldg(b + B_PLANE);
  it.w = __ldg(b + B_W);
  it.h = __ldg(b + B_H);
  it.mask = __ldg(b + B_MASK);
  it.tw = tile_w(it.w);
  it.th = tile_h(it.w, it.h);
  // nx tiles across, nx * ny a unit
  const int lnx = lg2(it.w) - lg2(it.tw);
  const int lper = lnx + lg2(it.h) - lg2(it.th);
  const int local = idx - first[lo];
  const int t = local & ((1 << lper) - 1);
  it.unit = __ldg(b + B_UNIT) + (local >> lper);
  it.ox = (t & ((1 << lnx) - 1)) * it.tw;
  it.oy = (t >> lnx) * it.th;
  return it;
}

// One prediction of a rect: where its window's tap 0 of pixel (0, 0)
// lies in the reference, its taps and their live ranges.
template <typename T>
struct Pred {
  const T* ref;
  int x0, y0;
  int fh[8], fv[8];
  int c0, c1, r0, r1;       // first and last live tap across, down
};

__device__ __forceinline__ void live_taps(const int* f, int& a, int& b) {
  a = 7;
  b = 0;
#pragma unroll
  for (int k = 7; k >= 0; --k) if (f[k] != 0) a = k;
#pragma unroll
  for (int k = 0; k < 8; ++k) if (f[k] != 0) b = k;
  if (a > b) a = b = 3;     // no tap at all: the prediction is 0
}

// p: slot, ix, iy; taps: fh[8], fv[8] (a single unit's from S_SLOT and
// S_FH, a pair's prediction from P_PRED0 or P_PRED1 and 3 on); (dx, dy):
// the rect's offset in the unit.
template <typename T>
__device__ __forceinline__ Pred<T> load_pred(const Frame<T>& F, int pl,
                                             const int32_t* p,
                                             const int32_t* taps, int dx,
                                             int dy) {
  Pred<T> P;
  P.ref = F.ref[pl][__ldg(p)];
  P.x0 = __ldg(p + 1) + dx - 3;
  P.y0 = __ldg(p + 2) + dy - 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    P.fh[k] = __ldg(taps + k);
    P.fv[k] = __ldg(taps + 8 + k);
  }
  live_taps(P.fh, P.c0, P.c1);
  live_taps(P.fv, P.r0, P.r1);
  return P;
}

// Where row r of a window starts in its shared-memory row: the offset,
// in samples, of reference pixel (y0 + r, x0) within its 4-byte word,
// so that aligned 4-byte pieces of the reference land on aligned words.
template <typename T>
__device__ __forceinline__ int row_shift(const Pred<T>& P, int rw, int r) {
  return (static_cast<int>(reinterpret_cast<uintptr_t>(P.ref) & 3)
          / static_cast<int>(sizeof(T)) + (P.y0 + r) * rw + P.x0)
         & (kPiece<T> - 1);
}

// Stages the live rows and columns of the (ih + 7) x (iw + 7) window of
// P into win: sample row_shift + c of row r holds reference pixel
// (y0 + r, x0 + c), clamped to the reference.  Asynchronous where the
// window lies inside the reference; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage(const Pred<T>& P, int rw, int rh,
                                      int iw, int ih, int wp, T* win,
                                      int lane) {
  constexpr int S = kPiece<T>;
  const int cs = P.c0, ncols = iw + P.c1 - P.c0;
  const int rs = P.r0, nrows = ih + P.r1 - P.r0;
  const int xs = P.x0 + cs, ys = P.y0 + rs;
  if (xs >= 0 && xs + ncols <= rw && ys >= 1
      && ys + nrows <= rh - 1) {
    // rows strictly inside: the up to S - 1 samples read before and
    // after a row's pixels stay in the plane
    // 16 lanes a row where it has more than 8 words, 8 where it has 5
    // to 8, 4 where it has at most 4
    const int words = wp * static_cast<int>(sizeof(T)) / 4;
    const int ll = words > 8 ? 4 : (words > 4 ? 3 : 2);
    for (int i = lane >> ll; i < nrows; i += 32 >> ll) {
      const int r = rs + i;
      const int off = row_shift(P, rw, r);
      const int w = (off + cs) / S + (lane & ((1 << ll) - 1));
      if (w < (off + cs + ncols + S - 1) / S)
        cp_async4(win + r * wp + S * w,
                  P.ref + (static_cast<ptrdiff_t>(P.y0 + r) * rw + P.x0 - off
                           + S * w));
    }
  } else {
    for (int k = lane; k < nrows * ncols; k += 32) {
      const int r = rs + k / ncols, c = cs + k % ncols;
      win[r * wp + row_shift(P, rw, r) + c] =
          __ldg(P.ref + static_cast<size_t>(clampi(P.y0 + r, 0, rh - 1)) * rw
                + clampi(P.x0 + c, 0, rw - 1));
    }
  }
}

// The horizontal pass over the live rows of a staged window: mid[r][c] =
// (sum_q win[r][c + q] fh[q] + (1 << r0) / 2) >> r0 for c < iw.
template <typename T>
__device__ __forceinline__ void hpass(const Pred<T>& P, int rw, int iw,
                                      int ih, int wp, int mp, const T* win,
                                      int16_t* mid, int r0, int lane) {
  const int rnd = 1 << (r0 - 1);
  const int rs = P.r0, nrows = ih + P.r1 - P.r0;
  const int gpr = (iw + 3) >> 2, lg = lg2(gpr);
  const bool pow2 = (1 << lg) == gpr;
  const bool one = P.c0 == 3 && P.c1 == 3;
  for (int k = lane; k < nrows * gpr; k += 32) {
    const int q = pow2 ? k >> lg : k / gpr;
    const int r = rs + q, c = (k - q * gpr) * 4;
    const T* s = win + r * wp + row_shift(P, rw, r) + c;
    int16_t* d = mid + r * mp + c;
    if (one) {
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (c + o < iw)
          d[o] = static_cast<int16_t>((s[o + 3] * P.fh[3] + rnd) >> r0);
    } else {
      int px[11];
#pragma unroll
      for (int q = 0; q < 11; ++q) px[q] = s[q];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        int a = rnd;
#pragma unroll
        for (int q = 0; q < 8; ++q) a += px[o + q] * P.fh[q];
        if (c + o < iw) d[o] = static_cast<int16_t>(a >> r0);
      }
    }
  }
}

// The vertical sums, before their final rounding, of the n tile pixels
// (row0 + o, col), o < n <= 8, of a lane, where they lie in the rect
// [dy, dy + ih) x [dx, dx + iw) of the tile that mid was made for; 0
// elsewhere.
template <typename T>
__device__ __forceinline__ void vpass(const Pred<T>& P, int dx, int dy, int iw,
                                      int ih, int mp, const int16_t* mid,
                                      int col, int row0, int n,
                                      int (&acc)[8]) {
  const int c = col - dx, rb = row0 - dy;
#pragma unroll
  for (int o = 0; o < 8; ++o) acc[o] = 0;
  if (c < 0 || c >= iw) return;
  if (P.r0 == 3 && P.r1 == 3) {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int r = rb + o;
      if (o < n && r >= 0 && r < ih) acc[o] = mid[(r + 3) * mp + c] * P.fv[3];
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 15; ++q) {
    if (q < n + 7) {
      const int r = rb + q;
      const int v = (r >= 0 && r < ih + 7) ? mid[r * mp + c] : 0;
#pragma unroll
      for (int o = 0; o < 8; ++o)
        if (q - o >= 0 && q - o < 8) acc[o] += v * P.fv[q - o];
    }
  }
}

// A lane's pixels of a tile tw x th: column j, rows r0 .. r0 + n - 1.
struct Lane {
  int j, r0, n;
};

__device__ __forceinline__ Lane lane_map(int tw, int th, int lane) {
  const int ltw = lg2(tw), lpc = 32 >> ltw;      // lanes a column
  Lane L;
  L.n = (th + lpc - 1) >> (5 - ltw);
  L.j = lane & (tw - 1);
  L.r0 = (lane >> ltw) * L.n;
  return L;
}

// How many of a lane's rows, from plane row y on, lie in the tile and
// in the plane (0 where its column x lies outside the plane).
__device__ __forceinline__ int rows_in(const Lane& L, int th, int x, int y,
                                       int pw, int ph) {
  return x < pw ? max(0, min(L.n, min(th - L.r0, ph - y))) : 0;
}

// The shared memory of a warp: two sets of two windows, one
// intermediate.
template <typename T>
struct __align__(16) WarpMem {
  T win[2][2][kWinElems<T>];
  int16_t mid[MID_ELEMS];
};

// The reference position of a warp unit's window as a Pred (taps
// unused, all live): 15 x 15 from (ix4 - 7, iy4 - 7).
template <typename T>
__device__ __forceinline__ Pred<T> warp_pred(const Frame<T>& F, int pl,
                                             const int32_t* f) {
  Pred<T> P;
  P.ref = F.ref[pl][__ldg(f + W_SLOT)];
  P.x0 = __ldg(f + W_IX4) - 7;
  P.y0 = __ldg(f + W_IY4) - 7;
  P.c0 = P.r0 = 0;
  P.c1 = P.r1 = 7;
  return P;
}

// Stages the windows of work index idx into window set `set` of m.
template <typename T>
__device__ __forceinline__ void stage_item(const Frame<T>& F, const Tabs& B,
                                           const int* first, int idx,
                                           WarpMem<T>& m, int set, int lane) {
  const Item it = find(B, first, idx);
  const int rw = F.rw[it.pl], rh = F.rh[it.pl], wp = win_pitch<T>(it.tw);
  if (it.kind == K_SINGLE) {
    const int32_t* f = B.singles + static_cast<size_t>(it.unit) * NS;
    if (!__ldg(f + S_VALID)) return;
    const Pred<T> P = load_pred(F, it.pl, f + S_SLOT, f + S_FH, it.ox,
                                it.oy);
    stage(P, rw, rh, it.tw, it.th, wp, m.win[set][0], lane);
  } else if (it.kind == K_PAIR) {
    const int32_t* f = B.pairs + static_cast<size_t>(it.unit) * NPR;
    if (!__ldg(f + P_VALID)) return;
    for (int k = 0; k < 2; ++k) {
      const int32_t* p = f + (k ? P_PRED1 : P_PRED0);
      const Pred<T> P = load_pred(F, it.pl, p, p + 3, it.ox, it.oy);
      stage(P, rw, rh, it.tw, it.th, wp, m.win[set][k], lane);
    }
  } else {
    const int32_t* f = B.warps + static_cast<size_t>(it.unit) * NW;
    if (!__ldg(f + W_VALID)) return;
    stage(warp_pred(F, it.pl, f), rw, rh, 8, 8, wp, m.win[set][0], lane);
  }
}

// One 8x8 warp unit from its staged window (mc_jax._mc_warp_kernel).
template <typename T>
__device__ __forceinline__ void warp_unit(const Frame<T>& F, int pl,
                                          const int32_t* f,
                                          const int16_t* wf, WarpMem<T>& m,
                                          int set, int lane) {
  const Pred<T> P = warp_pred(F, pl, f);
  const int rw = F.rw[pl], wp = win_pitch<T>(8), mp = mid_pitch(8);
  const int r0 = round0(F);
  const int sx4 = __ldg(f + W_SX4), sy4 = __ldg(f + W_SY4);
  const int alpha = __ldg(f + W_ALPHA), beta = __ldg(f + W_BETA);
  const int gamma = __ldg(f + W_GAMMA), delta = __ldg(f + W_DELTA);
  for (int t = lane; t < 15 * 8; t += 32) {
    const int k = t >> 3, l = t & 7;
    const int16_t* c = wf + (((sx4 + beta * (k - 3) + alpha * l + 512) >> 10)
                             + 64) * 8;
    const T* s = m.win[set][0] + k * wp + row_shift(P, rw, k) + l;
    int a = 1 << (r0 - 1);
#pragma unroll
    for (int q = 0; q < 8; ++q) a += s[q] * c[q];
    m.mid[k * mp + l] = static_cast<int16_t>(a >> r0);
  }
  __syncwarp();
  const int mx = (1 << F.bd) - 1;
  const int x = __ldg(f + W_X), y = __ldg(f + W_Y);
  for (int t = lane; t < 64; t += 32) {
    const int k = t >> 3, l = t & 7;
    const int16_t* c = wf + (((sy4 + delta * k + gamma * l + 512) >> 10)
                             + 64) * 8;
    int a = 1 << (13 - r0);
#pragma unroll
    for (int q = 0; q < 8; ++q) a += m.mid[(k + q) * mp + l] * c[q];
    const int yy = y + k, xx = x + l;
    if (yy < F.ph[pl] && xx < F.pw[pl]) {
      const size_t o = static_cast<size_t>(yy) * F.pw[pl] + xx;
      F.out[pl][o] = clampi(clampi(a >> (14 - r0), 0, mx) + F.resid[pl][o],
                            0, mx);
    }
  }
}

// Computes and stores work index idx from window set `set` of m.
template <typename T>
__device__ __forceinline__ void compute_item(const Frame<T>& F, const Tabs& B,
                                             const int* first,
                                             const int16_t* wf, int idx,
                                             WarpMem<T>& m, int set,
                                             int lane) {
  const Item it = find(B, first, idx);
  const int pl = it.pl, rw = F.rw[pl];
  if (it.kind == K_WARP) {
    const int32_t* f = B.warps + static_cast<size_t>(it.unit) * NW;
    if (__ldg(f + W_VALID)) warp_unit(F, pl, f, wf, m, set, lane);
    return;
  }
  const bool pair = it.kind == K_PAIR;
  const int32_t* f = pair ? B.pairs + static_cast<size_t>(it.unit) * NPR
                          : B.singles + static_cast<size_t>(it.unit) * NS;
  const int c_valid = pair ? int(P_VALID) : int(S_VALID);
  const int c_x = pair ? int(P_X) : int(S_X), c_y = pair ? int(P_Y) : int(S_Y);
  const int c_pred = pair ? int(P_PRED0) : int(S_SLOT);
  const int c_taps = pair ? int(P_PRED0) + 3 : int(S_FH);
  if (!__ldg(f + c_valid)) return;
  const int wp = win_pitch<T>(it.tw), mp = mid_pitch(it.tw);
  const int mx = (1 << F.bd) - 1;
  const int r0 = round0(F), ipr = 7 - r0;
  const Lane L = lane_map(it.tw, it.th, lane);
  const int x = __ldg(f + c_x) + it.ox + L.j;
  const int y = __ldg(f + c_y) + it.oy + L.r0;
  const bool nores = !pair && __ldg(f + S_NORES) != 0;
  // the residual first: its loads fly while the passes run
  const int pw = F.pw[pl], nv = rows_in(L, it.th, x, y, pw, F.ph[pl]);
  const size_t at = static_cast<size_t>(y) * pw + x;
  const int16_t* rp = F.resid[pl] + at;
  int res[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) res[o] = o < nv && !nores ? rp[o * pw] : 0;
  int v[8];
  {
    const Pred<T> P = load_pred(F, pl, f + c_pred, f + c_taps, it.ox,
                                it.oy);
    hpass(P, rw, it.tw, it.th, wp, mp, m.win[set][0], m.mid, r0, lane);
    __syncwarp();
    vpass(P, 0, 0, it.tw, it.th, mp, m.mid, L.j, L.r0, L.n, v);
  }
  if (pair) {
    int v1[8];
    __syncwarp();             // the intermediate is written again
    const Pred<T> P = load_pred(F, pl, f + P_PRED1, f + P_PRED1 + 3, it.ox,
                                it.oy);
    hpass(P, rw, it.tw, it.th, wp, mp, m.win[set][1], m.mid, r0, lane);
    __syncwarp();
    vpass(P, 0, 0, it.tw, it.th, mp, m.mid, L.j, L.r0, L.n, v1);
    const bool masked = __ldg(f + P_MODE) == 1;
    const int w0 = __ldg(f + P_W0), w1 = __ldg(f + P_W1);
    const uint8_t* mk = B.masks + it.mask
        + (static_cast<size_t>(__ldg(f + P_MIDX)) * it.h + it.oy + L.r0)
          * it.w + it.ox + L.j;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int p0 = (v[o] + 64) >> 7, p1 = (v1[o] + 64) >> 7;
      if (masked) {
        const int mm = o < nv ? __ldg(mk + o * it.w) : 0;
        v[o] = (p0 * mm + p1 * (64 - mm) + (32 << ipr)) >> (ipr + 6);
      } else {
        v[o] = (p0 * w0 + p1 * w1 + (8 << ipr)) >> (ipr + 4);
      }
      v[o] = clampi(v[o], 0, mx);
    }
  } else {
#pragma unroll
    for (int o = 0; o < 8; ++o)
      v[o] = clampi((v[o] + (1 << (13 - r0))) >> (14 - r0), 0, mx);
  }
  int32_t* op = F.out[pl] + at;
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (o < nv) op[o * pw] = nores ? v[o] : clampi(v[o] + res[o], 0, mx);
}

// The buckets' first work indices, then the total, into shared memory.
__device__ __forceinline__ void load_first(const Tabs& B, int* first,
                                           int threads) {
  for (int k = threadIdx.x; k <= B.nb; k += threads)
    first[k] = k < B.nb ? __ldg(B.buckets + k * NB + B_TILE) : B.total;
}

// Kernel 6a: each warp walks work indices, one tile of a single, pair
// or warp unit each.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps<T>, kCtasPerSm)
mc_kernel(Frame<T> F, Tabs B, const int32_t* wf) {
  constexpr int W = kWarps<T>;
  __shared__ int first[MAXB + 1];
  __shared__ int16_t swf[WF_ELEMS];
  __shared__ WarpMem<T> mem[W];
  load_first(B, first, 32 * W);
  if (B.n_warps)
    for (int k = threadIdx.x; k < WF_ELEMS; k += 32 * W)
      swf[k] = static_cast<int16_t>(__ldg(wf + k));
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * W;
  WarpMem<T>& m = mem[warp];
  int set = 0;
  int idx = blockIdx.x * W + warp;
  if (idx < B.total) stage_item(F, B, first, idx, m, 0, lane);
  cp_async_commit();
  for (; idx < B.total; idx += stride) {
    if (idx + stride < B.total)
      stage_item(F, B, first, idx + stride, m, set ^ 1, lane);
    cp_async_commit();
    cp_async_wait<1>();       // all but the group just committed
    __syncwarp();
    compute_item(F, B, first, swf, idx, m, set, lane);
    __syncwarp();             // before the set is staged again
    set ^= 1;
  }
  cp_async_wait<0>();
}

// The part of an overlay's rect that a tile holds.
struct Rect {
  int ux, uy, uw, uh;       // the overlay's rect
  int x0, y0, iw, ih;       // the part inside the tile
};

// Whether the valid overlay f reaches into the tile at (tx, ty).
__device__ __forceinline__ bool reach(const int32_t* f, int tx, int ty,
                                      int tw, int th, Rect& R) {
  R.ux = __ldg(f + S_X);
  R.uy = __ldg(f + S_Y);
  R.uw = __ldg(f + O_W);
  R.uh = __ldg(f + O_H);
  R.x0 = max(tx, R.ux);
  R.y0 = max(ty, R.uy);
  R.iw = min(tx + tw, R.ux + R.uw) - R.x0;
  R.ih = min(ty + th, R.uy + R.uh) - R.y0;
  return __ldg(f + S_VALID) != 0 && R.iw > 0 && R.ih > 0;
}

// Kernel 6b: each warp walks work indices, one tile of an OBMC block
// each.  masks: the OBMC masks of lengths 2..32, the one of length n at
// offset n - 2.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps<T>, kCtasPerSm)
obmc_kernel(Frame<T> F, Tabs B, const int32_t* masks) {
  constexpr int W = kWarps<T>;
  __shared__ int first[MAXB + 1];
  __shared__ WarpMem<T> mem[W];
  load_first(B, first, 32 * W);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpMem<T>& m = mem[warp];
  const int mx = (1 << F.bd) - 1;
  const int r0 = round0(F);
  for (int idx = blockIdx.x * W + warp; idx < B.total;
       idx += gridDim.x * W) {
    const Item it = find(B, first, idx);
    const int pl = it.pl, rw = F.rw[pl], rh = F.rh[pl];
    const int pw = F.pw[pl], ph = F.ph[pl];
    const int wp = win_pitch<T>(it.tw), mp = mid_pitch(it.tw);
    const int32_t* blk = B.singles + static_cast<size_t>(it.unit) * NK;
    const int tx = __ldg(blk + K_X) + it.ox, ty = __ldg(blk + K_Y) + it.oy;
    const int ov0 = __ldg(blk + K_OV), na = __ldg(blk + K_NA);
    const int n_ov = na + __ldg(blk + K_NL);
    const Lane L = lane_map(it.tw, it.th, lane);
    const int x = tx + L.j, y = ty + L.r0;
    const int nv = rows_in(L, it.th, x, y, pw, ph);
    const size_t at = static_cast<size_t>(y) * pw + x;
    int32_t* op = F.out[pl] + at;
    const int16_t* rp = F.resid[pl] + at;
    int cur[8], res[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      cur[o] = o < nv ? op[o * pw] : 0;
      res[o] = o < nv ? rp[o * pw] : 0;
    }
    // up to four overlays that reach into this tile are staged
    // together, then run in their order: above before left
    for (int k = 0; k < n_ov;) {
      unsigned batch = 0;
      int cnt = 0;
      for (; k < n_ov && cnt < 4; ++k) {
        const int32_t* f = B.pairs + static_cast<size_t>(ov0 + k) * NOV;
        Rect R;
        if (!reach(f, tx, ty, it.tw, it.th, R)) continue;
        const Pred<T> P = load_pred(F, pl, f + S_SLOT, f + S_FH, R.x0 - R.ux,
                                    R.y0 - R.uy);
        stage(P, rw, rh, R.iw, R.ih, wp, m.win[cnt >> 1][cnt & 1], lane);
        batch |= static_cast<unsigned>(k) << (8 * cnt);
        ++cnt;
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      for (int i = 0; i < cnt; ++i) {
        const int kk = (batch >> (8 * i)) & 255;
        const int32_t* f = B.pairs + static_cast<size_t>(ov0 + kk) * NOV;
        Rect R;
        reach(f, tx, ty, it.tw, it.th, R);
        const Pred<T> P = load_pred(F, pl, f + S_SLOT, f + S_FH, R.x0 - R.ux,
                                    R.y0 - R.uy);
        hpass(P, rw, R.iw, R.ih, wp, mp, m.win[i >> 1][i & 1], m.mid, r0,
              lane);
        __syncwarp();
        int v[8];
        vpass(P, R.x0 - tx, R.y0 - ty, R.iw, R.ih, mp, m.mid, L.j, L.r0, L.n,
              v);
        const bool left = kk >= na;
        const bool col_in = x >= R.x0 && x < R.x0 + R.iw;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          if (o < nv && col_in && y + o >= R.y0 && y + o < R.y0 + R.ih) {
            const int mm = __ldg(masks + (left ? R.uw - 2 + x - R.ux
                                               : R.uh - 2 + y + o - R.uy));
            const int p = clampi((v[o] + (1 << (13 - r0))) >> (14 - r0), 0,
                                 mx);
            cur[o] = (mm * cur[o] + (64 - mm) * p + 32) >> 6;
          }
        }
        __syncwarp();         // before the intermediate, and after the
                              // last of a batch the windows, are written
                              // again
      }
    }
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if (o < nv) op[o * pw] = clampi(cur[o] + res[o], 0, mx);
  }
}

template <typename T>
Frame<T> make_frame(int np, void* const* out, const void* const* resid,
                    const int* ph, const int* pw, const void* const* refs,
                    const int* rw, const int* rh, int bd) {
  Frame<T> F = {};
  for (int p = 0; p < np; ++p) {
    F.out[p] = static_cast<int32_t*>(out[p]);
    F.resid[p] = static_cast<const int16_t*>(resid[p]);
    for (int s = 0; s < 8; ++s)
      F.ref[p][s] = static_cast<const T*>(refs[8 * p + s]);
    F.ph[p] = ph[p];
    F.pw[p] = pw[p];
    F.rw[p] = rw[p];
    F.rh[p] = rh[p];
  }
  F.bd = bd;
  return F;
}

// The fixed grid: enough CTAs of `warps` warps for the work, at most
// kCtasPerSm on each SM of the current device.
int grid_for(int total, int warps) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || sms < 1)
    sms = 132;
  const int want = (total + warps - 1) / warps;
  return want < sms * kCtasPerSm ? want : sms * kCtasPerSm;
}

template <typename T>
int mc_launch_t(int np, void* const* out, const void* const* resid,
                const int* ph, const int* pw, const void* const* refs,
                const int* rw, const int* rh, const void* buf,
                const int* layout, const void* wf, int bd, void* stream) {
  if (np < 1 || np > 3 || layout[0] < 1 || layout[0] > MAXB || layout[1] < 1)
    return cudaErrorInvalidValue;
  const Frame<T> F = make_frame<T>(np, out, resid, ph, pw, refs, rw, rh, bd);
  const int32_t* b = static_cast<const int32_t*>(buf);
  Tabs B = {};
  B.nb = layout[0];
  B.total = layout[1];
  B.buckets = b + layout[2];
  B.singles = b + layout[3];
  B.pairs = b + layout[4];
  B.warps = b + layout[5];
  B.masks = reinterpret_cast<const uint8_t*>(b + layout[6]);
  B.n_warps = layout[7];
  MC_LAUNCH(mc_kernel<T>, grid_for(B.total, kWarps<T>), 32 * kWarps<T>,
            static_cast<cudaStream_t>(stream), F, B,
            static_cast<const int32_t*>(wf));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int obmc_launch_t(int np, void* const* out, const void* const* resid,
                  const int* ph, const int* pw, const void* const* refs,
                  const int* rw, const int* rh, const void* buf,
                  const int* layout, const void* masks, int bd,
                  void* stream) {
  if (np < 1 || np > 3 || layout[0] < 1 || layout[0] > MAXB || layout[1] < 1)
    return cudaErrorInvalidValue;
  const Frame<T> F = make_frame<T>(np, out, resid, ph, pw, refs, rw, rh, bd);
  const int32_t* b = static_cast<const int32_t*>(buf);
  Tabs B = {};
  B.nb = layout[0];
  B.total = layout[1];
  B.buckets = b + layout[2];
  B.singles = b + layout[3];
  B.pairs = b + layout[4];
  MC_LAUNCH(obmc_kernel<T>, grid_for(B.total, kWarps<T>), 32 * kWarps<T>,
            static_cast<cudaStream_t>(stream), F, B,
            static_cast<const int32_t*>(masks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel 6a over one frame on `stream`: np planes out[p] int32 and
// resid[p] int16 of [ph[p], pw[p]], refs[8 p + s] the uint8
// [rh[p], rw[p]] plane of slot s; buf: inter_mc.mc_tables' buffer on the
// device, layout: its host ints [buckets, work indices, the int32
// offsets of the buckets, singles, pairs, warps and masks, warp units];
// wf: warped_filter [193, 8] int32.  Returns the cudaError_t of the
// launch.
extern "C" int inter_mc_launch(int np, void* const* out,
                               const void* const* resid, const int* ph,
                               const int* pw, const void* const* refs,
                               const int* rw, const int* rh, const void* buf,
                               const int* layout, const void* wf, int bd,
                               void* stream) {
  return mc_launch_t<uint8_t>(np, out, resid, ph, pw, refs, rw, rh, buf,
                              layout, wf, bd, stream);
}

// Kernel 6a on uint16 reference planes (bd 10 or 12); as inter_mc_launch.
extern "C" int inter_mc_launch16(int np, void* const* out,
                                 const void* const* resid, const int* ph,
                                 const int* pw, const void* const* refs,
                                 const int* rw, const int* rh,
                                 const void* buf, const int* layout,
                                 const void* wf, int bd, void* stream) {
  return mc_launch_t<uint16_t>(np, out, resid, ph, pw, refs, rw, rh, buf,
                               layout, wf, bd, stream);
}

// Kernel 6b over one frame's OBMC blocks; buf: inter_mc.obmc_tables'
// buffer on the device, layout: [buckets, work indices, the int32
// offsets of the buckets, blocks and overlays]; masks: the OBMC masks,
// int32.  Other arguments as inter_mc_launch.  Returns the cudaError_t
// of the launch.
extern "C" int obmc_launch(int np, void* const* out,
                           const void* const* resid, const int* ph,
                           const int* pw, const void* const* refs,
                           const int* rw, const int* rh, const void* buf,
                           const int* layout, const void* masks, int bd,
                           void* stream) {
  return obmc_launch_t<uint8_t>(np, out, resid, ph, pw, refs, rw, rh, buf,
                                layout, masks, bd, stream);
}

// Kernel 6b on uint16 reference planes (bd 10 or 12); as obmc_launch.
extern "C" int obmc_launch16(int np, void* const* out,
                             const void* const* resid, const int* ph,
                             const int* pw, const void* const* refs,
                             const int* rw, const int* rh, const void* buf,
                             const int* layout, const void* masks, int bd,
                             void* stream) {
  return obmc_launch_t<uint16_t>(np, out, resid, ph, pw, refs, rw, rh, buf,
                                 layout, masks, bd, stream);
}
