// The first design of the MC kernels 6a and 6b, kept as a source variant
// for tools/torch_mc_variants.py, which builds it and times it beside
// easyav1_tpu_torch/csrc/inter_mc.cu.  The package does not build it.
//
// Motion compensation for Hopper (sm_90a).
//
// Replaces the XLA kernels of easyav1_tpu/video/av1/recon/mc_jax.py:
// _mc_single_kernel (:636-677), _mc_pair_kernel (:816-867) and
// _mc_warp_kernel (:760-812) with kernel 6a, mc_kernel: one launch a
// frame over every plane's single, pair and warp units; and
// _obmc_overlay_kernel (:681-725) and _obmc_resid_kernel (:729-749) with
// kernel 6b, obmc_kernel: one launch for each OBMC pass (above overlays,
// left overlays, the deferred residual), each reading what the one
// before wrote, so the passes are separate launches in stream order.
//
// The units are mc_plan.export_inter_plan's (layouts S_*, P_*, W_*),
// cut by the host into tiles (torch_mc_variants.first_tiles): one CTA of 256 threads
// per 16x16 output tile of a unit (smaller units: one tile of their
// size), one CTA per 8x8 warp unit.  A CTA stages its (th + 7) x (tw + 7)
// reference window in shared memory, clamped to the reference's logical
// width and height, runs the horizontal 8-tap into a shared intermediate
// at (acc + 4) >> 3 and the vertical 8-tap with the reference's
// rounding: a single prediction at clip((acc + 1024) >> 11), each
// prediction of a pair at (acc + 64) >> 7, then the weight blend
// (p0 w0 + p1 w1 + 128) >> 8 or the mask blend
// (p0 m + p1 (64 - m) + 512) >> 10.  A warp unit stages its 15x15
// window and takes per-pixel phases from warped_filter.  Then the
// residual is added (unless the unit's nores is set: OBMC and
// interintra blocks blend first), clipped, and stored.  Writes and
// residual reads are clipped to the unpadded, mi-aligned int32 planes.
// The units' output rects are disjoint, so the CTAs of a launch never
// write the same pixel.  All arithmetic is int32, exact.
//
// This version is simple: a CTA's window load, its two passes and its
// store follow one another, on int windows in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// mc_plan layouts
enum { S_X, S_Y, S_SLOT, S_IX, S_IY, S_VALID, S_FH = 6, S_FV = 14,
       S_NORES = 22, NS = 23 };
enum { P_X, P_Y, P_VALID, P_PRED0 = 3, P_PRED1 = 22, P_W0 = 41, P_W1 = 42,
       P_MODE = 43, P_MIDX = 44, NPR = 45 };
enum { W_X, W_Y, W_VALID, W_SLOT, W_IX4, W_IY4, W_SX4, W_SY4, W_ALPHA,
       W_BETA, W_GAMMA, W_DELTA, NW };
// tile kinds and record (torch_mc_variants.NT): kind, plane, unit row, unit w,
// unit h, tile x and y offset in the unit, pair mask offset
enum { K_SINGLE, K_PAIR, K_WARP, K_OVERLAY, K_RESID };
constexpr int NT = 8;
constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int WIN = TILE + 7;

struct Frame {
  int32_t* out[3];          // [ph, pw] planes, written in place
  const int16_t* resid[3];  // [ph, pw]
  const uint8_t* ref[3][8]; // [rh, rw] logical reference planes per slot
  int ph[3], pw[3];
  int rw[3], rh[3];         // the references' logical dims (= row pitch)
  int bd;
};

struct Smem {
  int win[WIN * WIN];
  int mid[WIN * TILE];
  int fh[8], fv[8];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The vertical sum, before its final rounding, of pixel (t / TILE,
// t % TILE) of a tw x th tile predicted from reference `slot` at integer
// position (ix, iy) with taps fh, fv; 0 outside the tile.  Every thread
// of the block calls it.
__device__ int subpel(const Frame& F, int pl, int slot, int ix, int iy,
                      const int32_t* fh, const int32_t* fv, int tw, int th,
                      Smem& sm) {
  const int t = threadIdx.x;
  const uint8_t* r = F.ref[pl][slot];
  const int rw = F.rw[pl], rh = F.rh[pl];
  const int ww = tw + 7, wh = th + 7;
  if (t < 8) {
    sm.fh[t] = __ldg(fh + t);
    sm.fv[t] = __ldg(fv + t);
  }
  for (int k = t; k < ww * wh; k += THREADS) {
    const int rr = k / ww, cc = k - rr * ww;
    sm.win[k] = __ldg(r + (size_t)clampi(iy - 3 + rr, 0, rh - 1) * rw
                      + clampi(ix - 3 + cc, 0, rw - 1));
  }
  __syncthreads();
  for (int k = t; k < wh * tw; k += THREADS) {
    const int rr = k / tw, cc = k - rr * tw;
    const int* wp = sm.win + rr * ww + cc;
    int s = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) s += wp[q] * sm.fh[q];
    sm.mid[k] = (s + 4) >> 3;
  }
  __syncthreads();
  const int i = t / TILE, j = t % TILE;
  int acc = 0;
  if (i < th && j < tw) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc += sm.mid[(i + q) * tw + j] * sm.fv[q];
  }
  __syncthreads();  // the next call rewrites the window
  return acc;
}

// One 8x8 warp unit (mc_jax._mc_warp_kernel).
__device__ void warp_unit(const Frame& F, int pl, const int32_t* f,
                          const int32_t* wf, Smem& sm) {
  const int t = threadIdx.x;
  const uint8_t* r = F.ref[pl][f[W_SLOT]];
  const int rw = F.rw[pl], rh = F.rh[pl];
  const int ix4 = f[W_IX4], iy4 = f[W_IY4];
  for (int k = t; k < 15 * 15; k += THREADS) {
    const int rr = k / 15, cc = k - rr * 15;
    sm.win[k] = __ldg(r + (size_t)clampi(iy4 - 7 + rr, 0, rh - 1) * rw
                      + clampi(ix4 - 7 + cc, 0, rw - 1));
  }
  __syncthreads();
  if (t < 15 * 8) {
    const int k = t >> 3, l = t & 7;
    const int offs = ((f[W_SX4] + f[W_BETA] * (k - 3) + f[W_ALPHA] * l + 512)
                      >> 10) + 64;
    const int32_t* c = wf + offs * 8;
    int s = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) s += sm.win[k * 15 + l + q] * __ldg(c + q);
    sm.mid[t] = (s + 4) >> 3;
  }
  __syncthreads();
  if (t < 64) {
    const int k = t >> 3, l = t & 7;
    const int offs = ((f[W_SY4] + f[W_DELTA] * k + f[W_GAMMA] * l + 512)
                      >> 10) + 64;
    const int32_t* c = wf + offs * 8;
    int acc = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc += sm.mid[(k + q) * 8 + l] * __ldg(c + q);
    const int mx = (1 << F.bd) - 1;
    const int v = clampi((acc + 1024) >> 11, 0, mx);
    const int y = f[W_Y] + k, x = f[W_X] + l;
    if (y < F.ph[pl] && x < F.pw[pl]) {
      const size_t o = (size_t)y * F.pw[pl] + x;
      F.out[pl][o] = clampi(v + F.resid[pl][o], 0, mx);
    }
  }
}

// Kernel 6a: one tile of a single, pair or warp unit per CTA.
__global__ void __launch_bounds__(THREADS)
mc_kernel(Frame F, const int32_t* tiles, const int32_t* singles,
          const int32_t* pairs, const int32_t* warps, const int32_t* masks,
          const int32_t* wf) {
  __shared__ Smem sm;
  const int32_t* T = tiles + (size_t)blockIdx.x * NT;
  const int kind = T[0], pl = T[1], u = T[2], w = T[3], h = T[4];
  const int ox = T[5], oy = T[6];
  if (kind == K_WARP) {
    const int32_t* f = warps + (size_t)u * NW;
    if (f[W_VALID]) warp_unit(F, pl, f, wf, sm);
    return;
  }
  const int tw = min(TILE, w - ox), th = min(TILE, h - oy);
  const int t = threadIdx.x, i = t / TILE, j = t % TILE;
  const int mx = (1 << F.bd) - 1;
  const int32_t* f;
  int x, y, v = 0;
  bool nores = false;
  if (kind == K_SINGLE) {
    f = singles + (size_t)u * NS;
    if (!f[S_VALID]) return;  // the whole block: before any barrier
    x = f[S_X];
    y = f[S_Y];
    nores = f[S_NORES] != 0;
    const int acc = subpel(F, pl, f[S_SLOT], f[S_IX] + ox, f[S_IY] + oy,
                           f + S_FH, f + S_FV, tw, th, sm);
    v = clampi((acc + 1024) >> 11, 0, mx);
  } else {
    f = pairs + (size_t)u * NPR;
    if (!f[P_VALID]) return;
    x = f[P_X];
    y = f[P_Y];
    const int32_t* a = f + P_PRED0;
    const int32_t* b = f + P_PRED1;
    const int p0 = (subpel(F, pl, a[0], a[1] + ox, a[2] + oy, a + 3, a + 11,
                           tw, th, sm) + 64) >> 7;
    const int p1 = (subpel(F, pl, b[0], b[1] + ox, b[2] + oy, b + 3, b + 11,
                           tw, th, sm) + 64) >> 7;
    if (i < th && j < tw) {
      if (f[P_MODE] == 1) {
        const int m = __ldg(masks + T[7]
                            + ((size_t)f[P_MIDX] * h + oy + i) * w + ox + j);
        v = (p0 * m + p1 * (64 - m) + 512) >> 10;
      } else {
        v = (p0 * f[P_W0] + p1 * f[P_W1] + 128) >> 8;
      }
      v = clampi(v, 0, mx);
    }
  }
  const int yy = y + oy + i, xx = x + ox + j;
  if (i < th && j < tw && yy < F.ph[pl] && xx < F.pw[pl]) {
    const size_t o = (size_t)yy * F.pw[pl] + xx;
    F.out[pl][o] = nores ? v : clampi(v + F.resid[pl][o], 0, mx);
  }
}

// Kernel 6b: one tile of one OBMC pass per CTA.  pass 0: above overlays,
// masked by row; 1: left overlays, masked by column; 2: the residual
// over OBMC block rects (units [n, 2] = x, y).  masks: the OBMC masks of
// lengths 2..32, the one of length n at offset n - 2.
__global__ void __launch_bounds__(THREADS)
obmc_kernel(Frame F, int pass, const int32_t* tiles, const int32_t* units,
            const int32_t* masks) {
  __shared__ Smem sm;
  const int32_t* T = tiles + (size_t)blockIdx.x * NT;
  const int pl = T[1], u = T[2], w = T[3], h = T[4], ox = T[5], oy = T[6];
  const int tw = min(TILE, w - ox), th = min(TILE, h - oy);
  const int t = threadIdx.x, i = t / TILE, j = t % TILE;
  const int mx = (1 << F.bd) - 1;
  const bool in = i < th && j < tw;
  if (pass == 2) {
    const int32_t* r = units + (size_t)u * 2;
    const int yy = r[1] + oy + i, xx = r[0] + ox + j;
    if (in && yy < F.ph[pl] && xx < F.pw[pl]) {
      const size_t o = (size_t)yy * F.pw[pl] + xx;
      F.out[pl][o] = clampi(F.out[pl][o] + F.resid[pl][o], 0, mx);
    }
    return;
  }
  const int32_t* f = units + (size_t)u * NS;
  if (!f[S_VALID]) return;
  const int acc = subpel(F, pl, f[S_SLOT], f[S_IX] + ox, f[S_IY] + oy,
                         f + S_FH, f + S_FV, tw, th, sm);
  const int v = clampi((acc + 1024) >> 11, 0, mx);
  const int yy = f[S_Y] + oy + i, xx = f[S_X] + ox + j;
  if (in && yy < F.ph[pl] && xx < F.pw[pl]) {
    const int m = __ldg(masks + (pass == 0 ? h - 2 + oy + i : w - 2 + ox + j));
    const size_t o = (size_t)yy * F.pw[pl] + xx;
    F.out[pl][o] = (m * F.out[pl][o] + (64 - m) * v + 32) >> 6;
  }
}

Frame make_frame(int np, void* const* out, const void* const* resid,
                 const int* ph, const int* pw, const void* const* refs,
                 const int* rw, const int* rh, int bd) {
  Frame F = {};
  for (int p = 0; p < np; ++p) {
    F.out[p] = static_cast<int32_t*>(out[p]);
    F.resid[p] = static_cast<const int16_t*>(resid[p]);
    for (int s = 0; s < 8; ++s)
      F.ref[p][s] = static_cast<const uint8_t*>(refs[8 * p + s]);
    F.ph[p] = ph[p];
    F.pw[p] = pw[p];
    F.rw[p] = rw[p];
    F.rh[p] = rh[p];
  }
  F.bd = bd;
  return F;
}

}  // namespace

// Kernel 6a over the n_tiles tile records [n_tiles, NT] of one frame on
// `stream`: np planes out[p] int32 and resid[p] int16 of [ph[p], pw[p]],
// refs[8 p + s] the uint8 [rh[p], rw[p]] plane of slot s; the unit
// tables singles [n, NS], pairs [n, NPR], warps [n, NW], the pairs' mask
// stacks flat, warped_filter [193, 8].  Returns the cudaError_t of the
// launch.
extern "C" int inter_mc_launch(int np, void* const* out,
                               const void* const* resid, const int* ph,
                               const int* pw, const void* const* refs,
                               const int* rw, const int* rh,
                               const void* tiles, int n_tiles,
                               const void* singles, const void* pairs,
                               const void* warps, const void* masks,
                               const void* wf, int bd, void* stream) {
  if (np < 1 || np > 3 || n_tiles < 1) return cudaErrorInvalidValue;
  const Frame F = make_frame(np, out, resid, ph, pw, refs, rw, rh, bd);
  mc_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const int32_t*>(tiles),
      static_cast<const int32_t*>(singles), static_cast<const int32_t*>(pairs),
      static_cast<const int32_t*>(warps), static_cast<const int32_t*>(masks),
      static_cast<const int32_t*>(wf));
  return static_cast<int>(cudaGetLastError());
}

// Kernel 6b, one pass (0 above, 1 left, 2 residual) over its n_tiles
// tile records; units: the pass's overlay units [n, NS] or residual
// rects [n, 2]; masks: the OBMC masks.  Other arguments as
// inter_mc_launch.  Returns the cudaError_t of the launch.
extern "C" int obmc_launch(int pass, int np, void* const* out,
                           const void* const* resid, const int* ph,
                           const int* pw, const void* const* refs,
                           const int* rw, const int* rh, const void* tiles,
                           int n_tiles, const void* units, const void* masks,
                           int bd, void* stream) {
  if (np < 1 || np > 3 || n_tiles < 1 || pass < 0 || pass > 2)
    return cudaErrorInvalidValue;
  const Frame F = make_frame(np, out, resid, ph, pw, refs, rw, rh, bd);
  obmc_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      F, pass, static_cast<const int32_t*>(tiles),
      static_cast<const int32_t*>(units), static_cast<const int32_t*>(masks));
  return static_cast<int>(cudaGetLastError());
}
