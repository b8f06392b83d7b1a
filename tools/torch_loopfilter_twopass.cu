// The deblocking as two launches a frame on the decoder's cell maps: the
// design easyav1_tpu_torch/csrc/loopfilter.cu's one-launch tile is raced
// against (chip_smoke.py times both on the same frames and holds this
// one's output to the shipped kernel's; built by nvcc with the shipped
// source's extern names suffixed "_twopass").
//
// Launch 1 runs the vertical edges of every plane: a CTA stages a 64x64
// tile with the horizontal halo alone (20 columns before, 12 after) and
// stores the tile's filtered pixels to a scratch plane.  Launch 2 runs the
// horizontal edges on the scratch plane, the tile staged with the
// vertical halo alone.  Each edge is decided and computed once (the fused
// tile computes the halo rows' vertical edges again in each CTA that
// needs them), but the planes are read and written twice and each halo is
// read again through L2 by the neighbouring tiles.  The steps (staging,
// decisions, the write rule, the store), the maps' layout and the launch
// checks are the shipped source's, whose device functions this file
// includes.

#include "../easyav1_tpu_torch/csrc/loopfilter.cu"

namespace {

// Launch 1: the vertical edges of the tile's rows.
__global__ void __launch_bounds__(kThreads, 6) lf_twopass_v(Frame f) {
  __align__(16) __shared__ int16_t A[kTileH * kPA];
  __align__(16) __shared__ int16_t B[kTileH * kPB];
  __shared__ uint8_t dec[kSlotsV * kTileH];
  __shared__ uint8_t mS[kTileH / 4 * kSlotsV], mL[kTileH / 4 * kSlotsV];
  __shared__ int lut[3 * 64];
  uint32_t* A32 = reinterpret_cast<uint32_t*>(A);
  uint32_t* B32 = reinterpret_cast<uint32_t*>(B);
  Plane P;
  int st, y0, x0;
  tile_of(f, P, st, y0, x0);
  const int h = P.h, w = P.w, t = threadIdx.x;
  const int nev = (w + 3) / 4 - 1;
  const size_t plane = (size_t)h * w;
  stage(P.src + st * plane, h, w, y0, x0, 0, kTileH, -kHaloLo, kAW / 4, A32,
        kPA);
  const int e0 = x0 / 4 - 4;
  const int rv = (h + (1 << P.shv) - 1) >> P.shv;
  const size_t mv = (size_t)rv * nev;
  for (int i = t; P.shv && i < kTileH / 4 * kSlotsV; i += kThreads) {
    const int r = i / kSlotsV, j = i % kSlotsV;
    const int mr = y0 / 4 + r, e = e0 + j;
    uint8_t sz = 0, lv = 0;
    if (mr < rv && e >= 0 && e < nev) {
      const size_t at = st * mv + (size_t)mr * nev + e;
      sz = __ldg(P.sv + at);
      lv = __ldg(P.lv + at);
    }
    mS[i] = sz;
    mL[i] = lv;
  }
  for (int i = t; i < 3 * 64; i += kThreads)
    lut[i] = __ldg(P.lut + st * 3 * 64 + i);
  __syncthreads();

  for (int i = t; i < kTileH * kSlotsV; i += kThreads) {
    const int r = i % kTileH, j = i / kTileH;
    const int y = y0 + r, e = e0 + j;
    int sz = 0, lv = 0;
    if (y < h) {
      if (P.shv) {
        sz = mS[(r >> 2) * kSlotsV + j];
        lv = mL[(r >> 2) * kSlotsV + j];
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
    dec[j * kTileH + r] = (uint8_t)k;
  }
  for (int i = t; i < kTileH * (kTileW / 2); i += kThreads) {
    const int r = i / (kTileW / 2), c = i % (kTileW / 2);
    B32[r * (kPB / 2) + c] = A32[r * (kPA / 2) + kHaloLo / 2 + c];
  }
  __syncthreads();

  for (int i = t; i < kTileH * (kSlotsV - 2); i += kThreads) {
    const int r = i % kTileH, j = i / kTileH + 2;
    const int k = dec[j * kTileH + r];
    if (k == kNone) continue;
    const unsigned own = wmask(k) & ~(wmask(dec[(j - 1) * kTileH + r]) >> 4
                                      | wmask(dec[(j - 2) * kTileH + r]) >> 8);
    apply(k, A + r * kPA, 1, 8 + 4 * j, own, kHaloLo, kTileW, B + r * kPB, 1,
          f.bd);
  }
  __syncthreads();
  store(B32, kPB, P.dst + st * plane, h, w, y0, x0);
}

// Launch 2: the horizontal edges of the tile's columns.
__global__ void __launch_bounds__(kThreads, 6) lf_twopass_h(Frame f) {
  __align__(16) __shared__ int16_t B[kAH * kPB];
  __align__(16) __shared__ int16_t C[kTileH * kTileW];
  __shared__ uint8_t dec[kSlotsH * kTileW];
  __shared__ uint8_t mS[kTileW / 4 * kSlotsH], mL[kTileW / 4 * kSlotsH];
  __shared__ int lut[3 * 64];
  uint32_t* B32 = reinterpret_cast<uint32_t*>(B);
  uint32_t* C32 = reinterpret_cast<uint32_t*>(C);
  Plane P;
  int st, y0, x0;
  tile_of(f, P, st, y0, x0);
  const int h = P.h, w = P.w, t = threadIdx.x;
  const int neh = (h + 3) / 4 - 1;
  const size_t plane = (size_t)h * w;
  stage(P.src + st * plane, h, w, y0, x0, -kHaloLo, kAH, 0, kTileW / 4, B32,
        kPB);
  const int e0 = y0 / 4 - 4;
  const int rh = (w + (1 << P.shh) - 1) >> P.shh;
  const size_t mh = (size_t)rh * neh;
  for (int i = t; P.shh && i < kTileW / 4 * kSlotsH; i += kThreads) {
    const int r = i / kSlotsH, j = i % kSlotsH;
    const int mr = x0 / 4 + r, e = e0 + j;
    uint8_t sz = 0, lv = 0;
    if (mr < rh && e >= 0 && e < neh) {
      const size_t at = st * mh + (size_t)mr * neh + e;
      sz = __ldg(P.sh + at);
      lv = __ldg(P.lh + at);
    }
    mS[i] = sz;
    mL[i] = lv;
  }
  for (int i = t; i < 3 * 64; i += kThreads)
    lut[i] = __ldg(P.lut + st * 3 * 64 + i);
  __syncthreads();

  for (int i = t; i < kTileW * kSlotsH; i += kThreads) {
    const int c = i % kTileW, j = i / kTileW;
    const int x = x0 + c, e = e0 + j;
    int sz = 0, lv = 0;
    if (x < w) {
      if (P.shh) {
        sz = mS[(c >> 2) * kSlotsH + j];
        lv = mL[(c >> 2) * kSlotsH + j];
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
    dec[j * kTileW + c] = (uint8_t)k;
  }
  for (int i = t; i < kTileH * (kTileW / 2); i += kThreads) {
    const int r = i / (kTileW / 2), c = i % (kTileW / 2);
    C32[r * (kTileW / 2) + c] = B32[(r + kHaloLo) * (kPB / 2) + c];
  }
  __syncthreads();

  for (int i = t; i < kTileW * (kSlotsH - 2); i += kThreads) {
    const int c = i % kTileW, j = i / kTileW + 2;
    const int k = dec[j * kTileW + c];
    if (k == kNone) continue;
    const unsigned own = wmask(k) & ~(wmask(dec[(j - 1) * kTileW + c]) >> 4
                                      | wmask(dec[(j - 2) * kTileW + c]) >> 8);
    apply(k, B + c, kPB, 8 + 4 * j, own, kHaloLo, kTileH, C + c, kTileW,
          f.bd);
  }
  __syncthreads();
  store(C32, kTileW, P.dst + st * plane, h, w, y0, x0);
}

}  // namespace

// Two launches deblock `planes` (1 to 3) int32 planes of `streams`
// streams, as the shipped lf_frame_launch does.  ptrs: 8 a plane: src,
// tmp (a scratch plane of src's shape), dst, sv, lv, sh, lh, lut; dims
// and the rest as lf_frame_launch's.  Returns cudaGetLastError().
extern "C" int lf_twopass_launch(const void* const* ptrs, const int* dims,
                                 int planes, int streams, int bd,
                                 void* stream) {
  if (planes < 1 || planes > kMaxPlanes || streams < 1
      || (bd != 8 && bd != 10 && bd != 12))
    return cudaErrorInvalidValue;
  Frame fv = {}, fh = {};
  fv.planes = fh.planes = planes;
  fv.bd = fh.bd = bd;
  long long tiles = 0;
  for (int p = 0; p < planes; ++p) {
    const void* const* a = ptrs + 8 * p;
    const int* d = dims + 4 * p;
    if (d[0] < 1 || d[1] < 1 || (d[2] != 0 && d[2] != 2)
        || (d[3] != 0 && d[3] != 2))
      return cudaErrorInvalidValue;
    const int tiles_x = (d[1] + kTileW - 1) / kTileW;
    const int n = tiles_x * ((d[0] + kTileH - 1) / kTileH);
    int* tmp = static_cast<int*>(const_cast<void*>(a[1]));
    fv.p[p] = {static_cast<const int*>(a[0]), tmp,
               static_cast<const uint8_t*>(a[3]),
               static_cast<const uint8_t*>(a[4]),
               static_cast<const uint8_t*>(a[5]),
               static_cast<const uint8_t*>(a[6]),
               static_cast<const int*>(a[7]), d[0], d[1], d[2], d[3], tiles_x,
               n};
    fh.p[p] = fv.p[p];
    fh.p[p].src = tmp;
    fh.p[p].dst = static_cast<int*>(const_cast<void*>(a[2]));
    tiles += n;
  }
  fv.tiles = fh.tiles = (int)tiles;
  const long long grid = tiles * streams;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  LF_LAUNCH(lf_twopass_v, (int)grid, kThreads, s, fv);
  LF_LAUNCH(lf_twopass_h, (int)grid, kThreads, s, fh);
  return cudaGetLastError();
}
