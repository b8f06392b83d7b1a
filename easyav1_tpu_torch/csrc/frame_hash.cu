// Position-weighted 32-bit hash of a frame's uint8 planes for Hopper
// (sm_90a): one launch a frame over all planes.
//
// Replaces easyav1_tpu/video/av1/recon/resident.py:31-50 (_hash_kernel,
// an XLA-jitted function).  For each plane p [ph, pw],
//   s_p = sum over (r, c) of p[r, c] * (1 + r * 2654435761 + c * 40503)
// in uint32, wrapping, and over the planes in order
//   h = h * 16777619 + s_p, from h = 2166136261.
// It equals `resident.frame_hash_host` (the port's `api.frame_hash`) on
// the same planes.
//
// What bounds it: bytes.  Each pixel is read once (3.11 MB for a 1080p
// 4:2:0 frame, under a microsecond at 3.35 TB/s) and costs two integer
// multiply-adds; the output is one word.  In plain torch ops the same
// function needs int64 index grids, products and masks (torch has no
// uint32 arithmetic): some fifteen launches and 8 bytes a pixel and more
// of traffic.  Here a fixed grid walks the rows of all planes, a warp
// reads a row's aligned middle as 4-byte words (a row's unaligned head
// and tail by bytes), each thread keeps one partial sum a plane, a CTA
// reduces them by warp shuffles and shared memory and adds them to the
// planes' words with one atomicAdd a plane: uint32 addition commutes, so
// the result does not depend on the order the CTAs finish in.  The last
// CTA to finish (a ticket counter) folds the planes' words into the
// hash.
//
// Scratch layout, `words` (uint32[8], zeroed by the caller before the
// launch): [0..2] the planes' sums, [3] the ticket counter, [4] the hash.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 3;
constexpr uint32_t kRowK = 2654435761u;
constexpr uint32_t kColK = 40503u;
constexpr uint32_t kFnv = 16777619u;
constexpr uint32_t kSeed = 2166136261u;

struct Plane {
  const uint8_t* p;
  int h, w, pitch;
};

struct Args {
  Plane pl[kMaxPlanes];
  int np;
  int rows;  // all planes' rows together
};

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
frame_hash_kernel(Args a, uint32_t* __restrict__ words) {
  uint32_t acc[kMaxPlanes] = {0u, 0u, 0u};
  // a CTA takes every gridDim.x-th row of the planes laid end to end
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    int p = 0, r = row;
    while (p < a.np - 1 && r >= a.pl[p].h) r -= a.pl[p++].h;
    const Plane pl = a.pl[p];
    const uint8_t* line = pl.p + (size_t)r * pl.pitch;
    const uint32_t base = 1u + (uint32_t)r * kRowK;
    // bytes up to the first 4-byte boundary, then words, then the tail
    int head = (int)((4u - ((uintptr_t)line & 3u)) & 3u);
    if (head > pl.w) head = pl.w;
    const int nwords = (pl.w - head) >> 2;
    uint32_t s = 0u;
    if (threadIdx.x < head)
      s += line[threadIdx.x] * (base + (uint32_t)threadIdx.x * kColK);
    const uint32_t* mid = reinterpret_cast<const uint32_t*>(line + head);
    for (int i = threadIdx.x; i < nwords; i += kThreads) {
      const uint32_t v = __ldg(mid + i);
      const uint32_t wt = base + (uint32_t)(head + 4 * i) * kColK;
      s += (v & 0xffu) * wt + ((v >> 8) & 0xffu) * (wt + kColK) +
           ((v >> 16) & 0xffu) * (wt + 2u * kColK) +
           (v >> 24) * (wt + 3u * kColK);
    }
    const int c = head + 4 * nwords + threadIdx.x;
    if (c < pl.w) s += line[c] * (base + (uint32_t)c * kColK);
    // a constant index keeps the partial sums in registers
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q)
      if (q == p) acc[q] += s;
  }

  __shared__ uint32_t part[kMaxPlanes][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    const uint32_t v = warp_sum(acc[p]);
    if (lane == 0) part[p][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < a.np; ++p) {
      uint32_t v = 0u;
      for (int w = 0; w < kThreads / 32; ++w) v += part[p][w];
      if (v != 0u) atomicAdd(&words[p], v);
    }
    __threadfence();
    if (atomicAdd(&words[3], 1u) == gridDim.x - 1) {
      __threadfence();
      uint32_t h = kSeed;
      for (int p = 0; p < a.np; ++p)
        h = h * kFnv + atomicAdd(&words[p], 0u);
      words[4] = h;
    }
  }
}

}  // namespace

// planes[p]: uint8 [h[p], w[p]] with row pitch[p] bytes, np of them (1 to
// 3); words: uint32[8] on the device, zeroed.  Returns cudaGetLastError().
extern "C" int frame_hash_launch(int np, const void* const* planes,
                                 const int* h, const int* w, const int* pitch,
                                 void* words, void* stream) {
  if (np < 1 || np > kMaxPlanes) return cudaErrorInvalidValue;
  Args a = {};
  a.np = np;
  for (int p = 0; p < np; ++p) {
    if (h[p] < 0 || w[p] < 0 || pitch[p] < w[p]) return cudaErrorInvalidValue;
    a.pl[p] = {static_cast<const uint8_t*>(planes[p]), h[p], w[p], pitch[p]};
    a.rows += h[p];
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int grid = sms * 8;
  if (grid > a.rows) grid = a.rows;
  if (grid < 1) grid = 1;
  frame_hash_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint32_t*>(words));
  return cudaGetLastError();
}
