// Position-weighted 32-bit hash of a frame's planes for Hopper (sm_90a):
// one launch a frame over all planes, uint8 (8-bit frames) or uint16
// (10- and 12-bit frames) samples.
//
// Replaces easyav1_tpu/video/av1/recon/resident.py:31-50 (_hash_kernel,
// an XLA-jitted function).  For each plane p [ph, pw],
//   s_p = sum over (r, c) of p[r, c] * (1 + r * 2654435761 + c * 40503)
// in uint32, wrapping, and over the planes in order
//   h = h * 16777619 + s_p, from h = 2166136261.
// It equals `resident.frame_hash_host` (the port's `api.frame_hash`) on
// the same planes.
//
// What bounds it: bytes.  Each sample is read once (3.11 MB for a 1080p
// 8-bit 4:2:0 frame, 24.9 MB for a 4K 10-bit one: 0.93 and 7.4 us at
// 3.35 TB/s); the output is one word.  The first design read rows as
// 4-byte words, a CTA a row, and each thread had two or three loads in
// flight: it ran at 17x its byte bound on a 1080p frame.  This one:
//
// - The sum splits into three sums that need no per-sample weight:
//   s_p = A + 2654435761 B + 40503 C (mod 2^32) with A = sum v,
//   B = sum r v, C = sum c v.  A thread keeps A, B and C of each plane;
//   a 16-byte chunk of n samples from column c adds S = sum v_k and
//   c S + sum k v_k, a row segment adds r times its S to B.
// - Loads are 16 bytes (uint4), the aligned middle of a row segment of
//   2048 bytes: a warp takes a segment, each lane up to four chunks,
//   all four loads issued before any is used (kSegBytes).  The
//   segment's samples before its first 16-byte boundary and after its
//   last are read one by one (rows of a view, or of an odd pitch, start
//   anywhere).
// - A fixed grid of two CTAs an SM walks the segments of all planes by
//   the grid's stride (kCtasPerSm; on a 4K 10-bit frame two beat four by
//   some 15% and eight by 35%); a CTA reduces its threads' values by
//   warp shuffles and shared memory and adds them to the planes' words
//   with one atomicAdd a plane:
//   uint32 addition commutes, so the result does not depend on the order
//   the CTAs finish in.  The last CTA to finish (a ticket counter) folds
//   the planes' words into the hash.
//
// Scratch layout, `words` (uint32[8], zeroed by the caller before the
// launch): [0..2] the planes' sums, [3] the ticket counter, [4] the hash.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 3;
constexpr int kSegBytes = 2048;   // a warp's row segment, 32 x 4 x 16 bytes
constexpr int kLaneChunks = kSegBytes / (32 * 16);  // 16-byte loads a lane
constexpr int kCtasPerSm = 2;     // the fixed grid, in CTAs an SM
static_assert(kSegBytes % 512 == 0, "whole 16-byte chunks for every lane");
constexpr uint32_t kRowK = 2654435761u;
constexpr uint32_t kColK = 40503u;
constexpr uint32_t kFnv = 16777619u;
constexpr uint32_t kSeed = 2166136261u;

struct Plane {
  const void* p;
  int h, w, pitch;  // pitch in samples
  int spr;          // segments a row
  int first;        // the plane's first segment
};

struct Args {
  Plane pl[kMaxPlanes];
  int np;
  int segs;         // all planes' segments together
};

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (S, sum k v_k) of the samples of a 16-byte chunk, k from 0.
__device__ __forceinline__ void chunk_sums(const uint4 q, uint8_t, uint32_t& s,
                                           uint32_t& d) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  s = d = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sj = __dp4a(w[j], 0x01010101u, 0u);
    d += 4u * j * sj + __dp4a(w[j], 0x03020100u, 0u);
    s += sj;
  }
}

__device__ __forceinline__ void chunk_sums(const uint4 q, uint16_t,
                                           uint32_t& s, uint32_t& d) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  s = d = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = w[j] & 0xffffu, hi = w[j] >> 16;
    s += lo + hi;
    d += 2u * j * (lo + hi) + hi;
  }
}

// Adds the samples of segment `seg` of plane row `r` to (S, C) of this
// lane: S = sum v, C = sum c v over the lane's samples.
template <typename T>
__device__ __forceinline__ void segment(const Plane& pl, int r, int seg,
                                        int lane, uint32_t& S, uint32_t& C) {
  constexpr int kSamples = kSegBytes / sizeof(T);   // a segment's samples
  constexpr int kChunk = 16 / sizeof(T);            // a chunk's samples
  const T* line = static_cast<const T*>(pl.p) + (size_t)r * pl.pitch;
  const int c0 = seg * kSamples;
  const int c1 = min(c0 + kSamples, pl.w);
  // samples before the first 16-byte boundary at or after column c0
  const int mis = (int)(reinterpret_cast<uintptr_t>(line + c0) & 15u);
  const int head = min((int)((16 - mis) & 15) / (int)sizeof(T), c1 - c0);
  const int nchunks = (c1 - c0 - head) / kChunk;
  const int ca = c0 + head;                         // first aligned column
  const uint4* mid = reinterpret_cast<const uint4*>(line + ca);
  uint4 q[kLaneChunks];
#pragma unroll
  for (int j = 0; j < kLaneChunks; ++j)
    if (lane + 32 * j < nchunks) q[j] = __ldg(mid + lane + 32 * j);
#pragma unroll
  for (int j = 0; j < kLaneChunks; ++j) {
    const int k = lane + 32 * j;
    if (k < nchunks) {
      uint32_t s, d;
      chunk_sums(q[j], T(), s, d);
      S += s;
      C += (uint32_t)(ca + k * kChunk) * s + d;
    }
  }
  // the head, and the tail after the last whole chunk
  const int ct = ca + nchunks * kChunk;
  const int c = lane < head ? c0 + lane : ct + lane - head;
  if (lane < head || (c < c1 && lane - head < kChunk)) {
    const uint32_t v = line[c];
    S += v;
    C += (uint32_t)c * v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
frame_hash_kernel(Args a, uint32_t* __restrict__ words) {
  // per plane: A = sum v, B = sum r v, C = sum c v of this lane's samples
  uint32_t A[kMaxPlanes] = {0u, 0u, 0u}, B[kMaxPlanes] = {0u, 0u, 0u},
           C[kMaxPlanes] = {0u, 0u, 0u};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = blockIdx.x * kWarps + warp; g < a.segs;
       g += gridDim.x * kWarps) {
    int p = 0;
    while (p < a.np - 1 && g >= a.pl[p + 1].first) ++p;
    const Plane& pl = a.pl[p];
    const int local = g - pl.first;
    const int r = local / pl.spr, seg = local - r * pl.spr;
    uint32_t S = 0u, Cs = 0u;
    segment<T>(pl, r, seg, lane, S, Cs);
    // a constant index keeps the sums in registers
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q)
      if (q == p) {
        A[q] += S;
        B[q] += (uint32_t)r * S;
        C[q] += Cs;
      }
  }

  __shared__ uint32_t part[kMaxPlanes][kWarps];
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    const uint32_t v = warp_sum(A[p] + kRowK * B[p] + kColK * C[p]);
    if (lane == 0) part[p][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < a.np; ++p) {
      uint32_t v = 0u;
      for (int w = 0; w < kWarps; ++w) v += part[p][w];
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

// planes[p]: [h[p], w[p]] samples of `sample_bytes` bytes (1: uint8, 2:
// uint16) with a row pitch of pitch[p] samples, np of them (1 to 3), each
// aligned to its sample size; words: uint32[8] on the device, zeroed.
// Returns cudaGetLastError().
extern "C" int frame_hash_launch(int np, const void* const* planes,
                                 const int* h, const int* w, const int* pitch,
                                 int sample_bytes, void* words, void* stream) {
  if (np < 1 || np > kMaxPlanes || (sample_bytes != 1 && sample_bytes != 2))
    return cudaErrorInvalidValue;
  const int seg_samples = kSegBytes / sample_bytes;
  Args a = {};
  a.np = np;
  for (int p = 0; p < np; ++p) {
    if (h[p] < 0 || w[p] < 0 || pitch[p] < w[p]
        || reinterpret_cast<uintptr_t>(planes[p]) % sample_bytes)
      return cudaErrorInvalidValue;
    const int spr = (w[p] + seg_samples - 1) / seg_samples;
    a.pl[p] = {planes[p], h[p], w[p], pitch[p], spr, a.segs};
    a.segs += h[p] * spr;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int grid = sms * kCtasPerSm;
  const int want = (a.segs + kWarps - 1) / kWarps;
  if (grid > want) grid = want;
  if (grid < 1) grid = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* out = static_cast<uint32_t*>(words);
  if (sample_bytes == 1)
    frame_hash_kernel<uint8_t><<<grid, kThreads, 0, s>>>(a, out);
  else
    frame_hash_kernel<uint16_t><<<grid, kThreads, 0, s>>>(a, out);
  return cudaGetLastError();
}
