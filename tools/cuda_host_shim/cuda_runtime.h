// A host stand-in for <cuda_runtime.h>, for tools/torch_mc_host_run.py:
// enough of CUDA C++ to compile easyav1_tpu_torch/csrc/inter_mc.cu with
// g++ and run its kernels on the CPU.  A launch (MC_LAUNCH) runs the
// grid's CTAs one after another, each thread of a CTA as an OS thread;
// __syncthreads and __syncwarp are pthread barriers, so a warp whose
// lanes do not all reach a barrier hangs here as it would misbehave on
// the card; __shared__ is static storage, which one CTA at a time
// owns; cp.async has the source's own synchronous fallback.  The SM
// count the source asks for is the environment's HOST_RUN_SMS (default
// 2), so that a small grid's warps walk several tiles each.
#pragma once
#include <pthread.h>
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
using std::max;
using std::min;
struct HostDim { int x; };
inline thread_local HostDim threadIdx;
inline HostDim blockIdx, gridDim;
inline pthread_barrier_t host_cta;
inline pthread_barrier_t host_warp[64];
inline void __syncthreads() { pthread_barrier_wait(&host_cta); }
inline void __syncwarp() { pthread_barrier_wait(&host_warp[threadIdx.x >> 5]); }
inline int __clz(int v) { return v ? __builtin_clz(v) : 32; }
template <class T> inline T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) {
  const char* e = getenv("HOST_RUN_SMS");
  *v = e ? atoi(e) : 2;
  return 0;
}
template <class F> void host_launch(int grid, int threads, F fn) {
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    pthread_barrier_init(&host_cta, nullptr, threads);
    for (int w = 0; w < threads / 32; ++w)
      pthread_barrier_init(&host_warp[w], nullptr, 32);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=] { threadIdx.x = t; fn(); });
    for (auto& t : ts) t.join();
  }
}
#define MC_LAUNCH(kernel, grid, threads, stream, ...) \
  host_launch(grid, threads, [=] { kernel(__VA_ARGS__); })
