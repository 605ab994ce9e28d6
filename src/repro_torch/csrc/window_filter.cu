// Points-in-rectangle filter over gathered candidate pages: counts
// (window_filter) and membership masks (window_match).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/window_filter/kernel.py:
// `window_filter_pallas` (body `_filter_kernel`) and `window_match_pallas`
// (body `_match_kernel`).  Same contract: pts (G, d, cap) int32 holding
// unsigned coordinates, rect (G, d, 2) int32 [lo, hi], size (G,) int32.
// For every (query, page) pair g, slot s is a hit when s < size[g] and
// lo[i] <= pts[g, i, s] <= hi[i] for every dimension i, compared unsigned.
//
// Bound on the H100: memory.  Each coordinate is read once and takes two
// compares, far below the card's integer rate, so the least time is the
// bytes of the valid slots of `pts` over the HBM bandwidth (3.35 TB/s).
//
// Design: one block of 256 threads per pair g.  The block stages the
// rectangle in shared memory; threads stride over the slots, so neighbouring
// threads read neighbouring words of each (d, cap) row and every load is
// coalesced.  Slots at or past size[g] are never read.  The TPU compared
// signed words after a sign flip; here the words are compared as uint32
// directly.  window_filter reduces its per-thread counts with warp shuffles
// and one shared-memory step, so no state crosses blocks; window_match
// writes the 0/1 mask as bytes (the ops-level contract is a bool mask).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 32;

__device__ __forceinline__ int valid_slots(const int* __restrict__ size,
                                           int g, int cap) {
  return min(max(size[g], 0), cap);
}

__device__ __forceinline__ void stage_rect(const uint32_t* __restrict__ rect,
                                           int g, int d, uint32_t* lo,
                                           uint32_t* hi) {
  if (threadIdx.x < d) {
    const uint32_t* r = rect + ((size_t)g * d + threadIdx.x) * 2;
    lo[threadIdx.x] = r[0];
    hi[threadIdx.x] = r[1];
  }
  __syncthreads();
}

__device__ __forceinline__ bool inside(const uint32_t* __restrict__ page,
                                       int s, int d, int cap,
                                       const uint32_t* lo, const uint32_t* hi) {
  bool ok = true;
  for (int i = 0; i < d; ++i) {
    const uint32_t v = __ldg(page + (size_t)i * cap + s);
    ok &= (lo[i] <= v) & (v <= hi[i]);
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
window_filter_kernel(const uint32_t* __restrict__ pts,
                     const uint32_t* __restrict__ rect,
                     const int* __restrict__ size, int* __restrict__ out,
                     int d, int cap) {
  __shared__ uint32_t lo[kMaxDims], hi[kMaxDims];
  __shared__ int warp_sums[kThreads / 32];
  const int g = blockIdx.x;
  stage_rect(rect, g, d, lo, hi);
  const uint32_t* page = pts + (size_t)g * d * cap;
  const int n = valid_slots(size, g, cap);
  int cnt = 0;
  for (int s = threadIdx.x; s < n; s += kThreads) {
    cnt += inside(page, s, d, cap, lo, hi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (threadIdx.x == 0) out[g] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
window_match_kernel(const uint32_t* __restrict__ pts,
                    const uint32_t* __restrict__ rect,
                    const int* __restrict__ size, uint8_t* __restrict__ out,
                    int d, int cap) {
  __shared__ uint32_t lo[kMaxDims], hi[kMaxDims];
  const int g = blockIdx.x;
  stage_rect(rect, g, d, lo, hi);
  const uint32_t* page = pts + (size_t)g * d * cap;
  const int n = valid_slots(size, g, cap);
  uint8_t* row = out + (size_t)g * cap;
  for (int s = threadIdx.x; s < cap; s += kThreads) {
    row[s] = s < n && inside(page, s, d, cap, lo, hi);
  }
}

}  // namespace

extern "C" int window_filter_launch(const void* pts, const void* rect,
                                    const void* size, void* out, int G,
                                    int d, int cap, void* stream) {
  if (d < 1 || d > kMaxDims) return (int)cudaErrorInvalidValue;
  window_filter_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)rect, (const int*)size,
      (int*)out, d, cap);
  return (int)cudaGetLastError();
}

extern "C" int window_match_launch(const void* pts, const void* rect,
                                   const void* size, void* out, int G, int d,
                                   int cap, void* stream) {
  if (d < 1 || d > kMaxDims) return (int)cudaErrorInvalidValue;
  window_match_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)rect, (const int*)size,
      (uint8_t*)out, d, cap);
  return (int)cudaGetLastError();
}
