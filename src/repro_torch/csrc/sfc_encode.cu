// Monotone space-filling-curve encode: (n, d) coordinates -> (n, 2) Z64.
//
// Replaces the Pallas TPU kernel `sfc_encode_dn` in
// src/repro/kernels/sfc_encode/kernel.py, both of its bodies:
// `_encode_kernel` (one global θ) and `_encode_piecewise_kernel` (a quadtree
// of regions, each with its own θ over the low bits).  Output: row p is
// (hi, lo) int32 of the 64-bit address, bit-identical to the reference.
//
// The TPU kernel unrolled a static chain per curve and so compiled once per
// curve.  Here the curve is data, as `pack_curve_pool` lays it out for one
// curve: pos (R, T) int32, the output position of flat input bit
// t = i*K + j in region r (R = 1 for a global θ; row r of a piecewise curve
// is `full_theta(r).pos_of_bit`), and reg (M,) int32, the flat input bit
// feeding region-code bit m (an index >= T reads a zero bit).  One compiled
// kernel serves every curve, and a pooled variant only adds a curve axis.
//
// Bound on the H100: memory.  A point costs d*4 bytes in and 8 bytes out
// against about 3*d*K integer operations; at d*K <= 64 that is under 20
// operations per byte, below the ratio at which the integer units would
// limit.  Least time: (n*d*4 + n*8 bytes) over 3.35 TB/s.
//
// Design: one thread per point over a grid-stride loop of at most 8 blocks
// per SM.  Each block stages the position table in shared memory once when
// R*T*4 bytes fit in 48 KB (every global curve; piecewise up to about
// 190 regions at T = 64); otherwise rows are read from global memory, where
// they stay in L1/L2.  The same kernel runs either way.  The thread forms
// the region code from the `reg` bits, then ORs bit (i, j) into position
// pos[r, i*K + j] of a 64-bit word and stores its two halves.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr size_t kSmemLimit = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
sfc_encode_kernel(const uint32_t* __restrict__ x, const int* __restrict__ pos,
                  const int* __restrict__ reg, uint32_t* __restrict__ out,
                  long long n, int d, int K, int R, int M, int use_smem) {
  extern __shared__ int smem_pos[];
  const int T = d * K;
  const int* table = pos;
  if (use_smem) {
    for (int t = threadIdx.x; t < R * T; t += blockDim.x) smem_pos[t] = pos[t];
    __syncthreads();
    table = smem_pos;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const uint32_t* xp = x + p * d;
    int r = 0;
    for (int m = 0; m < M; ++m) {
      const int t = __ldg(reg + m);
      if (t < T) {
        const int i = t / K;
        r |= (int)((__ldg(xp + i) >> (t - i * K)) & 1u) << m;
      }
    }
    const int* row = table + (size_t)r * T;
    unsigned long long z = 0;
    for (int i = 0; i < d; ++i) {
      const uint32_t v = __ldg(xp + i);
      for (int j = 0; j < K; ++j) {
        z |= (unsigned long long)((v >> j) & 1u) << row[i * K + j];
      }
    }
    out[2 * p] = (uint32_t)(z >> 32);
    out[2 * p + 1] = (uint32_t)z;
  }
}

}  // namespace

extern "C" int sfc_encode_launch(const void* x, const void* pos,
                                 const void* reg, void* out, long long n,
                                 int d, int K, int R, int M, int sms,
                                 void* stream) {
  if (d < 1 || K < 1 || d * K > 64 || R < 1 || M < 0 || sms < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t table_bytes = (size_t)R * d * K * sizeof(int);
  const int use_smem = table_bytes <= kSmemLimit;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSM) blocks = (long long)sms * kBlocksPerSM;
  if (blocks < 1) blocks = 1;
  sfc_encode_kernel<<<(unsigned)blocks, kThreads, use_smem ? table_bytes : 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const int*)pos, (const int*)reg, (uint32_t*)out, n,
      d, K, R, M, use_smem);
  return (int)cudaGetLastError();
}
