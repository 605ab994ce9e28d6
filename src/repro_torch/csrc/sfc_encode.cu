// Monotone space-filling-curve encode: coordinates -> Z64, under one curve
// or under every curve of an SMBO candidate pool.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/sfc_encode/kernel.py:
// `sfc_encode_dn`, both of its bodies (`_encode_kernel`, one global θ, and
// `_encode_piecewise_kernel`, a quadtree of regions each with its own θ over
// the low bits), and `sfc_encode_pool_dn` (body `_encode_pool_kernel`), the
// same points encoded under every curve of a pool.  Output row p is (hi, lo)
// int32 of the 64-bit address, bit-identical to the reference.
//
// The TPU's single-curve kernel unrolled a static chain per curve and so
// compiled once per curve.  Here the curve is data, as `pack_curve_pool` lays
// it out: pos (P, R, T) int32, the output position of flat input bit
// t = i*K + j in region r (R = 1 for a global θ; row r of a piecewise curve
// is `full_theta(r).pos_of_bit`; rows past a curve's own region count repeat
// row 0 and are never selected), and reg (P, M) int32, the flat input bit
// feeding region-code bit m (an index >= T reads a zero bit, which pads
// global curves and shallower quadtrees).  One compiled kernel serves every
// curve; a single encode is a pool of one.
//
// Points: the TPU's pooled kernel encodes the same (d, n) block under every
// curve.  The SMBO evaluator also needs each candidate's own points (after
// the first query split every candidate has its own sub-rectangles), so the
// points of candidate p start at x + p * x_stride: x_stride = 0 is the TPU
// kernel's shared-point contract, x_stride = n * d a (P, n, d) batch.
//
// Bound on the H100: memory.  A point costs d*4 bytes in (once per pool when
// shared) and 8 bytes out per curve against about 3*d*K integer operations;
// at d*K <= 64 that is under 20 operations per byte, below the ratio at
// which the integer units would limit.  Least time: the bytes over 3.35 TB/s.
//
// Design: grid (point blocks, P); blockIdx.y is the curve.  One thread per
// point over a grid-stride loop, at most 8 blocks per SM across the whole
// pool.  Each block stages its curve's position table in shared memory once
// when R*T*4 bytes fit in 48 KB (every global curve; piecewise up to about
// 190 regions at T = 64); otherwise rows are read from global memory, where
// they stay in L1/L2.  The same kernel runs either way.  The thread forms the
// region code from the `reg` bits, then ORs bit (i, j) into position
// pos[r, i*K + j] of a 64-bit word and stores its two halves.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr size_t kSmemLimit = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
sfc_encode_kernel(const uint32_t* __restrict__ x, long long x_stride,
                  const int* __restrict__ pos, const int* __restrict__ reg,
                  uint32_t* __restrict__ out, long long n, int d, int K, int R,
                  int M, int use_smem) {
  extern __shared__ int smem_pos[];
  const int T = d * K;
  const long long c = blockIdx.y;               // the curve of this block
  x += c * x_stride;
  pos += c * R * T;
  reg += c * M;
  out += c * n * 2;
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

int encode(const void* x, long long x_stride, const void* pos,
           const void* reg, void* out, long long n, int d, int K, int R,
           int M, int P, int sms, void* stream) {
  if (d < 1 || K < 1 || d * K > 64 || R < 1 || M < 0 || P < 1 ||
      P > 65535 || sms < 1 || x_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t table_bytes = (size_t)R * d * K * sizeof(int);
  const int use_smem = table_bytes <= kSmemLimit;
  long long blocks = (n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * kBlocksPerSM / P;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)P);
  sfc_encode_kernel<<<grid, kThreads, use_smem ? table_bytes : 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)x, x_stride, (const int*)pos, (const int*)reg,
      (uint32_t*)out, n, d, K, R, M, use_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// One curve: x (n, d), pos (R, T), reg (M,) -> out (n, 2).
extern "C" int sfc_encode_launch(const void* x, const void* pos,
                                 const void* reg, void* out, long long n,
                                 int d, int K, int R, int M, int sms,
                                 void* stream) {
  return encode(x, 0, pos, reg, out, n, d, K, R, M, 1, sms, stream);
}

// A pool of P curves: x (n, d) shared (x_stride 0) or (P, n, d) (x_stride
// n*d), pos (P, R, T), reg (P, M) -> out (P, n, 2).
extern "C" int sfc_encode_pool_launch(const void* x, long long x_stride,
                                      const void* pos, const void* reg,
                                      void* out, long long n, int d, int K,
                                      int R, int M, int P, int sms,
                                      void* stream) {
  return encode(x, x_stride, pos, reg, out, n, d, K, R, M, P, sms, stream);
}
