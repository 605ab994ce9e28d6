// The bit-loop body of the SFC encode, as the library shipped it before the
// nibble lookup tables (csrc/sfc_encode.cu): kept only so that
// `python -m repro_torch.kernels.sfc_encode.bench` can time the two bodies
// on the same inputs in one run.  It is not part of the library and no
// path calls it.
//
// Inputs are the `pack_curve_pool` layouts: pos (P, R, T) int32, the output
// position of flat input bit t = i*K + j in region r, and reg (P, M) int32.
// Grid (point blocks, P), one thread per point over a grid-stride loop, at
// most 8 blocks per SM across the pool; each block stages its curve's
// position table in shared memory when R*T*4 bytes fit in 48 KB.  The thread
// forms the region code from the `reg` bits (one division by K per bit),
// then ORs bit (i, j) into position pos[r, i*K + j] of a 64-bit word and
// stores its two halves.
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

// A pool of P curves: x (n, d) shared (x_stride 0) or (P, n, d) (x_stride
// n*d), pos (P, R, T), reg (P, M) -> out (P, n, 2).
extern "C" int sfc_encode_bitloop_launch(const void* x, long long x_stride,
                                         const void* pos, const void* reg,
                                         void* out, long long n, int d, int K,
                                         int R, int M, int P, int sms,
                                         void* stream) {
  return encode(x, x_stride, pos, reg, out, n, d, K, R, M, P, sms, stream);
}
