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
// compiled once per curve.  Here the curve is data, one compiled kernel
// serves every curve, and a single encode is a pool of one.  Per curve the
// wrapper passes
//   lut (R, d, C, 16) uint64, C = ceil(K / 4): lut[r][i][c][v] is the word
//       with bit j of v placed where region r's θ puts input bit
//       (i, 4c + j), zero where 4c + j >= K (`core.sfc.lut_tables`, built
//       once per curve from the `pack_curve_pool` position table);
//   reg (M,) int32: the flat input bit t = i*K + j feeding region-code bit
//       m; t >= d*K reads a zero bit (global curves, shallower quadtrees).
// A point then costs d*C table loads of 8 bytes and their ORs (16 at d 2,
// K 32; 18 at d 3, K 21) instead of d*K single-bit placements.
//
// Points: the TPU's pooled kernel encodes the same (d, n) block under every
// curve.  The SMBO evaluator also needs each candidate's own points, so the
// points of curve p start at x + p * x_stride: x_stride = 0 shares them
// (the TPU kernel's contract), x_stride = n * d is a (P, n, d) batch.
//
// Bound on the H100: memory.  A point reads d*4 bytes (once per pool when
// shared) and writes 8 bytes per curve; each curve's table is R*d*C*128
// bytes.  Least time: those bytes once over 3.35 TB/s.
//
// Design: grid (point blocks, P); blockIdx.y is the curve.  256 threads,
// each encoding 4 points (256 apart, so loads and stores coalesce) per step
// of a grid-stride loop: the 4 points' lookups are independent, which hides
// the load latency.  The usual shapes (d 2 with K 29-32, d 3 with K 21-24,
// d 4 with K 13-16) are compiled with d and C fixed, so every lookup's
// table offset is an immediate and the loops unroll; any other (d, K) runs
// one general instantiation.  At d 2 a point's coordinates are one 8-byte
// load, at d 3 and 4 one 4-byte load each; (hi, lo) is one 8-byte store.
// The block prologue lists the live region bits in shared memory, each as
// one word (shift | bit << 8 | dim << 16, one shared load a bit), so no
// point divides by K and a global curve's points skip the region code.
// The table is read from one of two places, chosen by the wrapper
// (`ops.plan_encode`) from its size:
//   staged: the block copies its curve's table into shared memory with
//     cp.async while its first points load.  A nibble table of 16 words of
//     8 bytes spans the 32 banks once, so a warp's lookups into one table
//     never conflict (a global curve's lookups all hit one table; lanes in
//     different regions of a piecewise curve can).
//   L1: lookups read the table in device memory through the read-only
//     cache (__ldg), for a table larger than a block's shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 4;
constexpr int kMaxRegionBits = 30;
constexpr int kMaxNibbles = 8;                    // K <= 32
// 227 KB of shared memory a block may use, less 1 KB for the static arrays
constexpr long long kMaxStagedBytes = 227 * 1024 - 1024;

typedef unsigned long long u64;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kStaged>
__device__ __forceinline__ u64 entry(const u64* t, int i) {
  if constexpr (kStaged) {
    return t[i];
  } else {
    return __ldg(t + i);
  }
}

// Coordinate i of a point held in registers, without indexing the array by
// a runtime value (which would put it in local memory).
template <int D>
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[D], int i) {
  uint32_t r = v[0];
#pragma unroll
  for (int k = 1; k < D; ++k) r = i == k ? v[k] : r;
  return r;
}

template <int D>
__device__ __forceinline__ void load_point(const uint32_t* __restrict__ x,
                                           long long p, long long n,
                                           uint32_t (&v)[D]) {
  if (p >= n) {
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = 0;      // encoded, never stored
  } else if constexpr (D == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(x) + p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = __ldg(x + p * D + i);
  }
}

struct RegionBits {
  int count;                      // live region bits
  int word[kMaxRegionBits];       // shift | bit << 8 | dim << 16
};

// D coordinates in registers, C nibbles a coordinate (D, C > 0).
template <int D, int C, bool kStaged>
__device__ __forceinline__ u64 encode_point(const uint32_t (&v)[D],
                                            const u64* table,
                                            const RegionBits& rb) {
  int r = 0;
  for (int k = 0; k < rb.count; ++k) {
    const int w = rb.word[k];
    r |= (int)((pick<D>(v, w >> 16) >> (w & 31)) & 1u) << ((w >> 8) & 31);
  }
  const u64* row = table + r * (D * C * 16);
  u64 z = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      z |= entry<kStaged>(row, (i * C + c) * 16 + ((v[i] >> (4 * c)) & 15u));
    }
  }
  return z;
}

// Any d and C: coordinates read where they are used (the read-only cache
// holds the point between the region code and the lookups).
template <bool kStaged>
__device__ __forceinline__ u64 encode_point_any(
    const uint32_t* __restrict__ xp, int d, int C, const u64* table,
    const RegionBits& rb) {
  int r = 0;
  for (int k = 0; k < rb.count; ++k) {
    const int w = rb.word[k];
    r |= (int)((__ldg(xp + (w >> 16)) >> (w & 31)) & 1u) << ((w >> 8) & 31);
  }
  const u64* row = table + (long long)r * d * C * 16;
  u64 z = 0;
  for (int i = 0; i < d; ++i) {
    const uint32_t v = __ldg(xp + i);
#pragma unroll
    for (int c = 0; c < kMaxNibbles; ++c) {
      if (c < C) {
        z |= entry<kStaged>(row, (i * C + c) * 16 + ((v >> (4 * c)) & 15u));
      }
    }
  }
  return z;
}

__device__ __forceinline__ void store(uint2* __restrict__ out, long long p,
                                      u64 z) {
  out[p] = make_uint2((uint32_t)(z >> 32), (uint32_t)z);
}

// D, C = 0: any d and K (read from the arguments); else that d and C.
template <int D, int C, bool kStaged>
__global__ void __launch_bounds__(kThreads)
sfc_encode_kernel(const uint32_t* __restrict__ x, long long x_stride,
                  const u64* __restrict__ lut, const int* __restrict__ reg,
                  uint2* __restrict__ out, long long n, int d, int K, int R,
                  int M) {
  extern __shared__ __align__(16) u64 s_lut[];
  __shared__ RegionBits rb;
  const int nC = C ? C : (K + 3) / 4;
  const int row_words = d * nC * 16;            // one region's tables
  const long long curve = blockIdx.y;
  x += curve * x_stride;
  lut += curve * R * row_words;
  reg += curve * M;
  out += curve * n;
  if constexpr (kStaged) {
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(s_lut);
    const int chunks = R * row_words / 2;       // 16-byte pieces
    for (int t = threadIdx.x; t < chunks; t += kThreads) {
      cp_async16(base + 16u * t, lut + 2 * t);
    }
  }
  if (threadIdx.x == 0) {
    int count = 0;
    for (int m = 0; m < M; ++m) {
      const int t = __ldg(reg + m);
      if (t >= 0 && t < d * K) {
        const int i = t / K;
        rb.word[count] = (t - i * K) | (m << 8) | (i << 16);
        ++count;
      }
    }
    rb.count = count;
  }
  const u64* table;
  if constexpr (kStaged) {
    table = s_lut;
  } else {
    table = lut;
  }
  const long long step = (long long)gridDim.x * kThreads * kPointsPerThread;
  const long long first =
      (long long)blockIdx.x * kThreads * kPointsPerThread + threadIdx.x;
  if constexpr (D > 0) {
    uint32_t v[kPointsPerThread][D];
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      load_point<D>(x, first + k * kThreads, n, v[k]);
    }
    if constexpr (kStaged) cp_async_wait_all();
    __syncthreads();
    for (long long b = first; b < n; b += step) {
      if (b != first) {
#pragma unroll
        for (int k = 0; k < kPointsPerThread; ++k) {
          load_point<D>(x, b + k * kThreads, n, v[k]);
        }
      }
      u64 z[kPointsPerThread];
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        z[k] = encode_point<D, C, kStaged>(v[k], table, rb);
      }
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        if (b + k * kThreads < n) store(out, b + k * kThreads, z[k]);
      }
    }
  } else {
    if constexpr (kStaged) cp_async_wait_all();
    __syncthreads();
    for (long long b = first; b < n; b += step) {
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        const long long p = b + k * kThreads;
        if (p < n) {
          store(out, p, encode_point_any<kStaged>(x + p * d, d, nC, table,
                                                  rb));
        }
      }
    }
  }
}

template <int D, int C, bool kStaged>
int launch(dim3 grid, size_t smem, cudaStream_t stream, const void* x,
           long long x_stride, const void* lut, const void* reg, void* out,
           long long n, int d, int K, int R, int M) {
  auto kernel = sfc_encode_kernel<D, C, kStaged>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      (const uint32_t*)x, x_stride, (const u64*)lut, (const int*)reg,
      (uint2*)out, n, d, K, R, M);
  return (int)cudaGetLastError();
}

template <bool kStaged>
int dispatch(int D, int C, dim3 grid, size_t smem, cudaStream_t s,
             const void* x, long long x_stride, const void* lut,
             const void* reg, void* out, long long n, int d, int K, int R,
             int M) {
  if (D == 2 && C == 8) {
    return launch<2, 8, kStaged>(grid, smem, s, x, x_stride, lut, reg, out,
                                 n, d, K, R, M);
  }
  if (D == 3 && C == 6) {
    return launch<3, 6, kStaged>(grid, smem, s, x, x_stride, lut, reg, out,
                                 n, d, K, R, M);
  }
  if (D == 4 && C == 4) {
    return launch<4, 4, kStaged>(grid, smem, s, x, x_stride, lut, reg, out,
                                 n, d, K, R, M);
  }
  return launch<0, 0, kStaged>(grid, smem, s, x, x_stride, lut, reg, out, n,
                               d, K, R, M);
}

int encode(const void* x, long long x_stride, const void* lut,
           const void* reg, void* out, long long n, int d, int K, int R,
           int M, int P, int staged, int blocks, void* stream) {
  if (d < 1 || K < 1 || K > 32 || d * K > 64 || R < 1 || M < 0 ||
      M > kMaxRegionBits || P < 1 || P > 65535 || blocks < 1 ||
      x_stride < 0 || ((uintptr_t)out & 7) || ((uintptr_t)lut & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int C = (K + 3) / 4;
  const long long table_bytes = (long long)R * d * C * 128;
  if (staged && table_bytes > kMaxStagedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  int D = d;
  if (D == 2 && (((uintptr_t)x & 7) || (x_stride & 1))) D = 0;  // 8-byte loads
  const dim3 grid((unsigned)blocks, (unsigned)P);
  cudaStream_t s = (cudaStream_t)stream;
  return staged ? dispatch<true>(D, C, grid, (size_t)table_bytes, s, x,
                                 x_stride, lut, reg, out, n, d, K, R, M)
                : dispatch<false>(D, C, grid, 0, s, x, x_stride, lut, reg,
                                  out, n, d, K, R, M);
}

}  // namespace

// One curve: x (n, d), lut (R, d, C, 16), reg (M,) -> out (n, 2).
extern "C" int sfc_encode_launch(const void* x, const void* lut,
                                 const void* reg, void* out, long long n,
                                 int d, int K, int R, int M, int staged,
                                 int blocks, void* stream) {
  return encode(x, 0, lut, reg, out, n, d, K, R, M, 1, staged, blocks,
                stream);
}

// A pool of P curves: x (n, d) shared (x_stride 0) or (P, n, d) (x_stride
// n*d), lut (P, R, d, C, 16), reg (P, M) -> out (P, n, 2).
extern "C" int sfc_encode_pool_launch(const void* x, long long x_stride,
                                      const void* lut, const void* reg,
                                      void* out, long long n, int d, int K,
                                      int R, int M, int P, int staged,
                                      int blocks, void* stream) {
  return encode(x, x_stride, lut, reg, out, n, d, K, R, M, P, staged, blocks,
                stream);
}
