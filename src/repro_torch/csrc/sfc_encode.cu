// Monotone space-filling-curve encode: coordinates -> Z64, under one curve
// or under every curve of an SMBO candidate pool; and, built on the same
// encode, the query split and its z-ranges (the second part of this file).
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

// A point in device memory, read through the read-only cache.
struct GlobalPoint {
  const uint32_t* __restrict__ p;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return __ldg(p + i);
  }
};

// Any d and C: coordinate i is xp(i), read where it is used (for a
// `GlobalPoint` the read-only cache holds the point between the region
// code and the lookups).
template <bool kStaged, typename Point>
__device__ __forceinline__ u64 encode_point_any(const Point& xp, int d,
                                                int C, const u64* table,
                                                const RegionBits& rb) {
  int r = 0;
  for (int k = 0; k < rb.count; ++k) {
    const int w = rb.word[k];
    r |= (int)((xp(w >> 16) >> (w & 31)) & 1u) << ((w >> 8) & 31);
  }
  const u64* row = table + (long long)r * d * C * 16;
  u64 z = 0;
  for (int i = 0; i < d; ++i) {
    const uint32_t v = xp(i);
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

// A block's prologue: start copying a curve's table (`words` words) into
// shared memory with cp.async when staged, and list its live region bits
// in `rb` (thread 0).  Returns where lookups read the table; the caller
// waits (`cp_async_wait_all`) and syncs before the first one.
template <bool kStaged>
__device__ __forceinline__ const u64* stage_curve(
    const u64* __restrict__ lut, const int* __restrict__ reg, int words,
    int d, int K, int M, u64* s_lut, RegionBits& rb) {
  if constexpr (kStaged) {
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(s_lut);
    for (int t = threadIdx.x; t < words / 2; t += kThreads) {  // 16 bytes
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
  if constexpr (kStaged) {
    return s_lut;
  } else {
    return lut;
  }
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
  const u64* table = stage_curve<kStaged>(lut, reg, R * row_words, d, K, M,
                                          s_lut, rb);
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
          store(out, p, encode_point_any<kStaged>(GlobalPoint{x + p * d}, d,
                                                  nC, table, rb));
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

// ---------------------------------------------------------------------------
// The query split (paper §6, Lemma 2) and its z-ranges, in one launch.
//
// Replaces no TPU kernel: the reference leaves `recursive_split_jax` and
// `zranges_jax` to XLA, which fuses them.  Their plain-torch twin
// (`core.split.recursive_split_torch`, then `zranges_torch`) is some 380
// small launches a batch, whatever its size, and the serving path runs it
// once a device call.
//
// Windows (Q, d, 2) uint32 [lo, up] -> valid (Q, S) uint8, zlo and zhi
// (Q, S) Z64 (hi, lo), S = 2^k.  The twin goes level by level: a node cuts
// each dim with lo < up at Lemma 2's v = (up >> l) << l, l the top bit of
// lo ^ up, encodes the corners U (up with the dim at v - 1) and L (lo with
// the dim at v), and splits on the first dim of the largest positive gap
// f(L) - f(U): child 0 [lo, up with the dim at v - 1] at 2s, child 1 [lo
// with the dim at v, up] at 2s + 1.  A node that is invalid or has no
// positive gap keeps its rectangle in both children, child 1 invalid.  The
// leaves' z-ranges are the encodes of their two corners, invalid leaves
// included.
//
// Design: one thread a leaf (window q, leaf s), walking its path from the
// root; at level j it takes child bit (s >> (k - 1 - j)) & 1.  The leaves of
// a window sit in neighbouring lanes and compute their shared upper nodes
// in the same instructions, so a warp pays k levels of at most 2d encodes,
// as a schedule of one node a lane would, with no node state in memory and
// no barrier after the prologue.  Once a node has no split, its rectangle
// is final and the leaf is valid iff every later bit is 0 (child 0 all the
// way down), so the walk stops there.  The encodes are the encode kernel's
// (`encode_point`, or `encode_point_any` on any other (d, K)), with the
// table staged in shared memory or read through L1 as `ops.plan_split`
// picks.  Bound: memory, the windows in and the leaves out
// (`ops.split_work`); the encodes are k * 2d + 2 a leaf.
constexpr int kMaxSplitDims = 16;
constexpr int kMaxSplit = 16;

template <int D>
using Bounds = uint32_t[D ? D : kMaxSplitDims];

// b[i] = value, without indexing registers by a runtime value (D > 0).
template <int D>
__device__ __forceinline__ void put(Bounds<D>& b, int i, uint32_t value) {
  if constexpr (D > 0) {
#pragma unroll
    for (int t = 0; t < D; ++t) b[t] = t == i ? value : b[t];
  } else {
    b[i] = value;
  }
}

// A corner in the general instance: the bounds b with dim `dim` at `value`.
struct Corner {
  const uint32_t* b;
  int dim;
  uint32_t value;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return i == dim ? value : b[i];
  }
};

template <int D, int C, bool kStaged>
__device__ __forceinline__ u64 encode_corner(const Bounds<D>& b, int dim,
                                             uint32_t value, int d, int nC,
                                             const u64* table,
                                             const RegionBits& rb) {
  if constexpr (D > 0) {
    uint32_t v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = i == dim ? value : b[i];
    return encode_point<D, C, kStaged>(v, table, rb);
  } else {
    return encode_point_any<kStaged>(Corner{b, dim, value}, d, nC, table,
                                     rb);
  }
}

// The node [lo, up]'s split dim (-1: none) and its cut v.
template <int D, int C, bool kStaged>
__device__ __forceinline__ int best_cut(const Bounds<D>& lo,
                                        const Bounds<D>& up, int d, int nC,
                                        const u64* table,
                                        const RegionBits& rb,
                                        uint32_t& cut) {
  int best = -1;
  u64 best_gap = 0;
  auto try_dim = [&](int i) {
    if (lo[i] < up[i]) {
      const int l = 31 - __clz(lo[i] ^ up[i]);
      const uint32_t v = (up[i] >> l) << l;            // >= 1: bit l of up
      const u64 fU = encode_corner<D, C, kStaged>(up, i, v - 1u, d, nC,
                                                  table, rb);
      const u64 fL = encode_corner<D, C, kStaged>(lo, i, v, d, nC, table,
                                                  rb);
      if (fL > fU && fL - fU > best_gap) {            // first max
        best = i;
        best_gap = fL - fU;
        cut = v;
      }
    }
  };
  if constexpr (D > 0) {
#pragma unroll
    for (int i = 0; i < D; ++i) try_dim(i);
  } else {
    for (int i = 0; i < d; ++i) try_dim(i);
  }
  return best;
}

// D, C = 0: any d <= kMaxSplitDims and K; else that d and C.
template <int D, int C, bool kStaged>
__global__ void __launch_bounds__(kThreads)
split_zranges_kernel(const uint32_t* __restrict__ q,
                     const u64* __restrict__ lut, const int* __restrict__ reg,
                     uint8_t* __restrict__ valid, uint2* __restrict__ zlo,
                     uint2* __restrict__ zhi, long long Q, int d, int K,
                     int R, int M, int k) {
  extern __shared__ __align__(16) u64 s_lut[];
  __shared__ RegionBits rb;
  const int nd = D ? D : d;
  const int nC = C ? C : (K + 3) / 4;
  const u64* table = stage_curve<kStaged>(lut, reg, R * nd * nC * 16, nd, K,
                                          M, s_lut, rb);
  if constexpr (kStaged) cp_async_wait_all();
  __syncthreads();
  const long long leaves = Q << k;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < leaves; p += step) {
    const uint32_t* w = q + (p >> k) * nd * 2;
    const int s = (int)(p & ((1LL << k) - 1));
    Bounds<D> lo, up;
    if constexpr (D > 0) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        lo[i] = __ldg(w + 2 * i);
        up[i] = __ldg(w + 2 * i + 1);
      }
    } else {
      for (int i = 0; i < d; ++i) {
        lo[i] = __ldg(w + 2 * i);
        up[i] = __ldg(w + 2 * i + 1);
      }
    }
    bool ok = true;
    for (int rest = k; rest > 0; --rest) {    // levels left, this one too
      uint32_t v = 0;
      const int i = best_cut<D, C, kStaged>(lo, up, nd, nC, table, rb, v);
      if (i < 0) {
        ok = (s & ((1 << rest) - 1)) == 0;
        break;
      }
      if ((s >> (rest - 1)) & 1) {
        put<D>(lo, i, v);
      } else {
        put<D>(up, i, v - 1u);
      }
    }
    valid[p] = ok;
    store(zlo, p, encode_corner<D, C, kStaged>(lo, -1, 0u, nd, nC, table,
                                               rb));
    store(zhi, p, encode_corner<D, C, kStaged>(up, -1, 0u, nd, nC, table,
                                               rb));
  }
}

template <int D, int C, bool kStaged>
int launch_split(int blocks, size_t smem, cudaStream_t stream,
                 const void* q, const void* lut, const void* reg,
                 void* valid, void* zlo, void* zhi, long long Q, int d,
                 int K, int R, int M, int k) {
  auto kernel = split_zranges_kernel<D, C, kStaged>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      (const uint32_t*)q, (const u64*)lut, (const int*)reg, (uint8_t*)valid,
      (uint2*)zlo, (uint2*)zhi, Q, d, K, R, M, k);
  return (int)cudaGetLastError();
}

template <bool kStaged>
int dispatch_split(int C, int blocks, size_t smem, cudaStream_t s,
                   const void* q, const void* lut, const void* reg,
                   void* valid, void* zlo, void* zhi, long long Q, int d,
                   int K, int R, int M, int k) {
  if (d == 2 && C == 8) {
    return launch_split<2, 8, kStaged>(blocks, smem, s, q, lut, reg, valid,
                                       zlo, zhi, Q, d, K, R, M, k);
  }
  if (d == 3 && C == 6) {
    return launch_split<3, 6, kStaged>(blocks, smem, s, q, lut, reg, valid,
                                       zlo, zhi, Q, d, K, R, M, k);
  }
  if (d == 4 && C == 4) {
    return launch_split<4, 4, kStaged>(blocks, smem, s, q, lut, reg, valid,
                                       zlo, zhi, Q, d, K, R, M, k);
  }
  return launch_split<0, 0, kStaged>(blocks, smem, s, q, lut, reg, valid,
                                     zlo, zhi, Q, d, K, R, M, k);
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

// The split and its z-ranges: windows q (Q, d, 2), one curve's lut
// (R, d, C, 16) and reg (M,) -> valid (Q, 2^k) uint8, zlo and zhi
// (Q, 2^k, 2) int32 Z64.
extern "C" int split_zranges_launch(const void* q, const void* lut,
                                    const void* reg, void* valid, void* zlo,
                                    void* zhi, long long Q, int d, int K,
                                    int R, int M, int k, int staged,
                                    int blocks, void* stream) {
  if (d < 1 || d > kMaxSplitDims || K < 1 || K > 32 || d * K > 64 || R < 1 ||
      M < 0 || M > kMaxRegionBits || k < 0 || k > kMaxSplit || Q < 0 ||
      blocks < 1 || ((uintptr_t)zlo & 7) || ((uintptr_t)zhi & 7) ||
      ((uintptr_t)lut & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int C = (K + 3) / 4;
  const long long table_bytes = (long long)R * d * C * 128;
  if (staged && table_bytes > kMaxStagedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return staged ? dispatch_split<true>(C, blocks, (size_t)table_bytes, s, q,
                                       lut, reg, valid, zlo, zhi, Q, d, K, R,
                                       M, k)
                : dispatch_split<false>(C, blocks, 0, s, q, lut, reg, valid,
                                        zlo, zhi, Q, d, K, R, M, k);
}
