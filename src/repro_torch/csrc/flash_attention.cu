// Forward attention in float32 on Hopper's tensor cores, with GQA, causal
// and sliding-window masks and online softmax in float32.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py for
// float32 inputs (bfloat16 inputs take flash_attention_tc.cu).  It
// computes what that kernel computes:
//   o[bh] = softmax(q[bh] * dh^-0.5 . k[kvh]^T + mask) . v[kvh],
//   kvh = bh / (BH / BKH)   (the TPU kernel's kv index map, bh // group),
// with q scaled before the product, masked scores set to -1e30 (not -inf,
// as the TPU kernel does), the causal mask col <= row, the window mask
// col >= row - window + 1, and the output acc / max(l, 1e-30) in float32.
// Inputs q (BH, S, dh) and k/v (BKH, S, dh), contiguous float32 with
// 16-byte aligned bases; dh in {32, 64, 128}; any S (the ragged last tile
// is masked here; the TPU's S % bq assertion was a tiling limit).
//
// Arithmetic: three TF32 parts.  One TF32 operand keeps 11 significant
// bits, about three decimal digits, short of the reference's 2e-5 float32
// bar.  So every operand element x is split as big = rna(x) and small =
// rna(x - big), rna being cvt.rna.tf32.f32's rounding (to nearest, ties
// away from zero; `tf32` below), so that big is exactly the value the
// tensor core reads, and each product a.b is taken as
// small_a.big_b + big_a.small_b + big_a.big_b on the tensor cores
// (mma.sync m16n8k8 tf32, float32 accumulators); small.small (~2^-22 of
// a.b) is dropped.  That holds for both products, S = (q*scale).K^T and
// O += P.V with P split too.  Row max and row sum are taken in float32 on
// the unrounded scores and P.  `flash_tf32x3_ref` in
// repro_torch/kernels/flash_attention/ref.py rounds at the same points.
//
// Bound on the H100: operations.  Causal attention does 4*dh flops per
// visible (row, col) pair.  Three TF32 products give a float32-accurate
// product, so the least time is those flops at a third of the TF32 peak
// (495 / 3 = 165 TFLOP/s): at (B 4, H 32, S 2048, dh 128, causal) 1.375e11
// flops are 0.833 ms, against 335.5 MB of q, k, v and o over 3.35 TB/s =
// 0.100 ms.
//
// Design (FlashAttention-2's work split).  A block of 8 warps owns a
// q-tile of 128 rows of one head, 16 rows a warp, and walks exactly the kv
// tiles of 64 rows that tile can see: hi = min(n_kv, ceil((q0 + 128) /
// 64)) when causal and lo = max(0, (q0 - window + 1) / 64) when window > 0;
// a warp skips a tile none of its rows sees, and masks only a tile that
// crosses its diagonal, window edge or S.  K and V tiles arrive by 16-byte
// cp.async into a ring of two stages, tile t+1 loading while tile t is
// multiplied; rows past S are zero-filled.  Shared memory holds raw
// float32 tiles: the q-tile, loaded once, and the ring (192 KB a block at
// dh 128); each warp loads its fragments with 16-byte loads and scales
// (q) and splits them in registers.
//
// Fragment layouts (m16n8k8 tf32; lane = 4g + t): A (16 x 8, row-major)
// a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4); B (8 x 8,
// col-major) b0 = (t, g), b1 = (t+4, g); C c0 = (g, 2t), c1 = (g, 2t+1),
// c2 = (g+8, 2t), c3 = (g+8, 2t+1).  Three choices make every fragment
// one 16-byte load and P need no shuffle:
// - Q.K^T sums over d in any order, so its k index t of step 2p+s is
//   column 16p + 4t + 2s and t+4 is 16p + 4t + 2s + 1: a lane's q and K
//   fragments of two steps are one float4 each.
// - P.V's k index t of kv step j is kv row 8j + 2t and t+4 is 8j + 2t + 1,
//   the columns a lane's S accumulator already holds (c0, c1), so P's A
//   fragment is (c0, c2, c1, c3) as it lies.
// - P.V's n index g of n-tile 4m + i is output column 32m + 4g + i: a
//   lane's V fragments of four n-tiles are one float4, and its O
//   accumulators of those tiles are columns 32m + 8t + {i, 4 + i}, two
//   float4 stores a row.
// Tiles are swizzled in 16-byte chunks (chunk c of row r at c ^ (r & 1) * 4
// for q and K, c ^ (r & 7) for V) so that each quarter-warp of those loads
// touches 8 different chunks of 128 bytes: no bank conflicts.
//
// Measured on an H100 (PERF.md §6): 2.37 ms at the shape above, 35% of
// the bound.  Two warps an SM sub-partition issue the splits and the
// mma.sync's.  Giving each warp 32 rows (two m16 tiles sharing every split
// K and V fragment, so half the K and V splits a product; 32-row kv
// tiles) cut the time by only 4.5%, so mma.sync itself is near its limit
// here: the next step is wgmma, with the split K and a transposed split V
// staged in shared memory (it takes TF32 operands only K-major).
//
// Grid: one block per (q-tile, bh), the heaviest causal q-tiles of every
// head first.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBQ = 16 * kWarps;   // q rows per block, 16 a warp
constexpr int kBK = 64;            // kv rows per tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory (floats): the q-tile | kStages K tiles | kStages V tiles.
template <int DH>
struct Cfg {
  static constexpr int kChunks = DH / 4;        // 16-byte chunks a row
  static constexpr int kQ = kBQ * DH;           // floats of the q-tile
  static constexpr int kTile = kBK * DH;        // floats of a K or V tile
  static constexpr size_t kBytes = sizeof(float) * (kQ + 2 * kStages * kTile);
};

// 16-byte chunk c of row `row` lies at chunk k_chunk (q and K tiles) or
// v_chunk (V tiles) of that row.
__device__ __forceinline__ int k_chunk(int row, int c) {
  return c ^ ((row & 1) << 2);
}
__device__ __forceinline__ int v_chunk(int row, int c) { return c ^ (row & 7); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x to TF32, round to nearest, ties away from zero (low 13 bits zero):
// what cvt.rna.tf32.f32 gives for finite x, in two integer instructions
// (ptxas lowers the cvt to four, with a check for infinities that finite
// inputs never take): the sign-magnitude bits plus half a TF32 ulp, the
// low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32; small is rounded from x - big, where big is
// the value the tensor core reads.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in three TF32 parts, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// One kv tile of K and V (rows k0 .. k0 + 63) into a ring stage; rows past
// S are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(float* ks, float* vs,
                                          const float* kg, const float* vg,
                                          int k0, int S, int tid) {
  constexpr int C = Cfg<DH>::kChunks;
#pragma unroll
  for (int i = 0; i < kBK * C / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / C, c = e % C;
    const bool in = k0 + r < S;
    const size_t g = (size_t)(in ? k0 + r : 0) * DH + 4 * c;
    cp_async16(ks + r * DH + 4 * k_chunk(r, c), kg + g, in);
    cp_async16(vs + r * DH + 4 * v_chunk(r, c), vg + g, in);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int BH,
                 int group, int S, int causal, int window, float scale) {
  constexpr int NP = DH / 16;   // pairs of k8 steps of Q.K^T
  constexpr int NJ = kBK / 8;   // n8 tiles of S = k8 steps of P.V
  constexpr int NM = DH / 32;   // groups of 4 n8 tiles of O
  constexpr int C = Cfg<DH>::kChunks;
  constexpr int kTile = Cfg<DH>::kTile;
  extern __shared__ __align__(128) float smem[];
  float* qs = smem;                       // the q-tile, unscaled
  float* ks = qs + Cfg<DH>::kQ;           // kStages K tiles
  float* vs = ks + kStages * kTile;       // kStages V tiles

  const int n_q = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_q - 1 - blockIdx.x / BH;
  const int kvh = bh / group;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (tid >> 5);         // the warp's first row in the tile
  const int r0 = q0 + wr;
  const int rows[2] = {r0 + g, r0 + g + 8};
  const float* kg = k + (size_t)kvh * S * DH;
  const float* vg = v + (size_t)kvh * S * DH;

  const int n_kv = (S + kBK - 1) / kBK;
  const int hi = causal ? min(n_kv, (q0 + kBQ + kBK - 1) / kBK) : n_kv;
  const int lo = window > 0 ? max(0, (q0 - window + 1) / kBK) : 0;

  // the q-tile (rows past S zero-filled) and the first kv tile
  const float* qg = q + (size_t)bh * S * DH;
#pragma unroll
  for (int i = 0; i < kBQ * C / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / C, c = e % C;
    const bool in = q0 + r < S;
    cp_async16(qs + r * DH + 4 * k_chunk(r, c),
               qg + (size_t)(in ? q0 + r : 0) * DH + 4 * c, in);
  }
  load_tile<DH>(ks, vs, kg, vg, lo * kBK, S, tid);
  cp_async_commit();

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = lo; it < hi; ++it) {
    if (it + 1 < hi) {
      const int nx = (it + 1 - lo) % kStages;
      load_tile<DH>(ks + nx * kTile, vs + nx * kTile, kg, vg,
                    (it + 1) * kBK, S, tid);
    }
    cp_async_commit();
    cp_async_wait1();   // tile it has landed (this thread's copies)
    __syncthreads();    // ... and every thread's

    const int k0 = it * kBK;
    const bool seen = r0 < S && !(causal && k0 > r0 + 15) &&
                      !(window > 0 && k0 + kBK - 1 < r0 - window + 1);
    if (seen) {
      const float* kt = ks + ((it - lo) % kStages) * kTile;
      const float* vt = vs + ((it - lo) % kStages) * kTile;

      // S = (q * scale) . K^T
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        // rows g and g + 8, columns 16p + 4t .. + 3, scaled
        const float4 x0 = *reinterpret_cast<const float4*>(
            qs + (wr + g) * DH + 4 * k_chunk(g, 4 * p + t));
        const float4 x1 = *reinterpret_cast<const float4*>(
            qs + (wr + g + 8) * DH + 4 * k_chunk(g, 4 * p + t));
        uint32_t ab[2][4], as[2][4];   // A of steps 2p and 2p + 1
        split(x0.x * scale, ab[0][0], as[0][0]);
        split(x1.x * scale, ab[0][1], as[0][1]);
        split(x0.y * scale, ab[0][2], as[0][2]);
        split(x1.y * scale, ab[0][3], as[0][3]);
        split(x0.z * scale, ab[1][0], as[1][0]);
        split(x1.z * scale, ab[1][1], as[1][1]);
        split(x0.w * scale, ab[1][2], as[1][2]);
        split(x1.w * scale, ab[1][3], as[1][3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = 8 * j + g;
          const float4 x = *reinterpret_cast<const float4*>(
              kt + r * DH + 4 * k_chunk(r, 4 * p + t));
          uint32_t bb[4], bs[4];
          split(x.x, bb[0], bs[0]);
          split(x.y, bb[1], bs[1]);
          split(x.z, bb[2], bs[2]);
          split(x.w, bb[3], bs[3]);
          mma3(s[j], ab[0], as[0], bb[0], bb[1], bs[0], bs[1]);
          mma3(s[j], ab[1], as[1], bb[2], bb[3], bs[2], bs[3]);
        }
      }

      // masks, only where the tile crosses this warp's diagonal, window
      // edge or S
      if (k0 + kBK > S || (causal && k0 + kBK - 1 > r0) ||
          (window > 0 && k0 < r0 + 15 - window + 1)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = rows[e >> 1];
            bool live = col < S;
            if (causal) live = live && col <= row;
            if (window > 0) live = live && col >= row - window + 1;
            if (!live) s[j][e] = kNegInf;
          }
      }

      // online softmax: a row's 64 scores lie on the 4 lanes of its g
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);
        // a row masked so far keeps p = 0
        mb[h] = mx[h] == kNegInf ? 0.f : mx[h] * kLog2e;
        m[h] = mx[h];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P . V
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t pb[4], ps[4];
        split(s[j][0], pb[0], ps[0]);
        split(s[j][2], pb[1], ps[1]);
        split(s[j][1], pb[2], ps[2]);
        split(s[j][3], pb[3], ps[3]);
        const int rv = 8 * j + 2 * t;
#pragma unroll
        for (int mm = 0; mm < NM; ++mm) {
          const float4 x0 = *reinterpret_cast<const float4*>(
              vt + rv * DH + 4 * v_chunk(rv, 8 * mm + g));
          const float4 x1 = *reinterpret_cast<const float4*>(
              vt + (rv + 1) * DH + 4 * v_chunk(rv + 1, 8 * mm + g));
          const float w0[4] = {x0.x, x0.y, x0.z, x0.w};
          const float w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t b0b, b0s, b1b, b1s;
            split(w0[i], b0b, b0s);
            split(w1[i], b1b, b1s);
            mma3(acc[4 * mm + i], pb, ps, b0b, b1b, b0s, b1s);
          }
        }
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }

  float* og = o + (size_t)bh * S * DH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (rows[h] >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
    float* orow = og + (size_t)rows[h] * DH;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(orow + 32 * mm + 8 * t + 4 * e) =
            make_float4(acc[4 * mm][2 * h + e] / den,
                        acc[4 * mm + 1][2 * h + e] / den,
                        acc[4 * mm + 2][2 * h + e] / den,
                        acc[4 * mm + 3][2 * h + e] / den);
  }
}

template <int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      int BH, int BKH, int S, int causal, int window,
                      cudaStream_t stream) {
  const size_t bytes = Cfg<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * BH;
  const float scale = (float)(1.0 / sqrt((double)DH));
  flash_fwd_kernel<DH><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, BH / BKH, S,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (BH, S, dh), k/v (BKH, S, dh), o (BH, S, dh), contiguous float32,
// 16-byte aligned.  Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH,
                                      int BKH, int S, int dh, int causal,
                                      int window, void* stream) {
  if (BH <= 0 || BKH <= 0 || BH % BKH || S <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return (int)launch_dh<32>(q, k, v, o, BH, BKH, S, causal, window, st);
    case 64: return (int)launch_dh<64>(q, k, v, o, BH, BKH, S, causal, window, st);
    case 128: return (int)launch_dh<128>(q, k, v, o, BH, BKH, S, causal, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at head dim `dh` (bytes; 0 for a dh
// the kernel does not take).
extern "C" int flash_attention_smem_bytes(int dh) {
  switch (dh) {
    case 32: return (int)Cfg<32>::kBytes;
    case 64: return (int)Cfg<64>::kBytes;
    case 128: return (int)Cfg<128>::kBytes;
  }
  return 0;
}
