// Forward attention in bfloat16 on Hopper's tensor cores, with GQA, causal
// and sliding-window masks and online softmax in float32.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py for
// bfloat16 inputs; float32 inputs take flash_attention.cu (three TF32
// products a product on mma.sync).  It computes what the TPU kernel
// computes:
//   o[b, h] = softmax(q[b, h] . k[b, kvh]^T * dh^-0.5 + mask) . v[b, kvh],
//   kvh = h / (H / KH),
// with masked scores at -1e30 (not -inf), the causal mask col <= row, the
// window mask col >= row - window + 1, and o = acc / max(l, 1e-30) in q's
// dtype.  It rounds in two places where the TPU kernel does not: the scale
// is applied to the float32 product (the TPU kernel scales q first), and
// the probabilities enter P.V as two bfloat16 parts, hi = bf16(p) and
// lo = bf16(p - hi), about 16 bits of p (the TPU kernel keeps float32;
// P in one bf16 part flipped a greedy token of the qwen3-4b prefill
// against the float32 attention path).  `flash_tc_ref` in
// repro_torch/kernels/flash_attention/ref.py rounds at the same points.
//
// Bound on the H100: operations.  4*dh flops per visible (row, col) pair;
// at the qwen3-4b prefill (B 4, H 32, S 2048, dh 128, causal) 1.37e11 flops
// are 0.139 ms at the bf16 tensor-core peak (989 TFLOP/s), against 168 MB of
// q, k, v and o over 3.35 TB/s = 0.050 ms.
//
// Design.  One CTA of three warpgroups per (128-row q-tile, q head), the
// heaviest causal q-tiles first.  Warpgroup 0 is the producer: it drops to
// 24 registers (setmaxnreg) and one thread issues every TMA load, the
// q-tile once, then K and V tiles of 128 kv rows into a ring of two stages
// with a "full" and an "empty" mbarrier each.  Warpgroups 1 and 2 are the
// consumers (240 registers), each owning 64 q rows: S = Q.K^T by
// wgmma m64n128k16 with both operands in shared memory (K-major), the
// masks only on tiles that cross the diagonal, the window edge or S, the
// online softmax in registers (exp2 with scale*log2(e) folded into one
// FMA; a row's max reduces over the 4 lanes holding it), then P's two
// bfloat16 parts straight from the accumulator registers as the A
// operands of two wgmma m64n{dh}k16 per k16 step, with V from shared
// memory, MN-major (transpose bit), so V needs no transposed copy.  The
// kv range of a q-tile is exact: hi = min(n_kv, ceil((q0 + 128) / 128))
// when causal and lo = max(0, (q0 - window + 1) / 128) when window > 0.
//
// Layout.  q, k, v and o are (B, heads, S, dh) views with any batch, head
// and row strides (16-byte multiples) and a contiguous last dimension, so
// the model's (B, S, H, dh) activations are read and written in place.
// The TMA maps are 4-D (dh, S, heads, B) over the tensors as they lie;
// rows past S are zero-filled by TMA and masked.  A tile is stored as
// 64-column boxes (128-byte rows; dh 32: one 32-column box, 64-byte rows)
// in the TMA's 128-byte (64-byte) swizzle, the mode the wgmma descriptors
// name.  The output is stored from registers through o's strides.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // q rows per CTA, 64 per consumer warpgroup
constexpr int kBN = 128;        // kv rows per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer + 2 consumer warpgroups
constexpr float kNegInf = -1e30f;

template <int DH>
struct Cfg {
  static constexpr int kBoxCols = DH >= 64 ? 64 : DH;   // columns per box
  static constexpr int kRowBytes = kBoxCols * 2;        // swizzle span
  static constexpr int kBoxes = DH / kBoxCols;
  static constexpr int kKPerBox = kBoxCols / 16;        // k16 steps a box
  static constexpr int kBoxBytes = kBN * kRowBytes;     // one 128-row box
  static constexpr int kTileBytes = kBN * DH * 2;       // Q, K or V tile
  static constexpr int kSBO = 8 * kRowBytes;            // 8-row group
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // shared memory: Q | K stages | V stages | barriers (1024-aligned base)
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 4-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x n128, f32) = A . B^T, or d += A . B^T when `accumulate`;
// A and B as smem descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64 x n32, f32) += A (registers, bf16 pairs) . B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// d (m64 x n64, f32) += A (registers, bf16 pairs) . B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// d (m64 x n128, f32) += A (registers, bf16 pairs) . B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (DH == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (DH == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, long long o_sb, long long o_sh,
                long long o_ss, int BH, int H, int group, int S, int causal,
                int window, float scale_log2) {
  using C = Cfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t q_s = base, k_s = base + C::kK, v_s = base + C::kV;
  const uint32_t q_full = base + C::kBar;        // 8 bytes each
  const uint32_t full = q_full + 8, empty = q_full + 8 + 8 * kStages;

  const int n_q = (S + kBM - 1) / kBM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - blockIdx.x / BH) * kBM;
  const int b = bh / H, h = bh % H, kvh = h / group;
  const int n_kv = (S + kBN - 1) / kBN;
  const int hi = causal ? min(n_kv, (q0 + kBM + kBN - 1) / kBN) : n_kv;
  const int lo = window > 0 ? max(0, (q0 - window + 1) / kBN) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kTileBytes);
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(q_s + c * C::kBoxBytes, &tq, q_full, c * C::kBoxCols, q0, h,
                 b);
      for (int i = 0, t = lo; t < hi; ++i, ++t) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kTileBytes);
        const uint32_t ks = k_s + s * C::kTileBytes;
        const uint32_t vs = v_s + s * C::kTileBytes;
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load(ks + c * C::kBoxBytes, &tk, full + 8 * s, c * C::kBoxCols,
                   t * kBN, kvh, b);
          tma_load(vs + c * C::kBoxBytes, &tv, full + 8 * s, c * C::kBoxCols,
                   t * kBN, kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, quad = lane % 4;
  // the accumulator rows of this thread: row0 and row0 + 8
  const int row0 = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;
  const int wg_first = q0 + wg * 64, wg_last = wg_first + 63;
  const uint32_t q_wg = q_s + wg * 64 * C::kRowBytes;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0, t = lo; t < hi; ++i, ++t) {
    const int s = i % kStages;
    const int k0 = t * kBN;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t ks = k_s + s * C::kTileBytes;
    const uint32_t vs = v_s + s * C::kTileBytes;

    // S = Q . K^T: 64 x 128 per warpgroup, float32
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / C::kKPerBox) * C::kBoxBytes +
                           (kk % C::kKPerBox) * 32;
      wgmma_ss_n128(sc, smem_desc(q_wg + off, 16, C::kSBO, C::kLayout),
                    smem_desc(ks + off, 16, C::kSBO, C::kLayout), kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs<64>(sc);

    // accumulator element e of n8 block j: row row0 + 8 * (e / 2),
    // column k0 + 8 * j + 2 * quad + e % 2
    const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > wg_first) ||
                      (window > 0 && k0 < wg_last - window + 1);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * quad + e % 2;
          bool live = col < S;
          if (causal) live = live && col <= row;
          if (window > 0) live = live && col >= row - window + 1;
          if (!live) sc[4 * j + e] = kNegInf;
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
    float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      // a row masked so far keeps p = 0: the FMA below would otherwise
      // give exp2 of the rounding error of -1e30 * scale * log2(e)
      mb[r] = mx[r] == kNegInf ? 0.f : mx[r] * scale_log2;
    }

    // P = exp2(S * scale * log2(e) - m * scale * log2(e)) as bf16 pairs
    // hi + lo in accumulator order: that is the A fragment of k16 step kk
    // in registers 4 kk .. 4 kk + 3.
    uint32_t p_hi[32], p_lo[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int r = n % 2;   // elements 2n, 2n + 1 share row row0 + 8 r
      const float p0 = exp2f(fmaf(sc[2 * n], scale_log2, -mb[r]));
      const float p1 = exp2f(fmaf(sc[2 * n + 1], scale_log2, -mb[r]));
      rs[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[n] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[n] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];

    // O += P_hi . V + P_lo . V: k16 steps over the tile's kv rows
    fence_regs<DH / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t v_desc = smem_desc(vs + kk * 16 * C::kRowBytes,
                                        C::kBoxBytes, C::kSBO, C::kLayout);
      wgmma_pv<DH>(acc, p_hi + 4 * kk, v_desc);
      wgmma_pv<DH>(acc, p_lo + 4 * kk, v_desc);
    }
    wgmma_commit_and_wait();
    fence_regs<DH / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = ob + row * o_ss + 2 * quad;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / l[r],
                                acc[4 * j + 2 * r + 1] / l[r]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is looked up through the runtime once.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (dh, S, heads, B) over a bf16 tensor with element strides
// st = (batch, head, row), boxes of box_cols x 128 rows.
bool make_map(CUtensorMap* map, const void* ptr, int dh, int S, int heads,
              int B, const long long* st, int box_cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)heads,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)kBN, 1, 1};
  cuuint32_t one[4] = {1, 1, 1, 1};
  CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int KH, int S,
                   int causal, int window, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, DH, S, H, B, st, C::kBoxCols) ||
      !make_map(&tk, k, DH, S, KH, B, st + 3, C::kBoxCols) ||
      !make_map(&tv, v, DH, S, KH, B, st + 6, C::kBoxCols))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((S + kBM - 1) / kBM) * B * H;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)DH));
  flash_tc_kernel<DH><<<(unsigned)blocks, kThreads, C::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11],
      B * H, H, H / KH, S, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, S, dh), k/v (B, KH, S, dh), o (B, H, S, dh), bfloat16 views with
// a contiguous last dimension; st holds their (batch, head, row) element
// strides in the order q, k, v, o (12 values).  Returns a cudaError_t
// (0 = ok; cudaErrorInvalidValue also when a TMA map is refused).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* st, int B, int H,
                                         int KH, int S, int dh, int causal,
                                         int window, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || S <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 32: return (int)launch<32>(q, k, v, o, st, B, H, KH, S, causal, window, s);
    case 64: return (int)launch<64>(q, k, v, o, st, B, H, KH, S, causal, window, s);
    case 128: return (int)launch<128>(q, k, v, o, st, B, H, KH, S, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
