// Forward attention in float32 with GQA, causal and sliding-window masks,
// online softmax in float32.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py for
// float32 inputs (bfloat16 inputs take the tensor-core kernel in
// flash_attention_tc.cu).  It computes what that kernel computes:
//   o[bh] = softmax(q[bh] * dh^-0.5 . k[kvh]^T + mask) . v[kvh],
//   kvh = bh / (BH / BKH)   (the TPU kernel's kv index map, bh // group),
// with q, k and v cast to float32 and q scaled before the product, masked
// scores set to -1e30 (not -inf, as the TPU kernel does), the causal mask
// col <= row, the window mask col >= row - window + 1, and the output
// acc / max(l, 1e-30).  Inputs q (BH, S, dh) and k/v (BKH, S, dh),
// contiguous float32; dh in {32, 64, 128};
// any S (the ragged last tile is masked here; the TPU's S % bq assertion was
// a tiling limit).
//
// The TPU kernel walks kv blocks along a sequential grid axis and carries the
// running max, sum and accumulator in VMEM scratch, skipping dead blocks with
// pl.when.  Blocks on this card run in no order, so one block owns a q-tile
// of 64 rows of one head and loops over exactly the kv tiles that tile can
// see: hi = min(n_kv, ceil((q0 + 64) / 64)) when causal and
// lo = max(0, (q0 - window + 1) / 64) when window > 0.
//
// Bound on the H100: operations.  Causal attention does 4*dh flops per
// visible (row, col) pair, 2*2*BH*S^2*dh/2 in all, at the float32
// non-tensor peak (67 TFLOP/s) this kernel's scalar FMAs run at.  TF32
// tensor cores would keep about three decimal digits, short of the
// reference's 2e-5 float32 bar.
//
// Design, simple and correct first: 256 threads as 16 x 16; thread (ty, tx)
// owns rows ty*4 .. ty*4+3 of the q-tile, score columns tx + 16*j (j < 4) of
// the kv tile and output columns tx + 16*c (c < dh/16).  The q-tile, the kv
// tile's K (transposed) and V are staged in shared memory in the input type,
// the tile's probabilities in float32; row max and sum reduce across the 16
// lanes of a half-warp with shuffles.  Pitches are padded so that no two
// lanes of a warp read different words of one bank.  Grid: one block per
// (q-tile, bh), the heaviest causal q-tiles of every head first.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;         // q rows per block
constexpr int kBK = 64;         // kv rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Shared memory layout (bytes), probabilities first so that every region
// starts 4-byte aligned.
template <typename T, int DH>
struct Layout {
  static constexpr int kQPitch = DH + 1;     // q rows, in elements
  static constexpr int kKPitch = kBK + 1;    // K^T rows (one per feature)
  static constexpr int kPPitch = kBK + 4;    // probability rows (float)
  static constexpr size_t kP = sizeof(float) * kBQ * kPPitch;
  static constexpr size_t kQ = sizeof(T) * kBQ * kQPitch;
  static constexpr size_t kK = sizeof(T) * DH * kKPitch;
  static constexpr size_t kV = sizeof(T) * kBK * DH;
  static constexpr size_t kBytes = kP + kQ + kK + kV;
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int BH,
                 int group, int S, int causal, int window, float scale) {
  using L = Layout<T, DH>;
  constexpr int NC = DH / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem);
  T* qs = reinterpret_cast<T*>(smem + L::kP);
  T* kts = reinterpret_cast<T*>(smem + L::kP + L::kQ);
  T* vs = reinterpret_cast<T*>(smem + L::kP + L::kQ + L::kK);

  const int n_q = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_q - 1 - blockIdx.x / BH;
  const int kvh = bh / group;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const T* qg = q + (size_t)bh * S * DH;
  const T* kg = k + (size_t)kvh * S * DH;
  const T* vg = v + (size_t)kvh * S * DH;
  const T zero = from_f32<T>(0.f);

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    qs[r * L::kQPitch + c] = q0 + r < S ? qg[(size_t)(q0 + r) * DH + c] : zero;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (S + kBK - 1) / kBK;
  const int hi = causal ? min(n_kv, (q0 + kBQ + kBK - 1) / kBK) : n_kv;
  const int lo = window > 0 ? max(0, (q0 - window + 1) / kBK) : 0;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the last tile's K, V and P are no longer read
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int j = e / DH, c = e % DH;
      const bool in = k0 + j < S;
      const size_t g = (size_t)(k0 + j) * DH + c;
      kts[c * L::kKPitch + j] = in ? kg[g] : zero;
      vs[j * DH + c] = in ? vg[g] : zero;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = to_f32(qs[(ty * 4 + i) * L::kQPitch + d]) * scale;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = to_f32(kts[d * L::kKPitch + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool live = col < S;
        if (causal) live = live && col <= row;
        if (window > 0) live = live && col >= row - window + 1;
        if (!live) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * L::kPPitch + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], w[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * L::kPPitch + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) w[c] = to_f32(vs[j * DH + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }

  T* og = o + (size_t)bh * S * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      og[(size_t)row * DH + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int DH>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* o, int BH, int BKH, int S, int causal,
                         int window, cudaStream_t stream) {
  const size_t bytes = Layout<T, DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * BH;
  const float scale = (float)(1.0 / sqrt((double)DH));
  flash_fwd_kernel<T, DH><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), BH, BH / BKH, S, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (BH, S, dh), k/v (BKH, S, dh), o (BH, S, dh), contiguous float32.
// Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH,
                                      int BKH, int S, int dh, int causal,
                                      int window, void* stream) {
  if (BH <= 0 || BKH <= 0 || BH % BKH || S <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return (int)launch_typed<float, 32>(q, k, v, o, BH, BKH, S, causal, window, st);
    case 64: return (int)launch_typed<float, 64>(q, k, v, o, BH, BKH, S, causal, window, st);
    case 128: return (int)launch_typed<float, 128>(q, k, v, o, BH, BKH, S, causal, window, st);
  }
  return (int)cudaErrorInvalidValue;
}
