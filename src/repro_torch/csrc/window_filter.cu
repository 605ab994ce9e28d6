// Points-in-rectangle filter over candidate pages: counts (window_filter)
// and membership masks (window_match).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/window_filter/kernel.py:
// `window_filter_pallas` (body `_filter_kernel`) and `window_match_pallas`
// (body `_match_kernel`).  The TPU kernels take pages that XLA gathered
// for them: pts (G, d, cap) int32 holding unsigned coordinates, rect
// (G, d, 2) int32 [lo, hi], size (G,) int32.  For every (query, page)
// pair g, slot s is a hit when s < size[g] and lo[i] <= pts[g, i, s] <=
// hi[i] for every dimension i, compared unsigned.  The TPU compared signed
// words after a sign flip; here the words are compared as uint32.
//
// Bound on the H100: memory.  Each coordinate is read once and takes two
// compares, far below the card's integer rate, so the least time is the
// bytes of the valid slots over the HBM bandwidth (3.35 TB/s).
//
// window_filter reads the candidate pages by id itself (the TPU kernel's
// scalar prefetch becomes a block that loads its own indices), so the
// Count path copies no gathered pages.  Inputs: points (P, d, cap), the
// index's page array; page_size (P,); queries (Qc, d, 2); cand (Qc, C)
// page ids in [0, P) (a live id outside it traps the kernel); n_cand
// (Qc,) int64, the live candidates of each query.  Out:
// (Qc,) int32, for each query the hits summed over its live candidates
// c < clamp(n_cand[q], 0, C), each page's slots s < clamp(size, 0, cap).
// Without cand the page of item (q, c) is q*C + c, and without n_cand
// every item is live: the TPU contract is the case Qc = G, C = 1 with
// neither, the pages their own queries.
//
// Design: persistent blocks, about as many as fit on the SMs, split the
// live (query, candidate) items in contiguous runs; dead items are never
// touched.  A block is one producer warp and four consumer warps around a
// ring of kStages tiles in dynamic shared memory.  The producer's lanes
// load 32 items' page ids and sizes at once, then for each tile of (d, T)
// slots lane i starts one `cp.async.bulk` of row i's valid prefix (rounded
// up to 16 bytes; only the valid slots of a page are copied), completing
// on the stage's "full" mbarrier.  A row is 16-byte aligned only when cap
// % 4 == 0, so each copy starts at the row's aligned-down address and the
// consumers read from the offset it leaves (the slack lies inside the
// points tensor's allocation, which the caching allocator rounds up to
// 512 bytes).  Consumers compare from shared memory, the tile's rectangle
// in registers (d <= 4) or shared memory, add their warp's hits into the
// stage's count and release it on its "empty" mbarrier.  The producer
// reads each stage's count when it reclaims the stage and sums a query's
// tiles in a register: one int32 atomicAdd a (block, query) into an out
// the launch zeroes (integer sums: exact in any order).  In the TPU
// contract each query's one item lies in one block, so its count is
// stored and nothing is zeroed.
//
// window_match keeps the gathered contract: one block of 256 threads per
// pair g, threads striding over the slots (coalesced), the 0/1 mask
// written as bytes (the ops-level contract is a bool mask).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 32;
constexpr unsigned kFull = 0xffffffffu;

// ---- window_filter ---------------------------------------------------------

// The ring's shape: 4 consumer warps, 4 stages of at most 16 KB of points
constexpr int kConsumerWarps = 4;
constexpr int kFilterThreads = 32 * (kConsumerWarps + 1);
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;

struct Stage {          // one tile, described by the producer
  int q;                // its query
  int n;                // its slots; -1: no more tiles
  int count;            // hits, added by the consumer warps
  int pad;
  uint32_t lo[kMaxDims], hi[kMaxDims];
  int off[kMaxDims];    // words from row i's copy start to slot t0
};

// dynamic shared memory: full[kStages] | empty[kStages] | Stage[kStages] |
// tiles, each d rows of RS words (RS = T + 4: the copy's slack)
constexpr int kMetaOffset = 2 * kStages * 8;
constexpr int kTileOffset =
    (kMetaOffset + kStages * (int)sizeof(Stage) + 127) / 128 * 128;

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

// `bytes` (a multiple of 16) from 16-byte aligned `src` to `dst`,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

struct Args {
  const uint32_t* points;
  const int* page_size;
  const uint32_t* queries;
  const int* cand;          // null: page of item (q, c) is q*C + c
  const long long* n_cand;  // null: every item is live
  int* out;
  int P, Qc, C, cap, T, RS;
  bool store;               // each query's items lie in one block
};

// Live items of a run of 32 queries from `qb`: this lane's query's count
// and the inclusive prefix over the run.
struct Run {
  int qb, base, v, incl, total;
};

__device__ __forceinline__ void load_run(const Args& a, Run& r, int lane) {
  const int q = r.qb + lane;
  int v = 0;
  if (q < a.Qc) {
    v = a.C;
    if (a.n_cand) {
      const long long n = a.n_cand[q];
      v = (int)(n < 0 ? 0 : (n > a.C ? a.C : n));
    }
  }
  r.v = v;
  r.incl = warp_inclusive_sum(v, lane);
  r.total = __shfl_sync(kFull, r.incl, 31);
}

template <int D>
__device__ void filter_producer(const Args& a, int d, uint64_t* full,
                                uint64_t* empty, Stage* st, uint32_t* tiles,
                                int lane) {
  // this block's share [start, end) of the L live items
  int L = a.Qc * a.C;
  if (a.n_cand) {
    L = 0;
    for (int qb = 0; qb < a.Qc; qb += 32) {
      Run t{qb, 0, 0, 0, 0};
      load_run(a, t, lane);
      L += t.total;
    }
  }
  const int per = (L + gridDim.x - 1) / gridDim.x;
  const int start = (int)min((long long)L, (long long)blockIdx.x * per);
  const int end = (int)min((long long)L, (long long)start + per);
  // the run of 32 queries that holds item `start` is found below; without
  // n_cand every query has C items, so start from its own run
  Run r{0, 0, 0, 0, 0};
  if (!a.n_cand) {
    r.qb = start / a.C / 32 * 32;
    r.base = r.qb * a.C;
  }
  load_run(a, r, lane);
  const int tile_words = d * a.RS;

  int posted = 0;           // stages posted
  int run_q = -1, run_sum = 0;
  auto emit = [&](int q, int v) {
    if (lane == 0) {
      if (a.store) a.out[q] = v;
      else if (v) atomicAdd(a.out + q, v);
    }
  };
  // wait until stage k's consumers are done and take its count (lane 0
  // keeps the sums; the warp syncs before the stage is written again)
  auto reclaim = [&](int k) {
    const int s = k % kStages;
    mbar_wait(smem_u32(empty + s), (k / kStages) & 1);
    if (lane == 0) {
      const int q = st[s].q;
      if (q != run_q) {
        if (run_q >= 0) emit(run_q, run_sum);
        run_q = q;
        run_sum = 0;
      }
      run_sum += st[s].count;
    }
    __syncwarp();
  };

  for (int j = start; j < end;) {
    while (r.base + r.total <= j) {
      r.base += r.total;
      r.qb += 32;
      load_run(a, r, lane);
    }
    const int m = min(32, min(end, r.base + r.total) - j);
    // lane k takes item j + k: the first query of the run whose
    // inclusive prefix passes it
    const int rel = j + lane - r.base;
    int l = 0;
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, r.incl, l + step - 1) <= rel) l += step;
    }
    const int q_k = r.qb + l;
    const int c_k = rel - __shfl_sync(kFull, r.incl - r.v, l);
    int p_k = 0, n_k = 0;
    if (lane < m) {
      const long long item = (long long)q_k * a.C + c_k;
      p_k = a.cand ? a.cand[item] : (int)item;
      // a live id outside [0, P) stops the kernel, as an index assert
      // would: the launch's context reports the fault at its next sync
      if ((unsigned)p_k >= (unsigned)a.P) __trap();
      n_k = min(max(a.page_size[p_k], 0), a.cap);
    }
    for (int k = 0; k < m; ++k) {
      const int p = __shfl_sync(kFull, p_k, k);
      const int n = __shfl_sync(kFull, n_k, k);
      const int q = __shfl_sync(kFull, q_k, k);
      if (n == 0 && a.store) emit(q, 0);
      for (int t0 = 0; t0 < n; t0 += a.T) {
        const int nt = min(a.T, n - t0);
        const int s = posted % kStages;
        if (posted >= kStages) reclaim(posted - kStages);
        int bytes = 0;
        const char* src = nullptr;
        if (lane < d) {
          const uint32_t* row =
              a.points + ((size_t)p * d + lane) * a.cap + t0;
          const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
          const uintptr_t aligned = addr & ~(uintptr_t)15;
          const int off = (int)((addr - aligned) >> 2);
          bytes = ((off + nt) * 4 + 15) & ~15;
          src = reinterpret_cast<const char*>(aligned);
          const uint32_t* rect = a.queries + ((size_t)q * d + lane) * 2;
          st[s].lo[lane] = rect[0];
          st[s].hi[lane] = rect[1];
          st[s].off[lane] = off;
        }
        if (lane == 0) {
          st[s].q = q;
          st[s].n = nt;
          st[s].count = 0;
        }
        const int total = __reduce_add_sync(kFull, bytes);
        __syncwarp();
        if (lane == 0) mbar_expect_tx(smem_u32(full + s), total);
        __syncwarp();
        if (lane < d) {
          bulk_copy(smem_u32(tiles + (size_t)s * tile_words + lane * a.RS),
                    src, bytes, smem_u32(full + s));
        }
        ++posted;
      }
    }
    j += m;
  }

  // no more tiles: a stage with n = -1 ends the consumers
  const int s = posted % kStages;
  if (posted >= kStages) reclaim(posted - kStages);
  if (lane == 0) {
    st[s].n = -1;
    mbar_arrive(smem_u32(full + s));
  }
  for (int k = max(0, posted - kStages + 1); k < posted; ++k) reclaim(k);
  if (lane == 0 && run_q >= 0) emit(run_q, run_sum);
}

template <int D>
__device__ void filter_consumer(const Args& a, int d, uint64_t* full,
                                uint64_t* empty, const Stage* st,
                                const uint32_t* tiles, int lane) {
  const int tile_words = d * a.RS;
  for (int k = 0;; ++k) {
    const int s = k % kStages;
    mbar_wait(smem_u32(full + s), (k / kStages) & 1);
    const int n = st[s].n;
    if (n < 0) break;
    const uint32_t* tile = tiles + (size_t)s * tile_words;
    int cnt = 0;
    if constexpr (D > 0) {
      uint32_t lo[D], hi[D];
      const uint32_t* row[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        lo[i] = st[s].lo[i];
        hi[i] = st[s].hi[i];
        row[i] = tile + i * a.RS + st[s].off[i];
      }
      for (int x = threadIdx.x; x < n; x += 32 * kConsumerWarps) {
        bool ok = true;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const uint32_t v = row[i][x];
          ok &= (lo[i] <= v) & (v <= hi[i]);
        }
        cnt += ok;
      }
    } else {
      for (int x = threadIdx.x; x < n; x += 32 * kConsumerWarps) {
        bool ok = true;
        for (int i = 0; i < d; ++i) {
          const uint32_t v = tile[i * a.RS + st[s].off[i] + x];
          ok &= (st[s].lo[i] <= v) & (v <= st[s].hi[i]);
        }
        cnt += ok;
      }
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
      atomicAdd(const_cast<int*>(&st[s].count), cnt);
      mbar_arrive(smem_u32(empty + s));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFilterThreads)
window_filter_kernel(Args a, int d_arg) {
  const int d = D > 0 ? D : d_arg;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  Stage* st = reinterpret_cast<Stage*>(smem + kMetaOffset);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem + kTileOffset);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    filter_producer<D>(a, d, full, empty, st, tiles, lane);
  } else {
    filter_consumer<D>(a, d, full, empty, st, tiles, lane);
  }
}

using FilterKernel = void (*)(Args, int);

FilterKernel filter_kernel(int d) {
  switch (d) {
    case 1: return window_filter_kernel<1>;
    case 2: return window_filter_kernel<2>;
    case 3: return window_filter_kernel<3>;
    case 4: return window_filter_kernel<4>;
    default: return window_filter_kernel<0>;
  }
}

// ---- window_match ----------------------------------------------------------

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

// Tile width T (slots a stage holds, a multiple of 4) and the dynamic
// shared memory of a window_filter block at d and cap.
static void filter_tiles(int d, int cap, int* T, size_t* smem) {
  int t = (kStageBytes / (4 * d)) & ~3;
  t = t < 4 ? 4 : t;
  const int cap4 = (cap + 3) & ~3;
  *T = t < cap4 ? t : cap4;
  *smem = kTileOffset + (size_t)kStages * d * (*T + 4) * 4;
}

extern "C" int window_filter_launch(const void* points, const void* page_size,
                                    const void* queries, const void* cand,
                                    const void* n_cand, void* out, int P,
                                    int Qc, int C, int d, int cap,
                                    void* stream) {
  if (d < 1 || d > kMaxDims || P < 0 || Qc < 0 || C < 0 || cap < 1 ||
      (long long)Qc * C > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bool store = C == 1 && n_cand == nullptr;
  if (!store && Qc > 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)Qc * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  if ((long long)Qc * C == 0) return (int)cudaSuccess;
  int T;
  size_t smem;
  filter_tiles(d, cap, &T, &smem);
  const FilterKernel fn = filter_kernel(d);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                    kFilterThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)Qc * C;
  const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = (int)(items < fit ? items : fit);
  Args a{(const uint32_t*)points, (const int*)page_size,
         (const uint32_t*)queries, (const int*)cand,
         (const long long*)n_cand, (int*)out, P, Qc, C, cap, T, T + 4,
         store};
  fn<<<grid, kFilterThreads, smem, s>>>(a, d);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) and tile width of a window_filter block.
extern "C" int window_filter_smem_bytes(int d, int cap) {
  if (d < 1 || d > kMaxDims || cap < 1) return -1;
  int T;
  size_t smem;
  filter_tiles(d, cap, &T, &smem);
  return (int)smem;
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
