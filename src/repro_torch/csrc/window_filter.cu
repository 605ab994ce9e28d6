// Points-in-rectangle filter over candidate pages: counts (window_filter)
// and matching row ids or membership masks (window_match).
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
// bytes of the valid slots (and of the ids written) over the HBM
// bandwidth (3.35 TB/s).
//
// Both read the candidate pages by id themselves (the TPU kernel's scalar
// prefetch becomes a block that loads its own indices), so the serving
// path copies no gathered pages.  Inputs: points (P, d, cap), the index's
// page array; page_size (P,); queries (Qc, d, 2); cand (Qc, C) page ids in
// [0, P) (a live id outside it traps the kernel); n_cand (Qc,) int64, the
// live candidates of each query.  Item (q, c) is live when c <
// clamp(n_cand[q], 0, C); its page's slots s < clamp(size, 0, cap) count.
// Without cand the page of item (q, c) is q*C + c, and without n_cand
// every item is live: the TPU contracts are the case Qc = G, C = 1 with
// neither, the pages their own queries.
//
// One ring kernel serves three outputs:
// - count (window_filter): (Qc,) int32, each query's hits summed over its
//   live items;
// - bits (window_match, pass 1 of the Range path): for each live item its
//   hit count (Qc, C) int32 and its hits as (Qc, C, W) uint32 words, W =
//   ceil(cap / 32), bit s % 32 of word s / 32 for slot s (warp ballots);
//   all W words of an item with a valid slot are written (0 past them);
// - mask (window_match, the TPU contract): the (G, cap) 0/1 byte mask.
// Pass 2 of the Range path (window_match_ids_kernel) turns the counts and
// words into row ids: see there.
//
// The ring: persistent blocks, about as many as fit on the SMs, split the
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
// 512 bytes).  T is a multiple of 32 whenever a page spans several tiles,
// so a tile's hit words are whole.  Consumers compare from shared memory,
// the tile's rectangle in registers (d <= 4) or shared memory, add their
// warp's hits into the stage's count (and store the tile's words or mask
// bytes) and release it on its "empty" mbarrier.  The producer reads each
// stage's count when it reclaims the stage and sums a key's tiles in a
// register: for counts the key is the query, one int32 atomicAdd a
// (block, query) into an out the launch zeroes (integer sums: exact in any
// order); for bits the key is the item, which lies in one block, so its
// count is stored (as is a query's count in the TPU contract, where
// nothing is zeroed).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 32;
constexpr unsigned kFull = 0xffffffffu;

// ---- the ring kernel -------------------------------------------------------

// The ring's shape: 4 consumer warps, 4 stages of at most 16 KB of points
constexpr int kConsumerWarps = 4;
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;

// What the consumers make of a tile
constexpr int kCount = 0;   // hits summed per query (window_filter)
constexpr int kBits = 1;    // hit words and per-item counts (window_match)
constexpr int kMask = 2;    // 0/1 bytes, the TPU contract (window_match)

struct Stage {          // one tile, described by the producer
  int key;              // the sum it adds to: its query (kCount), its item
  int item;             // q * C + c
  int t0;               // its first slot in the page
  int n;                // its slots; -1: no more tiles
  int tail;             // slots past the page's valid ones to zero: to
                        // cap (kMask) or to the last hit word (kBits)
  int count;            // hits, added by the consumer warps
  int pad[2];
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
  int* out;                 // kCount: (Qc,) counts; kBits: (Qc*C,) counts
  uint32_t* bits;           // kBits: (Qc*C, W) hit words
  uint8_t* mask;            // kMask: (Qc*C, cap) bytes
  int P, Qc, C, cap, T, RS, W;
  bool store;               // each key's items lie in one block
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

template <int M>
__device__ void ring_producer(const Args& a, int d, uint64_t* full,
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
  int run_key = -1, run_sum = 0;
  auto emit = [&](int key, int v) {
    if (lane == 0 && a.out) {
      if (a.store) a.out[key] = v;
      else if (v) atomicAdd(a.out + key, v);
    }
  };
  // wait until stage k's consumers are done and take its count (lane 0
  // keeps the sums; the warp syncs before the stage is written again)
  auto reclaim = [&](int k) {
    const int s = k % kStages;
    mbar_wait(smem_u32(empty + s), (k / kStages) & 1);
    if (lane == 0) {
      const int key = st[s].key;
      if (key != run_key) {
        if (run_key >= 0) emit(run_key, run_sum);
        run_key = key;
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
    const int item_k = q_k * a.C + c_k;
    int p_k = 0, n_k = 0;
    if (lane < m) {
      p_k = a.cand ? a.cand[item_k] : item_k;
      // a live id outside [0, P) stops the kernel, as an index assert
      // would: the launch's context reports the fault at its next sync
      if ((unsigned)p_k >= (unsigned)a.P) __trap();
      n_k = min(max(a.page_size[p_k], 0), a.cap);
    }
    for (int k = 0; k < m; ++k) {
      const int p = __shfl_sync(kFull, p_k, k);
      const int n = __shfl_sync(kFull, n_k, k);
      const int q = __shfl_sync(kFull, q_k, k);
      const int item = __shfl_sync(kFull, item_k, k);
      const int key = M == kCount ? q : item;
      if (n == 0) {
        if (a.store) emit(key, 0);
        if constexpr (M == kMask) {
          for (int s = lane; s < a.cap; s += 32) {
            a.mask[(size_t)item * a.cap + s] = 0;
          }
        }
      }
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
          st[s].key = key;
          st[s].item = item;
          st[s].t0 = t0;
          st[s].n = nt;
          st[s].tail = t0 + nt < n ? 0
                       : M == kMask ? a.cap - n
                       : M == kBits ? a.W * 32 - n : 0;
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
  if (lane == 0 && run_key >= 0) emit(run_key, run_sum);
}

template <int D, int M>
__device__ void ring_consumer(const Args& a, int d, uint64_t* full,
                              uint64_t* empty, const Stage* st,
                              const uint32_t* tiles, int lane) {
  const int warp = threadIdx.x >> 5;
  const int tile_words = d * a.RS;
  for (int k = 0;; ++k) {
    const int s = k % kStages;
    mbar_wait(smem_u32(full + s), (k / kStages) & 1);
    const int n = st[s].n;
    if (n < 0) break;
    const uint32_t* tile = tiles + (size_t)s * tile_words;
    uint32_t lo[D > 0 ? D : 1], hi[D > 0 ? D : 1];
    const uint32_t* row[D > 0 ? D : 1];
    if constexpr (D > 0) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        lo[i] = st[s].lo[i];
        hi[i] = st[s].hi[i];
        row[i] = tile + i * a.RS + st[s].off[i];
      }
    }
    // slot x of the tile (x < n) inside the rectangle
    auto inside = [&](int x) {
      bool ok = true;
      if constexpr (D > 0) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const uint32_t v = row[i][x];
          ok &= (lo[i] <= v) & (v <= hi[i]);
        }
      } else {
        for (int i = 0; i < d; ++i) {
          const uint32_t v = tile[i * a.RS + st[s].off[i] + x];
          ok &= (st[s].lo[i] <= v) & (v <= st[s].hi[i]);
        }
      }
      return ok;
    };
    int cnt = 0;
    if constexpr (M == kCount) {
      for (int x = threadIdx.x; x < n; x += 32 * kConsumerWarps) {
        cnt += inside(x);
      }
    } else {
      // a warp takes 32 consecutive slots at a time: one hit word
      const int item = st[s].item, t0 = st[s].t0;
      const int lim = n + st[s].tail;
      for (int base = warp * 32; base < lim;
           base += 32 * kConsumerWarps) {
        const int x = base + lane;
        const bool ok = x < n && inside(x);
        if constexpr (M == kBits) {
          const uint32_t word = __ballot_sync(kFull, ok);
          if (lane == 0) {
            a.bits[(size_t)item * a.W + ((t0 + base) >> 5)] = word;
            cnt += __popc(word);
          }
        } else {
          if (x < lim) a.mask[(size_t)item * a.cap + t0 + x] = ok;
        }
      }
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
      atomicAdd(const_cast<int*>(&st[s].count), cnt);
      mbar_arrive(smem_u32(empty + s));
    }
  }
}

template <int D, int M>
__global__ void __launch_bounds__(kRingThreads)
window_ring_kernel(Args a, int d_arg) {
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
    ring_producer<M>(a, d, full, empty, st, tiles, lane);
  } else {
    ring_consumer<D, M>(a, d, full, empty, st, tiles, lane);
  }
}

using RingKernel = void (*)(Args, int);

template <int M>
RingKernel ring_kernel_for(int d) {
  switch (d) {
    case 1: return window_ring_kernel<1, M>;
    case 2: return window_ring_kernel<2, M>;
    case 3: return window_ring_kernel<3, M>;
    case 4: return window_ring_kernel<4, M>;
    default: return window_ring_kernel<0, M>;
  }
}

RingKernel ring_kernel(int d, int mode) {
  switch (mode) {
    case kCount: return ring_kernel_for<kCount>(d);
    case kBits: return ring_kernel_for<kBits>(d);
    default: return ring_kernel_for<kMask>(d);
  }
}

// ---- window_match pass 2: hit words to row ids -----------------------------
//
// Grid: F blocks a query (F from the SM count, so that a chunk of 16
// queries fills the card).  Every block of query q scans q's live items'
// counts (exclusive, in shared memory, 256 at a time), which gives each
// item's first position in the id buffer and, at the end, n_hits[q] (every
// match, past max_hits too).  Warp w of block f expands items k = f * 8 + w,
// stepping by 8F, 32 words at a time: lane i loads word i, a warp scan of
// the words' popcounts gives each word's first position, and for each
// nonzero word lane b writes the id of slot 32 * word + b, if bit b is
// set, at that position plus the popcount of the word's lower bits (no
// step waits on the one before; ids of a word land in neighbouring
// positions, so the stores coalesce).  An item with no hit, whose words
// pass 1 did not write, is skipped.  Then block f writes -1 over its slice
// of [min(n_hits, max_hits), max_hits), 16 bytes a store where aligned.
// Bound: memory (the counts and the set words in, the (Qc, max_hits) ids
// out); the scan repeats F times over C counts, from L2.

constexpr int kIdsThreads = 256;
constexpr int kIdsWarps = kIdsThreads / 32;
constexpr int kIdsMaxBlocks = 32;     // blocks a query, at most

__global__ void __launch_bounds__(kIdsThreads)
window_match_ids_kernel(const int* __restrict__ counts,
                        const uint32_t* __restrict__ bits,
                        const int* __restrict__ cand,
                        const long long* __restrict__ n_cand,
                        int* __restrict__ ids, long long* __restrict__ n_hits,
                        int C, int W, int cap, int max_hits, int F) {
  __shared__ long long off[kIdsThreads];
  __shared__ int cnt[kIdsThreads];
  __shared__ long long wsum[kIdsWarps];
  const int q = blockIdx.x / F, f = blockIdx.x % F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)q * C;
  // the first 256 counts load beside n_cand, not after it (those past
  // the live items are read but not used)
  int next = (int)threadIdx.x < C ? counts[row0 + threadIdx.x] : 0;
  const long long nc = n_cand[q];
  const int live = (int)(nc < 0 ? 0 : (nc > C ? C : nc));
  long long carry = 0;
  for (int c0 = 0; c0 < live; c0 += kIdsThreads) {
    const int m = min(kIdsThreads, live - c0);
    const int v = (int)threadIdx.x < m ? next : 0;
    cnt[threadIdx.x] = v;
    if (c0 + kIdsThreads + (int)threadIdx.x < live) {
      next = counts[row0 + c0 + kIdsThreads + threadIdx.x];
    }
    const int incl = warp_inclusive_sum(v, lane);
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long t = lane < kIdsWarps ? wsum[lane] : 0;
      for (int o = 1; o < kIdsWarps; o <<= 1) {
        const long long u = __shfl_up_sync(kFull, t, o);
        if (lane >= o) t += u;
      }
      if (lane < kIdsWarps) wsum[lane] = t;
    }
    __syncthreads();
    off[threadIdx.x] = carry + (warp ? wsum[warp - 1] : 0) + incl - v;
    const long long total = wsum[kIdsWarps - 1];
    __syncthreads();
    for (int k = f * kIdsWarps + warp; k < m; k += F * kIdsWarps) {
      long long pos = off[k];
      if (pos >= max_hits) break;        // later items start further on
      if (cnt[k] == 0) continue;          // its words were not written
      const size_t item = row0 + c0 + k;
      const uint32_t* words = bits + item * W;
      const int gid0 = cand[item] * cap;
      for (int w0 = 0; w0 < W && pos < max_hits; w0 += 32) {
        const uint32_t mine = w0 + lane < W ? words[w0 + lane] : 0u;
        const int pc = __popc(mine);
        const int upto = warp_inclusive_sum(pc, lane);
        const long long first = pos + upto - pc;
        for (uint32_t nz = __ballot_sync(kFull, mine != 0u); nz;
             nz &= nz - 1) {
          const int j = __ffs(nz) - 1;
          const uint32_t word = __shfl_sync(kFull, mine, j);
          const long long p =
              __shfl_sync(kFull, first, j) +
              __popc(word & ((1u << lane) - 1u));
          if (((word >> lane) & 1u) && p < max_hits) {
            ids[(size_t)q * max_hits + p] = gid0 + (w0 + j) * 32 + lane;
          }
        }
        pos += __shfl_sync(kFull, upto, 31);
      }
    }
    carry += total;
    __syncthreads();    // off and wsum are rewritten by the next 256
  }
  if (f == 0 && threadIdx.x == 0) n_hits[q] = carry;
  // -1 over this block's slice of [min(n_hits, max_hits), max_hits)
  const long long per = ((long long)max_hits + F - 1) / F;
  const long long a0 = max(carry < max_hits ? carry : (long long)max_hits,
                           (long long)f * per);
  const long long a1 = min((long long)max_hits, (long long)(f + 1) * per);
  if (a0 >= a1) return;
  int* row = ids + (size_t)q * max_hits;
  int* p = row + a0;
  int* e = row + a1;
  const uintptr_t up = (reinterpret_cast<uintptr_t>(p) + 15) & ~(uintptr_t)15;
  const uintptr_t ue = reinterpret_cast<uintptr_t>(e);
  int* pa = reinterpret_cast<int*>(up < ue ? up : ue);
  const uintptr_t down = ue & ~(uintptr_t)15;
  int* ea = down > reinterpret_cast<uintptr_t>(pa) ? reinterpret_cast<int*>(down)
                                                   : pa;
  for (int* x = p + threadIdx.x; x < pa; x += kIdsThreads) *x = -1;
  int4* v4 = reinterpret_cast<int4*>(pa);
  const int n4 = (int)((ea - pa) / 4);
  for (int i = threadIdx.x; i < n4; i += kIdsThreads) {
    v4[i] = make_int4(-1, -1, -1, -1);
  }
  for (int* x = ea + threadIdx.x; x < e; x += kIdsThreads) *x = -1;
}

}  // namespace

// Tile width T (slots a stage holds: a multiple of 32 when a page spans
// several tiles, else the page rounded up to 4) and the dynamic shared
// memory of a ring block at d and cap.
static void ring_tiles(int d, int cap, int* T, size_t* smem) {
  int t = (kStageBytes / (4 * d)) & ~31;
  t = t < 32 ? 32 : t;
  const int cap4 = (cap + 3) & ~3;
  *T = t < cap4 ? t : cap4;
  *smem = kTileOffset + (size_t)kStages * d * (*T + 4) * 4;
}

static int ring_launch(Args a, int d, int mode, cudaStream_t s) {
  int T;
  size_t smem;
  ring_tiles(d, a.cap, &T, &smem);
  a.T = T;
  a.RS = T + 4;
  a.W = (a.cap + 31) / 32;
  const RingKernel fn = ring_kernel(d, mode);
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
                                                    kRingThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)a.Qc * a.C;
  const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = (int)(items < fit ? items : fit);
  fn<<<grid, kRingThreads, smem, s>>>(a, d);
  return (int)cudaGetLastError();
}

static bool bad_shape(int P, int Qc, int C, int d, int cap) {
  return d < 1 || d > kMaxDims || P < 0 || Qc < 0 || C < 0 || cap < 1 ||
         (long long)Qc * C > 0x7fffffffLL;
}

extern "C" int window_filter_launch(const void* points, const void* page_size,
                                    const void* queries, const void* cand,
                                    const void* n_cand, void* out, int P,
                                    int Qc, int C, int d, int cap,
                                    void* stream) {
  if (bad_shape(P, Qc, C, d, cap)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool store = C == 1 && n_cand == nullptr;
  if (!store && Qc > 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)Qc * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  if ((long long)Qc * C == 0) return (int)cudaSuccess;
  Args a{(const uint32_t*)points, (const int*)page_size,
         (const uint32_t*)queries, (const int*)cand,
         (const long long*)n_cand, (int*)out, nullptr, nullptr, P, Qc, C,
         cap, 0, 0, 0, store};
  return ring_launch(a, d, kCount, s);
}

// Dynamic shared memory (bytes) of a ring block (window_filter and
// window_match) at d and cap.
extern "C" int window_filter_smem_bytes(int d, int cap) {
  if (d < 1 || d > kMaxDims || cap < 1) return -1;
  int T;
  size_t smem;
  ring_tiles(d, cap, &T, &smem);
  return (int)smem;
}

// window_match's ring pass.  With `bits`: each live item's count into
// `counts` (Qc*C,) and its hit words into `bits` (Qc*C, ceil(cap/32)).
// Without: the TPU contract (cand and n_cand null), the (Qc*C, cap) byte
// mask into `mask`.
extern "C" int window_match_launch(const void* points, const void* page_size,
                                   const void* queries, const void* cand,
                                   const void* n_cand, void* counts,
                                   void* bits, void* mask, int P, int Qc,
                                   int C, int d, int cap, void* stream) {
  if (bad_shape(P, Qc, C, d, cap)) return (int)cudaErrorInvalidValue;
  const bool to_bits = bits != nullptr;
  if (to_bits ? counts == nullptr
              : (mask == nullptr || cand != nullptr || n_cand != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)Qc * C == 0) return (int)cudaSuccess;
  Args a{(const uint32_t*)points, (const int*)page_size,
         (const uint32_t*)queries, (const int*)cand,
         (const long long*)n_cand, to_bits ? (int*)counts : nullptr,
         (uint32_t*)bits, (uint8_t*)mask, P, Qc, C, cap, 0, 0, 0, true};
  return ring_launch(a, d, to_bits ? kBits : kMask, (cudaStream_t)stream);
}

// window_match's id pass: `counts` and `bits` from the ring pass, cand
// (Qc, C), n_cand (Qc,) int64 -> ids (Qc, max_hits) int32, -1 padded, and
// n_hits (Qc,) int64.
extern "C" int window_match_ids_launch(const void* counts, const void* bits,
                                       const void* cand, const void* n_cand,
                                       void* ids, void* n_hits, int Qc,
                                       int C, int cap, int max_hits,
                                       void* stream) {
  if (Qc < 0 || C < 0 || cap < 1 || max_hits < 0 ||
      (C > 0 && cand == nullptr) || (Qc > 0 && n_cand == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (Qc == 0) return (int)cudaSuccess;
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int F = (2 * sms + Qc - 1) / Qc;
  F = F < 1 ? 1 : (F > kIdsMaxBlocks ? kIdsMaxBlocks : F);
  if ((long long)Qc * F > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_match_ids_kernel<<<Qc * F, kIdsThreads, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const uint32_t*)bits, (const int*)cand,
      (const long long*)n_cand, (int*)ids, (long long*)n_hits, C,
      (cap + 31) / 32, cap, max_hits, F);
  return (int)cudaGetLastError();
}
