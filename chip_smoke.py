#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (`nvcc`); it fails without them and prints
no result.  Phases, each printing one JSON line:

1. set-up: builds the CUDA kernels from `src/repro_torch/csrc/` into
   `build/repro_torch/`, prints the card's name and power limit, reads its
   SMs and maximum SM clock (the integer peak, 64 int32 operations an SM a
   clock), and records for each flash and encode kernel instantiation the
   registers, static shared memory and spills that `ptxas -v` reports,
   whether the bf16 kernel's SASS holds `HGMMA` (wgmma) instructions and
   the float32 kernel's `HMMA` (mma.sync) instructions, the float32
   kernel's dynamic shared memory a block (a `flash_f32_kernel` line),
   and how many SASS instructions each encode instantiation has
   (`cuobjdump -sass`);
2. smbo: curve learning (SMBO, Algorithm 1) on the card through
   `learn_sfc`, on a 5% sample of each path's data with 100 sampled
   queries: a global curve for the main path (d=2, K=32) and a depth-2
   piecewise curve for the piecewise path (d=3, K=21).  Each run is held
   against the same run on the encode kernel's plain twin, its best
   candidates against the host's `batched` evaluator, and its learned
   cost against the z-order anchor; every round must launch the pooled
   encode kernel k_maxsplit + 2 times (keys, one a split level, z-ranges);
3. kernels: each kernel against its plain-torch twin on the card, bit for
   bit, with times and bounds, at the shapes its path gives it and at a
   larger one; `window_filter` at the path's shape also cold (the L2 cache
   flushed by a write of twice its size before each launch), with its
   ring's dynamic shared memory a block.  `split_zranges` (the query split
   and its z-ranges in one launch) takes a served batch of windows (256)
   and the benchmark's (1,024) from each path's workload under both
   learned curves, its `valid`, `zlo` and `zhi` held bit for bit against
   the twin and bounded by `split_work` and its encodes' integer
   operations, beside the split as the serving path ran it before, on the
   encode kernel (its time and launches).  The single-curve encode, which
   no served path launches any more (the serving paths encode inside
   `split_zranges`), is held at that split's largest call and at 2^20;
4. main path: a 10M-row OSM-like index (d=2, K=32, heuristic paging) under
   the learned global curve, served on the card, Count and Range batches
   through the CUDA kernels (one `split_zranges` launch and no encode
   launch a batch, one `window_filter` launch a Count chunk and two
   `window_match` launches a Range chunk, each reading its candidate pages
   by id: the page gather runs in neither), held bit for bit against the
   plain-torch backend on
   the card and against brute force; the live candidate pages a Count
   query and the profiled Count and Range batches' busy ms, launches and
   top kernels.  Then (`kernels_paged` line) the paged filter on this
   index's own arrays: with the first Count batch's candidates, chunk by
   chunk, and at a dense shape (16 queries with 256 live, distinct pages
   each), and the paged match with the first Range batch's candidates
   (max_hits 65,536), each against its twin, warm and cold;
5. piecewise path: a 1M-row NYC-like index (d=3) under the learned
   piecewise curve, held the same way;
6. database: the user's entry point, `repro_torch.api.Database`, on the
   main path's 10M rows: `fit` (SMBO on the device program, 100 training
   queries, a 10,000-row sample; the pooled encode launched) and the index
   build; the `cuda` engine (the main path's knobs) serves 4 Count and 4
   Range batches of 256, a Point batch of 256 (half stored rows) and 16
   kNN centers (k 10, l2 and linf), every output held bit for bit against
   the `torch` engine on the card, samples against brute force; forced
   escalation (max_cand 4, max_hits 64) ends exact; 10,000 inserts and
   1,000 deletes are served after a refresh that re-packs only dirty
   pages; one batch with obs on equals it with obs off.  It prints q/s
   through `Database.query` beside the main phase's bare-function q/s,
   `CacheStats`, the span totals, launches and peak device memory;
7. dp_paging: `paging="dp"` above 200k rows runs `dp_paging_torch` on the
   card: the piecewise path's 1M NYC-like rows under its learned curve are
   paged (seconds, pages, total score against `heuristic` and `fixed`: the
   exact DP must score no worse than either) and built into an index, and
   on a 250,000-row prefix the card's boundaries must equal
   `dp_paging_np`'s on the host, element for element;
8. store: the main path's 10M rows become an on-disk segment
   (`build_segment`, a host external sort of 500k-row chunks under the
   learned global curve, pages of 256 rows) under `build/`, opened with
   `verify="full"`; `Database.from_segment(...).engine("store")` on the
   kernels serves the database phase's traffic (4 Count and 4 Range
   batches of 256, 256 Point probes, 2 x 16 kNN centers) cold and warm at
   the default 256 MB page-group budget and again at 16 MB (evictions and
   bypass; resident bytes never above the budget), every output held bit
   for bit against the `store` engine on the plain twins on the card and
   against the `cuda` engine over the segment's index in memory, samples
   against brute force; build rows/s, q/s per kind, the cache's counters,
   the assemble and upload span totals and a profiled warm batch; the
   segment is removed at the end;
9. serving: `Database.serve(engine="cuda")` over the database phase's
   index under the JAX package's serving load (200 clients, Zipf 1.2,
   Count 0.45 / Range 0.2 / Point 0.25 / kNN 0.1 with k 4; SLO p99 100
   ms, batch_max 64, reject on overload) for 0.5 s at 250, 1,000 and 4,000
   offered q/s: completion q/s, p50/p95/p99 from the scheduled arrivals,
   shed counts and the controller's window; every served result equals
   `replay_serial` of the served log on the `cuda` and on the `torch`
   engine, bit for bit;
10. distributed: the database phase's index (after its updates) through
   the page-sharded `distributed` engine on a mesh of every visible card
   and on four shards of the first card: its Count batches and Point
   batch through the kernels on every shard, bit for bit against the
   `cuda` engine (counts, found flags, a one-shard mesh's overflow
   flags); forced escalation (max_cand 4), where each query's overflow
   count must equal the number of shards that overflowed; 1,000 inserts
   and 100 deletes served after a refresh that copies only the dirty
   pages into their shards; q/s beside the `cuda` engine's and a
   profiled batch.  One card runs its shards one after another: no peer
   copy and no collective runs;
11. router: `Router.build` of the 10M rows into 4 shard Databases on the
   card (each fitted as the database phase's fit is), the earlier
   phases' inserts and deletes applied through it, every shard on the
   `cuda` engine: the database phase's Count, Range, Point and kNN
   traffic bit for bit against the unsharded database's `cuda` engine,
   samples against brute force; `Router.serve` under the serving load at
   250 offered q/s, every served result equal to `replay_serial` on the
   Router; q/s per kind and the per-shard plan accounting;
12. pipeline: `synth_corpus` (250,000 docs, vocab 32,000, up to 512
   tokens) in an `IndexedDataset` on the card with `verify_selects`: 64
   seeded curriculum windows selected through a Range on the `cuda`
   engine (`window_match`), each equal to the full metadata mask; a
   `TokenBatcher` of 2 phases x 16 steps of (8, 512) batches resumed
   mid-stream; the same selections through a segment of the unique
   metadata rows on the `store` engine;
13. kernels_flash: the two flash attention kernels against their plain
   twin `mha_ref` on the card (atol = rtol = 2e-5 for the float32
   kernel, three TF32 products a product on the tensor cores, which is
   also held against `flash_tf32x3_ref` at 1e-5; 2e-2 for the bf16
   kernel, which is also held against `flash_tc_ref` at 1e-2: each twin
   rounds where its kernel rounds), with times (CUDA events over 20
   launches after a warm-up, for the twin and SDPA too, beside the
   profiler's), bounds (float32: its flops at a third of the TF32 peak,
   with `fp32_nontensor_ms` beside it) and
   `scaled_dot_product_attention` as a yardstick, at the LM path's shape
   (also as the model's (B, S, H, dh)-strided views) and the reference
   tests' shapes;
14. lm_serve: qwen3-4b at its published widths and full depth (36 layers)
   on seeded random weights serves 4 requests of 2,048 seeded random
   tokens: one prefill through the bf16 flash kernel (exactly one launch
   per layer), the caches stitched into
   a state of 2,048 + 32 slots, 32 greedy decode steps; the prefill is
   held against the plain-torch attention backend on the card;
15. lm_families: the other LM families at their published widths on
   seeded random bf16 weights, one config after another, each freed
   before the next: granite-moe-3b-a800m (32 layers, 2 x 2,048 tokens),
   mixtral-8x22b (12 of 56 layers: 282 GB of bf16 weights do not fit,
   12 layers are ~61 GB; 1 x 8,192 tokens, so its 4,096-token window
   bites), qwen2-vl-72b (32 of 80 layers, ~61 GB; 1,024 image embeddings
   on a 32 x 32 M-RoPE grid, 2 x 2,048), seamless-m4t-medium (12 + 12
   layers, 2 x 2,048 tokens over 512 encoder frames), zamba2-1.2b (38
   layers) and xlstm-125m (12 layers), 2 x 2,048 each.  First the bf16
   flash kernel alone at each of the config's self-attention shapes
   (seamless's encoder non-causal over 512 frames and its causal
   decoder; mixtral's window), on seeded inputs in the model's strided
   layout, held against `mha_ref` at 2e-2 and `flash_tc_ref` at 1e-2 and
   timed beside SDPA.  Then a prefill through the flash kernel launches
   it exactly once a self-attention (32 / 12 / 32 / 24 / 6 / 0; enc-dec
   cross-attention runs the plain walk, xLSTM has no attention) and
   nothing else, held against the plain-torch attention backend at atol
   0.15 / rtol 0.1 with equal (or tied) greedy first tokens; then 16 (8)
   greedy decode steps from the prefill's caches, or, for zamba2 and
   xlstm, 16 steps from the zero state over the prompt, each held
   against the prefill's logits at its position at a relative L2 bar
   (the JAX package's own full-depth prefill and decode differ past atol
   0.15 / rtol 0.1), and two planted faults (the state not carried, the
   prompt read one token ahead) must each pass that bar;
16. lm_train: qwen3-4b at its published widths on seeded random bf16
   weights, as many of its 36 layers as leave 20 GB of the card free
   beside the training state (~20 B a parameter: bf16 params and
   gradients, float32 accumulators, AdamW's float32 master, m and v),
   at most 16 (the script's time),
   trained by `make_train_step` with its own remat "full" and microbatch
   8 on one seeded batch of 8 x 4,096 tokens (train_4k's length) with
   `AdamWConfig(lr=1e-3, warmup_steps=1)`: one warm step under the
   profiler (idle share, device launches), three timed steps (tokens/s,
   s a step, peak memory; every launch count reset just before and read
   just after, and all must be 0: attention trains on the plain-torch
   walk, the flash kernel having no backward).  It holds (a) the first step's
   loss to the served loss, the bf16 flash kernel's forward under
   no_grad on the same weights and batch, within a relative 1e-3; (b) the
   loss falling over the repeated batch; (c) AdamW on the card to AdamW
   on the CPU for one leaf's gradient and state (relative L2 1e-6); (d)
   the learning rate to `lr_at`; (e) the training launcher at the reduced
   config on the card (6 steps, checkpoints every 3 under `build/`)
   against its run resumed from step 3, losses within 1e-3;
   Its model flops are `dist.roofline.model_flops` at the phase's own
   shape and depth, and its `mfu` those over the step time at the H100's
   989 TFLOP/s;
17. cost_model: the step counter (`dist.hlo_analysis.StepCounter`) on
   the card against the same step counted on `meta` tensors (shapes
   only): qwen3-4b at published widths and 4 layers, one lm_serve-shaped
   prefill (4 x 2,048) and one decode step from its caches, and one
   Count and one Range batch of the `cuda` kernels on the main phase's
   10M-row index; and the dry run's own card route (`count_cell` on
   "cuda", the prefill and a decode step from seeded `input_specs`
   inputs) against its meta route.  Flops, bytes and calls of every op
   name must be equal, each kernel's counted calls must equal its
   `LAUNCHES` delta, and each kernel op's bytes (and flops) must equal
   its bound's at the call's shapes (the window kernels' with every slot
   valid).  Then
   the shares of the measured steps: meta dry runs of lm_serve's prefill
   and decode step (36 layers), lm_train's step (its depth, 8 x 4,096)
   and the main phase's Count batch give counted flops and bytes,
   `compute_s` and `memory_s` at the H100's ceilings
   (`dist.roofline`), `mfu` (model flops over the measured time at 989
   TFLOP/s), `roofline_share` (the larger term over the measured time)
   and `useful_flops_ratio`; lm_train's counted argument and temporary
   bytes stand beside its measured peak.  Every share must be at most
   1.05;
18. lm_mesh: the LM on a torch `DeviceMesh`: a one-rank NCCL group (an
   in-process store) and a 1 x 1 mesh over it, destroyed at the end of
   the phase; no collective crosses cards.  A qwen3-4b prefill at
   published widths and 4 layers (4 x 2,048 tokens, the bf16 flash
   kernel on each rank's heads: 4 launches) through `make_prefill_step(
   ..., mesh=)` equal bit for bit to the unsharded step's logits and
   caches, its `StepCounter` count on the card equal to its count on
   meta with 0 collective wire bytes; 4 decode steps from its caches
   under `decode_state_specs` placements, bit for bit; granite-moe at
   full depth (2 x 2,048) with the shard-map dispatch within atol 0.15 /
   rtol 0.1 of the global dispatch with the same drop fraction; one
   qwen3-4b train step (4 layers, 8 x 4,096, microbatch 8) with its loss
   within a relative 1e-6 and its params and AdamW state bit for bit, no
   kernel launched; the sharded params checkpointed and restored with
   ``shardings=`` byte for byte.  At most 45 s;
19. launch check: every kernel but the float32 flash kernel and the
   single-curve encode ran on each path (those two only in the kernel
   phases), the window and split kernels in the store and serving phases
   too, `window_filter` and `split_zranges` in the distributed and router
   phases, `window_match` in
   the router and pipeline phases, `flash_attention_tc` in every
   attention family and in lm_mesh; no kernel in lm_train's timed
   steps; each kernel's calls in cost_model beside its row.

The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that line.  ``--osm-rows``/``--nyc-rows``/``--batches``/``--smbo-iters``/
``--lm-layers``/``--decode-steps``/``--dp-prefix``/``--store-rows``/
``--serve-seconds``/``--router-shards``/``--pipeline-docs``/
``--lm-families``/``--lm-train-layers`` cut the depth for a quick run; the
defaults are the full run.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_SM_CLOCK = 64    # sm_90: 64 int32 ALU ops an SM a clock
# Peak rate of the flash kernels' arithmetic by input type: bf16 on the
# dense bf16 tensor cores (989 TFLOP/s, data sheet); float32 as three TF32
# products (a third of the 495 TFLOP/s TF32 peak), which keep float32's
# accuracy at the reference's bar.  FP32_NONTENSOR is the float32 rate
# outside the tensor cores (67 TFLOP/s), kept beside it.
FLOPS_PER_S = {"float32": 495e12 / 3, "bfloat16": 989e12}
FP32_NONTENSOR_FLOPS_PER_S = 67e12
BATCH = 256                    # queries per served batch
Q_CHUNK = 16
K_MAXSPLIT = 4
MAX_CAND = 256
MAX_HITS = 65536
MAIN_CAP = 1024                # page capacity of the main path's index
CARD = None                    # nvidia-smi's name and power limit (setup)
START = time.perf_counter()    # the script's start, for `script_s`


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    """Print one JSON line; a phase's line also carries the script's wall
    seconds so far (`script_s`), which time the phases against the
    1,200 s budget."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median per-call device time (CUDA events over `iters` calls)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int = 20) -> tuple:
    """Device time from `torch.profiler` over `iters` calls (the kernels'
    self time, summed) per call, or None when the profiler recorded no
    device time; the device events it recorded per call; and the mean
    time of one recorded event.  A window that recorded no device event
    at all is run again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            break
    total_us = sum(e.self_device_time_total for e in events)
    count = sum(e.count for e in events)
    if total_us <= 0:
        return None, count / iters, None
    return total_us / iters / 1e3, count / iters, total_us / count / 1e3


def _device_events(prof) -> list:
    """The profiler's device-side events (kernels, copies, fills).  The
    host-side aten ops repeat their kernels' time as their own, so only
    events that ran on the card are summed."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def kernel_times(fn, iters: int = 20, one_launch: bool = False) -> dict:
    """Device time per call (profiler; CUDA events over back-to-back calls
    when the profiler sees nothing) and the back-to-back wall time, which
    includes the host's launch overhead when that dominates.  A long run
    of this script can lose some calls' device records (fewer than one
    event per call for a one-kernel wrapper), so for a wrapper that
    launches exactly one kernel (`one_launch`) the time is the mean of the
    recorded launches."""
    wall = time_ms(fn, iters=iters)
    dev, per_call, per_event = device_ms(fn, iters=iters)
    if one_launch and per_event is not None:
        dev = per_event
    return {"ms": dev if dev is not None else wall, "wall_ms": wall,
            "timing": "profiler" if dev is not None else "events",
            "device_events_per_call": per_call}


def flush_buffer(dev):
    """int32 buffer of twice the card's L2 cache (writing it evicts L2)."""
    import torch
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return torch.empty(2 * l2 // 4, dtype=torch.int32, device=dev)


def profiled_ms(fn, flush=None, iters: int = 30,
                kernels=("window_ring_kernel",)) -> tuple:
    """The profiler's device time of one call (every device event but the
    flush's fill), of its kernels named in `kernels` alone, and of each of
    them by name, means over `iters` calls; the flush, if any, is written
    before each call.  A window that recorded no device event at all is
    run again, up to three times (a long run of this script can lose a
    window's device records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                if flush is not None:
                    flush.fill_(i)
                fn()
            torch.cuda.synchronize()
        total, by_name = 0, dict.fromkeys(kernels, 0)
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() != DeviceType.CUDA
                    or "FillFunctor<int>" in e.name()):
                continue
            total += e.duration_ns()
            for k in kernels:
                if k in e.name():
                    by_name[k] += e.duration_ns()
        if total:
            break
    check(total > 0, "the profiler recorded no device event in three "
                     "windows")
    by_name = {k: v / iters / 1e6 for k, v in by_name.items()}
    return total / iters / 1e6, sum(by_name.values()), by_name


def profile_batch(fn) -> dict:
    """One served batch under the profiler: host wall time, device busy
    time, the idle share, and the kernels that took the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    top = sorted(avgs, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_launches": sum(e.count for e in avgs),
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def profile_step(fn) -> dict:
    """`profile_batch` for work that launches hundreds of thousands of
    kernels (a train step): device activity only, read from the raw
    profiler records, which skips building the profiler's event tree
    (minutes at that count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, busy_ns, n = {}, 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        busy_ns += e.duration_ns()
        n += 1
        t = by_name.setdefault(e.name()[:80], [0, 0])
        t[0] += e.duration_ns()
        t[1] += 1
    busy_ms = busy_ns / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return r, {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
               "device_launches": n,
               "top": [[k, v[0] / 1e6, v[1]] for k, v in top]}


def max_abs_err(a, b) -> int:
    import torch
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b, strict=True))
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def bound(nbytes: float, ops: float, int_ops_per_s: float) -> tuple:
    """Least time in ms for the work (`ops` integer operations), and which
    rate bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: set-up
# ---------------------------------------------------------------------------


def _smi(query: str) -> str:
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_setup() -> dict:
    """Builds the kernels; returns the card's name and power limit and its
    integer peak (64 int32 operations an SM a clock at the maximum SM
    clock)."""
    import torch
    from repro_torch.kernels import cuda_lib
    card = _smi("name,power.limit")
    print(card, flush=True)
    clock = _smi("clocks.max.sm")
    mhz = float(re.match(r"\s*([\d.]+)\s*MHz", clock).group(1))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = INT32_OPS_PER_SM_CLOCK * sms * mhz * 1e6
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    ptxas = log.read_text() if log.exists() else ""
    print(ptxas, file=sys.stderr, flush=True)
    flash_hgmma, flash_hmma, encode_sass = sass_counts(lib)
    flash_ptxas = ptxas_entries(ptxas, FLASH_ENTRY, lambda m: {
        "kernel": m.group(1),
        "dtype": ("float32" if m.group(1) == "flash_fwd_kernel"
                  else "bfloat16"),
        "dh": int(m.group(2))})
    # the float32 kernel's resources a block, on a line of their own; its
    # products must be tensor-core (HMMA) instructions
    f32_smem = cuda_lib.library().flash_attention_smem_bytes
    hmma = flash_hmma if isinstance(flash_hmma, dict) else {}
    f32 = [{**e, "dynamic_smem_bytes": f32_smem(e["dh"]),
            "hmma": hmma.get(str(e["dh"]), 0)}
           for e in flash_ptxas if e["dtype"] == "float32"]
    emit({"flash_f32_kernel": f32})
    check(not hmma or all(e["hmma"] > 0 for e in f32),
          f"the float32 flash kernel's SASS holds no HMMA: {f32}")
    window_ptxas = ptxas_entries(ptxas, WINDOW_ENTRY, lambda m: {
        "kernel": m.group(1) or "window_match_ids_kernel",
        **({"d": int(m.group(2)) or "any",
            "out": ("count", "bits", "mask")[int(m.group(3))]}
           if m.group(1) else {})})
    check(len(window_ptxas) == 16, f"the build log lists "
          f"{len(window_ptxas)} window kernel instantiations, not 16 (the "
          f"ring kernel's 5 d x 3 outputs and the id pass)")
    emit({"phase": "setup", "card": card, "build_s": build_s,
          "library": str(lib.relative_to(ROOT)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "sms": sms,
          "sm_clock_max": clock, "int32_ops_per_s": int_ops_per_s,
          "flash_ptxas": flash_ptxas, "flash_tc_hgmma": flash_hgmma,
          "encode_ptxas": ptxas_entries(ptxas, ENCODE_ENTRY, lambda m: {
              "kernel": "sfc_encode_kernel",
              "d": int(m.group(1)) or "any", "C": int(m.group(2)) or "any",
              "table": "smem" if m.group(3) == "1" else "l1"}),
          "encode_sass_instructions": encode_sass,
          "filter_ptxas": window_ptxas})
    return {"card": card, "int_ops_per_s": int_ops_per_s}


FLASH_ENTRY = re.compile(r"Compiling entry function '\S*?"
                         r"(flash_tc_kernel|flash_fwd_kernel)ILi(\d+)E")
ENCODE_ENTRY = re.compile(r"Compiling entry function '\S*?"
                          r"sfc_encode_kernelILi(\d+)ELi(\d+)ELb([01])E")
WINDOW_ENTRY = re.compile(r"Compiling entry function '\S*?"
                          r"(?:(window_ring_kernel)ILi(\d+)ELi(\d+)E|"
                          r"window_match_ids_kernel)")


def ptxas_entries(log: str, entry: re.Pattern, label) -> list:
    """Registers, static shared memory and spill bytes of each kernel
    instantiation whose entry name matches `entry`, as `ptxas -v`
    reported them in the build log; `label(match)` names it."""
    out, cur = [], None
    for line in log.splitlines():
        m = entry.search(line)
        if m:
            cur = label(m)
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            cur["spill_store_bytes"], cur["spill_load_bytes"] = (int(st),
                                                                 int(ld))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
            cur = None
    return out


SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+\S")


def sass_counts(lib: Path) -> tuple:
    """From the library's SASS (`cuobjdump -sass`): the HGMMA (wgmma)
    instructions of each bf16 flash kernel instantiation and the HMMA
    (mma.sync) instructions of each float32 one, by head dim, and the
    instructions of each `sfc_encode_kernel` instantiation, by its
    template arguments (d, C, staged); "not available" without
    `cuobjdump`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "not available", "not available", "not available"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if sass.returncode != 0:
        why = f"not available ({sass.stderr.strip()[:120]})"
        return why, why, why
    hgmma, hmma, encode, dh, f32_dh, enc = {}, {}, {}, None, None, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_tc_kernelILi(\d+)E", line)
            dh = m.group(1) if m else None
            m = re.search(r"flash_fwd_kernelILi(\d+)E", line)
            f32_dh = m.group(1) if m else None
            m = re.search(r"sfc_encode_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          line)
            enc = (f"d{m.group(1)}_C{m.group(2)}_"
                   f"{'smem' if m.group(3) == '1' else 'l1'}" if m else None)
        elif dh is not None and "HGMMA" in line:
            hgmma[dh] = hgmma.get(dh, 0) + 1
        elif f32_dh is not None and "HMMA" in line:
            hmma[f32_dh] = hmma.get(f32_dh, 0) + 1
        elif enc is not None and SASS_INSTRUCTION.search(line):
            encode[enc] = encode.get(enc, 0) + 1
    return hgmma, hmma, encode


# ---------------------------------------------------------------------------
# phase 2: SMBO curve learning on the card
# ---------------------------------------------------------------------------


class _SmboClock:
    """Wraps the SMBO path's stages for one `learn_sfc` run: seconds in the
    host index builds, the surrogate, the round's curve pool (packed,
    uploaded and its lookup tables built, once), the shared-point encode,
    the index pack + upload and the pooled program (each device stage ends
    in a synchronize), plus, per BatchEval round, the engine `auto` chose,
    the pooled-encode launches and the device stages' seconds."""

    DEVICE_STAGES = ("tables", "encode", "pack", "program")

    def __init__(self):
        self.s = {k: 0.0 for k in ("build", "surrogate",
                                   *self.DEVICE_STAGES)}
        self.rounds = []
        self._saved = []

    def _wrap(self, owner, name, key, sync=False, static=False):
        import torch
        fn = getattr(owner, name)
        self._saved.append((owner, name, owner.__dict__[name]))

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.s[key] += time.perf_counter() - t0
        setattr(owner, name, staticmethod(timed) if static else timed)

    def __enter__(self):
        from repro_torch.core import batcheval, cost, smbo
        from repro_torch.core.index import LMSFCIndex
        from repro_torch.core.surrogate import RandomForest
        from repro_torch.kernels import cuda_lib
        self._wrap(LMSFCIndex, "build", "build", static=True)
        self._wrap(RandomForest, "fit", "surrogate")
        self._wrap(RandomForest, "predict", "surrogate")
        self._wrap(cost, "device_curve_pool", "tables", sync=True)
        self._wrap(cost, "pool_keys", "encode", sync=True)
        self._wrap(batcheval, "_pack_index_pool", "pack", sync=True)
        self._wrap(batcheval, "_pool_program", "program", sync=True)
        run_pool, evaluate_pool = cost.run_workload_pool, smbo.evaluate_pool
        self._saved += [(cost, "run_workload_pool", run_pool),
                        (smbo, "evaluate_pool", evaluate_pool)]

        def run_workload_pool(*a, engine, **kw):
            self.rounds[-1]["engine"] = engine
            return run_pool(*a, engine=engine, **kw)

        def one_round(cs, *a, **kw):
            before = cuda_lib.LAUNCHES["sfc_encode_pool"]
            s0 = dict(self.s)
            self.rounds.append({"candidates": len(cs)})
            out = evaluate_pool(cs, *a, **kw)
            self.rounds[-1]["sfc_encode_pool"] = (
                cuda_lib.LAUNCHES["sfc_encode_pool"] - before)
            self.rounds[-1]["seconds"] = {k: self.s[k] - s0[k]
                                          for k in self.DEVICE_STAGES}
            return out
        cost.run_workload_pool = run_workload_pool
        smbo.evaluate_pool = one_round
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        return False


def smbo_sample(data, seed: int, width_scale: float, K: int,
                n_queries: int = 100) -> tuple:
    """The paper's learning input: a seeded 5% sample of the rows, the
    sampled workload over it, and the scale-matched evaluation page size
    of `benchmarks/common.py` (8192 B x sample fraction x 4, in [512,
    8192]; 1638 B for a 5% sample)."""
    import numpy as np
    from repro_torch.core.index import IndexConfig
    from repro_torch.data.workload import make_workload
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(data), size=len(data) // 20,
                              replace=False))
    sample = data[pick]
    Ls, Us = make_workload(sample, n_queries, seed=seed,
                           width_scale=width_scale, K=K)
    page_bytes = int(min(8192, max(512, 8192 * len(sample) / len(data) * 4)))
    return sample, Ls, Us, IndexConfig(paging="heuristic",
                                       page_bytes=page_bytes)


def _result_key(res) -> tuple:
    return (res.curve_best.to_json(), res.y_best, res.history,
            [(c.to_json(), y) for c, y in res.evaluated])


def phase_smbo(name: str, data, *, K: int, space: str, depth: int,
               max_iters: int, seed: int, width_scale: float) -> dict:
    """`learn_sfc` on the card with its own defaults (n_init 8, pool 48,
    4 evaluations per round, evaluator "pooled"), held four ways: the
    plain-twin run is identical, the best 4 candidates' costs equal the
    host `batched` evaluator's, every round took the device program and
    launched the pooled encode, and the learned cost is at most the z-order
    anchor's."""
    import torch
    from repro_torch.core.cost import evaluate_curve, evaluate_pool
    from repro_torch.core.curve import default_curve
    from repro_torch.core.smbo import learn_sfc
    from repro_torch.kernels import cuda_lib

    sample, Ls, Us, cfg = smbo_sample(data, seed, width_scale, K)
    kw = dict(K=K, cfg=cfg, space=space, depth=depth, max_iters=max_iters,
              seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    cuda_lib.reset_launches()
    with _SmboClock() as clock:
        t0 = time.perf_counter()
        res = learn_sfc(sample, Ls, Us, **kw)
        total_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base_bytes
    for i, r in enumerate(clock.rounds):
        check(r.get("engine") == "torch",
              f"{name}: round {i} took the {r.get('engine')!r} engine, not "
              f"the device program")
        check(r["sfc_encode_pool"] == cfg.k_maxsplit + 2,
              f"{name}: round {i} launched sfc_encode_pool "
              f"{r['sfc_encode_pool']} times, not {cfg.k_maxsplit + 2} (the "
              f"keys, one a split level, one for the z-ranges)")
    check(launches["sfc_encode_pool"] > 0, f"{name}: no pooled launch")

    t0 = time.perf_counter()
    twin = learn_sfc(sample, Ls, Us, backend="torch", **kw)
    twin_s = time.perf_counter() - t0
    check(_result_key(twin) == _result_key(res),
          f"{name}: the kernel and plain-twin runs of learn_sfc differ")

    best4 = sorted(res.evaluated, key=lambda cy: cy[1])[:4]
    t0 = time.perf_counter()
    host = [evaluate_curve(c, sample, Ls, Us, cfg, K, evaluator="batched")
            for c, _ in best4]
    host_s = time.perf_counter() - t0
    check(host == [y for _, y in best4],
          f"{name}: host batched costs {host} != pooled "
          f"{[y for _, y in best4]}")
    anchor, anchor_y = res.evaluated[0]
    check(anchor == default_curve(sample.shape[1], K, space, depth),
          f"{name}: the first evaluated curve is not the z-order anchor")
    check(res.y_best <= anchor_y,
          f"{name}: learned cost {res.y_best} > z-order {anchor_y}")

    # one more round (the last round's candidates) under the profiler:
    # its wall time, device busy time and idle share
    last = [c for c, _ in res.evaluated[-4:]]
    prof = profile_batch(lambda: evaluate_pool(last, sample, Ls, Us, cfg, K))

    device_s = sum(clock.s[k] for k in clock.DEVICE_STAGES)
    out = {
        "phase": name, "space": space, "depth": depth, "rows": len(data),
        "sample_rows": int(len(sample)), "queries": int(len(Ls)),
        "width_scale": width_scale, "page_bytes": cfg.page_bytes, "K": K,
        "max_iters": max_iters, "evaluations": len(res.evaluated),
        "rounds": clock.rounds, "y_best": res.y_best,
        "zorder_cost": anchor_y, "history": res.history,
        "curve_best_sha256": hashlib.sha256(
            res.curve_best.to_json().encode()).hexdigest()[:16],
        "seconds": {"total": total_s, "host_build": clock.s["build"],
                    "surrogate": clock.s["surrogate"],
                    "device_eval": device_s,
                    "device_eval_parts": {k: clock.s[k] for k in
                                          clock.DEVICE_STAGES},
                    "rest": total_s - device_s - clock.s["build"]
                    - clock.s["surrogate"]},
        "twin_run_s": twin_s, "twin_identical": True,
        "host_batched_s": host_s, "host_batched_equal": True,
        "peak_device_bytes": int(peak), "launches": launches,
        "round_profile": prof}
    emit(out)
    out["curve"] = res.curve_best
    out["pools"] = {"first": [c for c, _ in res.evaluated[:8]],
                    "last": last, "all": [c for c, _ in res.evaluated]}
    out["sample"] = sample
    out["n_queries"] = len(Ls)
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin at the paths' shapes
# ---------------------------------------------------------------------------


def _filter_inputs(rng, G: int, d: int, cap: int, dev):
    import numpy as np
    import torch
    pts = rng.integers(0, 2**32, size=(G, d, cap), dtype=np.uint64)
    lo = rng.integers(0, 2**31, size=(G, d), dtype=np.uint64)
    hi = lo + rng.integers(0, 2**31, size=(G, d), dtype=np.uint64)
    rect = np.stack([lo, hi], axis=-1)
    size = rng.integers(0, cap + 1, size=G)
    size[: G // 2] = cap                       # half the pages full
    as_i32 = lambda a: torch.from_numpy(
        np.ascontiguousarray(a.astype(np.uint32).view(np.int32))).to(dev)
    return (as_i32(pts), as_i32(rect),
            torch.from_numpy(size.astype(np.int32)).to(dev))


def _hold_kernel(name: str, fn, ref, args, nbytes: float, ops: float,
                 int_ops_per_s: float, plain_iters: int = 20) -> dict:
    """`fn` (the kernel's wrapper) against `ref` (its plain twin) on the
    same card inputs: bit-equality, then both timed, and the bound."""
    import torch
    got = fn(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"{name} disagrees with its plain twin (max {err})")
    b_ms, b_by = bound(nbytes, ops, int_ops_per_s)
    plain = kernel_times(lambda: ref(*args), iters=plain_iters)
    return {"max_abs_err": err,
            **kernel_times(lambda: fn(*args), one_launch=True),
            "plain_ms": plain["ms"], "plain_wall_ms": plain["wall_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def paged_chunks(arrays, curve, batch) -> list:
    """The Count path's `window_filter_paged` inputs for each q_chunk of
    `batch`: (points, page_size, queries, cand, n_cand)."""
    from repro_torch.core import serve as tsv
    out = []
    for queries, *split in tsv._chunks(arrays, batch, curve, K_MAXSPLIT,
                                       Q_CHUNK, "cuda"):
        _, cand, n_cand = tsv._count_candidates(arrays, queries, *split,
                                                max_cand=MAX_CAND)
        out.append((arrays.points, arrays.page_size, queries.contiguous(),
                    cand, n_cand))
    return out


def range_chunks(arrays, curve, batch) -> list:
    """The Range path's `window_match_paged` inputs for each q_chunk of
    `batch`: (points, page_size, queries, cand, n_cand, max_hits)."""
    import torch
    from repro_torch.core import serve as tsv
    from repro_torch.kernels.window_filter.ref import compact_rows
    out = []
    for queries, *split in tsv._chunks(arrays, batch, curve, K_MAXSPLIT,
                                       Q_CHUNK, "cuda"):
        live, _ = tsv._live_pages(arrays, queries, *split)
        pidx = torch.arange(live.shape[1], device=live.device)[None]
        cand, n_cand = compact_rows(live, pidx, MAX_CAND, 0)
        out.append((arrays.points, arrays.page_size, queries.contiguous(),
                    cand, n_cand, MAX_HITS))
    return out


def live_candidates(chunks) -> dict:
    """Live candidate pages a query (n_cand capped at max_cand) over the
    chunks, and how many queries overflowed max_cand."""
    import torch
    raw = torch.cat([c[4] for c in chunks]).cpu()
    n = raw.clamp(0, MAX_CAND).float()
    return {"queries": len(n), "mean": float(n.mean()),
            "median": float(n.median()), "max": int(n.max()),
            "overflowed": int((raw > MAX_CAND).sum())}


def filter_bytes_paged(page_size, cand, n_cand, d: int, cap: int) -> int:
    """Bytes a paged filter call must move for its data (a bound's count,
    read on the host): each distinct live page's valid slots and its size
    once, the (Qc, d, 2) rectangles, the live ids, the (Qc,) int64 live
    counts in, and the (Qc,) int32 counts out."""
    import torch
    Qc, C = cand.shape
    live = (torch.arange(C)[None, :]
            < torch.clamp(n_cand.cpu(), max=C)[:, None])
    pages = torch.unique(cand.cpu()[live].to(torch.int64))
    valid = int(page_size.cpu()[pages].clamp(0, cap).sum())
    return (valid * d * 4 + len(pages) * 4 + Qc * d * 2 * 4
            + int(live.sum()) * 4 + Qc * 8 + Qc * 4)


def match_bytes_paged(page_size, cand, n_cand, d: int, cap: int,
                      max_hits: int) -> int:
    """Bytes a paged match call must move for its data: what
    `filter_bytes_paged` reads in, and out the (Qc, max_hits) int32 id
    buffer and the (Qc,) int64 match counts."""
    Qc = cand.shape[0]
    return (filter_bytes_paged(page_size, cand, n_cand, d, cap) - Qc * 4
            + Qc * max_hits * 4 + Qc * 8)


def _hold_paged(name: str, chunks, flush, match: bool = False,
                plain_iters: int = 2) -> dict:
    """`window_filter_paged` (or, with `match`, `window_match_paged`) on
    each chunk against its twin, bit for bit, and its times per call,
    means over the chunks: `ms` the profiler's device time of a call (the
    filter's zeroing of its output and its kernel; the match's two
    kernels), warm and `cold` (L2 flushed before each call), `kernel_ms`
    the kernels alone, `plain_ms` the twin's; the bound, the bytes the
    chunks' data needs (`filter_bytes_paged`: the distinct live pages'
    valid slots once; `match_bytes_paged` with the id buffer out) at 3.35
    TB/s."""
    import torch
    from repro_torch.kernels.window_filter.ops import (window_filter_paged,
                                                       window_match_paged)
    from repro_torch.kernels.window_filter.ref import (
        window_filter_paged_ref, window_match_paged_ref)
    fn, twin = ((window_match_paged, window_match_paged_ref) if match else
                (window_filter_paged, window_filter_paged_ref))
    kernels = (("window_ring_kernel", "window_match_ids_kernel") if match
               else ("window_ring_kernel",))
    err, nbytes = 0, 0
    for args in chunks:
        got = fn(*args)
        want = twin(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want) if match else [(got, want)]:
            err = max(err, max_abs_err(g, w))
        points, page_size, _, cand, n_cand = args[:5]
        _, d, cap = points.shape
        nbytes += (match_bytes_paged(page_size, cand, n_cand, d, cap,
                                     args[5]) if match else
                   filter_bytes_paged(page_size, cand, n_cand, d, cap))
    check(err == 0, f"{name}: {fn.__name__} disagrees with its plain twin "
                    f"(max {err})")
    n = len(chunks)

    def each(cold: bool):
        def run():
            for i, args in enumerate(chunks):
                if cold:
                    flush.fill_(i)
                fn(*args)
        return run

    warm, warm_k, warm_by = profiled_ms(each(False), iters=10,
                                        kernels=kernels)
    cold, cold_k, cold_by = profiled_ms(each(True), iters=10,
                                        kernels=kernels)
    plain = kernel_times(lambda: [twin(*a) for a in chunks],
                         iters=plain_iters)
    b_ms = nbytes / n / HBM_BYTES_PER_S * 1e3
    return {"calls": n, "max_abs_err": err, "ms": warm / n,
            "kernel_ms": warm_k / n, "cold_ms": cold / n,
            "cold_kernel_ms": cold_k / n, "plain_ms": plain["ms"] / n,
            "bound_ms": b_ms, "bound_by": "bytes", "bytes": nbytes / n,
            "share": b_ms / (warm / n), "cold_share": b_ms / (cold / n),
            "by_kernel_ms": {k: v / n for k, v in warm_by.items()},
            "cold_by_kernel_ms": {k: v / n for k, v in cold_by.items()},
            "library_ms": None}


def _launch_floor(chunks, match: bool) -> dict:
    """What a paged call costs with no work: the same chunks with every
    n_cand 0 (no live item, so no page is read and no id written beyond
    the match's -1s), the profiler's device time a call, warm, by
    kernel."""
    import torch
    from repro_torch.kernels.window_filter.ops import (window_filter_paged,
                                                       window_match_paged)
    fn = window_match_paged if match else window_filter_paged
    empty = [(*c[:4], torch.zeros_like(c[4]), *c[5:]) for c in chunks]
    kernels = (("window_ring_kernel", "window_match_ids_kernel") if match
               else ("window_ring_kernel",))
    total, _, by_name = profiled_ms(lambda: [fn(*a) for a in empty],
                                    iters=10, kernels=kernels)
    n = len(chunks)
    return {"ms": total / n, "by_kernel_ms": {k: v / n
                                              for k, v in by_name.items()}}


def phase_paged_filter(served: dict, seed: int) -> dict:
    """The paged filter on the main index's own `ServingArrays`: (b) with
    the candidates of the main phase's first Count batch, chunk by chunk;
    (c) at a dense shape, its first chunk's 16 queries with 256 live,
    distinct non-empty pages each.  The paged match (`match_paged`) with
    the candidates of the main phase's first Range batch, chunk by chunk
    (max_hits 65,536).  Each against its twin; times warm and cold
    (`_hold_paged`), and the paged filter's and match's `floor`: the
    same calls with no live candidate (`_launch_floor`)."""
    import numpy as np
    import torch
    arrays, curve = served["arrays"], served["curve"]
    flush = flush_buffer(arrays.points.device)
    chunks = paged_chunks(arrays, curve, served["batch"])
    live = live_candidates(chunks)
    paged = {**_hold_paged("kernels_paged: paged", chunks, flush),
             "live_candidates": live}
    rng = np.random.default_rng(seed + 24)
    full = (arrays.page_size > 0).nonzero().flatten().cpu().numpy()
    cand = np.stack([rng.choice(full, size=MAX_CAND, replace=False)
                     for _ in range(Q_CHUNK)]).astype(np.int32)
    points, page_size, queries = chunks[0][:3]
    dense_args = (points, page_size, queries,
                  torch.from_numpy(cand).to(points.device),
                  torch.full((Q_CHUNK,), MAX_CAND, dtype=torch.int64,
                             device=points.device))
    dense = {**_hold_paged("kernels_paged: dense", [dense_args], flush),
             "shape": [Q_CHUNK, MAX_CAND, *points.shape[1:]],
             "pages": int(points.shape[0])}
    r_chunks = range_chunks(arrays, curve, served["batch"])
    match = {**_hold_paged("kernels_paged: match", r_chunks, flush,
                           match=True),
             "live_candidates": live_candidates(
                 [c[:5] for c in r_chunks]),
             "max_hits": MAX_HITS}
    paged["floor"] = _launch_floor(chunks, False)
    match["floor"] = _launch_floor(r_chunks, True)
    del flush
    out = {"paged": paged, "paged_dense": dense, "match_paged": match}
    emit({"phase": "kernels_paged", "card": CARD, **out})
    return out


def encode_work(n: int, d: int, K: int, R: int, M: int, P: int = 1,
                shared: bool = True) -> int:
    """The bytes an encode of n points under P curves must move: the points
    in once (once per pool when shared), the Z64 out once per curve, and
    each curve's own data once, its R*d*K bit positions and M live region
    bits (4 bytes each).  The kernel's lookup tables (R*d*C*128 bytes a
    curve) are derived from the positions by this design, so they are not
    counted; they stand beside the row as `table_bytes`."""
    return ((1 if shared else P) * n * d * 4 + P * n * 8
            + P * (R * d * K + M) * 4)


def encode_shapes(d: int, batch: int) -> dict:
    """Points of the encode calls: `twin` the largest call of the split's
    twin on the encode kernel over a batch (the last split level's
    2·Q·2^(k-1)·d corners, or both z-range corners of Q·2^k leaves) and
    2^20."""
    level = 2 * batch * 2**(K_MAXSPLIT - 1) * d
    zr = 2 * batch * 2**K_MAXSPLIT
    return {"twin": max(level, zr), "large": 2**20}


SPLIT_WINDOWS = {"path": BATCH, "bench": 1024}   # windows a split call


def split_encode_ops(queries, curve) -> int:
    """Integer operations the split of `queries` (Q, d, 2) at K_MAXSPLIT
    must do at least: both corner encodes of every dim a live node can cut
    (lo < up), and both corners of every leaf, each encode counted at its
    d * nibbles(K) 64-bit ORs of table words (2 int32 operations each).  A
    node is live when its leftmost leaf is valid (an invalid node passes
    its rectangle on to child 0, invalid), and its rectangle is the
    bounding box of its leaves' (its children partition it, or repeat
    it)."""
    from repro_torch.core.split import recursive_split_torch
    rects, valid = recursive_split_torch(queries, curve, K_MAXSPLIT,
                                         backend="torch")
    Q, S = valid.shape
    encodes = 2 * Q * S
    for level in range(K_MAXSPLIT):
        nodes = rects.reshape(Q, 1 << level, S >> level, curve.d, 2)
        lo, up = nodes[..., 0].amin(2), nodes[..., 1].amax(2)
        live = valid[:, ::S >> level]
        encodes += 2 * int(((lo < up).sum(-1) * live).sum())
    return encodes * 2 * curve.d * ((curve.K + 3) // 4)


def hold_split(paths, dev, sms: int, int_ops_per_s: float) -> dict:
    """`split_zranges` at `SPLIT_WINDOWS` of each path's workload (kind,
    curve, data, width_scale), against its twin, bounded by `split_work`
    and `split_encode_ops`, beside the split as the serving path ran it
    before (on the encode kernel: `on_encode`, its time and launches)."""
    import torch
    from repro_torch.core.curve import curve_tables
    from repro_torch.core.serve import pack_query_rects
    from repro_torch.core.split import recursive_split_torch, zranges_torch
    from repro_torch.data.workload import make_workload
    from repro_torch.kernels.sfc_encode.ops import (plan_split, split_work,
                                                    split_zranges)
    out = {}
    for kind, curve, data, width in paths:
        K, R = curve.K, 1 if kind == "global" else curve.num_regions
        M = int((curve_tables(curve, "cpu")[1] < curve.d * K).sum())
        for shape, Q in SPLIT_WINDOWS.items():
            Ls, Us = make_workload(data, Q, seed=3, width_scale=width, K=K)
            q = torch.from_numpy(pack_query_rects(Ls, Us)).to(dev)
            plan = plan_split(Q, K_MAXSPLIT, R, curve.d, K, sms)

            def on_encode(q):       # the split as the path ran it before
                rects, valid = recursive_split_torch(q, curve, K_MAXSPLIT)
                return (valid, *zranges_torch(rects, curve))
            err = max_abs_err(on_encode(q),
                              split_zranges(q, curve, K_MAXSPLIT))
            check(err == 0, f"split_zranges[{kind}_{shape}] disagrees with "
                            f"the split on the encode kernel (max {err})")
            before = kernel_times(lambda: on_encode(q), iters=5)
            out[f"{kind}_{shape}"] = {
                "shape": list(q.shape), "k_maxsplit": K_MAXSPLIT, "K": K,
                "regions": R, "placement": plan.placement,
                "blocks": plan.blocks, "table_bytes": plan.table_bytes,
                **_hold_kernel(
                    f"split_zranges[{kind}_{shape}]",
                    lambda q: split_zranges(q, curve, K_MAXSPLIT),
                    lambda q: split_zranges(q, curve, K_MAXSPLIT,
                                            backend="torch"), (q,),
                    split_work(Q, curve.d, K, R, M, K_MAXSPLIT),
                    split_encode_ops(q, curve), int_ops_per_s,
                    plain_iters=5),
                "on_encode": {"ms": before["ms"],
                              "wall_ms": before["wall_ms"],
                              "launches": before["device_events_per_call"]}}
    return out


def phase_kernels(main_curve, pw_curve, main_data, pw_data,
                  int_ops_per_s: float) -> dict:
    """Each kernel at the shapes its path gives it and a larger one: the
    filter at "path", a q_chunk of queries times max_cand pages, and
    "large", 64 candidates per query; the split at `SPLIT_WINDOWS` of each
    path's workload; the encode at `encode_shapes`.  The encode rows are
    bounded by their bytes (`encode_work`), the split by `split_work` and
    `split_encode_ops`."""
    import numpy as np
    import torch
    from repro_torch.core.curve import curve_tables
    from repro_torch.kernels.sfc_encode.ops import plan_encode, sfc_encode
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.sfc_encode.ref import sfc_encode_ref
    from repro_torch.kernels.window_filter.ops import (window_filter,
                                                       window_match)
    from repro_torch.kernels.window_filter.ref import (window_filter_ref,
                                                       window_match_ref)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(7)
    out = {"window_filter": {}, "window_match": {}}

    d, cap = 2, MAIN_CAP
    flush = flush_buffer(dev)
    for shape, G in (("path", Q_CHUNK * MAX_CAND), ("large", Q_CHUNK * 64)):
        pts, rect, size = _filter_inputs(rng, G, d, cap, dev)
        valid = int(size.clamp(0, cap).sum().item())
        in_bytes = valid * d * 4 + rect.numel() * 4 + size.numel() * 4
        for name, fn, ref, out_bytes in (
                ("window_filter", window_filter, window_filter_ref, G * 4),
                ("window_match", window_match, window_match_ref, G * cap)):
            out[name][shape] = {
                "shape": [G, d, cap],
                **_hold_kernel(name, fn, ref, (pts, rect, size),
                               in_bytes + out_bytes, 2.0 * valid * d,
                               int_ops_per_s)}
        if shape == "path":
            # cold: L2 (50 MB) flushed by a 2 x L2 write before each
            # launch; the kernel's own time
            _, cold, _ = profiled_ms(
                lambda: window_filter(pts, rect, size), flush, iters=20)
            row = out["window_filter"]["path"]
            row["cold"] = {"ms": cold, "bound_ms": row["bound_ms"],
                           "share": row["bound_ms"] / cold}
    del flush
    out["window_filter"]["smem_bytes"] = (
        cuda_lib.library().window_filter_smem_bytes(d, cap))

    encodes = cuda_lib.LAUNCHES["sfc_encode"]
    out["split_zranges"] = hold_split(
        (("global", main_curve, main_data, 0.01),
         ("piecewise", pw_curve, pw_data, 0.05)), dev, sms, int_ops_per_s)

    out["sfc_encode"] = {}
    for kind, curve in (("global", main_curve), ("piecewise", pw_curve)):
        K, T = curve.K, curve.d * curve.K
        R = 1 if kind == "global" else curve.num_regions
        M = int((curve_tables(curve, "cpu")[1] < T).sum())
        for shape, n in encode_shapes(curve.d, BATCH).items():
            x = rng.integers(0, 2**K, size=(n, curve.d), dtype=np.uint64)
            x[:8] = 2**K - 1                   # the sign bit at K = 32
            xt = torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(dev)
            plan = plan_encode(n, 1, R, curve.d, K, sms)
            out["sfc_encode"][f"{kind}_{shape}"] = {
                "shape": [n, curve.d], "K": K, "regions": R,
                "placement": plan.placement, "blocks": plan.blocks,
                "table_bytes": plan.table_bytes,
                **_hold_kernel(f"sfc_encode[{kind}_{shape}]",
                               lambda x: sfc_encode(x, curve),
                               lambda x: sfc_encode_ref(x, curve), (xt,),
                               encode_work(n, curve.d, K, R, M), 0,
                               int_ops_per_s, plain_iters=5)}
    out["sfc_encode"]["held_launches"] = (cuda_lib.LAUNCHES["sfc_encode"]
                                          - encodes)
    emit({"phase": "kernels", **out})
    return out


def phase_pool_kernel(smbo_runs: dict, int_ops_per_s: float) -> dict:
    """`sfc_encode_pool` against its twin at the SMBO path's shapes: the
    shared-point launch of the first round (its 8 curves over the whole
    sample) and the largest per-candidate launch of a 4-curve round (both
    corner sets of the last split level, 2·Q·2^(k-1)·d points each, or both
    z-range corners, 2·Q·2^k); and at a larger shape, a 16-curve pool over
    2^20 shared points.  The pool's lookup tables are built once, before
    the timed calls, as the pooled evaluator builds them once a round."""
    import numpy as np
    import torch
    from repro_torch.core.curve import CurvePool, pack_curve_pool
    from repro_torch.core.sfc import lut_tables
    from repro_torch.kernels.sfc_encode.ops import (plan_encode,
                                                    sfc_encode_pool)
    from repro_torch.kernels.sfc_encode.ref import sfc_encode_pool_ref
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(11)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint32).view(np.int32))).to(dev)
    shapes = []
    for kind, run in smbo_runs.items():
        sample = run["sample"]
        d, K = sample.shape[1], run["K"]
        Q = run["n_queries"]
        corners = max(2 * Q * 2**(K_MAXSPLIT - 1) * d, 2 * Q * 2**K_MAXSPLIT)
        shapes += [(f"{kind}_shared_path", run["pools"]["first"],
                    as_dev(sample)),
                   (f"{kind}_per_candidate_path", run["pools"]["last"],
                    as_dev(rng.integers(0, 2**K, size=(4, corners, d),
                                        dtype=np.uint64)))]
    shapes.append(("global_large", smbo_runs["global"]["pools"]["all"][:16],
                   as_dev(rng.integers(0, 2**32, size=(2**20, 2),
                                       dtype=np.uint64))))
    out = {}
    for shape, curves, x in shapes:
        pool = pack_curve_pool(curves)
        pos = torch.from_numpy(pool.pos).to(dev)
        reg = torch.from_numpy(pool.reg).to(dev)
        tables = CurvePool(pos=pos, reg=reg, d=pool.d, K=pool.K,
                           lut=lut_tables(pos, pool.d, pool.K))
        P, R, T = pos.shape
        n = x.shape[-2]
        M = int((reg < T).sum(1).max())
        nbytes = encode_work(n, pool.d, pool.K, R, M, P, shared=x.dim() == 2)
        plan = plan_encode(n, P, R, pool.d, pool.K, sms)
        out[shape] = {
            "shape": ([P] if x.dim() == 2 else []) + list(x.shape),
            "K": pool.K, "regions": R, "placement": plan.placement,
            "blocks": plan.blocks, "table_bytes": plan.table_bytes,
            **_hold_kernel(f"sfc_encode_pool[{shape}]",
                           lambda x: sfc_encode_pool(x, tables),
                           lambda x: sfc_encode_pool_ref(x, tables), (x,),
                           nbytes, 0, int_ops_per_s, plain_iters=2)}
    emit({"phase": "kernels_pool", "sfc_encode_pool": out})
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: a served index, held against the plain backend and
# brute force
# ---------------------------------------------------------------------------


def _fns(curve, backend: str) -> tuple:
    from repro_torch.core.serve import make_query_fn, make_range_fn
    kw = dict(k_maxsplit=K_MAXSPLIT, max_cand=MAX_CAND, q_chunk=Q_CHUNK,
              backend=backend)
    return (make_query_fn(curve, **kw),
            make_range_fn(curve, max_hits=MAX_HITS, **kw))


def _serve(arrays, curve, batches, backend: str) -> tuple:
    """Run every batch through Count, then through Range; results on the
    host, the wall-clock seconds of each (ending in a synchronize), the
    launch counts after the Count batches, and the calls of the candidate
    page gather (`ref.gather_pages`, which only the plain twins run) by
    Count and by Range."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.window_filter import ref as wf_ref
    qfn, rfn = _fns(curve, backend)
    gather, gathered = wf_ref.gather_pages, []

    def counted(*a):
        gathered.append(1)
        return gather(*a)

    wf_ref.gather_pages = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = [qfn(arrays, q) for q in batches]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_count = dict(cuda_lib.LAUNCHES)
        count_gathers = len(gathered)
        ranges = [rfn(arrays, q) for q in batches]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        wf_ref.gather_pages = gather
    to_host = lambda outs: [tuple(t.cpu() for t in o) for o in outs]
    return (to_host(counts), to_host(ranges), t1 - t0, t2 - t1,
            after_count, (count_gathers, len(gathered) - count_gathers))


def _hold_path(name: str, data, index, curve, n_batches: int, seed: int,
               width_scale: float, kernel_names) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.query import brute_force_count, brute_force_range
    from repro_torch.core.query import lex_sorted_rows
    from repro_torch.core.serve import (build_serving_arrays,
                                        pack_query_rects,
                                        pack_serving_arrays)
    from repro_torch.data.workload import make_workload
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    host = pack_serving_arrays(index)
    arrays = build_serving_arrays(index, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    dev_bytes = sum(t.numel() * t.element_size() for t in (
        arrays.points, arrays.page_zmin, arrays.page_zmax, arrays.page_mbr,
        arrays.page_size))
    Ls, Us = make_workload(data, n_batches * BATCH, seed=seed,
                           width_scale=width_scale, K=index.K)
    rects = pack_query_rects(Ls, Us)
    batches = [torch.from_numpy(rects[i * BATCH:(i + 1) * BATCH]).cuda()
               for i in range(n_batches)]

    # warm both backends (allocator, curve tables) outside the timed runs
    _serve(arrays, curve, batches[:1], "cuda")
    _serve(arrays, curve, batches[:1], "torch")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    counts, ranges, count_s, range_s, after_count, gathers = _serve(
        arrays, curve, batches, "cuda")
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for k in kernel_names:
        check(launches[k] > 0, f"{name}: kernel {k} was not launched")
    p_counts, p_ranges, p_count_s, p_range_s, _, _ = _serve(
        arrays, curve, batches, "torch")
    for a, b in zip(counts + ranges, p_counts + p_ranges):
        for x, y in zip(a, b):
            check(torch.equal(x, y),
                  f"{name}: cuda and torch backends disagree")

    cnt = torch.cat([c[0] for c in counts]).numpy().astype(np.int64)
    over = torch.cat([c[1] for c in counts]).numpy()
    ids = torch.cat([r[0] for r in ranges]).numpy()
    n_hits = torch.cat([r[1] for r in ranges]).numpy()
    r_over = (torch.cat([r[2] for r in ranges]).numpy()
              | torch.cat([r[3] for r in ranges]).numpy())
    Q = len(cnt)
    ok_count = float(np.mean(over == 0))
    ok_range = float(np.mean(r_over == 0))
    check(ok_count >= 0.9, f"{name}: only {ok_count:.3f} of Count queries "
                           f"fit max_cand={MAX_CAND}")
    check(ok_range >= 0.9, f"{name}: only {ok_range:.3f} of Range queries "
                           f"fit max_cand={MAX_CAND}, max_hits={MAX_HITS}")

    # brute force on sampled queries that did not overflow
    pick = np.random.default_rng(seed).permutation(Q)
    n_checked = 0
    for t in pick[over[pick] == 0][:32]:
        want = brute_force_count(data, Ls[t], Us[t])
        check(cnt[t] == want, f"{name}: count {cnt[t]} != brute {want} "
                              f"(query {t})")
        n_checked += 1
    check(n_checked > 0, f"{name}: no non-overflowed query to check")
    pts_u32 = np.ascontiguousarray(host.points).view(np.uint32)
    cap = pts_u32.shape[2]
    r_checked = 0
    for t in pick[r_over[pick] == 0][:8]:
        g = ids[t][ids[t] >= 0].astype(np.int64)
        check(len(g) == n_hits[t], f"{name}: ids/n_hits mismatch")
        rows = pts_u32[g // cap, :, g % cap].astype(np.uint64)
        want = brute_force_range(data, Ls[t], Us[t])
        check(np.array_equal(lex_sorted_rows(rows), want),
              f"{name}: range rows differ from brute force (query {t})")
        r_checked += 1

    qfn, rfn = _fns(curve, "cuda")
    profile = {"count": profile_batch(lambda: qfn(arrays, batches[0])),
               "range": profile_batch(lambda: rfn(arrays, batches[0]))}
    per_batch = {
        "count": {k: after_count[k] / n_batches for k in launches},
        "range": {k: (launches[k] - after_count[k]) / n_batches
                  for k in launches}}
    for kind in ("count", "range"):
        check(per_batch[kind]["split_zranges"] == 1
              and per_batch[kind]["sfc_encode"] == 0,
              f"{name}: {per_batch[kind]['split_zranges']} split_zranges "
              f"and {per_batch[kind]['sfc_encode']} sfc_encode launches a "
              f"{kind} batch, not 1 and 0 (the split and its z-ranges in "
              f"one launch)")
    check(per_batch["count"]["window_filter"] == BATCH // Q_CHUNK,
          f"{name}: {per_batch['count']['window_filter']} window_filter "
          f"launches a Count batch, not one a chunk ({BATCH // Q_CHUNK})")
    check(per_batch["range"]["window_match"] == 2 * BATCH // Q_CHUNK,
          f"{name}: {per_batch['range']['window_match']} window_match "
          f"launches a Range batch, not two a chunk ({2 * BATCH // Q_CHUNK})")
    check(per_batch["range"]["window_filter"] == 0,
          f"{name}: Range launched window_filter")
    check(gathers == (0, 0),
          f"{name}: the candidate page gather ran {gathers[0]} times in "
          f"Count and {gathers[1]} in Range (none: their kernels read "
          f"pages by id)")
    live = live_candidates(paged_chunks(arrays, curve, batches[0]))
    res = {
        "phase": name, "rows": int(index.n), "d": int(index.d),
        "K": int(index.K), "curve": curve.kind, "pages": int(index.num_pages),
        "cap": int(cap), "device_bytes": int(dev_bytes),
        "upload_s": upload_s, "queries": Q, "width_scale": width_scale,
        "q_chunk": Q_CHUNK,
        "max_cand": MAX_CAND, "max_hits": MAX_HITS,
        "count_qps": Q / count_s, "range_qps": Q / range_s,
        "count_qps_torch": Q / p_count_s, "range_qps_torch": Q / p_range_s,
        "count_not_overflowed": ok_count, "range_not_overflowed": ok_range,
        "brute_checked_count": n_checked, "brute_checked_range": r_checked,
        "mean_hits": float(np.mean(n_hits)), "launches": launches,
        "launches_per_batch": per_batch, "peak_device_bytes": int(peak),
        "gathers": {"count": gathers[0], "range": gathers[1]},
        "count_live_candidates": live, "profile": profile}
    emit(res)
    # what the cost_model phase counts again: not printed
    res["_served"] = {"arrays": arrays, "batch": batches[0],
                      "curve": curve, "batch_s": count_s / n_batches}
    return res


def phase_main(data, n_batches: int, curve) -> dict:
    from repro_torch.core.index import IndexConfig, LMSFCIndex
    t1 = time.perf_counter()
    index = LMSFCIndex.build(data, curve=curve,
                             cfg=IndexConfig(paging="heuristic"))
    t2 = time.perf_counter()
    res = _hold_path("main", data, index, curve, n_batches, seed=1,
                     width_scale=0.01, kernel_names=("window_filter", "window_match",
                                   "split_zranges"))
    res.update(build_s=t2 - t1)
    check(res["cap"] == MAIN_CAP, f"main path cap {res['cap']} != the "
                                  f"kernel phase's {MAIN_CAP}")
    return res


def phase_piecewise(data, n_batches: int, curve) -> dict:
    from repro_torch.core.index import IndexConfig, LMSFCIndex
    index = LMSFCIndex.build(data, curve=curve,
                             cfg=IndexConfig(paging="heuristic"))
    return _hold_path("piecewise", data, index, curve, n_batches, seed=2,
                      width_scale=0.05, kernel_names=("window_filter", "window_match",
                                    "split_zranges"))


# ---------------------------------------------------------------------------
# phase 6: the user's entry point, `repro_torch.api.Database`
# ---------------------------------------------------------------------------

DB_CAP = MAIN_CAP + MAIN_CAP // 4  # update headroom: refreshes stay per page
DB_FIELDS = ("counts", "rows", "offsets", "found", "neighbors", "dists",
             "overflowed", "residual_overflow")


def _same_result(name: str, got, want) -> None:
    """Every output of two results equal: arrays, escalations, fallbacks."""
    import numpy as np
    for f in DB_FIELDS:
        if hasattr(want, f):
            check(np.array_equal(getattr(got, f), getattr(want, f)),
                  f"database: {name}: {f} differs")
    check((got.escalations, got.cpu_fallbacks)
          == (want.escalations, want.cpu_fallbacks),
          f"database: {name}: escalations/fallbacks differ")


def _served_on_card(name: str, r, tally: dict) -> None:
    """A `cuda` engine result that the card answered whole: no query went
    to the CPU exactness net and none was left overflowed.  `tally` sums
    both over the phase, for its line."""
    import numpy as np
    residual = int(np.count_nonzero(getattr(r, "residual_overflow", ())))
    tally["results"] += 1
    tally["cpu_fallbacks"] += int(r.cpu_fallbacks)
    tally["residual_overflow"] += residual
    check(r.engine == "cuda", f"database: {name} was served by {r.engine}")
    check(r.cpu_fallbacks == 0,
          f"database: {name}: {r.cpu_fallbacks} queries fell back to the CPU")
    check(residual == 0, f"database: {name}: {residual} queries overflowed")


def _brute_knn(data, center, k: int, metric: str):
    """Exact kNN over all of `data`: float64 distances pick every row that
    can be among the k nearest (with slack past rounding), then the exact
    integer tie-broken selection of `core.query.knn_select` decides."""
    import numpy as np
    from repro_torch.core.query import knn_select
    diff = np.abs(data.astype(np.int64)
                  - center.astype(np.int64)).astype(np.float64)
    dist = diff.max(axis=1) if metric == "linf" else (diff * diff).sum(1)
    kth = np.partition(dist, k - 1)[k - 1]
    return knn_select(data[dist <= kth * (1 + 1e-9) + 1], center, k, metric)


def _span_totals(snapshot: dict, names) -> dict:
    """Summed seconds and counts of each span's histogram over its labels."""
    out = {}
    for name in names:
        hs = [v for k, v in snapshot["metrics"].items()
              if k.split("{")[0] == name + "_ns"]
        out[name] = {"s": sum(h["sum"] for h in hs) / 1e9,
                     "count": sum(h["count"] for h in hs)}
    return out


def phase_database(data, n_batches: int, seed: int, main_res: dict) -> dict:
    """The user's entry point on the card: `Database.fit` (SMBO on the
    device program, then the index build) on the main path's 10M rows, the
    `cuda` engine serving Count, Range, Point and kNN through the kernels,
    held bit for bit against the `torch` engine on the same card and on
    samples against brute force; forced escalation; inserts and deletes
    served after a per-page refresh; one batch with obs on.  Launch counts
    are set to 0 just before the phase and read just after it."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api, obs
    from repro_torch.api.deltas import rows_in_set
    from repro_torch.core.curve import default_curve
    from repro_torch.core.query import brute_force_count, brute_force_range
    from repro_torch.data.workload import make_workload
    from repro_torch.kernels import cuda_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t_phase = time.perf_counter()

    # 1. fit: 100 training queries, a 10,000-row sample, 4 evaluations a
    # round (5 x 100 x 10,000 >= 500,000: every round is the device program)
    Ls_tr, Us_tr = make_workload(data, 100, seed=seed + 7, width_scale=0.01,
                                 K=32)
    obs.enable()                   # read the fit's learn and build spans
    t0 = time.perf_counter()
    db = api.Database.fit(data, (Ls_tr, Us_tr), K=32, sample=10_000,
                          smbo={"evals_per_iter": 4}, seed=seed)
    fit_s = time.perf_counter() - t0
    fit_spans = _span_totals(obs.snapshot(), ("database.fit.learn",
                                              "database.fit.build"))
    obs.disable()
    obs.reset()
    fit_launches = dict(cuda_lib.LAUNCHES)
    check(fit_launches["sfc_encode_pool"] > 0,
          "database: fit launched no sfc_encode_pool")
    res = db.fit_result
    anchor, anchor_y = res.evaluated[0]
    check(anchor == default_curve(2, 32, "global"),
          "database: the first evaluated curve is not the z-order anchor")
    check(res.y_best <= anchor_y,
          f"database: learned cost {res.y_best} > z-order {anchor_y}")

    # 2. engines: the main phase's knobs, both on the card
    knobs = dict(q_chunk=Q_CHUNK, max_cand=MAX_CAND, max_hits=MAX_HITS)
    db.engine("torch", api.EngineConfig(**knobs))
    db.engine("cuda", api.EngineConfig(**knobs))
    check(db.engines["cuda"].device.type == "cuda"
          and db.engines["torch"].device.type == "cuda",
          "database: the engines are not on the card")

    # 3. serve: the main phase's batches (same seed and width)
    Ls, Us = make_workload(data, n_batches * BATCH, seed=1,
                           width_scale=0.01, K=32)
    batches = [(Ls[i * BATCH:(i + 1) * BATCH], Us[i * BATCH:(i + 1) * BATCH])
               for i in range(n_batches)]
    rng = np.random.default_rng(seed + 8)
    stored = data[rng.choice(len(data), BATCH // 2, replace=False)]
    absent = rng.integers(0, 2**32, size=(4 * BATCH, 2), dtype=np.uint64)
    absent = np.unique(absent[~rows_in_set(absent, data)], axis=0)
    absent = absent[rng.permutation(len(absent))[:BATCH // 2]]
    points = np.concatenate([stored, absent])
    centers = data[rng.choice(len(data), 16, replace=False)]
    for engine in ("cuda", "torch"):            # first use: pack, upload
        db.query(api.Count(*batches[0]), engine=engine)
        db.query(api.Range(*batches[0]), engine=engine)
    served, seconds = {}, {}
    for engine in ("cuda", "torch"):
        before = dict(cuda_lib.LAUNCHES)
        out = {}
        t0 = time.perf_counter()
        out["count"] = [db.query(api.Count(*b), engine=engine)
                        for b in batches]
        t1 = time.perf_counter()
        out["range"] = [db.query(api.Range(*b), engine=engine)
                        for b in batches]
        t2 = time.perf_counter()
        out["point"] = db.query(api.Point(points), engine=engine)
        out["knn"] = [db.query(api.Knn(centers, k=10, metric=m),
                               engine=engine) for m in ("l2", "linf")]
        seconds[engine] = (t1 - t0, t2 - t1)
        launched = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()}
        if engine == "cuda":
            serve_launches = launched
        else:
            check(not any(launched.values()),
                  "database: the torch engine launched a kernel")
        served[engine] = out
    for name in ("window_filter", "window_match", "split_zranges"):
        check(serve_launches[name] > 0,
              f"database: the cuda engine served without launching {name}")
    got, want = served["cuda"], served["torch"]
    on_card = {"results": 0, "cpu_fallbacks": 0, "residual_overflow": 0}
    for kind in ("count", "range", "knn"):
        for i, (g, w) in enumerate(zip(got[kind], want[kind])):
            check(g.engine == "cuda" and w.engine == "torch",
                  f"database: {kind} {i} was routed off its engine")
            _same_result(f"{kind} {i}", g, w)
            _served_on_card(f"{kind} {i}", g, on_card)
    _same_result("point", got["point"], want["point"])
    _served_on_card("point", got["point"], on_card)
    check(bool(got["point"].found[:BATCH // 2].all())
          and not got["point"].found[BATCH // 2:].any(),
          "database: point lookups disagree with the stored/absent split")
    for kind in ("count", "range"):
        for r in got[kind]:
            check(r.exact, f"database: a {kind} batch is not exact")
    counts = np.concatenate([r.counts for r in got["count"]])
    pick = np.random.default_rng(seed + 9).permutation(len(Ls))
    for t in pick[:32]:
        want_c = brute_force_count(data, Ls[t], Us[t])
        check(counts[t] == want_c, f"database: count {counts[t]} != brute "
                                   f"{want_c} (query {t})")
    for t in pick[:8]:
        rr = got["range"][t // BATCH]
        check(np.array_equal(rr.rows_for(t % BATCH),
                             brute_force_range(data, Ls[t], Us[t])),
              f"database: range rows differ from brute force (query {t})")
    knn_checked = 0
    for m, kr in zip(("l2", "linf"), got["knn"]):
        for i in range(4):
            rows, dists = _brute_knn(data, centers[i], 10, m)
            check(np.array_equal(kr.neighbors_for(i), rows)
                  and np.array_equal(kr.dists_for(i),
                                     np.asarray(dists, dtype=np.float64)),
                  f"database: {m} kNN of center {i} differs from brute force")
            knn_checked += 1

    # the same batches through the bare functions on the cuda engine's
    # arrays (its launches are left out of the phase's): what the facade
    # adds on top of them; then one warm Count and Range batch with obs on
    # splits the facade's time into its fenced device calls and the rest
    from repro_torch.core.serve import (make_query_fn, make_range_fn,
                                        pack_query_rects)
    arrays = db.engines["cuda"]._arrays
    kw = dict(k_maxsplit=K_MAXSPLIT, max_cand=MAX_CAND, q_chunk=Q_CHUNK)
    qfn = make_query_fn(db.curve, **kw)
    rfn = make_range_fn(db.curve, max_hits=MAX_HITS, **kw)
    rects = [torch.from_numpy(pack_query_rects(*b)).cuda() for b in batches]
    before = dict(cuda_lib.LAUNCHES)
    qfn(arrays, rects[0])
    rfn(arrays, rects[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bare_counts = [qfn(arrays, r)[0].cpu() for r in rects]
    t1 = time.perf_counter()
    for r in rects:
        rfn(arrays, r)[0].cpu()
    t2 = time.perf_counter()
    bare_s = (t1 - t0, t2 - t1)
    bare_launches = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()}
    first = np.concatenate([r.overflowed for r in got["count"]]) == 0
    check(np.array_equal(torch.cat(bare_counts).numpy()[first],
                         counts[first]),
          "database: the bare counts differ from the facade's")
    obs.enable()
    for kind, q in (("count", api.Count), ("range", api.Range)):
        db.query(q(*batches[0]), engine="cuda")
    attribution = {}
    for kind in ("count", "range"):
        sums = {}
        for m in obs.registry.metrics():
            labels = dict(m.labels)
            if labels.get("kind") == kind and m.name in (
                    "executor.execute_ns", "executor.device_call_ns"):
                sums[m.name] = sums.get(m.name, 0) + m.sum / 1e9
        attribution[kind] = {"execute_s": sums["executor.execute_ns"],
                             "device_call_s": sums["executor.device_call_ns"]}
    obs.disable()
    obs.reset()

    # 4. forced escalation: max_cand 4, max_hits 64, same batch, exact
    db.engine("cuda", api.EngineConfig(q_chunk=Q_CHUNK, max_cand=4,
                                       max_hits=64))
    t0 = time.perf_counter()
    forced = {"count": db.query(api.Count(*batches[0])),
              "range": db.query(api.Range(*batches[0]))}
    forced_s = time.perf_counter() - t0
    for kind, r in forced.items():
        check(r.exact and r.escalations > 0,
              f"database: forced {kind} did not escalate to exact")
        _served_on_card(f"forced {kind}", r, on_card)
        for f in ("counts", "rows", "offsets"):
            if hasattr(r, f):
                check(np.array_equal(getattr(r, f),
                                     getattr(got[kind][0], f)),
                      f"database: forced {kind} {f} differ from unforced")

    # 5. observability: a fresh cuda engine (pack, upload, fn builds) with
    # obs on, then the same batch with obs off
    db.engine("cuda", api.EngineConfig(cap=DB_CAP, **knobs))
    db.engine("torch", api.EngineConfig(cap=DB_CAP, **knobs))
    obs.enable()
    on = db.query(api.Count(*batches[0]), engine="cuda")
    spans = _span_totals(obs.snapshot(), (
        "executor.device_call", "engine.sync", "engine.upload",
        "executor.fn_build"))
    obs.disable()
    obs.reset()
    off = db.query(api.Count(*batches[0]), engine="cuda")
    _same_result("obs on/off", on, off)
    _same_result("obs on/unforced", on, got["count"][0])
    _served_on_card("obs on", on, on_card)
    _served_on_card("obs off", off, on_card)
    for name in ("executor.device_call", "engine.sync", "engine.upload",
                 "executor.fn_build"):
        check(spans[name]["count"] > 0, f"database: no {name} span")

    # 6. updates: 10,000 inserts near stored rows, 1,000 deletes; the next
    # query refreshes only the dirty pages
    db.query(api.Count(*batches[0]), engine="torch")     # pack at epoch 0
    near = data[rng.choice(len(data), 10_000, replace=False)].astype(np.int64)
    near += rng.integers(-64, 65, size=near.shape)
    new = np.unique(np.clip(near, 0, 2**32 - 1).astype(np.uint64), axis=0)
    new = new[~rows_in_set(new, data)]
    dead = data[rng.choice(len(data), 1_000, replace=False)]
    t0 = time.perf_counter()
    db.insert(new)
    n_deleted = db.delete(dead)
    mutate_s = time.perf_counter() - t0
    check(n_deleted == len(dead), f"database: {n_deleted} of {len(dead)} "
                                  f"deletes took")
    eng = db.engines["cuda"]
    dirty = db.store.dirty_since(eng.built_epoch)
    pts0 = eng._host.points.copy()
    size0 = eng._host.page_size.copy()
    t0 = time.perf_counter()
    upd = {"count": db.query(api.Count(*batches[-1]), engine="cuda")}
    refresh_s = time.perf_counter() - t0
    upd["range"] = db.query(api.Range(*batches[-1]), engine="cuda")
    check(eng.built_epoch == db.store.epoch, "database: no refresh ran")
    check(eng._host.points.shape == pts0.shape,
          "database: the refresh grew the capacity (full repack)")
    changed = np.nonzero((eng._host.points != pts0).any(axis=(1, 2))
                         | (eng._host.page_size != size0))[0]
    check(set(changed.tolist()) <= set(dirty),
          "database: the refresh repacked pages that were not dirty")
    for kind, r in upd.items():
        w = db.query((api.Count if kind == "count" else api.Range)(
            *batches[-1]), engine="torch")
        check(r.exact, f"database: {kind} after updates not exact")
        _same_result(f"{kind} after updates", r, w)
        _served_on_card(f"{kind} after updates", r, on_card)
    t0 = time.perf_counter()
    live = db.store.merged_data()
    merged_s = time.perf_counter() - t0
    check(len(live) == len(data) + len(new) - len(dead),
          "database: live rows do not add up")
    for t in pick[:16]:
        i = t % BATCH
        lo, hi = batches[-1][0][i], batches[-1][1][i]
        check(upd["count"].counts[i] == brute_force_count(live, lo, hi),
              f"database: count after updates differs (query {i})")
    for t in pick[:4]:
        i = t % BATCH
        lo, hi = batches[-1][0][i], batches[-1][1][i]
        check(np.array_equal(upd["range"].rows_for(i),
                             brute_force_range(live, lo, hi)),
              f"database: range after updates differs (query {i})")

    launches = {k: v - bare_launches[k] for k, v in cuda_lib.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    for name in ("window_filter", "window_match", "split_zranges",
                 "sfc_encode_pool"):
        check(launches[name] > 0, f"database: {name} was not launched")
    Q = n_batches * BATCH
    out = {
        "phase": "database", "rows": int(db.index.n), "d": int(db.d),
        "K": int(db.index.K), "pages": int(db.num_pages),
        "fit": {"seconds": fit_s,
                "learn_s": fit_spans["database.fit.learn"]["s"],
                "build_s": fit_spans["database.fit.build"]["s"],
                "evaluations": len(res.evaluated), "y_best": res.y_best,
                "zorder_cost": anchor_y,
                "sfc_encode_pool": fit_launches["sfc_encode_pool"]},
        "queries": Q, "q_chunk": Q_CHUNK, "max_cand": MAX_CAND,
        "max_hits": MAX_HITS,
        "count_qps": Q / seconds["cuda"][0],
        "range_qps": Q / seconds["cuda"][1],
        "count_qps_torch": Q / seconds["torch"][0],
        "range_qps_torch": Q / seconds["torch"][1],
        "bare_count_qps": Q / bare_s[0], "bare_range_qps": Q / bare_s[1],
        "main_count_qps": main_res["count_qps"],
        "main_range_qps": main_res["range_qps"],
        "first_pass_overflowed": {
            k: int(sum((r.overflowed > 0).sum() for r in got[k]))
            for k in ("count", "range")},
        "obs_attribution": attribution,
        "escalations": {k: [r.escalations for r in got[k]]
                        for k in ("count", "range")},
        "brute_checked": {"count": 32, "range": 8, "knn": knn_checked},
        "point": {"stored": BATCH // 2, "absent": BATCH // 2,
                  "found": int(got["point"].found.sum())},
        "forced": {"seconds": forced_s,
                   "escalations": {k: r.escalations
                                   for k, r in forced.items()},
                   "device_calls": {k: r.plan.accounting.device_calls
                                    for k, r in forced.items()}},
        "obs_spans": spans,
        "cuda_results": on_card,
        "updates": {"inserted": int(len(new)), "deleted": n_deleted,
                    "dirty_pages": len(dirty),
                    "repacked_pages": int(len(changed)), "cap": DB_CAP,
                    "mutate_s": mutate_s, "refresh_query_s": refresh_s,
                    "merged_data_s": merged_s, "brute_checked": 20},
        "cache": dataclasses.asdict(db.executor.cache),
        "serve_launches": serve_launches, "launches": launches,
        "bare_launches": bare_launches,
        "peak_device_bytes": int(peak),
        "phase_s": time.perf_counter() - t_phase}
    emit(out)
    # for the later phases, not printed: the database, its traffic and
    # the rows its updates inserted and deleted
    out["db"] = db
    out["traffic"] = (batches, points, centers)
    out["updates"] = [(new, dead)]
    return out


# ---------------------------------------------------------------------------
# phase 7: DP paging (paper Algorithm 2) on the card above 200k rows
# ---------------------------------------------------------------------------

DEVICE = "cuda"                # where the new phases put the port's tensors
KERNEL_ENGINE = "cuda"         # the in-memory engine on the kernels
DP_PREFIX = 250_000            # rows held element for element: above 200k


def phase_dp_paging(data, curve, prefix: int) -> dict:
    """`paging="dp"` on the card: `make_paging` takes `dp_paging_torch`
    above 200k rows.  On the piecewise path's NYC-like rows (d 3) under
    its learned curve it pages the whole set, scored against `heuristic`
    and `fixed` on the same rows (the exact DP must score no worse than
    either), builds the index through `LMSFCIndex.build(paging="dp")`,
    and holds the card's boundaries on a `prefix`-row prefix equal to
    `dp_paging_np`'s on the host, element for element."""
    import numpy as np
    import torch
    from repro_torch.core import paging
    from repro_torch.core.index import IndexConfig, LMSFCIndex

    K = curve.K
    d = data.shape[1]
    keys = curve.encode_np(data)
    xs = data[np.argsort(keys, kind="stable")].astype(np.int64)
    smin, smax = paging.page_capacity(d)
    check(len(xs) > 200_000 and prefix > 200_000,
          "dp_paging: needs more than 200k rows to take the device DP")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dp = paging.make_paging(xs, "dp", K, device=DEVICE)
    dp_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    heur = paging.make_paging(xs, "heuristic", K)
    heur_s = time.perf_counter() - t0
    fixed = paging.make_paging(xs, "fixed", K)
    scores = {m: paging.total_score(xs, pg.starts, K)
              for m, pg in (("dp", dp), ("heuristic", heur),
                            ("fixed", fixed))}
    check(scores["dp"] <= scores["heuristic"]
          and scores["dp"] <= scores["fixed"],
          f"dp_paging: the DP scores worse than heuristic or fixed {scores}")
    sizes = np.diff(dp.starts)
    check(sizes.max() <= smax and sizes[1:].min() >= smin,
          "dp_paging: a page outside [smin, smax] after the first")
    t0 = time.perf_counter()
    index = LMSFCIndex.build(data, curve=curve, cfg=IndexConfig(paging="dp"),
                             device=DEVICE)
    build_s = time.perf_counter() - t0
    check(np.array_equal(index.starts, dp.starts),
          "dp_paging: LMSFCIndex.build(paging='dp') paged otherwise")
    head = xs[:prefix]
    t0 = time.perf_counter()
    card = paging.dp_paging_torch(head, smin, smax, K, device=DEVICE)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = paging.dp_paging_np(head, smin, smax, K)
    host_s = time.perf_counter() - t0
    check(np.array_equal(card, host),
          f"dp_paging: the card's boundaries on {prefix} rows differ from "
          f"dp_paging_np's ({len(card)} vs {len(host)} boundaries)")
    out = {"phase": "dp_paging", "card": CARD, "rows": int(len(xs)), "d": d,
           "K": K, "curve": curve.kind, "smin": smin, "smax": smax,
           "dp_s": dp_s, "heuristic_s": heur_s, "build_s": build_s,
           "pages": {"dp": dp.num_pages, "heuristic": heur.num_pages,
                     "fixed": fixed.num_pages},
           "score": scores,
           "steps": -(-(len(xs) + 1 - smin) // smin),
           "peak_device_bytes": int(peak),
           "prefix": {"rows": prefix, "pages": int(len(card) - 1),
                      "card_s": card_s, "dp_paging_np_s": host_s,
                      "equal": True}}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 8: the store, out-of-core serving from cached device page groups
# ---------------------------------------------------------------------------

STORE_CHUNK = 500_000          # rows a build chunk
STORE_SMALL_BUDGET = 16 << 20  # forces evictions and bypass (~120 blocks;
                               # a fifth of the groups on a cut segment)


def _traffic_pass(db, traffic, name: str, budget=None):
    """Serve the database phase's traffic once through `db.query` (a
    Database on its attached engine, or a Router): per kind the results
    and the seconds; with a `budget`, the store cache's resident bytes are
    read after every query and must stay within it."""
    from repro_torch import api
    import torch
    batches, points, centers = traffic
    out, secs = {}, {}
    worst = 0

    def run(q):
        nonlocal worst
        r = db.query(q)
        if budget is not None:
            eng = db.engines[db.active_engine]
            worst = max(worst, eng.cache.resident_bytes)
            check(eng.cache.resident_bytes <= budget,
                  f"store: {name}: {eng.cache.resident_bytes} resident "
                  f"bytes over the {budget}-byte budget")
        return r

    for kind, make in (("count", api.Count), ("range", api.Range)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[kind] = [run(make(*b)) for b in batches]
        secs[kind] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["point"] = [run(api.Point(points))]
    secs["point"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["knn"] = [run(api.Knn(centers, k=10, metric=m))
                  for m in ("l2", "linf")]
    secs["knn"] = time.perf_counter() - t0
    qps = {"count": sum(len(b[0]) for b in batches) / secs["count"],
           "range": sum(len(b[0]) for b in batches) / secs["range"],
           "point": len(points) / secs["point"],
           "knn": 2 * len(centers) / secs["knn"]}
    return out, secs, qps, worst


ANSWER_FIELDS = ("counts", "rows", "offsets", "found", "neighbors", "dists")


def _same_answers(name: str, got: dict, want: dict, plain: bool) -> None:
    """Two passes' results equal kind by kind: every answer, and against
    the plain twins' pass (`plain`) the overflow flags and escalations
    too."""
    import numpy as np
    for kind in got:
        for i, (g, w) in enumerate(zip(got[kind], want[kind])):
            for f in DB_FIELDS if plain else ANSWER_FIELDS:
                if hasattr(w, f):
                    check(np.array_equal(getattr(g, f), getattr(w, f)),
                          f"store: {name}: {kind} {i}: {f} differs")
            check(not plain or (g.escalations, g.cpu_fallbacks)
                  == (w.escalations, w.cpu_fallbacks),
                  f"store: {name}: {kind} {i}: escalations differ")


def phase_store(data, curve, traffic, seed: int) -> dict:
    """Out-of-core serving on the card: `build_segment` (host external
    sort) of the main path's rows from 500k-row chunks under its learned
    curve, `open_segment(verify="full")`, `Database.from_segment(...)
    .engine("store")` on the kernels serving the database phase's traffic
    cold and warm at the default 256 MB budget and again at 16 MB
    (evictions and bypass); every output held bit for bit against the
    `store` engine on the plain twins on the card and the `cuda` engine
    over `seg.as_index()` in memory, samples against brute force.  Launch
    counts are set to 0 just before the kernels' store runs and read just
    after them."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api, obs
    from repro_torch.api.deltas import rows_in_set
    from repro_torch.core.query import brute_force_count, brute_force_range
    from repro_torch.kernels import cuda_lib
    from repro_torch.store import build_segment, open_segment
    from repro_torch.store.engine import (DEFAULT_CACHE_BYTES,
                                          DEFAULT_GROUP_PAGES)

    path = ROOT / "build" / "store_segment"
    shutil.rmtree(path, ignore_errors=True)
    knobs = dict(q_chunk=Q_CHUNK, max_cand=MAX_CAND, max_hits=MAX_HITS)
    try:
        chunks = (data[i:i + STORE_CHUNK]
                  for i in range(0, len(data), STORE_CHUNK))
        t0 = time.perf_counter()
        build_segment(chunks, str(path), curve=curve, page_rows=256)
        build_s = time.perf_counter() - t0
        seg_bytes = sum(p.stat().st_size for p in path.iterdir())
        t0 = time.perf_counter()
        seg = open_segment(str(path), verify="full")
        open_s = time.perf_counter() - t0
        rows = np.asarray(seg.xs)
        check(0.99 * len(data) <= seg.n <= len(data),
              f"store: the segment holds {seg.n} of {len(data)} rows")
        db = api.Database.from_segment(seg, device=DEVICE)
        block = seg.group_nbytes(DEFAULT_GROUP_PAGES)

        # the kernels: cold, then warm, at the default budget; then 16 MB
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        db.engine("store", api.EngineConfig(**knobs))
        eng = db.engines["store"]
        check(eng.backend == "cuda" and eng.device.type == DEVICE,
              "store: the store engine is not on the kernels and the card")
        got, secs, qps, cache = {}, {}, {}, {}
        # the warm pass times the per-query memmap row gather of Range
        gather = {"s": 0.0, "calls": 0}
        resolve = eng._resolve_rows

        def timed_resolve(*a):
            t = time.perf_counter()
            rows_ = resolve(*a)
            gather["s"] += time.perf_counter() - t
            gather["calls"] += 1
            return rows_

        for run in ("cold", "warm"):
            if run == "warm":
                eng._resolve_rows = timed_resolve
            got[run], secs[run], qps[run], _ = _traffic_pass(
                db, traffic, run, DEFAULT_CACHE_BYTES)
            cache[run] = dataclasses.asdict(eng.cache.stats.snapshot())
        eng._resolve_rows = resolve
        # one warm batch of each under the profiler (default budget)
        profile = {"count": profile_batch(
            lambda: db.query(api.Count(*traffic[0][0]))),
            "range": profile_batch(
            lambda: db.query(api.Range(*traffic[0][0])))}
        check(cache["cold"]["misses"] > 0 and cache["warm"]["hits"]
              > cache["cold"]["hits"], "store: the warm pass missed")
        small_budget = min(STORE_SMALL_BUDGET, max(
            1, seg.num_groups(DEFAULT_GROUP_PAGES) // 5) * block)
        db.engine("store", api.EngineConfig(cache_bytes=small_budget,
                                            **knobs))
        small = db.engines["store"]
        obs.enable()
        got["small"], secs["small"], qps["small"], worst = _traffic_pass(
            db, traffic, "small budget", small_budget)
        spans = _span_totals(obs.snapshot(), (
            "store.assemble", "store.cache.upload", "executor.device_call",
            "executor.execute"))
        obs.disable()
        obs.reset()
        cache["small"] = dataclasses.asdict(small.cache.stats.snapshot())
        check(cache["small"]["evictions"] > 0 and cache["small"]["bypass"]
              > 0, "store: the small budget forced no eviction or bypass")
        launches = dict(cuda_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for name in ("window_filter", "window_match", "split_zranges"):
            check(launches[name] > 0, f"store: {name} was not launched")
        for run in got:
            for kind, rs in got[run].items():
                for r in rs:
                    check(r.engine == "store" and r.cpu_fallbacks == 0,
                          f"store: {run} {kind} left the card")

        # the same traffic on the plain twins on the card, and through the
        # in-memory kernels' engine over the segment's index
        db.engine("store", api.EngineConfig(backend="torch", **knobs))
        before = dict(cuda_lib.LAUNCHES)
        twin, twin_s, twin_qps, _ = _traffic_pass(db, traffic, "torch",
                                                DEFAULT_CACHE_BYTES)
        check(cuda_lib.LAUNCHES == before,
              "store: the torch backend launched a kernel")
        mem = api.Database(seg.as_index(), device=DEVICE)
        mem.engine(KERNEL_ENGINE, api.EngineConfig(**knobs))
        t0 = time.perf_counter()
        mem.engines[KERNEL_ENGINE].sync()      # pack + upload, not timed
        mem_pack_s = time.perf_counter() - t0
        inmem, inmem_s, inmem_qps, _ = _traffic_pass(mem, traffic, "in memory")
        for run in ("cold", "warm", "small"):
            _same_answers(f"{run} against the torch backend", got[run], twin,
                          plain=True)
            _same_answers(f"{run} against the in-memory engine", got[run],
                          inmem, plain=False)

        # brute force over the segment's rows, on samples
        batches, points, centers = traffic
        counts = np.concatenate([r.counts for r in got["warm"]["count"]])
        Ls = np.concatenate([b[0] for b in batches])
        Us = np.concatenate([b[1] for b in batches])
        pick = np.random.default_rng(seed + 11).permutation(len(Ls))
        for t in pick[:32]:
            want = brute_force_count(rows, Ls[t], Us[t])
            check(counts[t] == want, f"store: count {counts[t]} != brute "
                                     f"{want} (query {t})")
        for t in pick[:8]:
            rr = got["warm"]["range"][t // BATCH]
            check(np.array_equal(rr.rows_for(t % BATCH),
                                 brute_force_range(rows, Ls[t], Us[t])),
                  f"store: range rows differ from brute force (query {t})")
        found = got["warm"]["point"][0].found
        for m, kr in zip(("l2", "linf"), got["warm"]["knn"]):
            for i in range(4):
                nb, dists = _brute_knn(rows, centers[i], 10, m)
                check(np.array_equal(kr.neighbors_for(i), nb)
                      and np.array_equal(kr.dists_for(i), np.asarray(
                          dists, dtype=np.float64)),
                      f"store: {m} kNN of center {i} differs from brute "
                      f"force")
        check(np.array_equal(found, rows_in_set(points, rows)),
              "store: point lookups disagree with the segment's rows")
        n_q = len(Ls)
        out = {
            "phase": "store", "card": CARD, "rows_in": int(len(data)),
            "rows": int(seg.n), "d": int(seg.d), "K": int(seg.K),
            "curve": seg.curve.kind, "pages": int(seg.num_pages),
            "cap": int(seg.cap), "page_rows": 256,
            "group_pages": DEFAULT_GROUP_PAGES,
            "groups": int(seg.num_groups(DEFAULT_GROUP_PAGES)),
            "block_bytes": int(block), "segment_bytes": int(seg_bytes),
            "build_s": build_s, "build_rows_per_s": len(data) / build_s,
            "open_full_s": open_s,
            "queries": {"count": n_q, "range": n_q, "point": len(points),
                        "knn": 2 * len(centers)},
            "qps": qps, "seconds": secs,
            "qps_torch_backend_cold": twin_qps,
            "qps_in_memory_cuda": inmem_qps, "in_memory_pack_s": mem_pack_s,
            "budgets": {"default": DEFAULT_CACHE_BYTES,
                        "small": small_budget},
            "small_worst_resident_bytes": int(worst),
            "warm_row_gather": gather,
            "cache": cache, "obs_spans_small": spans,
            "escalations": {k: [r.escalations for r in got["warm"][k]]
                            for k in ("count", "range")},
            "profile_warm": profile,
            "launches": launches, "peak_device_bytes": int(peak)}
        emit(out)
        return out
    finally:
        shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the async serving front under open-loop load
# ---------------------------------------------------------------------------

SERVE_RATES = (250.0, 1_000.0, 4_000.0)
# the load and SLO of the JAX package's serving sweep (BENCH_serving.json
# "config"): 200 clients, Zipf 1.2, the default kind mix, kNN k 4
SERVE_LOAD = dict(n_clients=200, zipf_a=1.2, knn_k=4,
                  mix=(("count", 0.45), ("range", 0.20), ("point", 0.25),
                       ("knn", 0.10)))
SERVE_SLO = dict(p99_target_ms=100.0, max_queue=4096, overload="reject",
                 batch_max=64, window_init_ms=2.0, window_min_ms=0.0,
                 window_max_ms=100.0, grow_ms=2.0, shrink=0.5, headroom=0.3,
                 sample_window=256, min_samples=16, adaptive=True,
                 max_retries=2)


def phase_serving(db, data, seconds: float, seed: int) -> dict:
    """`Database.serve(engine="cuda")` over the database phase's 10M-row
    index under the JAX package's serving load, `seconds` at each offered
    rate: completion q/s, latency quantiles from the scheduled arrival,
    shed counts and the controller's window.  Every served result is held
    bit for bit against `replay_serial` of the served log on the `cuda`
    engine and on the `torch` engine.  Launch counts are set to 0 just
    before the served runs and read just after them."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.serving import (LoadSpec, SLOConfig, assert_bit_identical,
                                     make_query_log, replay_serial,
                                     run_open_loop)

    K = db.index.K
    logs = {rate: make_query_log(data, LoadSpec(
        rate_qps=rate, duration_s=seconds, seed=seed + int(rate),
        **SERVE_LOAD), K=K) for rate in SERVE_RATES}
    # warm the engines' buckets outside the measured runs (the SLO's
    # batches are at most batch_max queries: the q_chunk buckets up to it)
    warm = make_query_log(data, LoadSpec(rate_qps=2_000.0, duration_s=0.25,
                                         seed=seed + 1, **SERVE_LOAD), K=K)
    for engine in (KERNEL_ENGINE, "torch"):
        with db.serve(slo=SLOConfig(**SERVE_SLO), engine=engine) as srv:
            run_open_loop(srv, warm)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    points, served = [], {}
    for rate in SERVE_RATES:
        srv = db.serve(slo=SLOConfig(**SERVE_SLO), engine=KERNEL_ENGINE)
        try:
            pt = run_open_loop(srv, logs[rate])
        finally:
            srv.close(timeout=600)
        check(not srv._thread.is_alive(), "serving: the drain loop hangs")
        st = srv.stats()
        check(pt["failed"] == 0 and st["failed"] == 0,
              f"serving: {pt['failed']} tickets failed at {rate} q/s")
        check(pt["completed"] == pt["admitted"],
              f"serving: {pt['admitted'] - pt['completed']} admitted "
              f"queries unresolved at {rate} q/s")
        served[rate] = (srv.query_log(), pt.pop("results"))
        lat = pt["latency_ms"]
        points.append({
            "offered_qps": rate, "scheduled": pt["scheduled"],
            "admitted": pt["admitted"], "shed": pt["shed"],
            "completed": pt["completed"],
            "sustained_qps": pt["sustained_qps"], "span_s": pt["span_s"],
            "p50_ms": lat["p50"], "p95_ms": lat["p95"], "p99_ms": lat["p99"],
            "mean_ms": lat["mean"], "batches": st["batches"],
            "mean_batch_fill": pt["completed"] / max(1, st["batches"]),
            "window_final_ms": st["controller"]["window_ms"],
            "controller_grows": st["controller"]["grows"],
            "controller_shrinks": st["controller"]["shrinks"]})
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    for name in ("window_filter", "window_match", "split_zranges"):
        check(launches[name] > 0, f"serving: {name} was not launched")
    # exactness: replay each served log serially on both engines, one
    # entry at a time (its result dropped once compared), timed by kind
    checked, replay_s = {}, {}
    for engine in (KERNEL_ENGINE, "torch"):
        by_kind = {}
        for rate, (log, results) in served.items():
            for entry in log:
                seq, q = entry
                t0 = time.perf_counter()
                want = replay_serial(db, [entry], engine=engine)[seq]
                k = by_kind.setdefault(q.kind, [0, 0.0])
                k[0] += 1
                k[1] += time.perf_counter() - t0
                assert_bit_identical(results[seq], want,
                                     context=f"{engine} {rate} seq{seq}")
        checked[engine] = sum(n for n, _ in by_kind.values())
        replay_s[engine] = {kind: {"queries": n, "s": t,
                                   "mean_ms": 1e3 * t / n}
                            for kind, (n, t) in by_kind.items()}
    # the device's share of a short served run (its launches come after
    # the counts were read)
    short = make_query_log(data, LoadSpec(
        rate_qps=SERVE_RATES[0], duration_s=0.5, seed=seed + 2,
        **SERVE_LOAD), K=K)

    def served_short():
        with db.serve(slo=SLOConfig(**SERVE_SLO), engine=KERNEL_ENGINE) as s:
            run_open_loop(s, short)

    profile = profile_batch(served_short)
    kinds = {}
    for log, _ in served.values():
        for _, q in log:
            kinds[q.kind] = kinds.get(q.kind, 0) + 1
    out = {"phase": "serving", "card": CARD, "rows": int(db.n),
           "engine": KERNEL_ENGINE, "seconds_per_rate": seconds,
           "slo": SERVE_SLO, "load": {k: v for k, v in SERVE_LOAD.items()
                                      if k != "mix"},
           "mix": dict(SERVE_LOAD["mix"]), "served_kinds": kinds,
           "points": points, "replay_checked": checked,
           "replay_s": replay_s, "profile_short_run": profile,
           "launches": launches}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 10: the page-sharded `distributed` engine
# ---------------------------------------------------------------------------

DIST_FORCED_CAND = 4           # forced escalation: most queries overflow
DIST_UPDATES = (1_000, 100)    # rows inserted / deleted in the phase


def _launch_delta(before: dict) -> dict:
    from repro_torch.kernels import cuda_lib
    return {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()}


def _add(total: dict, delta: dict) -> None:
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def _shard_overflow(eng, curve, rects, max_cand: int):
    """The number of shards whose candidate pages overflow `max_cand`, per
    query: the engine's packed host arrays cut here with numpy into
    `len(mesh)` contiguous equal page blocks (not by `shard_serving_arrays`,
    the split under test), each block served by the single-shard
    `make_query_fn` on the plain backend.  What the distributed fn's
    summed overflow must equal."""
    import torch
    from repro_torch.core.serve import make_query_fn, upload_serving_arrays
    fn = make_query_fn(curve, k_maxsplit=K_MAXSPLIT, max_cand=max_cand,
                       q_chunk=Q_CHUNK, backend="torch")
    n = len(eng.mesh)
    pages = eng._host.points.shape[0]
    check(pages % n == 0, f"distributed: {pages} pages do not split into "
          f"{n} equal shards")
    per = pages // n
    total = None
    for i, dev in enumerate(eng.mesh):
        block = eng._host.map(lambda a: a[i * per:(i + 1) * per])
        _, over = fn(upload_serving_arrays(block, dev), rects.to(dev))
        over = over.to(torch.int64).cpu()
        total = over if total is None else total + over
    return total.numpy()


def phase_distributed(db, traffic, seed: int) -> dict:
    """The `distributed` engine (`Database.engine("distributed")`) on the
    database phase's index after its updates: a mesh of every visible card
    and a mesh of four shards on the first card (pages padded to a
    multiple of 4).  Each serves the database phase's 4 Count batches and
    its Point batch through the kernels on every shard, held bit for bit
    against the `cuda` engine on the same rows (counts, found flags, and
    on a one-shard mesh the overflow flags); under forced escalation
    (max_cand 4) the first pass's overflow count of each query must equal
    the number of shards that overflowed (each shard's plain single-shard
    twin) and the escalated counts the `cuda` engine's; then 1,000
    inserts and 100 deletes are served after a refresh that copies only
    the dirty pages into the shards holding them.  Launches are counted
    over the distributed engine's calls only."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.serve import pack_query_rects
    from repro_torch.kernels import cuda_lib

    batches, points, _ = traffic
    knobs = dict(q_chunk=Q_CHUNK, max_cand=MAX_CAND, cap=DB_CAP)
    rng = np.random.default_rng(seed + 21)
    launches = {k: 0 for k in cuda_lib.LAUNCHES}
    meshes = {"all_cards": None, "four_shards_card0": [f"{DEVICE}:0"] * 4}
    Q = sum(len(b[0]) for b in batches)
    updates = []
    out = {"phase": "distributed", "card": CARD, "rows": int(db.n),
           "pages": int(db.num_pages), "meshes": {}}

    def dist(q):
        """One query on the distributed engine; its launches tallied."""
        before = dict(cuda_lib.LAUNCHES)
        r = db.query(q, engine="distributed")
        torch.cuda.synchronize()
        _add(launches, _launch_delta(before))
        return r

    def plain(q):
        return db.query(q, engine=KERNEL_ENGINE)

    def hold(name, got, want, flags: bool):
        for f in ("counts", "found") + (("overflowed",) if flags else ()):
            if hasattr(want, f):
                check(np.array_equal(getattr(got, f), getattr(want, f)),
                      f"distributed: {name}: {f} differs from the "
                      f"{KERNEL_ENGINE} engine")
        check(got.engine == "distributed" and got.exact
              and got.cpu_fallbacks == 0,
              f"distributed: {name}: not served whole by the engine")

    for label, mesh in meshes.items():
        db.engine("distributed", api.EngineConfig(mesh=mesh, **knobs))
        eng = db.engines["distributed"]
        check(eng.backend == "cuda" and all(d.type == "cuda"
                                            for d in eng.mesh),
              "distributed: the engine is not on the kernels of the cards")
        t0 = time.perf_counter()
        dist(api.Count(*batches[0]))             # first use: pack, upload
        pack_s = time.perf_counter() - t0
        one = len(eng.mesh) == 1
        t0 = time.perf_counter()
        got = [dist(api.Count(*b)) for b in batches]
        count_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_pt = dist(api.Point(points))
        point_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [plain(api.Count(*b)) for b in batches]
        torch.cuda.synchronize()
        cuda_count_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_pt = plain(api.Point(points))
        cuda_point_s = time.perf_counter() - t0
        for i, (g, w) in enumerate(zip(got, want)):
            hold(f"{label} count {i}", g, w, one)
        hold(f"{label} point", got_pt, want_pt, one)
        # forced escalation: first-pass overflow == shards that overflowed
        db.engine("distributed", api.EngineConfig(
            mesh=mesh, q_chunk=Q_CHUNK, max_cand=DIST_FORCED_CAND,
            cap=DB_CAP))
        forced = dist(api.Count(*batches[0]))
        eng = db.engines["distributed"]
        rects = torch.from_numpy(pack_query_rects(*batches[0]))
        expect = _shard_overflow(eng, db.curve, rects, DIST_FORCED_CAND)
        check(np.array_equal(forced.overflowed, expect[:len(forced)]),
              f"distributed: {label}: forced overflow counts differ from "
              f"the shards' own")
        check(forced.escalations > 0,
              f"distributed: {label}: forced max_cand did not escalate")
        hold(f"{label} forced", forced, want[0], False)
        # updates: a refresh copies only the dirty pages into their shards
        db.engine("distributed", api.EngineConfig(mesh=mesh, **knobs))
        eng = db.engines["distributed"]
        dist(api.Count(*batches[-1]))
        parts0 = eng._arrays.points.parts
        # rows near stored ones that are not stored, and live base rows
        # (the `cuda` engine's Point answers which; merging the whole
        # live set on the host would take ~15 s)
        xs = db.index.xs
        near = xs[rng.choice(len(xs), DIST_UPDATES[0],
                             replace=False)].astype(np.int64)
        near += rng.integers(-64, 65, size=near.shape)
        new = np.unique(np.clip(near, 0, 2**32 - 1).astype(np.uint64),
                        axis=0)
        new = new[~plain(api.Point(new)).found]
        dead = xs[rng.choice(len(xs), 2 * DIST_UPDATES[1], replace=False)]
        dead = dead[plain(api.Point(dead)).found][:DIST_UPDATES[1]]
        db.insert(new)
        check(db.delete(dead) == len(dead), "distributed: deletes missed")
        updates.append((new, dead))
        dirty = len(db.store.dirty_since(eng.built_epoch))
        probe = api.Point(np.concatenate([new[:64], dead[:64]]))
        t0 = time.perf_counter()
        upd = dist(api.Count(*batches[-1]))
        refresh_s = time.perf_counter() - t0
        upd_pt = dist(probe)
        check(eng.built_epoch == db.store.epoch
              and all(a is b for a, b in zip(eng._arrays.points.parts,
                                             parts0)),
              f"distributed: {label}: the refresh re-uploaded the shards")
        n_new = min(64, len(new))
        check(bool(upd_pt.found[:n_new].all())
              and not upd_pt.found[n_new:].any(),
              f"distributed: {label}: inserts/deletes not visible")
        hold(f"{label} after updates", upd, plain(api.Count(*batches[-1])),
             one)
        hold(f"{label} point after updates", upd_pt, plain(probe), one)
        profile = profile_batch(lambda: dist(api.Count(*batches[0])))
        out["meshes"][label] = {
            "shards": len(eng.mesh),
            "devices": sorted({str(d) for d in eng.mesh}),
            "pages_padded": int(eng._host.points.shape[0]),
            "pack_upload_s": pack_s,
            "count_qps": Q / count_s, "cuda_count_qps": Q / cuda_count_s,
            "point_qps": len(points) / point_s,
            "cuda_point_qps": len(points) / cuda_point_s,
            "first_pass_overflowed": int(sum((r.overflowed > 0).sum()
                                             for r in got)),
            "forced": {"max_cand": DIST_FORCED_CAND,
                       "escalations": forced.escalations,
                       "queries_overflowed":
                           int((forced.overflowed > 0).sum()),
                       "max_shards_overflowed": int(forced.overflowed.max()),
                       "device_calls": forced.plan.accounting.device_calls},
            "updates": {"inserted": int(len(new)), "deleted": len(dead),
                        "dirty_pages": dirty,
                        "refresh_query_s": refresh_s},
            "profile_count_batch": profile}
    for name in ("window_filter", "split_zranges"):
        check(launches[name] > 0, f"distributed: {name} was not launched")
    out["launches"] = launches
    out["cards"] = torch.cuda.device_count()
    emit(out)
    out["updates"] = updates
    return out


# ---------------------------------------------------------------------------
# phase 11: the multi-shard Router
# ---------------------------------------------------------------------------


def phase_router(data, db, traffic, updates, n_shards: int, seconds: float,
                 seed: int) -> dict:
    """`Router.build` of the main path's rows into `n_shards` shard
    Databases on the card, each fitted as the database phase's fit is (the
    device SMBO program, `sfc_encode_pool` launched), the database and
    distributed phases' inserts and deletes applied through the Router
    (round-robin inserts, broadcast deletes), every shard on the `cuda`
    engine with the main path's knobs.  The database phase's Count, Range,
    Point and kNN traffic is held bit for bit against the unsharded
    database on its `cuda` engine (kNN tie-breaks included), samples
    against brute force; the shards' curves differ from the unsharded
    one, and the answers do not depend on the curve.  `Router.serve`
    then serves the serving phase's load at 250 offered q/s for `seconds`
    and every served result must equal `replay_serial` on the Router.
    Launches are counted over the build, the traffic and the served run."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.query import brute_force_count, brute_force_range
    from repro_torch.data.workload import make_workload
    from repro_torch.kernels import cuda_lib
    from repro_torch.serving import (LoadSpec, SLOConfig, assert_bit_identical,
                                     make_query_log, replay_serial,
                                     run_open_loop)

    batches, points, centers = traffic
    launches = {k: 0 for k in cuda_lib.LAUNCHES}
    torch.cuda.synchronize()
    before = dict(cuda_lib.LAUNCHES)
    Ls_tr, Us_tr = make_workload(data, 100, seed=seed + 7, width_scale=0.01,
                                 K=32)
    t0 = time.perf_counter()
    router = api.Router.build(data, n_shards, workload=(Ls_tr, Us_tr), K=32,
                              sample=10_000, smbo={"evals_per_iter": 4},
                              seed=seed, device=DEVICE)
    build_s = time.perf_counter() - t0
    build_launches = _launch_delta(before)
    _add(launches, build_launches)
    check(build_launches["sfc_encode_pool"] > 0,
          "router: the shards' fits launched no sfc_encode_pool")
    t0 = time.perf_counter()
    for new, dead in updates:
        router.insert(new)
        check(router.delete(dead) == len(dead), "router: deletes missed")
    update_s = time.perf_counter() - t0
    check(router.n == db.n, f"router: {router.n} live rows, the unsharded "
                            f"database {db.n}")
    knobs = dict(q_chunk=Q_CHUNK, max_cand=MAX_CAND, max_hits=MAX_HITS,
                 cap=DB_CAP)
    router.engine(KERNEL_ENGINE, api.EngineConfig(**knobs))
    for s in router.shards:
        check(s.engines[KERNEL_ENGINE].device.type == "cuda",
              "router: a shard is not on the card")
    before = dict(cuda_lib.LAUNCHES)
    # first use of each kind (pack, upload, the fns of its shapes) is not
    # timed, on the Router as on the unsharded database
    warm = (api.Count(*batches[0]), api.Range(*batches[0]),
            api.Knn(centers, k=10), api.Knn(centers, k=10, metric="linf"))
    for q in warm:
        router.query(q)
    got, secs, qps, _ = _traffic_pass(router, traffic, "router")
    profile_knn = profile_batch(lambda: router.query(warm[2]))
    _add(launches, _launch_delta(before))
    db.engine(KERNEL_ENGINE, api.EngineConfig(**knobs))
    for q in warm:
        db.query(q)
    want, want_secs, want_qps, _ = _traffic_pass(db, traffic, "unsharded")
    for kind in got:
        for i, (g, w) in enumerate(zip(got[kind], want[kind])):
            residual = getattr(g, "residual_overflow", np.zeros(1))
            check(g.engine == f"router[{n_shards}x{KERNEL_ENGINE}]"
                  and g.cpu_fallbacks == 0 and not np.any(residual),
                  f"router: {kind} {i} was not served whole on the shards")
            for f in ANSWER_FIELDS:
                if hasattr(w, f):
                    check(np.array_equal(getattr(g, f), getattr(w, f)),
                          f"router: {kind} {i}: {f} differs from the "
                          f"unsharded database")
    live = db.store.merged_data()
    rng = np.random.default_rng(seed + 31)
    Ls = np.concatenate([b[0] for b in batches])
    Us = np.concatenate([b[1] for b in batches])
    counts = np.concatenate([r.counts for r in got["count"]])
    pick = rng.permutation(len(Ls))
    for t in pick[:16]:
        check(counts[t] == brute_force_count(live, Ls[t], Us[t]),
              f"router: count of query {t} differs from brute force")
    for t in pick[:4]:
        rr = got["range"][t // BATCH]
        check(np.array_equal(rr.rows_for(t % BATCH),
                             brute_force_range(live, Ls[t], Us[t])),
              f"router: range rows of query {t} differ from brute force")
    for m, kr in zip(("l2", "linf"), got["knn"]):
        for i in range(2):
            rows, dists = _brute_knn(live, centers[i], 10, m)
            check(np.array_equal(kr.neighbors_for(i), rows)
                  and np.array_equal(kr.dists_for(i),
                                     np.asarray(dists, dtype=np.float64)),
                  f"router: {m} kNN of center {i} differs from brute force")
    per_shard = {
        kind: [{k: v for k, v in dataclasses.asdict(a).items()
                if k != "per_shard"}
               for a in got[kind][0].plan.accounting.per_shard]
        for kind in got}
    # each timed kNN batch: per shard (device calls, escalations, compiles)
    knn_batches = [
        {"metric": r.metric, "escalations": r.escalations,
         "per_shard": [[a.device_calls, a.escalations, a.compiles]
                       for a in r.plan.accounting.per_shard]}
        for r in got["knn"]]
    # served: the serving phase's load at its first offered rate
    rate = SERVE_RATES[0]
    log = make_query_log(data, LoadSpec(rate_qps=rate, duration_s=seconds,
                                        seed=seed + int(rate),
                                        **SERVE_LOAD), K=32)
    before = dict(cuda_lib.LAUNCHES)
    srv = router.serve(slo=SLOConfig(**SERVE_SLO), engine=KERNEL_ENGINE)
    try:
        pt = run_open_loop(srv, log)
    finally:
        srv.close(timeout=600)
    torch.cuda.synchronize()
    serve_launches = _launch_delta(before)
    _add(launches, serve_launches)
    check(not srv._thread.is_alive(), "router: the drain loop hangs")
    check(pt["failed"] == 0 and pt["completed"] == pt["admitted"],
          f"router: {pt['failed']} served tickets failed")
    results = pt.pop("results")
    t0 = time.perf_counter()
    for entry in srv.query_log():
        seq, _ = entry
        want_r = replay_serial(router, [entry], engine=KERNEL_ENGINE)[seq]
        assert_bit_identical(results[seq], want_r, context=f"router seq{seq}")
    replay_s = time.perf_counter() - t0
    lat = pt["latency_ms"]
    st = srv.stats()
    for name in ("window_filter", "window_match", "split_zranges"):
        check(launches[name] > 0, f"router: {name} was not launched")
        check(serve_launches[name] > 0,
              f"router: the server launched no {name}")
    out = {"phase": "router", "card": CARD, "shards": n_shards,
           "rows": int(router.n),
           "shard_rows": [int(s.n) for s in router.shards],
           "shard_pages": [int(s.num_pages) for s in router.shards],
           "build_s": build_s, "update_s": update_s,
           "shard_costs": [s.fit_result.y_best for s in router.shards],
           "qps": qps, "unsharded_cuda_qps": want_qps,
           "knn_s": secs["knn"], "unsharded_knn_s": want_secs["knn"],
           "knn_batches": knn_batches, "profile_knn_batch": profile_knn,
           "plan_accounting_per_shard": per_shard,
           "brute_checked": {"count": 16, "range": 4, "knn": 4},
           "served": {"offered_qps": rate, "seconds": seconds,
                      "scheduled": pt["scheduled"],
                      "admitted": pt["admitted"], "shed": pt["shed"],
                      "completed": pt["completed"],
                      "sustained_qps": pt["sustained_qps"],
                      "p50_ms": lat["p50"], "p95_ms": lat["p95"],
                      "p99_ms": lat["p99"], "batches": st["batches"],
                      "replayed": len(results), "replay_s": replay_s},
           "build_launches": build_launches,
           "serve_launches": serve_launches, "launches": launches}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 12: the LM data pipeline's indexed sample selection
# ---------------------------------------------------------------------------

PIPE_VOCAB = 32_000
PIPE_MAX_LEN = 512
PIPE_WINDOWS = 64
PIPE_BATCH = (8, 512)          # (batch, seq_len) of a TokenBatcher step
PIPE_STEPS = 16                # steps per curriculum phase


def _windows(rng, n: int, d: int = 4) -> list:
    """Seeded curriculum windows: per metadata dimension a sub-interval of
    [0, 1] covering a fifth to all of it."""
    width = rng.uniform(0.2, 1.0, size=(n, d))
    lo = rng.uniform(0, 1, size=(n, d)) * (1 - width)
    return [(tuple(a), tuple(a + w)) for a, w in zip(lo, width)]


def phase_pipeline(n_docs: int, seed: int) -> dict:
    """`synth_corpus` (`n_docs` docs, vocab 32,000, up to 512 tokens) in an
    `IndexedDataset` on the card with ``verify_selects=True``: 64 seeded
    curriculum windows are selected through a Range on the `cuda` engine
    (the `window_match` kernel) and each must equal the full metadata
    mask (`verify_selects` raises on a mismatch); a `TokenBatcher` runs 2
    phases x 16 steps of (8, 512) batches and resumes from a mid-stream
    state (the resumed states continue the stream's, and two resumes give
    the same batches); the unique metadata rows are then written as a
    segment under `build/` and the same windows are selected through
    `Database.from_segment(...).engine("store")` on the kernels, equal to
    the in-memory selections.  Launch counts are set to 0 just before the
    selections and batches and read just after them."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.data.pipeline import (CurriculumPhase, IndexedDataset,
                                           TokenBatcher, synth_corpus)
    from repro_torch.kernels import cuda_lib
    from repro_torch.store import write_segment_from_index

    t0 = time.perf_counter()
    docs, meta = synth_corpus(n_docs, PIPE_VOCAB, PIPE_MAX_LEN, seed=seed)
    corpus_s = time.perf_counter() - t0
    tokens = int(sum(len(x) for x in docs))
    t0 = time.perf_counter()
    ds = IndexedDataset(docs, meta, seed=seed, device=DEVICE,
                        verify_selects=True)
    index_s = time.perf_counter() - t0
    check(ds.db.default_engine == KERNEL_ENGINE,
          f"pipeline: selects would run on {ds.db.default_engine}")
    windows = _windows(np.random.default_rng(seed + 41), PIPE_WINDOWS)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    sel = [ds.select(lo, hi) for lo, hi in windows]
    select_s = time.perf_counter() - t0
    phases = [CurriculumPhase("broad", (0.0, 0.0, 0.3, 0.0),
                              (1.0, 1.0, 1.0, 1.0), steps=PIPE_STEPS),
              CurriculumPhase("narrow", (0.0, 0.25, 0.6, 0.0),
                              (0.5, 0.75, 1.0, 0.8), steps=PIPE_STEPS)]
    B, S = PIPE_BATCH
    t0 = time.perf_counter()
    stream = list(TokenBatcher(ds, phases, batch=B, seq_len=S, seed=seed))
    batch_s = time.perf_counter() - t0
    check(len(stream) == 2 * PIPE_STEPS
          and all(b["tokens"].shape == (B, S) for b, _ in stream),
          "pipeline: the batcher did not yield 2 x 16 (8, 512) batches")
    mid = PIPE_STEPS + PIPE_STEPS // 2 - 1
    resumed = []
    for _ in range(2):
        tb = TokenBatcher(ds, phases, batch=B, seq_len=S, seed=seed)
        tb.set_state(stream[mid][1])
        resumed.append(list(tb))
    check(len(resumed[0]) == len(stream) - mid - 1
          and [s for _, s in resumed[0]] == [s for _, s in stream[mid + 1:]]
          and all(np.array_equal(a["tokens"], b["tokens"])
                  for (a, _), (b, _) in zip(*resumed)),
          "pipeline: resuming mid-stream did not continue the stream")
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    check(launches["window_match"] > 0,
          "pipeline: the selects launched no window_match")
    # the same dataset served from a segment through the store engine
    path = ROOT / "build" / "pipeline_segment"
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        write_segment_from_index(ds.index, str(path))
        seg = api.Database.from_segment(str(path), device=DEVICE)
        seg.engine("store", api.EngineConfig())
        sds = IndexedDataset(docs, meta, seed=seed, database=seg,
                             verify_selects=True)
        seg_setup_s = time.perf_counter() - t0
        before = dict(cuda_lib.LAUNCHES)
        t0 = time.perf_counter()
        for (lo, hi), ids in zip(windows, sel):
            check(np.array_equal(sds.select(lo, hi), ids),
                  "pipeline: the segment's selection differs")
        seg_select_s = time.perf_counter() - t0
        seg_launches = _launch_delta(before)
        check(seg_launches["window_match"] > 0,
              "pipeline: the store engine launched no window_match")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    rows = [len(x) for x in sel]
    out = {"phase": "pipeline", "card": CARD, "docs": n_docs,
           "tokens": tokens, "token_bytes": 4 * tokens,
           "unique_meta_rows": int(ds.index.n),
           "pages": int(ds.index.num_pages), "K": ds.K,
           "corpus_s": corpus_s, "index_s": index_s,
           "selects": len(windows), "selects_per_s": len(windows) / select_s,
           "ids_per_select": {"min": min(rows), "mean": sum(rows) / len(rows),
                              "max": max(rows)},
           "batches": len(stream), "batch": list(PIPE_BATCH),
           "batches_per_s": len(stream) / batch_s,
           "resumed_at": mid + 1, "resumed_batches": len(resumed[0]),
           "segment": {"setup_s": seg_setup_s,
                       "selects_per_s": len(windows) / seg_select_s,
                       "launches": seg_launches},
           "launches": launches}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 13: flash attention against its plain twin
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-4b"
LM_BATCH = 4                   # requests per prefill
LM_PROMPT = 2048               # tokens per request
FLASH_SHAPES = (
    # name, B, H, KH, S, dh, dtype, causal, window, strided: q, k and v
    # are (B, heads, S, dh) views of (B, S, heads, dh) tensors, as
    # `blocked_attention` passes them
    ("lm_serve", LM_BATCH, 32, 8, LM_PROMPT, 128, "bfloat16", True, 0,
     False),
    ("lm_serve_strided", LM_BATCH, 32, 8, LM_PROMPT, 128, "bfloat16", True,
     0, True),
    ("lm_shape_f32", LM_BATCH, 32, 8, LM_PROMPT, 128, "float32", True, 0,
     False),
    ("mqa_f32_causal", 1, 4, 1, 256, 128, "float32", True, 0, False),
    ("mqa_f32_full", 1, 4, 1, 256, 128, "float32", False, 0, False),
    ("mqa_bf16_causal", 1, 4, 1, 256, 128, "bfloat16", True, 0, False),
    ("mqa_bf16_full", 1, 4, 1, 256, 128, "bfloat16", False, 0, False),
    ("window64", 1, 2, 2, 512, 64, "float32", True, 64, False),
    ("window192", 1, 2, 2, 512, 64, "float32", True, 192, False),
    ("window64_bf16", 1, 2, 2, 512, 64, "bfloat16", True, 64, False),
    ("window192_bf16", 1, 2, 2, 512, 64, "bfloat16", True, 192, False),
    ("reduced_dh32", 2, 4, 4, 256, 32, "float32", True, 0, False),
    ("reduced_dh32_bf16", 2, 4, 4, 256, 32, "bfloat16", True, 0, False),
    ("ragged_s1000", 1, 8, 2, 1000, 128, "bfloat16", True, 0, False),
)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The bf16 kernel against `flash_tc_ref`, which rounds where it rounds:
# float32 summation order and exp2's last bits remain, which can flip one
# bf16 rounding of an output (at most 2^-7 of it) or of a probability.
FLASH_TC_TOL = 1e-2
# The float32 kernel against `flash_tf32x3_ref`, which takes the same
# three TF32 products: the tensor cores' summation order against the
# twin's is what remains.
FLASH_TF32_TOL = 1e-5
FLASH_ROWS = {"flash_attention_tc": "lm_serve_strided",
              "flash_attention": "lm_shape_f32"}


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(row, col) pairs one head's softmax sees under the masks."""
    import numpy as np
    rows = np.arange(S, dtype=np.int64)
    hi = rows + 1 if causal else np.full(S, S, dtype=np.int64)
    lo = np.maximum(rows - window + 1, 0) if window > 0 else 0
    return int(np.sum(hi - lo))


def flash_bound(B, H, KH, S, dh, dtype: str, causal, window) -> dict:
    """Least time for the attention: 4*dh flops per visible pair and head
    over the peak for the input type (bf16: its tensor cores; float32: a
    third of the TF32 tensor cores', three TF32 products a product),
    against q, k, v and o moved once over the memory rate; the flops at
    the float32 non-tensor peak beside it (`fp32_nontensor_ms`)."""
    esize = 4 if dtype == "float32" else 2
    nbytes = (2 * B * H + 2 * B * KH) * S * dh * esize
    flops = 4.0 * dh * B * H * visible_pairs(S, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_nontensor_ms": flops / FP32_NONTENSOR_FLOPS_PER_S * 1e3}


def _twin_err(twin, got, q, k, v, tol: float, **kw) -> tuple:
    """max |got - twin(q, k, v)| and whether every element is within `tol`
    (atol = rtol), the twin run one kv head's query group at a time: its
    S x S float32 scores then take 1/KH of the memory (1.6 GB a group at
    mixtral's S 8,192, where all 48 heads at once would take 13 GB)."""
    import torch
    g = q.shape[1] // k.shape[1]
    err, ok = 0.0, True
    for j in range(k.shape[1]):
        hs = slice(j * g, (j + 1) * g)
        want = twin(q[:, hs], k[:, j:j + 1], v[:, j:j + 1], **kw).float()
        o = got[:, hs].float()
        err = max(err, (o - want).abs().max().item())
        ok &= bool(torch.allclose(o, want, atol=tol, rtol=tol))
    return err, ok


def hold_flash(label: str, q, k, v, *, causal: bool, window: int) -> dict:
    """One `flash_attention` call, which must launch its dtype's kernel
    once and nothing else and write o with q's strides (bf16), held
    against `mha_ref` at FLASH_TOL and against the dtype's rounding twin:
    bf16 `flash_tc_ref` at FLASH_TC_TOL, float32 `flash_tf32x3_ref` at
    FLASH_TF32_TOL."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention.ops import (KERNELS,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import (flash_tc_ref,
                                                         flash_tf32x3_ref,
                                                         mha_ref)
    kw = dict(causal=causal, window=window)
    kernel = KERNELS[q.dtype]
    before = dict(cuda_lib.LAUNCHES)
    got = flash_attention(q, k, v, **kw)
    check(cuda_lib.LAUNCHES[kernel] == before[kernel] + 1
          and sum(cuda_lib.LAUNCHES.values()) == sum(before.values()) + 1,
          f"flash_attention[{label}] did not launch {kernel} once")
    check(got.stride() == q.stride() or q.dtype == torch.float32,
          f"flash_attention[{label}]: output strides {got.stride()} "
          f"differ from q's {q.stride()}")
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    err, ok = _twin_err(mha_ref, got, q, k, v, tol, **kw)
    check(ok, f"flash_attention[{label}] disagrees with mha_ref (max abs "
              f"{err}, tolerance {tol})")
    res = {"kernel": kernel, "tolerance": tol, "max_abs_err": err}
    if q.dtype == torch.bfloat16:
        tc_err, ok = _twin_err(flash_tc_ref, got, q, k, v, FLASH_TC_TOL, **kw)
        check(ok, f"flash_attention[{label}] disagrees with flash_tc_ref "
                  f"(max abs {tc_err}, tolerance {FLASH_TC_TOL})")
        res.update(tc_twin_tolerance=FLASH_TC_TOL,
                   tc_twin_max_abs_err=tc_err)
    else:
        tf_err, ok = _twin_err(flash_tf32x3_ref, got, q, k, v,
                               FLASH_TF32_TOL, **kw)
        check(ok, f"flash_attention[{label}] disagrees with "
                  f"flash_tf32x3_ref (max abs {tf_err}, tolerance "
                  f"{FLASH_TF32_TOL})")
        res.update(tf32_twin_tolerance=FLASH_TF32_TOL,
                   tf32_twin_max_abs_err=tf_err)
    return res


def flash_inputs(B, H, KH, S, dh, dtype: str, strided: bool, gen):
    """Seeded q (B, H, S, dh), k and v (B, KH, S, dh) on the card; strided:
    (B, heads, S, dh) views of (B, S, heads, dh) tensors, as
    `blocked_attention` passes them."""
    import torch
    dt = getattr(torch, dtype)
    if strided:
        return tuple(torch.randn(B, S, h, dh, generator=gen, device="cuda")
                     .to(dt).transpose(1, 2) for h in (H, KH, KH))
    return tuple(torch.randn(B, h, S, dh, generator=gen, device="cuda")
                 .to(dt) for h in (H, KH, KH))


def sdpa_call(q, k, v, *, causal: bool, window: int):
    """`scaled_dot_product_attention` on the same inputs and masks (the
    library time of the flash rows)."""
    import torch
    import torch.nn.functional as F
    mask = None
    if window > 0:
        r = torch.arange(q.shape[2], device=q.device)
        mask = (r[None, :] <= r[:, None]) & (r[None, :] >= r[:, None]
                                             - window + 1)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)


def phase_kernels_flash(seed: int) -> dict:
    """Each shape through `flash_attention` (the bf16 or the float32
    kernel by dtype), held by `hold_flash`, then timed beside the twin
    and SDPA.  The counts of the held calls, one per shape, are kept as
    `held_launches`."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (KERNELS,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import mha_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out, held = {}, {name: 0 for name in KERNELS.values()}
    for name, B, H, KH, S, dh, dtype, causal, window, strided in FLASH_SHAPES:
        q, k, v = flash_inputs(B, H, KH, S, dh, dtype, strided, gen)
        kw = dict(causal=causal, window=window)
        res = {"shape": [B, H, KH, S, dh], "dtype": dtype,
               "strided": strided, "causal": causal, "window": window,
               **hold_flash(name, q, k, v, **kw)}
        held[res["kernel"]] += 1
        sdpa = sdpa_call(q, k, v, **kw)
        plain = kernel_times(lambda: mha_ref(q, k, v, **kw), iters=5)
        lib = kernel_times(sdpa)
        t = kernel_times(lambda: flash_attention(q, k, v, **kw),
                         one_launch=True)
        # CUDA events for all three: in a long run the profiler loses
        # records, and SDPA's several kernels then read low (below the
        # bound once); at small shapes events include the host's launches
        res.update({"ms": t["wall_ms"], "timing": "events",
                    "profiler_ms": t["ms"],
                    "device_events_per_call": t["device_events_per_call"],
                    "plain_ms": plain["wall_ms"],
                    "plain_profiler_ms": plain["ms"],
                    "library_ms": lib["wall_ms"],
                    "library_profiler_ms": lib["ms"],
                    **flash_bound(B, H, KH, S, dh, dtype, causal, window)})
        out[name] = res
        del q, k, v
    out["held_launches"] = held
    emit({"phase": "kernels_flash", "flash_attention": out})
    return out


# ---------------------------------------------------------------------------
# phase 14: qwen3-4b prefill + decode serving on the card
# ---------------------------------------------------------------------------


def phase_lm_serve(seed: int, n_layers: int, decode_steps: int) -> dict:
    """Seeded random weights at the published widths; a prefill of
    LM_BATCH x LM_PROMPT seeded random tokens through the flash kernel
    (counts reset just before and read just after), then greedy decode
    steps; the same prefill through the plain-torch attention backend,
    held at the reference's bf16 bar for two computations of the same
    logits (atol 0.15, rtol 0.1) with equal greedy first tokens."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.transformer import (init_decode_state,
                                                init_model, param_bytes)
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_arch(LM_ARCH)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    B, S, T = LM_BATCH, LM_PROMPT, LM_PROMPT + decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = param_bytes(params)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    prefill = make_prefill_step(cfg, ShapeConfig("lm_prefill", S, B,
                                                 "prefill"))
    decode = make_decode_step(cfg, ShapeConfig("lm_decode", T, B, "decode"))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    warm_s = timed(lambda: prefill(params, batch))[1]   # cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    (last, caches), prefill_s = timed(lambda: prefill(params, batch))
    launches = dict(cuda_lib.LAUNCHES)
    check(launches["flash_attention_tc"] == cfg.n_layers
          and launches["flash_attention"] == 0,
          f"lm_serve: {launches['flash_attention_tc']} bf16 and "
          f"{launches['flash_attention']} float32 flash launches per "
          f"prefill, expected {cfg.n_layers} and 0")
    check(last.shape == (B, 1, cfg.vocab_padded),
          f"lm_serve: prefill logits {tuple(last.shape)}")
    check(bool(torch.isfinite(last.float()).all()),
          "lm_serve: non-finite prefill logits")

    state = init_decode_state(cfg, T, B)
    for kv in ("k", "v"):
        state[kv][:, :, :, :S] = caches[kv]
    cache_bytes = param_bytes(state)
    del caches
    nxt = last[:, 0].argmax(-1)
    first = nxt.clone()
    step_s, generated = [], [nxt]
    for i in range(decode_steps):
        (lg, state), s = timed(lambda: decode(
            params, {"tokens": nxt[:, None], "cur_len": S + i}, state))
        check(bool(torch.isfinite(lg.float()).all()),
              f"lm_serve: non-finite logits at decode step {i}")
        nxt = lg[:, 0].argmax(-1)
        generated.append(nxt)
        step_s.append(s)
    peak = torch.cuda.max_memory_allocated()
    # one more decode step under the profiler (rewriting the last slot)
    decode_prof = profile_batch(lambda: decode(
        params, {"tokens": nxt[:, None], "cur_len": T - 1}, state))
    del state

    prof = profile_batch(lambda: prefill(params, batch))

    twin = make_prefill_step(cfg, ShapeConfig("lm_prefill", S, B, "prefill"),
                             backend="torch")
    (t_last, t_caches), twin_s = timed(lambda: twin(params, batch))
    del t_caches
    a, b = last[:, 0].float(), t_last[:, 0].float()
    diff = (a - b).abs()
    max_abs = diff.max().item()
    rel_l2 = ((a - b).norm() / b.norm()).item()
    within = bool(torch.allclose(a, b, atol=0.15, rtol=0.1))
    same_first = bool(torch.equal(first, b.argmax(-1)))
    check(within, f"lm_serve: kernel and torch-backend prefill logits "
                  f"differ past atol 0.15 / rtol 0.1 (max abs {max_abs}, "
                  f"rel L2 {rel_l2})")
    check(same_first, f"lm_serve: greedy first tokens differ "
                      f"({first.tolist()} vs {b.argmax(-1).tolist()})")

    decode_s = sum(step_s)
    res = {
        "phase": "lm_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
        "vocab_padded": cfg.vocab_padded, "requests": B,
        "prompt_tokens": S, "decode_steps": decode_steps,
        "param_count": cfg.param_count(), "weight_bytes": weight_bytes,
        "kv_cache_bytes": cache_bytes, "peak_device_bytes": int(peak),
        "init_s": init_s, "warmup_prefill_s": warm_s,
        "prefill_s": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
        "decode_s_per_step": decode_s / max(decode_steps, 1),
        "decode_step_s": step_s,
        "decode_tokens_per_s": B * decode_steps / decode_s
        if decode_steps else None,
        "launches": launches, "prefill_profile": prof,
        "decode_profile": decode_prof,
        "torch_backend_prefill_s": twin_s,
        "vs_torch_backend": {"max_abs": max_abs, "rel_l2": rel_l2,
                             "atol": 0.15, "rtol": 0.1,
                             "within": within,
                             "same_greedy_first_token": same_first},
        "greedy_tokens": torch.stack(generated, 1).tolist()}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 15: the other LM families' prefill + decode on the card
# ---------------------------------------------------------------------------

LM_FAMILIES = (
    # arch, layers on the card (None: full depth), requests, prompt
    # tokens, decode steps.  mixtral-8x22b (56 layers of ~5.0 GB) and
    # qwen2-vl-72b (80 of ~1.76 GB, 5.0 GB of embedding and head) do not
    # fit in 80 GB: each runs the most layers that leave ~15 GB for the
    # activations, the torch-backend twin's prefill and the caches
    # (PERF.md, section 4)
    ("granite-moe-3b-a800m", None, 2, 2048, 16),
    ("mixtral-8x22b", 12, 1, 8192, 8),
    ("qwen2-vl-72b", 32, 2, 2048, 16),
    ("seamless-m4t-medium", None, 2, 2048, 16),
    ("zamba2-1.2b", None, 2, 2048, 16),
    ("xlstm-125m", None, 2, 2048, 16),
)
VLM_GRID = 32                  # the image prefix: one frame of 32 x 32 patches
LM_BAR = dict(atol=0.15, rtol=0.1)
# The hybrid and SSM configs' stepwise decode and their prefill differ
# past LM_BAR in the JAX package itself at full depth (the prefill's
# causal convs round in bf16, the decode's sum in float32, the chunked
# scans sum in other orders, over 38 / 12 bf16 layers): relative L2 up to
# 0.053 (zamba2) and 0.125 (xlstm) at positions 0-3
# (tests/test_torch_full_depth.py), while in float32 they agree to 1e-4.
# Their stepwise checks are held at a relative L2 bar that the sound
# decode stays under and each planted fault of `STEPWISE_FAULTS` passes.
STEPWISE_REL_L2 = {"zamba2-1.2b": 0.12, "xlstm-125m": 0.25}
# Faulty decodes driven through the same entry points, each of which the
# stepwise check must catch: the state is not carried from step to step
# (every step starts from the zero state), or the decode reads the
# prompt one token ahead.  Position 0 is the same under the first.
STEPWISE_FAULTS = ("state_not_carried", "one_token_ahead")


def flash_launches(cfg) -> int:
    """Self-attentions a prefill runs: one a layer (dense, MoE, VLM), one
    an encoder and a decoder layer (enc-dec; cross-attention runs the
    plain walk), one a shared-block application (hybrid), none (SSM)."""
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def self_attention_shapes(cfg, B: int, S: int) -> list:
    """(label, B, H, KH, S, dh, causal, window) of each distinct
    self-attention a prefill of B x S tokens runs through the kernel: the
    encoder's over S / enc_seq_div frames, non-causal (enc-dec); none
    (SSM)."""
    if cfg.family == "ssm":
        return []
    heads = (B, cfg.n_heads, cfg.n_kv_heads)
    if cfg.family == "encdec":
        return [("encoder", *heads, S // cfg.enc_seq_div, cfg.head_dim,
                 False, cfg.window),
                ("decoder", *heads, S, cfg.head_dim, True, cfg.window)]
    return [("self", *heads, S, cfg.head_dim, True, cfg.window)]


def family_flash(cfg, B: int, S: int, seed: int) -> dict:
    """The kernel at each of the config's self-attention shapes, on seeded
    inputs laid out as the model passes them: held by `hold_flash` against
    both twins, then timed (CUDA events) beside SDPA and its bound."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for label, B, H, KH, S, dh, causal, window in self_attention_shapes(
            cfg, B, S):
        q, k, v = flash_inputs(B, H, KH, S, dh, "bfloat16", True, gen)
        kw = dict(causal=causal, window=window)
        res = {"shape": [B, H, KH, S, dh], "causal": causal,
               "window": window,
               **hold_flash(f"{cfg.name}:{label}", q, k, v, **kw)}
        t = kernel_times(lambda: flash_attention(q, k, v, **kw),
                         one_launch=True)
        lib = kernel_times(sdpa_call(q, k, v, **kw))
        bnd = flash_bound(B, H, KH, S, dh, "bfloat16", causal, window)
        res.update(ms=t["wall_ms"], timing="events",
                   library_ms=lib["wall_ms"], bound_ms=bnd["bound_ms"],
                   bound_by=bnd["bound_by"])
        out[label] = res
        del q, k, v
    torch.cuda.empty_cache()
    return out


def vlm_positions(B: int, S: int, n_img: int, grid_w: int, dev):
    """M-RoPE (t, h, w) positions (B, S, 3): the image prefix on a grid of
    one frame, `grid_w` wide, the text after it at max + 1 + i."""
    import torch
    i = torch.arange(S, device=dev)
    img = i < n_img
    start = max((n_img - 1) // grid_w, min(n_img, grid_w) - 1) + 1
    text = start + i - n_img
    pos = torch.stack([torch.where(img, 0, text),
                       torch.where(img, i // grid_w, text),
                       torch.where(img, i % grid_w, text)], dim=-1)
    return pos.to(torch.int32)[None].expand(B, S, 3).contiguous()


def family_batch(cfg, B: int, S: int, gen, dev) -> dict:
    """Seeded tokens, and the family's inputs: M-RoPE positions and image
    embeddings (VLM), S / enc_seq_div encoder frames (enc-dec)."""
    import torch
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=dev)}

    def emb(n):
        return (torch.randn(B, n, cfg.d_model, generator=gen, device=dev)
                * 0.02).to(torch.bfloat16)

    if cfg.family == "vlm":
        batch["positions"] = vlm_positions(B, S, cfg.n_image_tokens,
                                           VLM_GRID, dev)
        batch["image_embeds"] = emb(cfg.n_image_tokens)
    if cfg.family == "encdec":
        batch["enc_embeds"] = emb(S // cfg.enc_seq_div)
    return batch


def _bar(a, b) -> dict:
    import torch
    a, b = a.float(), b.float()
    return {"max_abs": (a - b).abs().max().item(),
            "rel_l2": ((a - b).norm() / b.norm()).item(),
            "within": bool(torch.allclose(a, b, **LM_BAR))}


def faulty_decode(decode, params, cfg, batch, steps: int, fault: str,
                  dev) -> list:
    """Last-position logits of `steps` decode steps over the prompt from
    the zero state, with one of `STEPWISE_FAULTS` planted through the
    entry points: `state_not_carried` gives every step a fresh zero
    state, `one_token_ahead` feeds step i the prompt's token i + 1."""
    from repro_torch.models.transformer import init_decode_state
    B = batch["tokens"].shape[0]
    state, out = init_decode_state(cfg, steps, B, device=dev), []
    for i in range(steps):
        if fault == "state_not_carried":
            state = init_decode_state(cfg, steps, B, device=dev)
        t = i + 1 if fault == "one_token_ahead" else i
        lg, state = decode(params, {"tokens": batch["tokens"][:, t:t + 1],
                                    "cur_len": i}, state)
        out.append(lg[:, 0])
    return out


def phase_lm_family(arch: str, n_layers, B: int, S: int, steps: int,
                    seed: int) -> dict:
    """One config at its published widths on seeded random bf16 weights.
    First the flash kernel alone at each of its self-attention shapes,
    held against both twins (`family_flash`).  Then a prefill through the
    kernel (counts reset just before and read just after; exactly
    `flash_launches(cfg)` bf16 launches and nothing else), held against
    the plain-torch attention backend at the reference's bf16 bar with
    equal greedy first tokens; then decode steps: greedy from the
    prefill's caches (KV families), or from the zero state over the
    prompt's first tokens, each held against the prefill's logits at its
    position, and each of `STEPWISE_FAULTS` shown to fail that check
    (hybrid, SSM: the reference's prefill hands no recurrent state to
    decode)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.transformer import (forward, init_decode_state,
                                                init_model, param_bytes)
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_arch(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    want_flash = flash_launches(cfg)
    fam, dev = cfg.family, torch.device(DEVICE)
    recurrent = fam in ("hybrid", "ssm")
    T = steps if recurrent else S + steps

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    kernel_at_shapes = family_flash(cfg, B, S, seed + 2)
    params, init_s = timed(lambda: init_model(cfg, seed=seed, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = family_batch(cfg, B, S, gen, dev)
    prefill = make_prefill_step(cfg, ShapeConfig(f"{arch}_prefill", S, B,
                                                 "prefill"), device=dev)
    decode = make_decode_step(cfg, ShapeConfig(f"{arch}_decode", T, B,
                                               "decode"), device=dev)
    warm_s = timed(lambda: prefill(params, batch))[1]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    (last, caches), prefill_s = timed(lambda: prefill(params, batch))
    launches = dict(cuda_lib.LAUNCHES)
    check(launches["flash_attention_tc"] == want_flash
          and sum(launches.values()) == want_flash,
          f"{arch}: launches a prefill {launches}, expected "
          f"{want_flash} flash_attention_tc and nothing else")
    check(last.shape == (B, 1, cfg.vocab_padded)
          and bool(torch.isfinite(last.float()).all()),
          f"{arch}: prefill logits {tuple(last.shape)} or not finite")
    first = last[:, 0].argmax(-1)

    twin = make_prefill_step(cfg, ShapeConfig(f"{arch}_prefill", S, B,
                                              "prefill"), device=dev,
                             backend="torch")
    (t_last, t_caches), twin_s = timed(lambda: twin(params, batch))
    del t_caches
    vs_twin = _bar(last[:, 0], t_last[:, 0])
    tw = t_last[:, 0].float()
    # the twin's logit at its own greedy token less at the kernel's: 0
    # when they agree; random weights leave near-ties among the top
    # logits, so a differing token must be a tie at the bar's atol
    gap = tw.max(-1).values - tw.gather(-1, first[:, None])[:, 0]
    vs_twin.update(same_greedy_first_token=bool(
        torch.equal(first, tw.argmax(-1))), greedy_gap=gap.tolist())
    check(vs_twin["within"], f"{arch}: kernel and torch-backend prefill "
                             f"logits differ past atol 0.15 / rtol 0.1 "
                             f"({vs_twin})")
    check(bool((gap <= LM_BAR["atol"]).all()),
          f"{arch}: greedy first tokens differ by more than a tie at "
          f"atol 0.15 ({vs_twin})")

    state = init_decode_state(cfg, T, B, device=dev)
    if not recurrent:
        for kv in ("k", "v"):
            state[kv][:, :, :, :S] = caches[kv]
        if fam == "encdec":      # the prefill's frames, all of them
            state["cross_k"] = caches["cross_k"]
            state["cross_v"] = caches["cross_v"]
    del caches
    state_bytes = param_bytes(state)
    nxt = first
    step_s, generated = [], []
    for i in range(steps):
        cur = i if recurrent else S + i
        tok = batch["tokens"][:, i] if recurrent else nxt
        db = {"tokens": tok[:, None], "cur_len": cur}
        if fam == "vlm":
            db["positions"] = vlm_positions(B, cur + 1, cfg.n_image_tokens,
                                            VLM_GRID, dev)[:, cur:cur + 1]
        (lg, state), s = timed(lambda: decode(params, db, state))
        check(bool(torch.isfinite(lg.float()).all()),
              f"{arch}: non-finite logits at decode step {i}")
        nxt = lg[:, 0].argmax(-1)
        generated.append(lg[:, 0] if recurrent else nxt)
        step_s.append(s)
    stepwise, faults = None, None
    if recurrent:
        full = forward(params, cfg, batch)[0][:, :steps].clone()
        stepwise = [_bar(lg, full[:, i]) for i, lg in enumerate(generated)]
        generated = [lg.argmax(-1) for lg in generated]
        faults = {f: [_bar(lg, full[:, i]) for i, lg in enumerate(
            faulty_decode(decode, params, cfg, batch, steps, f, dev))]
            for f in STEPWISE_FAULTS}
        del full
        bar = STEPWISE_REL_L2[arch]
        worst = max(r["rel_l2"] for r in stepwise)
        caught = {f: max(r["rel_l2"] for r in rs) for f, rs in
                  faults.items()}
        print(json.dumps({"stepwise": arch, "bar": bar, "sound": [
            r["rel_l2"] for r in stepwise], "faults": {
            f: [r["rel_l2"] for r in rs] for f, rs in faults.items()}}),
            flush=True)
        check(worst <= bar, f"{arch}: a decode step differs from the "
                            f"prefill's logits at its position past "
                            f"relative L2 {bar} ({stepwise})")
        check(all(w > bar for w in caught.values()),
              f"{arch}: a planted decode fault stays within relative L2 "
              f"{bar} ({caught}): the check cannot tell it from a sound "
              f"decode")
    peak = torch.cuda.max_memory_allocated()
    decode_prof = profile_batch(lambda: decode(params, db, state))
    del state
    prefill_prof = profile_batch(lambda: prefill(params, batch))
    drop = None
    if fam == "moe":
        drop = forward(params, cfg, batch)[1]["moe_drop_frac"].item()
    decode_s = sum(step_s)
    res = {"phase": "lm_families", "arch": arch, "family": fam,
           "n_layers": cfg.n_layers, "published_layers": full_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.head_dim, "window": cfg.window,
           "vocab_padded": cfg.vocab_padded, "requests": B,
           "prompt_tokens": S, "decode_steps": steps,
           "decode_from": "zero state over the prompt" if recurrent
           else "prefill caches",
           "param_count": cfg.param_count(),
           "weight_bytes": param_bytes(params),
           "decode_state_bytes": state_bytes,
           "peak_device_bytes": int(peak), "init_s": init_s,
           "warmup_prefill_s": warm_s, "prefill_s": prefill_s,
           "prefill_tokens_per_s": B * S / prefill_s,
           "torch_backend_prefill_s": twin_s,
           "decode_s_per_step": decode_s / steps, "decode_step_s": step_s,
           "moe_drop_frac": drop, "launches": launches,
           "vs_torch_backend": {**vs_twin, **LM_BAR},
           "stepwise_vs_prefill": stepwise,
           "stepwise_rel_l2_bar": STEPWISE_REL_L2.get(arch),
           "stepwise_faults": faults,
           "kernel_at_shapes": kernel_at_shapes,
           "prefill_profile": prefill_prof, "decode_profile": decode_prof,
           "greedy_first_tokens": first.tolist(),
           "greedy_tokens": torch.stack(generated, 1).tolist()}
    emit(res)
    del params, batch, last, t_last
    torch.cuda.empty_cache()
    return res


def phase_lm_families(seed: int, only=None) -> dict:
    """Each config of `LM_FAMILIES` (or the names in `only`) one after
    another, each freed before the next; returns the flash launches of
    each config's counted prefill."""
    out = {}
    for arch, layers, B, S, steps in LM_FAMILIES:
        if only and arch not in only:
            continue
        out[arch] = phase_lm_family(arch, layers, B, S, steps, seed)
    return {"launches": {a: r["launches"] for a, r in out.items()},
            "kernel_at_shapes": {a: r["kernel_at_shapes"]
                                 for a, r in out.items()}}


# ---------------------------------------------------------------------------
# phase 16: LM training on the card
# ---------------------------------------------------------------------------

LM_TRAIN_ARCH = "qwen3-4b"
LM_TRAIN_SEQ = 4096            # train_4k's sequence length
LM_TRAIN_BATCH = 8             # global batch: its microbatch 8 of 1 x 4,096
LM_TRAIN_STEPS = 3             # timed steps, after one warm step
LM_TRAIN_FREE = 20e9           # bytes left free: activations and logits
LM_TRAIN_MAX_LAYERS = 16       # the script's time: ~3.5 s a layer (four
                               # steps and cost_model's meta count)
                               # (~6.5 GB at qwen3-4b's widths), and room
                               # for what earlier phases fragmented
# bf16 params and microbatch gradients, float32 accumulators, master, m
# and v: the bytes a parameter holds while a step runs
LM_TRAIN_BYTES_PER_PARAM = 2 + 2 + 4 + 4 + 4 + 4
LM_TRAIN_LAUNCHER = ["--arch", "qwen3-4b", "--steps", "6", "--ckpt-every",
                     "3"]      # the reduced config, the launcher's batch
LM_TRAIN_LOSS_RTOL = 1e-3      # training loss against the served loss
LM_TRAIN_ADAMW_RTOL = 1e-6     # AdamW card against CPU: master, m, v


def train_depth(cfg, free_bytes: float) -> int:
    """The most layers (at most the published depth) whose training state
    leaves `LM_TRAIN_FREE` bytes of `free_bytes`: the embedding (tied) and
    final norm, and each layer, at `LM_TRAIN_BYTES_PER_PARAM`."""
    import dataclasses
    fixed = cfg.vocab_padded * cfg.d_model + cfg.d_model
    per_layer = (dataclasses.replace(cfg, n_layers=1).param_count()
                 - dataclasses.replace(cfg, n_layers=0).param_count())
    room = free_bytes - LM_TRAIN_FREE - fixed * LM_TRAIN_BYTES_PER_PARAM
    return max(1, min(cfg.n_layers,
                      int(room // (per_layer * LM_TRAIN_BYTES_PER_PARAM))))


def _rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def adamw_card_vs_cpu(opt_cfg, grad, param, state: dict) -> dict:
    """One `adamw_update` of a single leaf (its gradient, param and state)
    on the card and on copies on the CPU: relative L2 of the new master, m
    and v, and the two grad norms and learning rates.  The new bf16 param
    is the master rounded to bf16, so a last-bit difference of a master
    can flip its rounding: params must equal their own master's rounding
    on each side, and each param that differs between the sides must sit
    on a master that differs, one bf16 step away (`param_flips`
    counts them)."""
    import torch
    from repro_torch.optim.adamw import adamw_update

    def run(dev):
        st = {k: ({"w": v.to(dev, copy=True)} if k != "step"
                  else v.to(dev, copy=True)) for k, v in state.items()}
        p, st, stats = adamw_update(opt_cfg, {"w": grad.to(dev)}, st,
                                    {"w": param.to(dev, copy=True)})
        return {"param": p["w"].cpu(), **{k: st[k]["w"].cpu() for k in
                                          ("master", "m", "v")}}, stats

    card, cs = run(DEVICE)
    host, hs = run("cpu")
    rel = {k: _rel_l2(card[k], host[k]) for k in ("master", "m", "v")}
    flips = card["param"] != host["param"]
    steps = (card["param"].view(torch.int16).int()
             - host["param"].view(torch.int16).int()).abs()[flips]
    rounding = all(torch.equal(side["param"],
                               side["master"].to(side["param"].dtype))
                   for side in (card, host))
    explained = bool((card["master"][flips] != host["master"][flips]).all()
                     and (steps <= 1).all())
    return {"numel": grad.numel(), "rel_l2": rel,
            "param_flips": int(flips.sum()),
            "grad_norm": [cs["grad_norm"].item(), hs["grad_norm"].item()],
            "lr": [cs["lr"].item(), hs["lr"].item()],
            "within": max(rel.values()) <= LM_TRAIN_ADAMW_RTOL
            and rounding and explained}


def run_launcher(ckpt_dir: Path) -> dict:
    """The training launcher at the reduced config on the card: 6 steps
    checkpointed every 3, then a run resumed from step 3 (the step-6
    checkpoint removed), whose losses must equal the uninterrupted run's
    within `LM_TRAIN_LOSS_RTOL` (the embedding's backward adds with
    atomics on the card, so not bit for bit)."""
    from repro_torch.launch import train as launch_train
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = LM_TRAIN_LAUNCHER + ["--ckpt-dir", str(ckpt_dir), "--device",
                                DEVICE]
    try:
        full = launch_train.main(argv)
        for sub in (ckpt_dir, ckpt_dir / "opt"):
            shutil.rmtree(sub / "step_00000006")
        resumed = launch_train.main(argv + ["--resume"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check([h["step"] for h in full] == list(range(6))
          and [h["step"] for h in resumed] == [3, 4, 5],
          f"lm_train: the launcher ran steps {[h['step'] for h in full]} "
          f"and resumed {[h['step'] for h in resumed]}")
    rel = [abs(b["loss"] - a["loss"]) / abs(a["loss"])
           for a, b in zip(full[3:], resumed)]
    return {"losses": [h["loss"] for h in full],
            "resumed_losses": [h["loss"] for h in resumed],
            "resumed_rel": rel, "step_s": [h["seconds"] for h in full],
            "within": max(rel) <= LM_TRAIN_LOSS_RTOL}


def phase_lm_train(seed: int, n_layers=None) -> dict:
    """qwen3-4b at its published widths on seeded random bf16 weights, as
    deep as the card's memory allows (`train_depth`, or `n_layers`),
    trained on one seeded batch of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens by
    `make_train_step` (its own remat "full" and microbatch 8; attention on
    the plain-torch walk, the flash kernel having no backward): one warm
    step under the profiler, then LM_TRAIN_STEPS timed steps, every launch
    count reset just before and read just after each (all must be 0).
    The phase's line is printed before its checks.  Holds (a) the first step's loss to the served loss
    (the flash kernel's forward under no_grad) on the same weights and
    batch, (b) the loss falling, (c) AdamW on the card to AdamW on the CPU
    for one leaf, (d) the learning rate to `lr_at`, (e) the launcher's
    resumed run to its uninterrupted one."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch, reduced_config
    from repro_torch.dist import roofline
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.transformer import init_model, lm_loss, \
        param_bytes
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state, lr_at
    from repro_torch.train.steps import make_grad_step, make_train_step

    published = get_arch(LM_TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held_before = torch.cuda.memory_allocated()
    depth = n_layers or min(train_depth(published, free),
                            LM_TRAIN_MAX_LAYERS)
    cfg = dataclasses.replace(published, n_layers=depth)
    B, S, mb = LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.microbatch
    dev = torch.device(DEVICE)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(lambda: init_model(cfg, seed=seed, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=dev)}

    # (a)'s reference: the served forward (the bf16 flash kernel) under
    # no_grad, one microbatch at a time, their losses summed and averaged
    # as the train step sums and averages them
    cuda_lib.reset_launches()
    with torch.no_grad():
        served, served_s = timed(lambda: sum(
            lm_loss(params, cfg, {"tokens": batch["tokens"][j:j + 1]},
                    backend="cuda")[0] for j in range(B)) / mb)
    served_launches = dict(cuda_lib.LAUNCHES)
    check(served_launches["flash_attention_tc"] == depth * B,
          f"lm_train: the served loss launched "
          f"{served_launches['flash_attention_tc']} bf16 flash kernels, "
          f"expected {depth * B}")

    opt = init_opt_state(params)
    weight_bytes, opt_bytes = param_bytes(params), param_bytes(opt)
    step = make_train_step(cfg, ShapeConfig("train_4k_cut", S, B, "train"),
                           opt_cfg, device=dev)
    history = []

    def run_step():
        nonlocal params, opt
        params, opt, m = step(params, opt, batch)
        history.append({k: v.item() for k, v in m.items()})

    # the warm step (cuBLAS, the allocator) is the profiled one: at ~1e5
    # launches a step its own warm-up is a small part of it
    cuda_lib.reset_launches()
    _, prof = profile_step(run_step)
    warm_launches = dict(cuda_lib.LAUNCHES)
    cuda_lib.reset_launches()
    step_s = [timed(run_step)[1] for _ in range(LM_TRAIN_STEPS)]
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # (c): one leaf's gradient from one microbatch, with its real state
    name = ("blocks", "attn", "wk")
    grad_step = make_grad_step(dataclasses.replace(cfg, microbatch=1),
                               ShapeConfig("one_microbatch", S, 1, "train"),
                               device=dev)
    _, _, grads = grad_step(params, {"tokens": batch["tokens"][:1]})
    leaf = grads[name[0]][name[1]][name[2]]
    del grads
    pick = lambda t: t[name[0]][name[1]][name[2]]       # noqa: E731
    adamw = adamw_card_vs_cpu(
        opt_cfg, leaf, pick(params),
        {"master": pick(opt["master"]), "m": pick(opt["m"]),
         "v": pick(opt["v"]), "step": opt["step"]})
    adamw["leaf"] = "/".join(name)
    del leaf, params, opt, batch
    torch.cuda.empty_cache()

    launcher = run_launcher(ROOT / "build" / "lm_train_ckpt")

    losses = [h["loss"] for h in history]
    served = served.item()
    rel_a = abs(losses[0] - served) / abs(served)
    want_lr = [lr_at(opt_cfg, i + 1).item() for i in range(len(history))]
    tokens = B * S
    mean_s = statistics.mean(step_s)
    # the model's flops at the phase's own shape and depth: 6 N T plus
    # the attention's matrix products, forward and backward
    model_flops = roofline.model_flops(
        cfg, ShapeConfig("train_4k_cut", S, B, "train"))
    res = {"phase": "lm_train", "arch": cfg.name, "n_layers": depth,
           "published_layers": published.n_layers,
           "reduced": {"n_layers": [depth, published.n_layers],
                       "why": "the script's time (at most "
                              f"{LM_TRAIN_MAX_LAYERS} layers) and the "
                              "training state at "
                              f"{LM_TRAIN_BYTES_PER_PARAM} B a parameter "
                              f"leaving {LM_TRAIN_FREE / 1e9:.0f} GB of "
                              f"{free / 1e9:.2f} GB free (memory alone: "
                              f"{train_depth(published, free)} layers)"},
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
           "vocab_padded": cfg.vocab_padded, "seq_len": S,
           "global_batch": B, "microbatch": mb, "remat": cfg.remat,
           "attention": "torch (plain walk)", "tokens_per_step": tokens,
           "param_count": cfg.param_count(), "weight_bytes": weight_bytes,
           "opt_state_bytes": opt_bytes, "free_bytes_before": free,
           "allocated_bytes_before": held_before,
           "total_bytes": total, "peak_device_bytes": int(peak),
           "init_s": init_s, "served_loss_s": served_s,
           "step_s": step_s, "s_per_step": mean_s,
           "tokens_per_s": tokens / mean_s,
           "model_flops_per_step": model_flops,
           "model_tflops_per_s": model_flops / mean_s / 1e12,
           "mfu": model_flops / (mean_s * roofline.PEAK_FLOPS),
           "steps": history, "lr_at": want_lr, "served_loss": served,
           "loss_vs_served_rel": rel_a, "served_launches": served_launches,
           "launches": launches, "warm_step_launches": warm_launches,
           "warm_step_profile": prof, "adamw_card_vs_cpu": adamw,
           "launcher": launcher}
    emit(res)
    check(sum(launches.values()) == 0 and sum(warm_launches.values()) == 0,
          f"lm_train: a train step launched {launches} / {warm_launches}; "
          f"the flash kernel has no backward and no kernel may run in "
          f"training")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in history),
          f"lm_train: non-finite loss or grad norm {history}")
    check(rel_a <= LM_TRAIN_LOSS_RTOL,
          f"lm_train: first step's loss {losses[0]} against the served "
          f"loss {served} (relative {rel_a}) past {LM_TRAIN_LOSS_RTOL}")
    check(losses[-1] < losses[0],
          f"lm_train: the loss did not fall over the repeated batch "
          f"({losses})")
    check([h["lr"] for h in history] == want_lr,
          f"lm_train: lr {[h['lr'] for h in history]} against lr_at "
          f"{want_lr}")
    check(adamw["within"], f"lm_train: AdamW on the card and on the CPU "
                           f"differ past {LM_TRAIN_ADAMW_RTOL} ({adamw})")
    check(launcher["within"], f"lm_train: the resumed launcher's losses "
                              f"differ past {LM_TRAIN_LOSS_RTOL} "
                              f"({launcher})")
    return res


# ---------------------------------------------------------------------------
# phase 17: the cost model, counted on the card
# ---------------------------------------------------------------------------

COST_LM_LAYERS = 4             # depth of the card-against-meta LM counts
SHARE_LIMIT = 1.05             # a share above this is a counting fault


def _count(step, *args):
    """`step(*args)` under a fresh `StepCounter` with its op log, every
    launch count reset just before; (output, counter, launches)."""
    import torch
    from repro_torch.dist.hlo_analysis import StepCounter
    from repro_torch.kernels import cuda_lib
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with StepCounter(op_log=True) as counter:
        out = step(*args)
    return out, counter, dict(cuda_lib.LAUNCHES)


def _on_meta(tree):
    """`tree` (tensors in dicts, lists, tuples, dataclasses) with every
    tensor replaced by an empty one of its shape, dtype and strides on
    meta."""
    import dataclasses
    import torch
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tree.stride(),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _on_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_meta(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return dataclasses.replace(tree, **{
            k: _on_meta(getattr(tree, k)) for k in tree.__dataclass_fields__})
    return tree


def _hold_counts(name: str, card, meta, launches: dict,
                 per_call: dict = None) -> dict:
    """The card's count of a step against meta's: totals and calls of
    every op name equal, each kernel's launches equal to its calls times
    its launches a call (`per_call`, 1 unless named: the paged match
    launches twice a call)."""
    per_call = per_call or {}
    got, want = card.analyze(), meta.analyze()
    ops_card, ops_meta = dict(card.op_counts), dict(meta.op_counts)
    diff = {k: (ops_card.get(k), ops_meta.get(k))
            for k in set(ops_card) | set(ops_meta)
            if ops_card.get(k) != ops_meta.get(k)}
    check(got == want and not diff,
          f"cost_model {name}: card count {got} != meta count {want}; "
          f"op calls that differ (card, meta): {diff}")
    calls = dict(card.kernel_calls)
    for key, n in launches.items():
        check(calls.get(key, 0) * per_call.get(key, 1) == n,
              f"cost_model {name}: {calls.get(key, 0)} counted calls of "
              f"{key} ({per_call.get(key, 1)} launches each) against {n} "
              f"launches")
    return {"flops": got["flops"], "bytes": got["bytes"],
            "ops": sum(ops_card.values()), "op_names": len(ops_card),
            "kernel_calls": calls, "launches": {k: v for k, v in
                                                launches.items() if v}}


def _kernel_bytes_vs_bounds(counters, curve) -> dict:
    """Every kernel op a counter logged against the bound's work at its
    shapes: flash `flash_bound`'s flops and bytes, the encode
    `encode_work`, the split `split_work`, the window kernels the bound's
    bytes with every slot valid (the bound itself counts the valid slots of
    its data), the paged
    filter's and match's over min(Qc * C, P) distinct pages
    (`filter_work_paged`, `match_work_paged`)."""
    from repro_torch.core.curve import curve_tables
    from repro_torch.kernels.sfc_encode.ops import split_work
    from repro_torch.kernels.window_filter.ops import (filter_work_paged,
                                                       match_work_paged)
    out = {}
    for counter in counters:
        for r in counter.op_log():
            if not r["op"].startswith("repro_torch."):
                continue
            key = r["op"][len("repro_torch."):]
            shapes, n = r["shapes"], r["count"]
            if key == "flash_attention_tc":
                (B, H, S, dh), KH = shapes[0], shapes[1][1]
                b = flash_bound(B, H, KH, S, dh, "bfloat16", True, 0)
                want = (n * b["flops"], n * b["bytes"])
            elif key in ("sfc_encode", "split_zranges"):
                pos, reg = curve_tables(curve, "cpu")
                M = int((reg < curve.d * curve.K).sum())
                if key == "sfc_encode":
                    x_n, d = shapes[0]
                    work = encode_work(x_n, d, curve.K, pos.shape[0], M)
                else:
                    (Q, d, _), (_, S) = shapes
                    work = split_work(Q, d, curve.K, pos.shape[0], M,
                                      S.bit_length() - 1)
                want = (0, n * work)
            elif key == "window_filter" and len(shapes) == 5:
                (P, d, cap), _, _, (Qc, C), _ = shapes
                want = (0, n * filter_work_paged(P, Qc, C, d, cap))
            elif key == "window_match" and len(shapes) == 6:
                (P, d, cap), _, _, (Qc, C), _, (_, H) = shapes
                want = (0, n * match_work_paged(P, Qc, C, d, cap, H))
            else:
                (G, d, cap) = shapes[0]
                out_bytes = G * 4 if key == "window_filter" else G * cap
                want = (0, n * ((G * cap) * d * 4 + G * d * 2 * 4 + G * 4
                                + out_bytes))
            ok = (r["flops"], r["bytes"]) == want
            check(ok, f"cost_model: {key} counted {r['flops']} flops, "
                      f"{r['bytes']} bytes at {shapes}; its bound's work "
                      f"is {want}")
            row = out.setdefault(key, {"calls": 0, "bytes": 0,
                                       "bound_bytes": 0})
            row["calls"] += n
            row["bytes"] += r["bytes"]
            row["bound_bytes"] += want[1]
    return out


def _share(cfg, shape, run: dict, measured_s: float) -> dict:
    """A measured step against its meta dry run at the H100's ceilings."""
    from repro_torch.dist import roofline as rl
    cost = run["counter"].analyze()
    roof = rl.analyze(cost, run["memory_stats"])
    mf = rl.model_flops(cfg, shape) if cfg is not None else None
    share = max(roof.compute_s, roof.memory_s) / measured_s
    return {"model_flops": mf, "counted_flops": cost["flops"],
            "counted_bytes": cost["bytes"], "compute_s": roof.compute_s,
            "memory_s": roof.memory_s, "dominant": roof.dominant,
            "measured_s": measured_s,
            "mfu": mf / (measured_s * rl.PEAK_FLOPS) if mf else None,
            "roofline_share": share,
            "useful_flops_ratio": mf / max(cost["flops"], 1.0)
            if mf else None,
            "memory_stats": run["memory_stats"],
            "count_s": run["seconds"]}


def phase_cost_model(seed: int, served: dict, lm: dict,
                     train: dict) -> dict:
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import roofline as rl
    from repro_torch.dist.hlo_analysis import tensor_bytes
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.models.transformer import init_decode_state, init_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    published = get_arch(LM_ARCH)
    cfg = dataclasses.replace(published, n_layers=COST_LM_LAYERS)
    B, S = LM_BATCH, LM_PROMPT
    T = lm["prompt_tokens"] + lm["decode_steps"]
    pre_shape = ShapeConfig("lm_prefill", S, B, "prefill")
    dec_shape = ShapeConfig("lm_decode", T, B, "decode")
    held = {}

    # --- LM: a prefill and a decode step, on the card and on meta --------
    params = init_model(cfg, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device="cuda")}
    prefill = make_prefill_step(cfg, pre_shape)
    (last, caches), card, launches = _count(prefill, params, batch)
    m_params, m_batch = _on_meta(params), _on_meta(batch)
    _, meta, _ = _count(make_prefill_step(cfg, pre_shape, device="meta"),
                        m_params, m_batch)
    held["prefill"] = _hold_counts("prefill", card, meta, launches)
    check(launches["flash_attention_tc"] == COST_LM_LAYERS,
          f"cost_model: {launches['flash_attention_tc']} flash launches in "
          f"a {COST_LM_LAYERS}-layer prefill")
    counters = [card]

    state = init_decode_state(cfg, T, B)
    for kv in ("k", "v"):
        state[kv][:, :, :, :S] = caches[kv]
    del caches
    step = {"tokens": last[:, 0].argmax(-1)[:, None], "cur_len": S}
    _, card, launches = _count(make_decode_step(cfg, dec_shape), params,
                               step, state)
    m_state = init_decode_state(cfg, T, B, device="meta")
    _, meta, _ = _count(make_decode_step(cfg, dec_shape, device="meta"),
                        m_params, _on_meta(step), m_state)
    held["decode"] = _hold_counts("decode", card, meta, launches)
    del params, state, last, batch

    # the dry run's own card route (`count_cell(device="cuda")`: seeded
    # inputs from `input_specs`, a zero decode state) against its meta
    # route, as `python -m repro_torch.launch.dryrun --device cuda` runs
    for kind, shape in (("dryrun_prefill", pre_shape),
                        ("dryrun_decode", dec_shape)):
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        card = count_cell(cfg, shape, device="cuda", seed=seed)["counter"]
        launches = dict(cuda_lib.LAUNCHES)
        meta = count_cell(cfg, shape)["counter"]
        held[kind] = _hold_counts(kind, card, meta, launches)
        del card

    # --- the main phase's Count and Range batches ---------------------------
    arrays, queries, curve = (served["arrays"], served["batch"],
                              served["curve"])
    m_arrays, m_queries = _on_meta(arrays), _on_meta(queries)
    for kind, fn in zip(("count", "range"), _fns(curve, "cuda")):
        _, card, launches = _count(fn, arrays, queries)
        _, meta, _ = _count(fn, m_arrays, m_queries)
        held[kind] = _hold_counts(kind, card, meta, launches,
                                  {"window_match": 2})
        counters.append(card)
        if kind == "count":
            count_meta = meta
    bound_check = _kernel_bytes_vs_bounds(counters, curve)
    card_s = time.perf_counter() - t_phase

    # --- shares of the measured steps ---------------------------------------
    shares = {}
    full = dataclasses.replace(published, n_layers=lm["n_layers"])
    shares["lm_serve_prefill"] = _share(
        full, pre_shape, count_cell(full, pre_shape), lm["prefill_s"])
    shares["lm_serve_decode"] = _share(
        full, dec_shape, count_cell(full, dec_shape),
        lm["decode_s_per_step"])
    tcfg = dataclasses.replace(published, n_layers=train["n_layers"])
    tshape = ShapeConfig("train_4k_cut", train["seq_len"],
                         train["global_batch"], "train")
    shares["lm_train"] = _share(tcfg, tshape, count_cell(tcfg, tshape),
                                train["s_per_step"])
    ms = shares["lm_train"]["memory_stats"]
    shares["lm_train"]["counted_peak_bytes"] = (
        ms["argument_size_in_bytes"] + ms["temp_size_in_bytes"])
    shares["lm_train"]["measured_peak_bytes"] = train["peak_device_bytes"]
    shares["lm_train"]["counted_over_measured_peak"] = (
        shares["lm_train"]["counted_peak_bytes"]
        / train["peak_device_bytes"])
    shares["main_count_batch"] = _share(None, None, {
        "counter": count_meta, "seconds": 0.0,
        "memory_stats": {"argument_size_in_bytes": tensor_bytes(
            (dataclasses.astuple(arrays), queries))}},
        served["batch_s"])
    res = {"phase": "cost_model", "card": CARD, "held": held,
           "kernel_bytes_vs_bound": bound_check,
           "ceilings": {"peak_flops": rl.PEAK_FLOPS, "hbm_bw": rl.HBM_BW,
                        "link_bw": rl.LINK_BW},
           "shares": shares,
           "reduced": {"held_lm_layers": [COST_LM_LAYERS,
                                          published.n_layers]},
           "card_counts_s": card_s,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    for name, sh in shares.items():
        check(sh["roofline_share"] <= SHARE_LIMIT
              and (sh["mfu"] is None or sh["mfu"] <= SHARE_LIMIT),
              f"cost_model: {name} reads a share above {SHARE_LIMIT} "
              f"(mfu {sh['mfu']}, roofline_share {sh['roofline_share']})")
    return res


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 18: the LM mesh, a 1 x 1 DeviceMesh over a one-rank NCCL group
# ---------------------------------------------------------------------------

LM_MESH_LAYERS = 4             # qwen3-4b's depth here (cost_model's)
LM_MESH_DECODE = 4             # sharded decode steps from the prefill
LM_MESH_MOE = ("granite-moe-3b-a800m", 2, 2048)   # full depth, B, S
LM_MESH_LOSS_RTOL = 1e-6       # sharded train loss against the unsharded
# The shard-map dispatch combines its k choices in float32 (as the
# reference's does), the global one in bf16: 32 layers on, a few tokens
# route another way, and the drop fraction moves (measured 2.7e-4
# relative).  On one layer's shared input the same pairs drop, exactly.
LM_MESH_DROP_RTOL = 1e-3
LM_MESH_LAYER_CF = 0.5         # the one-layer check's capacity: pairs drop
LM_MESH_LIMIT_S = 45.0         # the phase's time on the card


def _locals_equal(a, b) -> bool:
    """Every leaf of `a` (DTensors) equal, bit for bit, to `b`'s."""
    from repro_torch.optim.adamw import tree_leaves
    return all(x.to_local().equal(y) for x, y in zip(tree_leaves(a),
                                                      tree_leaves(b)))


def phase_lm_mesh(seed: int) -> dict:
    """The LM mesh on the card: a one-rank NCCL group (an in-process
    store) and a 1 x 1 `DeviceMesh` over it, destroyed at the end.  Every
    spec but FSDP's is replicated there and every collective is over one
    rank, so the sharded steps (DTensor params, the shard_map shim, the
    placements, NCCL) must equal the unsharded ones bit for bit: (a) a
    qwen3-4b prefill (published widths, LM_MESH_LAYERS layers, LM_BATCH x
    LM_PROMPT tokens, the bf16 flash kernel, LM_MESH_LAYERS launches) and
    its StepCounter count on the card against the same step on meta
    (equal, collective wire bytes 0); (b) LM_MESH_DECODE decode steps
    from its caches under `decode_state_specs`; (c) granite-moe at full
    depth with ``moe_dispatch="shardmap"`` (2 x 2,048 tokens) within
    LM_BAR of the global dispatch, its drop fraction within
    LM_MESH_DROP_RTOL, and one MoE layer on a shared input dropping the
    same pairs exactly (one shard holds the global capacity); (d) one qwen3-4b train step
    (LM_MESH_LAYERS layers, LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens,
    microbatch 8) with its loss within LM_MESH_LOSS_RTOL and its params
    bit for bit, no kernel launched; (e) the sharded params (and the
    step counter) checkpointed and restored with ``shardings=`` byte for
    byte.  Launch counts are reset just before each sharded run and read
    just after."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.dist.compat import to_dtensor
    from repro_torch.models.moe import moe_ffn, moe_ffn_shardmap, moe_specs
    from repro_torch.models.transformer import (forward, init_decode_state,
                                                init_model)
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.steps import (bind_runtime, make_decode_step,
                                         make_prefill_step, make_rules,
                                         make_train_step, shard_params)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device(DEVICE)
    sub_s, launches, held = {}, {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sub_s[name] = time.perf_counter() - t
        return out

    def run(name, fn):
        """`fn()` with the launch counts reset just before and read just
        after, its seconds in `sub_s`."""
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sub_s[name] = time.perf_counter() - t
        launches[name] = dict(cuda_lib.LAUNCHES)
        return out

    t = time.perf_counter()
    init_group(DEVICE)
    try:
        mesh = make_host_mesh(1, 1)
        sub_s["group"] = time.perf_counter() - t
        check(type(mesh).__name__ == "DeviceMesh"
              and mesh.device_type == dev.type,
              f"lm_mesh: make_host_mesh gave {mesh!r}")

        # (a) the prefill, and its count on the card against meta
        t = time.perf_counter()
        cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LM_MESH_LAYERS)
        B, S = LM_BATCH, LM_PROMPT
        params = init_model(cfg, seed=seed, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                         device=dev)}
        shape = ShapeConfig("lm_prefill", S, B, "prefill")
        plain = make_prefill_step(cfg, shape, device=dev)
        step = make_prefill_step(cfg, shape, mesh=mesh)
        sp = shard_params(params, step.in_shardings[0])
        l0, c0 = plain(params, batch)
        step(sp, batch)                                  # warm
        sub_s["prefill_setup"] = time.perf_counter() - t
        timed("prefill_unsharded", lambda: plain(params, batch))
        l1, c1 = run("prefill", lambda: step(sp, batch))
        prefill_equal = (l1.to_local().equal(l0) and set(c1) == set(c0)
                         and all(c1[k].to_local().equal(c0[k]) for k in c0))
        t = time.perf_counter()
        _, card, card_launches = _count(step, sp, batch)
        meta_params = shard_params(init_model(cfg, device="meta"),
                                   step.in_shardings[0])
        _, meta, _ = _count(step, meta_params, _on_meta(batch))
        held["prefill"] = _hold_counts("lm_mesh prefill", card, meta,
                                       card_launches)
        counted = card.analyze()
        held["prefill"]["wire_bytes"] = counted["wire_bytes"]
        held["prefill"]["collectives"] = counted["collectives"]
        sub_s["counts"] = time.perf_counter() - t
        del meta_params, card, meta

        # (b) decode from the prefill's caches
        T = S + LM_MESH_DECODE
        dshape = ShapeConfig("lm_decode", T, B, "decode")
        dplain = make_decode_step(cfg, dshape, device=dev)
        dstep = make_decode_step(cfg, dshape, mesh=mesh)
        s0 = init_decode_state(cfg, T, B, device=dev)
        for k in c0:
            s0[k][..., :S, :].copy_(c0[k])
        s1 = shard_params(s0, dstep.in_shardings[2])
        tok = l0.argmax(-1)
        decode_equal, sharded = True, []
        for i in range(LM_MESH_DECODE):
            db = {"tokens": tok, "cur_len": S + i}
            a, _ = dplain(params, db, s0)
            b, _ = run(f"decode_{i}", lambda: dstep(sp, db, s1))
            decode_equal &= b.to_local().equal(a)
            tok = a.argmax(-1)
        state_equal = _locals_equal(s1, s0)
        del params, sp, s0, s1, c0, c1, l0, l1, plain, step
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the shard-map MoE at full depth against the global dispatch
        t = time.perf_counter()
        arch, mB, mS = LM_MESH_MOE
        mcfg = dataclasses.replace(get_arch(arch), moe_dispatch="shardmap")
        gcfg = dataclasses.replace(mcfg, moe_dispatch="global")
        mp = init_model(mcfg, seed=seed, device=dev)
        mbatch = {"tokens": torch.randint(0, mcfg.vocab, (mB, mS),
                                          generator=gen, device=dev)}
        bound = bind_runtime(mcfg, mesh, mB)
        rules = make_rules(bound, mesh)
        msp = shard_params(mp, make_prefill_step(
            mcfg, ShapeConfig("moe", mS, mB, "prefill"),
            mesh=mesh).in_shardings[0])
        with torch.no_grad():
            forward(msp, bound, mbatch, rules, mesh)     # warm
            forward(mp, gcfg, mbatch)
            sub_s["moe_setup"] = time.perf_counter() - t
            g_logits, g_aux, _ = timed("moe_prefill_global", lambda: forward(
                mp, gcfg, mbatch))
            g_last, g_drop = g_logits[:, -1].float(), g_aux["moe_drop_frac"]
            del g_logits
            s_logits, s_aux, _ = run("moe_prefill", lambda: forward(
                msp, bound, mbatch, rules, mesh))
            s_local = s_logits.to_local()
            s_last, s_drop = s_local[:, -1].float(), s_aux["moe_drop_frac"]
            # one MoE layer on the same input, its capacity cut to drop
            # pairs: one shard holds the global capacity, so the same pairs
            # drop
            x = (torch.randn((mB, mS, mcfg.d_model), generator=gen,
                             device=dev) * 0.3).to(torch.bfloat16)
            lp = {k: v[0] for k, v in mp["blocks"]["moe"].items()}
            ms = moe_specs(bound, rules)
            y1, d1 = moe_ffn_shardmap(
                {k: to_dtensor(v, mesh, ms[k]) for k, v in lp.items()},
                bound, to_dtensor(x, mesh, rules.act_hidden(mB)), mesh,
                rules, capacity_factor=LM_MESH_LAYER_CF)
            y0, d0 = moe_ffn(lp, bound, x, capacity_factor=LM_MESH_LAYER_CF)
            layer = {"drop_frac": (float(d1), float(d0)),
                     "max_abs_err": (y1.to_local().float()
                                     - y0.float()).abs().max().item(),
                     "within_bar": torch.allclose(
                         y1.to_local().float(), y0.float(), **LM_BAR)}
        moe_err = (s_last - g_last).abs().max().item()
        moe_within = torch.allclose(s_last, g_last, **LM_BAR)
        moe_drops = (float(s_drop), float(g_drop))
        del mp, msp, s_logits, s_local, x, y0, y1
        gc.collect()
        torch.cuda.empty_cache()

        # (d) one train step, sharded and not, on the same weights
        t = time.perf_counter()
        tcfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH),
                                   n_layers=LM_MESH_LAYERS)
        tshape = ShapeConfig("train_4k_cut", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                             "train")
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
        p0 = init_model(tcfg, seed=seed, device=dev)
        o0 = init_opt_state(p0)
        tstep = make_train_step(tcfg, tshape, opt_cfg, mesh=mesh)
        p1 = shard_params(p0, tstep.in_shardings[0])
        o1 = shard_params(o0, tstep.in_shardings[1])
        tbatch = {"tokens": torch.randint(0, tcfg.vocab,
                                          (LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                                          generator=gen, device=dev)}
        sub_s["train_setup"] = time.perf_counter() - t
        plain_train = make_train_step(tcfg, tshape, opt_cfg, device=dev)
        _, _, m0 = timed("train_unsharded", lambda: plain_train(p0, o0,
                                                                 tbatch))
        _, _, m1 = run("train", lambda: tstep(p1, o1, tbatch))
        loss = (float(m1["loss"]), float(m0["loss"]))
        loss_rel = abs(loss[0] - loss[1]) / abs(loss[1])
        params_equal = _locals_equal(p1, p0)
        opt_equal = _locals_equal(o1, o0)
        opt_step = o1["step"]
        del p0, o0, o1
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the sharded params and step checkpointed and restored
        t = time.perf_counter()
        ckpt = ROOT / "build" / "lm_mesh_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        tree = {"params": p1, "opt": {"step": opt_step}}
        save_checkpoint(str(ckpt), 1, tree, keep=1)
        sh = {"params": tstep.in_shardings[0],
              "opt": {"step": tstep.in_shardings[1]["step"]}}
        back, manifest = restore_checkpoint(str(ckpt), 1, tree,
                                            shardings=sh)
        ckpt_equal = (_locals_equal(back, _to_local_tree(tree))
                      and manifest["step"] == 1)
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*.npy"))
        shutil.rmtree(ckpt, ignore_errors=True)
        sub_s["checkpoint"] = time.perf_counter() - t
        del p1, back, tree
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    total = {}
    for name, n in launches.items():
        _add(total, n)
    res = {"phase": "lm_mesh", "card": CARD, "mesh": "1x1 DeviceMesh, "
           "one-rank NCCL group (in-process store)",
           "arch": LM_ARCH, "n_layers": LM_MESH_LAYERS,
           "prefill_tokens": [B, S], "decode_steps": LM_MESH_DECODE,
           "moe": {"arch": arch, "tokens": [mB, mS],
                   "max_abs_err_last": moe_err, "within_bar": moe_within,
                   "drop_frac": moe_drops, "drop_frac_rel": abs(
                       moe_drops[0] - moe_drops[1]) / moe_drops[1],
                   "one_layer": layer},
           "train": {"tokens": [LM_TRAIN_BATCH, LM_TRAIN_SEQ],
                     "microbatch": tcfg.microbatch, "loss": loss,
                     "loss_rel": loss_rel, "params_equal": params_equal,
                     "opt_state_equal": opt_equal},
           "prefill_equal": prefill_equal, "decode_equal": decode_equal,
           "state_equal": state_equal, "checkpoint_equal": ckpt_equal,
           "checkpoint_bytes": ckpt_bytes, "counts": held,
           "launches": total, "launches_by_run": launches,
           "sub_s": sub_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "reduced": {"n_layers": [LM_MESH_LAYERS, get_arch(LM_ARCH).n_layers],
                       "checkpoint": "params and step (the AdamW state "
                                     "left out for the phase's time)"},
           "phase_s": phase_s}
    emit(res)
    flash = "flash_attention_tc"
    check(launches["prefill"].get(flash, 0) == LM_MESH_LAYERS
          and sum(launches["prefill"].values()) == LM_MESH_LAYERS,
          f"lm_mesh: the sharded prefill launched {launches['prefill']}; "
          f"expected {LM_MESH_LAYERS} {flash}")
    check(launches["moe_prefill"].get(flash, 0) == get_arch(arch).n_layers,
          f"lm_mesh: the shard-map MoE prefill launched "
          f"{launches['moe_prefill']}")
    check(sum(launches["train"].values()) == 0
          and all(sum(launches[f"decode_{i}"].values()) == 0
                  for i in range(LM_MESH_DECODE)),
          f"lm_mesh: the train step or a decode step launched a kernel "
          f"{launches}")
    check(prefill_equal, "lm_mesh: the sharded prefill's logits or caches "
                         "differ from the unsharded prefill's")
    check(held["prefill"]["wire_bytes"] == 0,
          f"lm_mesh: {held['prefill']['wire_bytes']} wire bytes counted on "
          f"a 1 x 1 mesh")
    check(decode_equal and state_equal,
          "lm_mesh: the sharded decode differs from the unsharded decode")
    check(moe_within and abs(moe_drops[0] - moe_drops[1])
          <= LM_MESH_DROP_RTOL * moe_drops[1],
          f"lm_mesh: shard-map MoE off the global dispatch by {moe_err} "
          f"(drop fractions {moe_drops})")
    check(layer["within_bar"]
          and layer["drop_frac"][0] == layer["drop_frac"][1] > 0,
          f"lm_mesh: one shard-map MoE layer against the global one: "
          f"{layer}")
    check(loss_rel <= LM_MESH_LOSS_RTOL,
          f"lm_mesh: sharded train loss {loss} (relative {loss_rel})")
    check(params_equal and opt_equal,
          "lm_mesh: the sharded train step's params or AdamW state differ "
          "from the unsharded step's")
    check(ckpt_equal, "lm_mesh: the restored checkpoint differs")
    check(phase_s <= LM_MESH_LIMIT_S,
          f"lm_mesh: {phase_s:.1f} s, past {LM_MESH_LIMIT_S} s")
    return res


def _to_local_tree(t):
    if isinstance(t, dict):
        return {k: _to_local_tree(v) for k, v in t.items()}
    return t.to_local()


KERNEL_ROWS = (
    ("window_filter", "src/repro_torch/csrc/window_filter.cu",
     "src/repro/kernels/window_filter/kernel.py:72"),
    ("window_match", "src/repro_torch/csrc/window_filter.cu",
     "src/repro/kernels/window_filter/kernel.py:51"),
    ("sfc_encode", "src/repro_torch/csrc/sfc_encode.cu",
     "src/repro/kernels/sfc_encode/kernel.py:107"),
    # no Pallas kernel: XLA fuses the reference's split and z-ranges
    ("split_zranges", "src/repro_torch/csrc/sfc_encode.cu",
     "src/repro/core/split.py:189"),
    ("sfc_encode_pool", "src/repro_torch/csrc/sfc_encode.cu",
     "src/repro/kernels/sfc_encode/kernel.py:174"),
    ("flash_attention_tc", "src/repro_torch/csrc/flash_attention_tc.cu",
     "src/repro/kernels/flash_attention/kernel.py:87"),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:87"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--osm-rows", type=int, default=10_000_000)
    ap.add_argument("--nyc-rows", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smbo-iters", type=int, default=10,
                    help="SMBO iterations of each learn_sfc run")
    ap.add_argument("--lm-layers", type=int, default=36,
                    help="layers of the served qwen3-4b (36 = full depth)")
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--dp-prefix", type=int, default=DP_PREFIX,
                    help="rows held against dp_paging_np (above 200k)")
    ap.add_argument("--store-rows", type=int, default=None,
                    help="rows of the store's segment (default: all of "
                         "--osm-rows)")
    ap.add_argument("--serve-seconds", type=float, default=0.5,
                    help="seconds of offered load at each serving rate")
    ap.add_argument("--router-shards", type=int, default=4,
                    help="shard Databases of the router phase")
    ap.add_argument("--pipeline-docs", type=int, default=250_000,
                    help="documents of the pipeline phase's corpus")
    ap.add_argument("--lm-families", default=None,
                    help="comma-separated configs of the lm_families "
                         "phase (default: all six)")
    ap.add_argument("--lm-train-layers", type=int, default=None,
                    help="layers of the trained qwen3-4b (default: the "
                         "most the card's memory takes, at most "
                         f"{LM_TRAIN_MAX_LAYERS})")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.data.synth import make_dataset

    global CARD
    setup = phase_setup()
    CARD, int_ops_per_s = setup["card"], setup["int_ops_per_s"]
    t0 = time.perf_counter()
    osm = make_dataset("osm", args.osm_rows, seed=0)
    nyc = make_dataset("nyc", args.nyc_rows, seed=1)
    emit({"phase": "data", "osm_rows": len(osm), "nyc_rows": len(nyc),
          "data_s": time.perf_counter() - t0})
    smbo = {
        "global": phase_smbo("smbo_global", osm, K=32, space="global",
                             depth=1, max_iters=args.smbo_iters,
                             seed=args.seed, width_scale=0.01),
        "piecewise": phase_smbo("smbo_piecewise", nyc, K=21,
                                space="piecewise", depth=2,
                                max_iters=args.smbo_iters,
                                seed=args.seed + 1, width_scale=0.05)}
    main_curve = smbo["global"]["curve"]
    pw_curve = smbo["piecewise"]["curve"]
    kern = phase_kernels(main_curve, pw_curve, osm, nyc, int_ops_per_s)
    kern["sfc_encode_pool"] = phase_pool_kernel(smbo, int_ops_per_s)
    main_res = phase_main(osm, args.batches, main_curve)
    paged = phase_paged_filter(main_res["_served"], args.seed)
    kern["window_match"]["paged"] = paged.pop("match_paged")
    kern["window_filter"].update(paged)
    pw_res = phase_piecewise(nyc, args.batches, pw_curve)
    pw_res.pop("_served")
    db_res = phase_database(osm, args.batches, args.seed, main_res)
    phase_dp_paging(nyc, pw_curve, args.dp_prefix)
    db, traffic = db_res.pop("db"), db_res.pop("traffic")
    store_res = phase_store(osm[:args.store_rows], main_curve, traffic,
                            args.seed)
    serving_res = phase_serving(db, osm, args.serve_seconds, args.seed)
    dist_res = phase_distributed(db, traffic, args.seed)
    router_res = phase_router(osm, db, traffic,
                              db_res.pop("updates") + dist_res.pop("updates"),
                              args.router_shards, args.serve_seconds,
                              args.seed)
    del osm, nyc, db, traffic
    pipeline_res = phase_pipeline(args.pipeline_docs, args.seed)
    flash = phase_kernels_flash(args.seed)
    lm = phase_lm_serve(args.seed, args.lm_layers, args.decode_steps)
    families = phase_lm_families(
        args.seed, args.lm_families.split(",") if args.lm_families else None)
    train = phase_lm_train(args.seed, args.lm_train_layers)
    cost = phase_cost_model(args.seed, main_res.pop("_served"), lm, train)
    mesh = phase_lm_mesh(args.seed)

    rows = []
    for name, source, replaces in KERNEL_ROWS:
        k, path, pw_path = kern.get(name, {}).get("path"), main_res, pw_res
        library_ms = None
        if name.startswith("flash_attention"):
            k, path, pw_path = flash[FLASH_ROWS[name]], lm, None
            library_ms = k["library_ms"]
        elif name == "window_match":
            # the main path's shape: Range's chunks, pages read by id
            k = kern[name]["paged"]
        elif name in ("sfc_encode", "split_zranges"):
            k = kern[name]["global_twin" if name == "sfc_encode"
                          else "global_path"]
        elif name == "sfc_encode_pool":
            k = kern[name]["global_shared_path"]
            path, pw_path = smbo["global"], smbo["piecewise"]
        # off every path, held only in the kernel phases: the float32
        # flash kernel (no served configuration takes float32 attention)
        # and the single-curve encode (the serving paths encode inside
        # split_zranges)
        off_path = name in ("flash_attention", "sfc_encode")
        check(off_path or path["launches"][name] > 0 and (
            pw_path is None or pw_path["launches"][name] > 0),
              f"{name} was not launched on its paths")
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path["phase"],
            "launches": path["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": library_ms}
        if name.startswith("sfc_encode"):
            row.update(shape=k["shape"], placement=k["placement"])
        if name == "split_zranges":
            row.update(shape=k["shape"], placement=k["placement"],
                       bytes=k["bytes"], on_encode=k["on_encode"],
                       at_shapes={s: {f: r[f] for f in (
                           "shape", "placement", "ms", "plain_ms",
                           "bound_ms", "bound_by", "on_encode")}
                           for s, r in kern[name].items()})
        if name == "window_filter":
            wf = kern[name]
            row.update(cold=wf["path"]["cold"], paged=wf["paged"],
                       paged_dense=wf["paged_dense"],
                       smem_bytes=wf["smem_bytes"])
        if name == "window_match":
            row.update(cold_ms=k["cold_ms"], share=k["share"],
                       cold_share=k["cold_share"],
                       tpu_contract=kern[name]["path"])
        if pw_path is not None:
            row["piecewise_launches"] = pw_path["launches"][name]
        row["database_launches"] = db_res["launches"][name]
        row["store_launches"] = store_res["launches"][name]
        row["serving_launches"] = serving_res["launches"][name]
        row["distributed_launches"] = dist_res["launches"][name]
        row["router_launches"] = router_res["launches"][name]
        row["pipeline_launches"] = pipeline_res["launches"][name]
        row["lm_families_launches"] = {
            arch: n[name] for arch, n in families["launches"].items()}
        row["lm_train_launches"] = train["launches"][name]
        row["lm_mesh_launches"] = mesh["launches"].get(name, 0)
        row["cost_model_calls"] = sum(
            h["kernel_calls"].get(name, 0) for h in cost["held"].values())
        if name in ("window_filter", "window_match", "split_zranges"):
            check(row["store_launches"] > 0 and row["serving_launches"] > 0,
                  f"{name} was not launched by the store or the server")
        if name in ("window_filter", "split_zranges"):
            check(row["distributed_launches"] > 0
                  and row["router_launches"] > 0,
                  f"{name} was not launched by the distributed engine or "
                  f"the router")
        if name == "window_match":
            check(row["router_launches"] > 0
                  and row["pipeline_launches"] > 0,
                  f"{name} was not launched by the router or the pipeline")
        if name == "flash_attention_tc":
            check(all(n > 0 for arch, n in
                      row["lm_families_launches"].items()
                      if arch != "xlstm-125m")
                  and row["lm_mesh_launches"] > 0,
                  f"{name} was not launched by every attention family "
                  f"and the mesh phase")
        if name == "flash_attention_tc":
            row["lm_families_shapes"] = {
                arch: {label: {key: r[key] for key in (
                    "shape", "causal", "window", "max_abs_err",
                    "tc_twin_max_abs_err", "ms", "bound_ms", "library_ms")}
                    for label, r in shapes.items()}
                for arch, shapes in families["kernel_at_shapes"].items()}
        if off_path:
            row["held_launches"] = (kern[name]["held_launches"]
                                    if name == "sfc_encode"
                                    else flash["held_launches"][name])
        rows.append(row)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
