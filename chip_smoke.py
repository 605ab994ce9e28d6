#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (`nvcc`); it fails without them and prints
no result.  Phases, each printing one JSON line:

1. set-up: builds the CUDA kernels from `src/repro_torch/csrc/` into
   `build/repro_torch/` and prints the card's name and power limit;
2. kernels: each kernel against its plain-torch twin on the card, bit for
   bit, with times and bounds, at the largest shape the main path gives
   it and at a larger one;
3. main path: a 10M-row OSM-like index (d=2, K=32, heuristic paging, a
   seeded random global curve) served on the card, Count and Range batches
   through the CUDA kernels, held bit for bit against the plain-torch
   backend on the card and against brute force;
4. piecewise path: a 1M-row NYC-like index (d=3) under a seeded depth-2
   piecewise curve, held the same way;
5. launch check: every kernel ran on each path.

The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that line.  ``--osm-rows``/``--nyc-rows``/``--batches`` cut the depth for a
quick run; the defaults are the full run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit peak (data sheet)
BATCH = 256                    # queries per served batch
Q_CHUNK = 16
K_MAXSPLIT = 4
MAX_CAND = 256
MAX_HITS = 65536
MAIN_CAP = 1024                # page capacity of the main path's index


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
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


def device_ms(fn, iters: int = 20):
    """Mean device time per call from `torch.profiler` (the kernels' self
    time, summed), or None when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in _device_events(prof))
    return total_us / iters / 1e3 if total_us > 0 else None


def _device_events(prof) -> list:
    """The profiler's device-side events (kernels, copies, fills).  The
    host-side aten ops repeat their kernels' time as their own, so only
    events that ran on the card are summed."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def kernel_times(fn, iters: int = 20) -> dict:
    """Device time per call (profiler; CUDA events over back-to-back calls
    when the profiler sees nothing) and the back-to-back wall time, which
    includes the host's launch overhead when that dominates."""
    wall = time_ms(fn, iters=iters)
    dev = device_ms(fn, iters=iters)
    return {"ms": dev if dev is not None else wall, "wall_ms": wall,
            "timing": "profiler" if dev is not None else "events"}


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


def max_abs_err(a, b) -> int:
    import torch
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def bound(nbytes: float, ops: float) -> tuple:
    """Least time in ms for the work, and which rate bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: set-up
# ---------------------------------------------------------------------------


def phase_setup() -> str:
    import torch
    from repro_torch.kernels import cuda_lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    if log.exists():
        print(log.read_text(), file=sys.stderr, flush=True)
    emit({"phase": "setup", "card": card, "build_s": build_s,
          "library": str(lib.relative_to(ROOT)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return card


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin at the main path's shapes
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
                 plain_iters: int = 20) -> dict:
    """`fn` (the kernel's wrapper) against `ref` (its plain twin) on the
    same card inputs: bit-equality, then both timed, and the bound."""
    import torch
    got = fn(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"{name} disagrees with its plain twin (max {err})")
    b_ms, b_by = bound(nbytes, ops)
    plain = kernel_times(lambda: ref(*args), iters=plain_iters)
    return {"max_abs_err": err, **kernel_times(lambda: fn(*args)),
            "plain_ms": plain["ms"], "plain_wall_ms": plain["wall_ms"],
            "bound_ms": b_ms, "bound_by": b_by}


def phase_kernels(main_curve, pw_curve) -> dict:
    """Each kernel at two shapes: "path", the largest call the main path
    makes (a q_chunk of queries times max_cand pages for the filter; the
    last split step's corner points for the encode), and "large" (the
    filter at 64 candidates per query, the encode over 2^20 points)."""
    import numpy as np
    import torch
    from repro_torch.kernels.sfc_encode.ops import sfc_encode
    from repro_torch.kernels.sfc_encode.ref import sfc_encode_ref
    from repro_torch.kernels.window_filter.ops import (window_filter,
                                                       window_match)
    from repro_torch.kernels.window_filter.ref import (window_filter_ref,
                                                       window_match_ref)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    out = {"window_filter": {}, "window_match": {}}

    d, cap = 2, MAIN_CAP
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
                               in_bytes + out_bytes, 2.0 * valid * d)}

    out["sfc_encode"] = {}
    for kind, curve in (("global", main_curve), ("piecewise", pw_curve)):
        K, T = curve.K, curve.d * curve.K
        R = 1 if kind == "global" else curve.num_regions
        for shape, n in (("path", Q_CHUNK * 2**(K_MAXSPLIT - 1) * curve.d),
                         ("large", 2**20)):
            x = rng.integers(0, 2**K, size=(n, curve.d), dtype=np.uint64)
            x[:8] = 2**K - 1                   # the sign bit at K = 32
            xt = torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(dev)
            nbytes = n * curve.d * 4 + n * 8 + R * T * 4
            out["sfc_encode"][f"{kind}_{shape}"] = {
                "shape": [n, curve.d], "K": K, "regions": R,
                **_hold_kernel(f"sfc_encode[{kind}]",
                               lambda x: sfc_encode(x, curve),
                               lambda x: sfc_encode_ref(x, curve), (xt,),
                               nbytes, 3.0 * n * T, plain_iters=5)}
    emit({"phase": "kernels", **out})
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: a served index, held against the plain backend and
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
    host, the wall-clock seconds of each (ending in a synchronize), and
    the launch counts after the Count batches."""
    import torch
    from repro_torch.kernels import cuda_lib
    qfn, rfn = _fns(curve, backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = [qfn(arrays, q) for q in batches]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_count = dict(cuda_lib.LAUNCHES)
    ranges = [rfn(arrays, q) for q in batches]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    to_host = lambda outs: [tuple(t.cpu() for t in o) for o in outs]
    return (to_host(counts), to_host(ranges), t1 - t0, t2 - t1,
            after_count)


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
    counts, ranges, count_s, range_s, after_count = _serve(
        arrays, curve, batches, "cuda")
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for k in kernel_names:
        check(launches[k] > 0, f"{name}: kernel {k} was not launched")
    p_counts, p_ranges, p_count_s, p_range_s, _ = _serve(arrays, curve,
                                                         batches, "torch")
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
        "profile": profile}
    emit(res)
    return res


def phase_main(osm_rows: int, n_batches: int, curve) -> dict:
    from repro_torch.core.index import IndexConfig, LMSFCIndex
    from repro_torch.data.synth import make_dataset
    t0 = time.perf_counter()
    data = make_dataset("osm", osm_rows, seed=0)
    t1 = time.perf_counter()
    index = LMSFCIndex.build(data, curve=curve,
                             cfg=IndexConfig(paging="heuristic"))
    t2 = time.perf_counter()
    res = _hold_path("main", data, index, curve, n_batches, seed=1,
                     width_scale=0.01, kernel_names=("window_filter", "window_match",
                                   "sfc_encode"))
    res.update(data_s=t1 - t0, build_s=t2 - t1)
    check(res["cap"] == MAIN_CAP, f"main path cap {res['cap']} != the "
                                  f"kernel phase's {MAIN_CAP}")
    return res


def phase_piecewise(nyc_rows: int, n_batches: int, curve) -> dict:
    from repro_torch.core.index import IndexConfig, LMSFCIndex
    from repro_torch.data.synth import make_dataset
    data = make_dataset("nyc", nyc_rows, seed=1)
    index = LMSFCIndex.build(data, curve=curve,
                             cfg=IndexConfig(paging="heuristic"))
    return _hold_path("piecewise", data, index, curve, n_batches, seed=2,
                      width_scale=0.05, kernel_names=("window_filter", "window_match",
                                    "sfc_encode"))


# ---------------------------------------------------------------------------


KERNEL_ROWS = (
    ("window_filter", "src/repro_torch/csrc/window_filter.cu",
     "src/repro/kernels/window_filter/kernel.py:72"),
    ("window_match", "src/repro_torch/csrc/window_filter.cu",
     "src/repro/kernels/window_filter/kernel.py:51"),
    ("sfc_encode", "src/repro_torch/csrc/sfc_encode.cu",
     "src/repro/kernels/sfc_encode/kernel.py:107"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--osm-rows", type=int, default=10_000_000)
    ap.add_argument("--nyc-rows", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.core.curve import GlobalTheta, PiecewiseCurve
    from repro_torch.core.theta import default_K

    phase_setup()
    main_curve = GlobalTheta.random(np.random.default_rng(args.seed), 2, 32)
    pw_curve = PiecewiseCurve.random(np.random.default_rng(args.seed + 1), 3,
                                     default_K(3), depth=2)
    kern = phase_kernels(main_curve, pw_curve)
    main_res = phase_main(args.osm_rows, args.batches, main_curve)
    pw_res = phase_piecewise(args.nyc_rows, args.batches, pw_curve)

    rows = []
    for name, source, replaces in KERNEL_ROWS:
        k = (kern[name]["path"] if name != "sfc_encode"
             else kern[name]["global_path"])
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_res["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "piecewise_launches": pw_res["launches"][name]})
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
