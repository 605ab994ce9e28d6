"""Chunked external-sort segment builds (the out-of-core twin of
`LMSFCIndex.build`).

The in-memory build materializes the whole dataset, argsorts it by curve
key, and pages it in one shot.  At 10M-100M rows that is exactly what we
cannot do, so `build_segment` runs the classic two-phase external sort:

  spill   — consume row chunks from any iterable (`data.synth.iter_chunks`
            or `iter_npy_shards`), encode curve keys with the curve's
            numpy oracle, argsort *within* the chunk, and spill the
            (keys, rows) run to disk.  Peak memory: one chunk.
  merge   — k-way merge of the sorted runs with vectorized block takes:
            per round, every live run exposes its next block of keys; all
            items at/below the smallest block-end key across runs are
            safe to emit (no unseen key can be smaller), so they are
            concatenated, stable-argsorted, and streamed into a
            `SegmentWriter` — which dedups equal keys, cuts fixed-size
            pages, and writes rows straight through.  Peak memory: one
            merge window (~`merge_rows` rows) + one partial page.

The result is a sealed on-disk segment (see `segment.py`): z-sorted rows,
page metadata/MBRs, per-page sort dimensions (workload-driven when a
training workload is supplied — the same §5.4 policy the in-memory build
applies), checksums, and a manifest.  Peak RSS of the whole build is
bounded by ~2 chunk-sized windows.  The build is host-only: it touches no
torch tensor and no device.

Equal curve keys are deduplicated (first occurrence wins), mirroring the
duplicate-free-input contract of `LMSFCIndex.build` — with an injective
curve (all d*K input bits appear in the output) that is exactly row-level
`np.unique`.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from .. import obs
from ..core.curve import as_curve, default_curve
from ..core.theta import default_K
from .segment import SegmentWriter


def iter_npy_shards(paths):
    """Yield row chunks from `.npy` shard files, one shard resident at a
    time (shards are loaded via memmap and materialized per yield)."""
    for p in paths:
        yield np.asarray(np.load(p, mmap_mode="r"))


def _spill_runs(chunks, curve, spill_dir, K):
    """Phase 1: encode + sort each chunk, spill (keys, rows) runs to disk.
    Returns (run list of (n_rows, keys_path, rows_path), d, total rows)."""
    runs = []
    total = 0
    d = None
    lim = np.uint64(1) << np.uint64(K)
    for i, chunk in enumerate(chunks):
        rows = np.asarray(chunk, dtype=np.uint64)
        if rows.ndim != 2:
            raise ValueError(f"chunk {i}: expected (m, d) rows; "
                             f"got shape {rows.shape}")
        if len(rows) == 0:
            continue
        if d is None:
            d = rows.shape[1]
        elif rows.shape[1] != d:
            raise ValueError(f"chunk {i} has d={rows.shape[1]}, "
                             f"earlier chunks d={d}")
        if rows.max() >= lim:
            raise ValueError(f"chunk {i}: coordinates must be < 2^K "
                             f"(K={K}); got max {int(rows.max())}")
        with obs.span("store.build.spill", run=i, rows=len(rows)):
            keys = curve.encode_np(rows)
            order = np.argsort(keys, kind="stable")
            kp = os.path.join(spill_dir, f"run{i:05d}.keys.bin")
            rp = os.path.join(spill_dir, f"run{i:05d}.rows.bin")
            # fancy-indexed results are fresh contiguous arrays; with
            # copy=False the little-endian cast is free on x86/ARM hosts
            keys[order].astype("<u8", copy=False).tofile(kp)
            rows[order].astype("<u8", copy=False).tofile(rp)
        runs.append((len(rows), kp, rp))
        total += len(rows)
        obs.inc("store.build.rows", len(rows))
        del rows, keys, order     # release before the next chunk generates
    return runs, d, total


def _merge_runs(runs, d, writer, merge_rows):
    """Phase 2: vectorized k-way merge of the sorted spill runs into the
    writer.  Invariant per round: every emitted key is <= the smallest
    block-end key over live runs, so no later read can produce a smaller
    key — global order is preserved with O(merge_rows) memory."""
    # sequential fromfile reads, not memmaps: mapped file pages count
    # toward ru_maxrss once touched, which would make the measured build
    # footprint look like the whole spill set instead of one merge window
    fks = [open(kp, "rb") for _, kp, _ in runs]
    frs = [open(rp, "rb") for _, _, rp in runs]
    try:
        remaining = [m for m, _, _ in runs]
        kbuf = [np.empty(0, dtype=np.uint64) for _ in runs]
        rbuf = [np.empty((0, d), dtype=np.uint64) for _ in runs]
        blk = max(1024, merge_rows // max(1, len(runs)))
        rounds = 0
        while True:
            live = []
            for r in range(len(runs)):
                if len(kbuf[r]) < max(1, blk // 4) and remaining[r] > 0:
                    take = min(blk - len(kbuf[r]), remaining[r])
                    k = np.fromfile(fks[r], dtype="<u8", count=take)
                    w = np.fromfile(frs[r], dtype="<u8",
                                    count=take * d).reshape(take, d)
                    kbuf[r] = np.concatenate(
                        [kbuf[r], k.astype(np.uint64, copy=False)])
                    rbuf[r] = np.concatenate(
                        [rbuf[r], w.astype(np.uint64, copy=False)])
                    remaining[r] -= take
                if len(kbuf[r]):
                    live.append(r)
            if not live:
                break
            bound = min(np.uint64(kbuf[r][-1]) for r in live)
            kparts, rparts = [], []
            for r in live:
                take = int(np.searchsorted(kbuf[r], bound, side="right"))
                if take == 0:
                    continue
                kparts.append(kbuf[r][:take])
                rparts.append(rbuf[r][:take])
                kbuf[r] = kbuf[r][take:]
                rbuf[r] = rbuf[r][take:]
            keys = np.concatenate(kparts)
            order = np.argsort(keys, kind="stable")
            writer.append_sorted(np.concatenate(rparts)[order], keys[order])
            del kparts, rparts, keys, order   # window dies before the next
            rounds += 1
        return rounds
    finally:
        for f in fks + frs:
            f.close()


def build_segment(chunks, path, *, curve=None, K: int = None,
                  page_rows: int = 256, workload=None,
                  merge_rows: int = 1 << 18, tmpdir: str = None,
                  build_info: dict = None) -> str:
    """Build an on-disk segment at `path` from an iterable of row chunks
    without materializing the dataset.

    `chunks` yields (m, d) integer arrays (any sizes; `data.synth.
    iter_chunks` and `iter_npy_shards` are ready-made producers).  `curve`
    pins the SFC (a `MonotonicCurve`, legacy Theta, or curve JSON);
    default is z-order at `K = default_K(d)` bits.  `workload` is an
    optional ``(Ls, Us)`` training workload driving per-page sort
    dimensions.  `merge_rows` caps the merge window (total rows resident
    across all run blocks per round).  Spill runs live under `tmpdir`
    (default ``<path>/.spill``) and are removed on success.

    Returns the segment path (open with `open_segment` /
    `Database.from_segment`).
    """
    curve = as_curve(curve)
    spill_dir = tmpdir or os.path.join(path, ".spill")
    os.makedirs(spill_dir, exist_ok=True)
    writer = None
    try:
        with obs.span("store.build", phase="spill"):
            if curve is None:
                chunks = iter(chunks)
                first = None
                for first in chunks:
                    if len(first) > 0:
                        break
                if first is None or len(first) == 0:
                    raise ValueError("no rows: cannot build an empty segment")
                d0 = np.asarray(first).shape[1]
                curve = default_curve(d0, K or default_K(d0))
                chunks = _chain_first(first, chunks)
            elif K is not None and K != curve.K:
                raise ValueError(f"K={K} conflicts with curve.K={curve.K}")
            runs, d, total = _spill_runs(chunks, curve, spill_dir, curve.K)
        if not runs:
            raise ValueError("no rows: cannot build an empty segment")
        obs.set_gauge("store.build.spill_runs", len(runs))
        writer = SegmentWriter(
            path, curve=curve, page_rows=page_rows,
            build_info=dict(build_info or {}, rows_in=total,
                            spill_runs=len(runs), merge_rows=merge_rows,
                            page_rows=page_rows))
        with obs.span("store.build", phase="merge", runs=len(runs)):
            rounds = _merge_runs(runs, d, writer, merge_rows)
        obs.set_gauge("store.build.merge_rounds", rounds)
        with obs.span("store.build", phase="finalize"):
            out = writer.finalize(workload=workload)
        return out
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


def _chain_first(first, rest):
    yield first
    yield from rest
