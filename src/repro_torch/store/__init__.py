"""repro_torch.store — out-of-core storage: external-sort builds,
memory-mapped segments, and a device-resident page-group cache.

Everything else in the port assumes the dataset fits one in-memory pack;
`repro_torch.store` serves 10M–100M-row datasets without ever
materializing them in memory:

  build.py    — chunked build pipeline on the host: consume row chunks (a
                seeded generator or `.npy` shards), encode curve keys per
                chunk, external-sort by z64 key (k-way merge of sorted
                spill runs on disk), and pack pages incrementally.  It
                touches no tensor and holds O(chunk + merge window) rows
                at a time.
  segment.py  — the on-disk segment format: raw packed arrays + a JSON
                manifest (schema version, curve spec, per-array CRC32s),
                byte-compatible with the JAX package's.  `open_segment`
                memory-maps the row store and loads only page *metadata*
                into memory; `Segment.as_index()` yields an `LMSFCIndex`
                view the CPU engine (and the executor's exactness net)
                serves directly — reads page on demand.
  cache.py    — `PageGroupCache`: an LRU of device-resident page groups
                (torch tensors) under a hard byte budget, with
                obs-integrated hit/miss/eviction counters and a
                resident-bytes gauge, feeding the `store` engine.
  engine.py   — the `store` execution engine (`db.engine("store")`):
                per batch it selects the page groups the queries'
                z-candidate ranges touch, assembles them from the cache
                on the device, and runs the standard serving path on that
                subset (the CUDA kernels on a card) — exact by the same
                superset/prune argument the in-memory engines use.

Quickstart::

    from repro_torch.store import build_segment, open_segment
    from repro_torch.data.synth import iter_chunks
    from repro_torch.api import Count, Database

    seg = build_segment(iter_chunks(10_000_000, 500_000, seed=0, d=3),
                        "seg_dir")
    db = Database.from_segment("seg_dir")      # cpu engine: memmap-backed
    db.engine("store")                          # cached device page groups
    db.query(Count(Ls, Us))                     # exact, out-of-core
"""
from .build import build_segment, iter_npy_shards
from .segment import (Segment, SegmentWriter, StoreCorruptionError,
                      open_segment, write_segment_from_index)

__all__ = [
    "build_segment", "iter_npy_shards",
    "Segment", "SegmentWriter", "StoreCorruptionError", "open_segment",
    "write_segment_from_index",
]
