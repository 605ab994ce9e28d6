"""Explicit update state for a built LMSFC index (paper §7.11).

`DeltaStore` replaces the monkey-patched ``index._deltas`` /
``index._tombstones`` attributes with a first-class object that

  * routes inserts to their target page's unsorted delta array (LMSFCb),
  * tombstones deletions,
  * keeps page metadata query-safe (MBR growth AND z-max growth, so both
    the CPU engine's z-overlap candidate test and the serving engine's
    prune step still see every delta row),
  * tracks a **staleness epoch**: every mutation bumps ``epoch`` and
    stamps the touched page, so serving engines holding device arrays can
    ask ``dirty_since(built_epoch)`` and re-pack only those pages.

Row-set membership (tombstone filtering) is vectorized through a void
view of the row bytes — O(n log n) instead of the old O(rows × tombstones)
Python loops.

Legacy call sites keep working: ``repro_torch.core.index.insert/delete/...``
are thin shims over this class, and ``index._deltas`` / ``_tombstones``
are aliased to the store's own containers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

import numpy as np



def rows_void(a: np.ndarray) -> np.ndarray:
    """(n, d) uint64 -> (n,) void view usable for row-set membership."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).reshape(-1)


def rows_in_set(rows: np.ndarray, members: np.ndarray) -> np.ndarray:
    """Vectorized per-row membership of `rows` in the row-set `members`."""
    if len(rows) == 0 or len(members) == 0:
        return np.zeros(len(rows), dtype=bool)
    return np.isin(rows_void(rows), rows_void(members))


@dataclasses.dataclass
class DeltaStore:
    """LMSFCb delta pages + tombstones + the staleness epoch, for one index."""

    index: "object"                      # the owning LMSFCIndex
    epoch: int = 0
    deltas: Dict[int, List[np.ndarray]] = dataclasses.field(default_factory=dict)
    tombstones: Set[Tuple[int, ...]] = dataclasses.field(default_factory=set)
    n_inserted: int = 0
    n_deleted: int = 0
    _page_epoch: Dict[int, int] = dataclasses.field(default_factory=dict)
    _stacked: Dict[int, Tuple[int, np.ndarray]] = dataclasses.field(
        default_factory=dict)           # page -> (len at stack time, rows)
    _tomb_cache: Tuple[int, np.ndarray] = None

    # -- mutation ----------------------------------------------------------
    def insert(self, x) -> int:
        """Append x to its target page's delta array; returns the page id."""
        return int(self.insert_many(np.asarray(x, dtype=np.uint64)[None])[0])

    def insert_many(self, xs) -> np.ndarray:
        """Bulk insert: one batched encode + forward-index lookup for all
        rows, grouped metadata growth.  Returns the target page ids."""
        index = self.index
        xs = np.asarray(xs, dtype=np.uint64)
        if len(xs) == 0:
            return np.empty(0, dtype=np.int64)
        z = index.curve.encode_np(xs)
        ps = np.asarray(index.page_of(z), dtype=np.int64)
        # keep page metadata query-safe: grow the MBR to cover the deltas,
        # and grow the page z-range (zmax, and zmin for below-minimum rows
        # clipped onto page 0) so z candidate tests can't skip the page
        np.minimum.at(index.mbrs[:, :, 0], ps, xs.astype(np.int64))
        np.maximum.at(index.mbrs[:, :, 1], ps, xs.astype(np.int64))
        np.minimum.at(index.page_zmin, ps, z)
        np.maximum.at(index.page_zmax, ps, z)
        self.epoch += 1
        for p, row in zip(ps, xs):
            self.deltas.setdefault(int(p), []).append(row)
            self._page_epoch[int(p)] = self.epoch
        self.n_inserted += len(xs)
        return ps

    def delete(self, x) -> None:
        """Tombstone x (base or delta row); rows not present in the index
        are a true no-op so live-row accounting stays correct."""
        self.delete_many(np.asarray(x, dtype=np.uint64)[None])

    def delete_many(self, xs) -> int:
        """Bulk tombstone: one batched encode + forward-index lookup +
        vectorized row-set membership for all rows (already-tombstoned and
        absent rows are no-ops, duplicates within the batch collapse), one
        epoch bump for the whole batch.  Returns how many rows were
        actually tombstoned."""
        index = self.index
        xs = np.asarray(xs, dtype=np.uint64)
        if len(xs) == 0:
            return 0
        xs = np.unique(xs, axis=0)
        if self.tombstones:
            xs = xs[~rows_in_set(xs, self.tombstone_rows())]
        if len(xs) == 0:
            return 0
        z = index.curve.encode_np(xs)
        ps = np.asarray(index.page_of(z), dtype=np.int64)
        exists = rows_in_set(xs, index.xs)
        missing = ~exists
        if missing.any() and self.deltas:
            for p in np.unique(ps[missing]):
                if self.deltas.get(int(p)):
                    sel = missing & (ps == p)
                    exists[sel] = rows_in_set(xs[sel],
                                              self.delta_rows(int(p)))
        if not exists.any():
            return 0
        self.epoch += 1
        for x, p in zip(xs[exists], ps[exists]):
            self.tombstones.add(tuple(int(v) for v in x))
            self._page_epoch[int(p)] = self.epoch
        n = int(exists.sum())
        self.n_deleted += n
        self._tomb_cache = None
        return n

    # -- staleness ---------------------------------------------------------
    def dirty_since(self, epoch: int) -> list:
        """Pages mutated after `epoch` (what a refresh must re-pack)."""
        return sorted(p for p, e in self._page_epoch.items() if e > epoch)

    def delta_fraction(self) -> float:
        return self.n_inserted / max(1, self.index.n)

    # -- reads -------------------------------------------------------------
    def delta_rows(self, p: int) -> np.ndarray:
        """Stacked (k, d) delta rows of page p (cached; empty if none)."""
        lst = self.deltas.get(p)
        if not lst:
            return np.empty((0, self.index.d), dtype=np.uint64)
        cached = self._stacked.get(p)
        if cached is None or cached[0] != len(lst):
            self._stacked[p] = (len(lst), np.stack(lst))
        return self._stacked[p][1]

    def tombstone_rows(self) -> np.ndarray:
        """(t, d) uint64 array of tombstoned rows (cached)."""
        if not self.tombstones:
            return np.empty((0, self.index.d), dtype=np.uint64)
        if self._tomb_cache is None or self._tomb_cache[0] != len(self.tombstones):
            arr = np.asarray(sorted(self.tombstones), dtype=np.uint64)
            self._tomb_cache = (len(self.tombstones), arr)
        return self._tomb_cache[1]

    def delta_count(self, p: int, qL, qU) -> int:
        """Extra matches from page p's delta array (minus tombstones)."""
        rows = self.delta_rows(p)
        if len(rows) == 0:
            return 0
        ok = np.all((rows >= qL) & (rows <= qU), axis=1)
        if ok.any() and self.tombstones:
            ok &= ~rows_in_set(rows, self.tombstone_rows())
        return int(ok.sum())

    def count_adjustment(self, pages, qL, qU) -> int:
        """Signed correction to a base-data count for the query [qL, qU]:
        + delta rows in the candidate pages, − tombstoned base rows."""
        extra = sum(self.delta_count(p, qL, qU) for p in pages)
        tomb = self.tombstone_rows()
        if len(tomb):
            in_rect = np.all((tomb >= qL) & (tomb <= qU), axis=1)
            if in_rect.any():
                extra -= int(rows_in_set(tomb[in_rect], self.index.xs).sum())
        return extra

    def live_page_rows(self, p: int) -> np.ndarray:
        """Current logical contents of page p: base rows minus tombstones
        plus delta rows minus tombstones.  Used by engine refresh."""
        index = self.index
        s, e = int(index.starts[p]), int(index.starts[p + 1])
        rows = np.concatenate([index.xs[s:e], self.delta_rows(p)])
        tomb = self.tombstone_rows()
        if len(tomb):
            rows = rows[~rows_in_set(rows, tomb)]
        return rows

    def merged_data(self) -> np.ndarray:
        """All live rows (base + deltas − tombstones, deduplicated) — the
        input to an LMSFCa rebuild."""
        index = self.index
        parts = [index.xs] + [self.delta_rows(p) for p in sorted(self.deltas)]
        data = np.concatenate([x for x in parts if len(x)])
        tomb = self.tombstone_rows()
        if len(tomb):
            data = data[~rows_in_set(data, tomb)]
        return np.unique(data, axis=0)


def get_delta_store(index) -> DeltaStore:
    """The index's DeltaStore, created on first use.  Also aliases the
    legacy ``_deltas`` / ``_tombstones`` attributes so pre-facade call
    sites that poke them directly stay consistent."""
    store = getattr(index, "_delta_store", None)
    if store is None:
        store = DeltaStore(index=index)
        index._delta_store = store
        index._deltas = store.deltas          # legacy aliases (same objects)
        index._tombstones = store.tombstones
    return store
