"""Window-query processing on an LMSFC index (paper §6) — CPU engine.

Faithful per-query engine with all paper optimizations: projection via
Theorem 1, recursive query splitting (RQS) or FindNextZaddress (FNZ)
skipping, MBR disjoint/containment short-cuts, and per-page sort-dimension
refinement.  Returns COUNT
aggregates plus the mechanical statistics that the paper reports (pages
accessed, false-positive points, index accesses).

Beyond COUNT, this module carries the typed query algebra:

  query_count  — COUNT(*) aggregation (the paper's §6 walk)
  query_range  — range *retrieval*: the matching rows themselves
  query_point  — exact-match lookup: curve encode + page binary search
  query_knn    — k nearest neighbors: expanding page rings around the
                 center's curve address seed an upper-bound radius, then an
                 exact box retrieval is refined by exact integer distances

Every function here reads the index's update state (delta pages and
tombstones, `repro_torch.api.deltas.DeltaStore`), so results reflect
inserts and deletes.  This is the execution layer behind the "cpu" engine
of the `repro_torch.api.Database` facade — prefer `Database.query`.  The
device engine lives in serve.py (mask→compact→gather→filter).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .index import LMSFCIndex
from .split import recursive_split


@dataclasses.dataclass
class QueryStats:
    pages_accessed: int = 0
    irrelevant_pages: int = 0      # z-range pages skipped via MBR disjointness
    points_scanned: int = 0        # points actually filtered
    false_positives: int = 0       # scanned but outside the query
    index_accesses: int = 0        # forward-index lookups
    subqueries: int = 0
    result: int = 0

    def merge(self, o: "QueryStats"):
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))
        return self


def _scan_page(index: LMSFCIndex, p: int, qL, qU, stats: QueryStats) -> int:
    """Scan one page with MBR + sort-dimension optimizations (COUNT form
    of `_scan_page_rows`; containment returns a slice view, so the only
    extra cost here is materializing the matches on filtered pages)."""
    rows = _scan_page_rows(index, p, qL, qU, stats)
    return 0 if rows is None else len(rows)


def _candidate_pages(index: LMSFCIndex, qL, qU, stats: QueryStats) -> list:
    """Sorted union of candidate pages for [qL, qU] via recursive query
    splitting + Theorem-1 projection.  The sub-rects partition the query, so
    each page is fetched once (buffer-cache semantics) and scanned against
    the FULL query rectangle — exact, no double counting."""
    cfg = index.cfg
    if cfg.use_query_split and cfg.skipping == "rqs":
        rects = recursive_split(qL, qU, index.curve, cfg.k_maxsplit)
    else:
        rects = [(qL, qU)]
    stats.subqueries += len(rects)
    # batched projection for every sub-query (Theorem 1)
    Ls = np.stack([r[0] for r in rects])
    Us = np.stack([r[1] for r in rects])
    zlo = index.curve.encode_np(Ls)
    zhi = index.curve.encode_np(Us)
    plo = index.page_of(zlo)
    phi = index.page_of(zhi)
    stats.index_accesses += 2 * len(rects)
    pages = set()
    for t in range(len(rects)):
        a, b = int(plo[t]), int(phi[t]) + 1
        hit = ((index.page_zmax[a:b] >= zlo[t])
               & (index.page_zmin[a:b] <= zhi[t]))
        pages.update((np.nonzero(hit)[0] + a).tolist())
    return sorted(pages)


def query_count(index: LMSFCIndex, qL, qU) -> QueryStats:
    """COUNT(*) WHERE qL <= x <= qU with the configured skipping strategy."""
    qL = np.asarray(qL, dtype=np.uint64)
    qU = np.asarray(qU, dtype=np.uint64)
    stats = QueryStats()
    cfg = index.cfg
    if cfg.skipping == "fnz":
        from ..baselines.fnz import fnz_query  # lazy import, avoids cycle
        return fnz_query(index, qL, qU)
    pages = _candidate_pages(index, qL, qU, stats)
    total = 0
    for p in pages:
        total += _scan_page(index, p, qL, qU, stats)
    # updates (paper §7.11): unsorted per-page delta arrays + tombstones,
    # held in the index's DeltaStore (repro_torch.api.deltas)
    store = getattr(index, "_delta_store", None)
    if store is not None and (store.deltas or store.tombstones):
        total += store.count_adjustment(pages, qL, qU)
    stats.result = total
    return stats


def _scan_page_rows(index: LMSFCIndex, p: int, qL, qU,
                    stats: QueryStats) -> np.ndarray:
    """`_scan_page`'s retrieval twin: the matching rows themselves (same
    MBR disjoint/containment shortcuts and sort-dimension refinement, same
    stats accounting)."""
    mbr = index.mbrs[p]
    if np.any(mbr[:, 0] > qU) or np.any(mbr[:, 1] < qL):
        stats.irrelevant_pages += 1
        return None
    stats.pages_accessed += 1
    s, e = index.starts[p], index.starts[p + 1]
    seg = index.xs[s:e]
    if np.all(mbr[:, 0] >= qL) and np.all(mbr[:, 1] <= qU):
        return seg  # containment: sequential, no filtering
    sd = int(index.sort_dims[p])
    col = seg[:, sd]
    lo = int(np.searchsorted(col, qL[sd], side="left"))
    hi = int(np.searchsorted(col, qU[sd], side="right"))
    sub = seg[lo:hi]
    stats.points_scanned += len(sub)
    other = [i for i in range(index.d) if i != sd]  # sort dim pre-verified
    ok = np.ones(len(sub), dtype=bool)
    for i in other:
        ok &= (sub[:, i] >= qL[i]) & (sub[:, i] <= qU[i])
    stats.false_positives += len(sub) - int(ok.sum())
    return sub[ok]


def query_range(index: LMSFCIndex, qL, qU):
    """Range *retrieval*: the rows in [qL, qU] (page-walk order), plus
    stats.  Same candidate-page walk as `query_count`; delta rows are
    appended and tombstoned rows filtered through the index's DeltaStore.
    (FNZ skipping is count-only; retrieval always walks the RQS/plain
    candidate set.)"""
    qL = np.asarray(qL, dtype=np.uint64)
    qU = np.asarray(qU, dtype=np.uint64)
    stats = QueryStats()
    pages = _candidate_pages(index, qL, qU, stats)
    parts = []
    for p in pages:
        rows = _scan_page_rows(index, p, qL, qU, stats)
        if rows is not None and len(rows):
            parts.append(rows)
    out = (np.concatenate(parts) if parts
           else np.empty((0, index.d), dtype=np.uint64))
    store = getattr(index, "_delta_store", None)
    if store is not None and (store.deltas or store.tombstones):
        from ..api.deltas import rows_in_set  # lazy: api imports core
        extra = [store.delta_rows(p) for p in pages if store.deltas.get(p)]
        if extra:
            dr = np.concatenate(extra)
            ok = np.all((dr >= qL) & (dr <= qU), axis=1)
            out = np.concatenate([out, dr[ok]])
        tomb = store.tombstone_rows()
        if len(tomb):
            out = out[~rows_in_set(out, tomb)]
    stats.result = len(out)
    return out, stats


def query_point(index: LMSFCIndex, xs) -> np.ndarray:
    """Exact-match lookup: curve encode + forward-index page probe + binary
    search on the page's sort dimension.  xs: (Q, d) -> (Q,) bool (delta
    rows found, tombstoned rows not)."""
    xs = np.atleast_2d(np.asarray(xs, dtype=np.uint64))
    z = index.curve.encode_np(xs)
    ps = np.asarray(index.page_of(z), dtype=np.int64)
    store = getattr(index, "_delta_store", None)
    found = np.zeros(len(xs), dtype=bool)
    for i, (x, p) in enumerate(zip(xs, ps)):
        s, e = int(index.starts[p]), int(index.starts[p + 1])
        seg = index.xs[s:e]
        sd = int(index.sort_dims[p])
        col = seg[:, sd]
        lo = int(np.searchsorted(col, x[sd], side="left"))
        hi = int(np.searchsorted(col, x[sd], side="right"))
        hit = bool(np.all(seg[lo:hi] == x, axis=1).any())
        if not hit and store is not None and store.deltas.get(int(p)):
            hit = bool(np.all(store.delta_rows(int(p)) == x, axis=1).any())
        if hit and store is not None and store.tombstones:
            hit = tuple(int(v) for v in x) not in store.tombstones
        found[i] = hit
    return found


def exact_dists(rows: np.ndarray, center: np.ndarray, metric: str) -> list:
    """Exact integer distances row->center as python ints: squared L2
    ('l2' — can exceed 64 bits at K=32, so no numpy dtype is safe) or
    Chebyshev ('linf')."""
    if len(rows) == 0:
        return []
    diff = np.abs(rows.astype(np.int64) - center.astype(np.int64))
    if metric == "linf":
        return [int(v) for v in diff.max(axis=1)]
    return [sum(v * v for v in r) for r in diff.tolist()]


def knn_radius(dist: int, metric: str) -> int:
    """Box half-width covering the ball of (squared-L2 or L∞) radius
    `dist`: ceil(sqrt) for l2, identity for linf."""
    if metric == "linf":
        return int(dist)
    r = math.isqrt(int(dist))
    return r if r * r >= dist else r + 1


def knn_box(center: np.ndarray, radius: int, K: int):
    """[center - r, center + r] clipped to the key domain, as uint64."""
    c = center.astype(np.int64)
    lim = np.int64(2**K - 1)
    qL = np.maximum(c - radius, 0).astype(np.uint64)
    qU = np.minimum(c + radius, lim).astype(np.uint64)
    return qL, qU


def knn_select(rows: np.ndarray, center: np.ndarray, k: int, metric: str):
    """Exact top-k of `rows` by distance to `center`, deterministic
    (distance, then lexicographic row) tie-break.  Returns (rows, dists)."""
    dists = exact_dists(rows, center, metric)
    order = sorted(range(len(rows)),
                   key=lambda i: (dists[i], tuple(rows[i].tolist())))[:k]
    sel = rows[order] if order else np.empty((0, rows.shape[1]
                                              if rows.ndim == 2 else 0),
                                             dtype=np.uint64)
    return sel, [dists[i] for i in order]


def query_knn(index: LMSFCIndex, center, k: int, metric: str = "l2"):
    """k nearest neighbors of `center`, exact by construction.

    Seed: expand page rings around the center's curve address until >= k
    live rows are covered; their exact k-th distance upper-bounds the true
    one.  Refine: retrieve the covering box [center-r, center+r] exactly
    (`query_range`) and take the exact top-k.  Returns (rows (k', d) uint64,
    dists list of python ints, stats) with k' = min(k, live rows)."""
    center = np.asarray(center, dtype=np.uint64)
    store = getattr(index, "_delta_store", None)
    has_updates = store is not None and (store.deltas or store.tombstones)
    total = index.n
    if store is not None:
        total += store.n_inserted - store.n_deleted
    kk = min(int(k), total)
    stats = QueryStats()
    if kk <= 0:
        return np.empty((0, index.d), dtype=np.uint64), [], stats
    z = index.curve.encode_np(center[None])
    p0 = int(index.page_of(z)[0])
    stats.index_accesses += 1
    Pn = index.num_pages

    def live_rows(p):
        if has_updates:
            return store.live_page_rows(p)
        s, e = int(index.starts[p]), int(index.starts[p + 1])
        return index.xs[s:e]

    w = 1
    parts = []
    n_seed = 0
    cov_lo, cov_hi = p0, p0 - 1         # nothing covered yet
    while True:
        lo, hi = max(p0 - w, 0), min(p0 + w, Pn - 1)
        # read only the pages the widened ring adds (once-per-page
        # semantics, like the buffer-cache contract of _candidate_pages)
        for p in list(range(lo, cov_lo)) + list(range(cov_hi + 1, hi + 1)):
            rows = live_rows(p)
            if len(rows):
                parts.append(rows)
                n_seed += len(rows)
        stats.pages_accessed += (cov_lo - lo) + (hi - cov_hi)
        cov_lo, cov_hi = lo, hi
        if n_seed >= kk or (lo == 0 and hi == Pn - 1):
            break
        w *= 2
    seed = np.concatenate(parts) if parts \
        else np.empty((0, index.d), dtype=np.uint64)
    if len(seed) == 0:          # duplicate-inserted rows can inflate `total`
        return np.empty((0, index.d), dtype=np.uint64), [], stats
    kth = sorted(exact_dists(seed, center, metric))[min(kk, len(seed)) - 1]
    qL, qU = knn_box(center, knn_radius(kth, metric), index.K)
    box_rows, rstats = query_range(index, qL, qU)
    stats.merge(rstats)
    rows, dists = knn_select(box_rows, center, kk, metric)
    stats.result = len(rows)
    return rows, dists, stats


def run_workload(index: LMSFCIndex, Ls: np.ndarray, Us: np.ndarray):
    """Vector of counts + aggregated stats over a workload."""
    agg = QueryStats()
    counts = np.zeros(len(Ls), dtype=np.int64)
    for t, (qL, qU) in enumerate(zip(Ls, Us)):
        st = query_count(index, qL, qU)
        counts[t] = st.result
        agg.merge(st)
    return counts, agg


def lex_sorted_rows(rows: np.ndarray) -> np.ndarray:
    """Rows sorted lexicographically (dim 0 primary) — the canonical
    per-query order of every range-retrieval result."""
    if len(rows) <= 1:
        return rows
    return rows[np.lexsort(rows.T[::-1])]


def brute_force_count(data: np.ndarray, qL, qU) -> int:
    """Oracle for tests/benchmarks."""
    return int(np.all((data >= qL) & (data <= qU), axis=1).sum())


def brute_force_range(data: np.ndarray, qL, qU) -> np.ndarray:
    """Oracle: rows of `data` inside [qL, qU], lexicographically sorted."""
    return lex_sorted_rows(data[np.all((data >= qL) & (data <= qU), axis=1)])


def brute_force_knn(data: np.ndarray, center, k: int, metric: str = "l2"):
    """Oracle: exact k nearest rows of `data` to `center` under the same
    deterministic (distance, lexicographic) tie-break.  Returns (rows,
    dists)."""
    center = np.asarray(center, dtype=np.uint64)
    return knn_select(np.asarray(data, dtype=np.uint64), center,
                      min(int(k), len(data)), metric)
