"""The `store` execution engine: segment-backed device serving through
the page-group cache.

``db = Database.from_segment(path); db.engine("store")`` serves every
query kind of the algebra without a full in-memory pack.  Per batch:

  select    — host-side page preselect: pages are z-disjoint and sorted,
              so the pages overlapping a query's whole z-range
              [enc(qL), enc(qU)] form one contiguous run found with two
              binary searches; the touched *page groups* over the whole
              batch are the union of those runs (vectorized difference-
              array sweep).
  assemble  — the cache yields the selected groups' device blocks
              (hits stay resident, misses upload on demand); the block
              list is padded with a shared dead block up to its pow2
              shape bucket and concatenated on the device (one `torch.cat`
              per field) into one `ServingArrays`, so the query fns see a
              bounded set of shapes.
  execute   — the standard serving path (`make_query_fn` /
              `make_range_fn` via the executor's query-fn cache) runs on
              that subset: on the hand-written CUDA kernels (backend
              'cuda', the default on a CUDA device) or on their plain-torch
              twins (backend 'torch', the default only under
              ``device="cpu"``; 'cuda' on a CPU device raises, so the
              engine never serves the twins while claiming the kernels);
              range hits resolve to rows through the group map + the
              segment memmap.

Exactness: monotonicity puts every split sub-rectangle's z-range inside
[enc(qL), enc(qU)], so the preselected run is a superset of every page
the serving path's own prune (per-sub-query z-overlap AND MBR intersect)
can keep — it sees exactly the candidate set it would see over the full
pack, and counts/hits/overflow flags are identical.  The executor's
escalation ladder and CPU net apply unchanged (the CPU net walks the
memmap-backed index).

The engine serves the immutable segment snapshot: once deltas exist
(`db.insert`/`delete`), `sync` raises `StaleServingError` — route those
epochs through the CPU engine or rebuild the segment — unless configured
``on_stale='serve_stale'``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import obs
from ..api.engines import BaseEngine, StaleServingError, register_engine
from ..api.result import EngineConfig
from ..core.device import resolve_device
from ..core.serve import (ServingArrays, bucket_pow2, make_query_fn,
                          make_range_fn, pack_query_rects)
from .cache import PageGroupCache

DEFAULT_GROUP_PAGES = 64
DEFAULT_CACHE_BYTES = 256 << 20


@register_engine("store")
class StoreEngine(BaseEngine):
    """Segment-backed batched device engine (out-of-core serving)."""

    backends = ("cuda", "torch")
    capabilities = frozenset({"count", "range", "point", "knn"})

    def __init__(self, db, cfg: EngineConfig):
        super().__init__(db, cfg)
        seg = getattr(db, "segment", None)
        if seg is None:
            raise ValueError(
                "the 'store' engine serves an on-disk segment; build one "
                "with repro_torch.store.build_segment (or write_segment_"
                "from_index) and attach via Database.from_segment(path)")
        self.segment = seg
        self.device = resolve_device(cfg.device if cfg.device is not None
                                     else db.device)
        if self.backend not in self.backends:
            raise ValueError(f"engine 'store' takes backend in "
                             f"{self.backends}; got {self.backend!r}")
        if self.backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"the 'store' engine's 'cuda' backend runs the CUDA kernels "
                f"and needs a CUDA device; got {self.device} (use "
                f"backend='torch' for the plain-torch path on the host)")
        self.group_pages = int(getattr(cfg, "group_pages", None)
                               or DEFAULT_GROUP_PAGES)
        self._cache = None

    # -- config --------------------------------------------------------
    @property
    def default_backend(self) -> str:
        return "cuda" if self.device.type == "cuda" else "torch"

    @property
    def backend(self) -> str:
        return self.cfg.backend or self.default_backend

    @property
    def pad_pages_to(self) -> int:
        """Planner bound hook: assembled page counts are group multiples."""
        return self.group_pages

    @property
    def cache(self) -> PageGroupCache:
        if self._cache is None:
            self._cache = PageGroupCache(
                self.segment, group_pages=self.group_pages,
                budget_bytes=(getattr(self.cfg, "cache_bytes", None)
                              or DEFAULT_CACHE_BYTES),
                device=self.device)
        return self._cache

    # -- lifecycle -----------------------------------------------------
    def sync(self, on_stale: str = "refresh"):
        if self.db.store.epoch > 0 and on_stale != "serve_stale":
            raise StaleServingError(
                f"store engine serves the immutable segment snapshot "
                f"(epoch 0) but the DeltaStore is at epoch "
                f"{self.db.store.epoch}; query deltas through the cpu "
                f"engine, rebuild the segment, or opt in with "
                f"on_stale='serve_stale'")

    def invalidate(self):
        if self._cache is not None:
            self._cache.clear()
        self._cache = None
        self.db.executor.evict(self)

    # -- executor hooks ------------------------------------------------
    @property
    def overflow_free_cand(self) -> int:
        G = self.group_pages
        return -(-self.segment.num_pages // G) * G

    @property
    def overflow_free_hits(self) -> int:
        return max(1, self.segment.n)

    def _build_qfn(self, max_cand):
        return make_query_fn(
            self.db.index.curve, k_maxsplit=self.cfg.k_maxsplit,
            max_cand=max_cand, q_chunk=self.cfg.q_chunk,
            backend=self.backend)

    def _build_rfn(self, max_cand, max_hits):
        return make_range_fn(
            self.db.index.curve, k_maxsplit=self.cfg.k_maxsplit,
            max_cand=max_cand, max_hits=max_hits, q_chunk=self.cfg.q_chunk,
            backend=self.backend)

    # -- selection + assembly -------------------------------------------
    def _select_groups(self, Ls, Us) -> np.ndarray:
        """Sorted unique page-group ids whose pages can survive the
        serving path's prune for any query in the batch (see module
        docstring for the superset argument)."""
        seg = self.segment
        curve = seg.curve
        zlo = curve.encode_np(np.asarray(Ls, dtype=np.uint64))
        zhi = curve.encode_np(np.asarray(Us, dtype=np.uint64))
        lo = np.searchsorted(seg.page_zmax, zlo, side="left")
        hi = np.searchsorted(seg.page_zmin, zhi, side="right")
        ok = hi > lo
        if not ok.any():
            return np.empty(0, dtype=np.int64)
        G = self.group_pages
        glo = lo[ok] // G
        ghi = (hi[ok] - 1) // G
        mark = np.zeros(seg.num_groups(G) + 1, dtype=np.int64)
        np.add.at(mark, glo, 1)
        np.add.at(mark, ghi + 1, -1)
        return np.nonzero(np.cumsum(mark[:-1]) > 0)[0]

    def _assemble(self, groups: np.ndarray) -> ServingArrays:
        """Concatenate the groups' device blocks (dead-padded to the pow2
        block bucket) into one ServingArrays for the query fns."""
        blocks = self.cache.get(groups)
        nb = bucket_pow2(len(blocks))
        if nb > len(blocks):
            blocks = blocks + [self.cache.dead_block()] * (nb - len(blocks))
        with obs.span("store.assemble", groups=len(groups), blocks=nb):
            if len(blocks) == 1:
                return blocks[0]
            out = ServingArrays(**{
                f: torch.cat([getattr(b, f) for b in blocks], dim=0)
                for f in ("points", "page_zmin", "page_zmax", "page_mbr",
                          "page_size")})
            if obs.enabled() and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return out

    def _device_queries(self, Ls, Us) -> torch.Tensor:
        Qp = bucket_pow2(len(Ls), self.cfg.q_chunk)
        return torch.from_numpy(pack_query_rects(Ls, Us, Qp)).to(self.device)

    def _resolve_rows(self, gid: np.ndarray, groups: np.ndarray,
                      cap: int) -> np.ndarray:
        """Assembled-local gids (page * cap + slot) -> rows read from the
        segment memmap (slot order within a packed page IS xs order)."""
        seg = self.segment
        G = self.group_pages
        lp = gid // cap
        gp = groups[lp // G] * G + lp % G
        return np.asarray(seg.xs[seg.starts[gp] + gid % cap],
                          dtype=np.uint64)

    # -- execution -----------------------------------------------------
    def run(self, Ls, Us, max_cand=None):
        if len(Ls) == 0:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int32), None)
        Q = len(Ls)
        groups = self._select_groups(Ls, Us)
        if len(groups) == 0:
            return (np.zeros(Q, dtype=np.int64),
                    np.zeros(Q, dtype=np.int32), None)
        arrays = self._assemble(groups)
        q = self._device_queries(Ls, Us)
        fn = self.db.executor.count_fn(self, max_cand or self.cfg.max_cand)
        counts, over = fn(arrays, q)
        return (counts.cpu().numpy()[:Q].astype(np.int64),
                over.cpu().numpy()[:Q].astype(np.int32), None)

    def run_range(self, Ls, Us, max_cand=None, max_hits=None):
        if len(Ls) == 0:
            zeros = np.empty(0, dtype=np.int32)
            return [], zeros, zeros.copy(), None
        Q = len(Ls)
        d = self.segment.d
        groups = self._select_groups(Ls, Us)
        if len(groups) == 0:
            zeros = np.zeros(Q, dtype=np.int32)
            return ([np.empty((0, d), dtype=np.uint64) for _ in range(Q)],
                    zeros, zeros.copy(), None)
        arrays = self._assemble(groups)
        cap = self.segment.cap
        P_pad = int(arrays.points.shape[0])
        if P_pad * cap >= 2**31:
            raise ValueError(
                f"range retrieval needs pages*cap < 2^31 for int32 row "
                f"ids; got {P_pad} assembled pages x cap {cap} — shrink "
                f"group_pages or the query batch")
        q = self._device_queries(Ls, Us)
        fn = self.db.executor.range_fn(
            self, max_cand or self.cfg.max_cand,
            max_hits or self.cfg.max_hits)
        ids, n_hits, co, ho = fn(arrays, q)
        ids = ids.cpu().numpy()[:Q]
        co = co.cpu().numpy()[:Q].astype(np.int32)
        ho = ho.cpu().numpy()[:Q].astype(np.int32)
        rows_list = []
        for i in range(Q):
            gid = ids[i][ids[i] >= 0].astype(np.int64)
            rows_list.append(self._resolve_rows(gid, groups, cap))
        return rows_list, co, ho, None

    # -- kNN seeding over the memmap ------------------------------------
    def live_row_total(self) -> int:
        return self.segment.n

    def knn_radius(self, centers: np.ndarray, k: int,
                   metric: str = "l2") -> list:
        """Upper-bound each center's k-th-NN distance by expanding page
        rings around its curve address, reading ring rows straight off
        the segment memmap (pages are contiguous in `xs`, so a ring is
        one slice).  Same bound-inflation contract as
        `core.serve.knn_seed_radius`."""
        seg = self.segment
        centers = np.atleast_2d(np.asarray(centers, dtype=np.uint64))
        Pn = seg.num_pages
        kk = min(int(k), seg.n)
        if kk <= 0:
            return [0] * len(centers)
        zc = seg.curve.encode_np(centers)
        p0 = np.clip(np.searchsorted(seg.page_zmin, zc, side="right") - 1,
                     0, Pn - 1)
        radius = []
        for c, p in zip(centers, p0):
            w = 1
            while True:
                lo = max(int(p) - w, 0)
                hi = min(int(p) + w, Pn - 1)
                s, e = int(seg.starts[lo]), int(seg.starts[hi + 1])
                if e - s >= kk or (lo == 0 and hi == Pn - 1):
                    rows = np.asarray(seg.xs[s:e], dtype=np.uint64)
                    if metric == "linf":
                        dist = np.abs(rows.astype(np.int64)
                                      - c.astype(np.int64)).max(axis=1)
                        radius.append(
                            int(np.partition(dist, kk - 1)[kk - 1]))
                    else:
                        diff = rows.astype(np.float64) - c.astype(np.float64)
                        d2 = np.sum(diff * diff, axis=1)
                        v = float(np.partition(d2, kk - 1)[kk - 1])
                        # float64 may round the exact integer d2 either
                        # way; inflate so the box stays a cover
                        safe = v * (1 + 1e-9) + 1.0
                        radius.append(int(math.ceil(math.sqrt(safe))) + 1)
                    break
                w *= 2
        return radius
