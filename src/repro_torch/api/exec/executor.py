"""The `Executor`: runs `QueryPlan`s with a shape-bucketed query-fn
cache shared across a Database's engines.

The executor owns the engines' query fns, keyed by *bucket* values
(powers of two, clipped at the overflow-free bound), so the cache size is
bounded by the bucket count whatever the traffic.  `CacheStats` exposes
hit / miss / compile counts with the reference's bookkeeping, where a
"compile" is a new (query fn, query shape, points shape) combination: in
the JAX package the event that traces and compiles, here the first launch
of a shape (the port's query fns are plain torch functions, nothing is
compiled, and the first launch pays the first-use costs only).

Execution itself is the exactness policy that used to be inlined in
`Database`: first pass at the plan's bucketed budgets, the plan's
escalation ladder over the still-overflowed subset, and the CPU walk as
the final net.  Per-stage costs land on ``plan.accounting``.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ... import obs
from ...core.query import (QueryStats, knn_box, knn_select, lex_sorted_rows,
                           query_count, query_knn, query_point, query_range)
from ...core.serve import bucket_pow2
from ..queries import Count, Query
from ..result import KnnResult, PointResult, QueryResult, RangeResult
from .plan import QueryPlan


@dataclasses.dataclass
class CacheStats:
    """The executor's compiled-fn cache counters."""

    hits: int = 0        # fn-cache hits (no build)
    misses: int = 0      # fn-cache misses (a fresh fn was built)
    compiles: int = 0    # new (fn, input-shape) combos — first launches
    calls: int = 0       # total query-fn launches
    evictions: int = 0   # entries dropped (engine invalidated/re-attached)

    def snapshot(self) -> "CacheStats":
        return dataclasses.replace(self)


def _fence(out):
    """Block until the query fn's CUDA outputs are computed, so a span
    around a launch measures device time instead of the enqueue.  A kernel
    fault surfaces here and propagates; CPU tensors need no fence."""
    devices = {t.device for t in out if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def _concat_rows(parts, d, dist_parts=None):
    """Per-query row lists -> (rows, offsets[, dists]) with empty-safe
    concatenation (the result assembly shared by Range and Knn)."""
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    rows = (np.concatenate(parts) if offsets[-1]
            else np.empty((0, d), dtype=np.uint64))
    if dist_parts is None:
        return rows, offsets
    dists = (np.concatenate([np.asarray(v, dtype=np.float64)
                             for v in dist_parts]) if offsets[-1]
             else np.empty(0, dtype=np.float64))
    return rows, offsets, dists


class Executor:
    """Plan execution + the shape-bucketed compiled-fn cache for one
    `Database` (shared by all of its engines)."""

    def __init__(self, db):
        self.db = db
        self.cache = CacheStats()
        self._fns = {}            # (engine serial, kind, *budgets) -> fn
        self._traced = set()      # (key, input shapes) — compile events
        self._serial = itertools.count()
        self._stage = "first"     # obs label for in-flight device calls:
                                  #   'first' | 'escalate' ('compile' when
                                  #   the launch is a new shape's first)

    # ------------------------------------------------------------------
    # compiled-fn cache (engines fetch their query fns here)
    # ------------------------------------------------------------------
    def _engine_key(self, eng) -> int:
        key = getattr(eng, "_exec_serial", None)
        if key is None:
            key = eng._exec_serial = next(self._serial)
        return key

    def bucket_cand(self, eng, max_cand: int) -> int:
        """Round a candidate budget up to its bucket (pow2, clipped at the
        engine's overflow-free bound — the bound itself is a bucket)."""
        return min(bucket_pow2(max_cand), eng.overflow_free_cand)

    def bucket_hits(self, eng, max_hits: int) -> int:
        return min(bucket_pow2(max_hits), eng.overflow_free_hits)

    def count_fn(self, eng, max_cand: int):
        """The (bucketed) compiled count fn for `eng`; builds on miss."""
        mc = self.bucket_cand(eng, max_cand)
        key = (self._engine_key(eng), "count", mc)
        return self._get(key, lambda: eng._build_qfn(mc), eng.name)

    def range_fn(self, eng, max_cand: int, max_hits: int):
        """The (bucketed) compiled range fn for `eng`; builds on miss."""
        mc = self.bucket_cand(eng, max_cand)
        mh = self.bucket_hits(eng, max_hits)
        key = (self._engine_key(eng), "range", mc, mh)
        return self._get(key, lambda: eng._build_rfn(mc, mh), eng.name)

    def _get(self, key, build, eng_name="?"):
        fn = self._fns.get(key)
        if fn is None:
            self.cache.misses += 1
            obs.inc("executor.fn_cache.misses", engine=eng_name)
            with obs.span("executor.fn_build", engine=eng_name,
                          kind=key[1]):
                inner = build()

            def fn(arrays, queries, _key=key, _inner=inner, _eng=eng_name):
                self.cache.calls += 1
                tk = (_key, tuple(queries.shape),
                      tuple(arrays.points.shape))
                new_trace = tk not in self._traced
                if new_trace:
                    self._traced.add(tk)
                    self.cache.compiles += 1
                if not obs.enabled():
                    return _inner(arrays, queries)
                # the first launch of a (fn, shape) combo books under
                # stage='compile' (first-use costs), as in the reference,
                # not the device stages; the fence makes device time real
                stage = "compile" if new_trace else self._stage
                with obs.span("executor.device_call", engine=_eng,
                              kind=_key[1], stage=stage):
                    out = _inner(arrays, queries)
                    with obs.span("executor.device_wait", engine=_eng):
                        _fence(out)
                return out

            self._fns[key] = fn
        else:
            self.cache.hits += 1
            obs.inc("executor.fn_cache.hits", engine=eng_name)
        return fn

    def evict(self, eng) -> int:
        """Drop every cached fn of `eng` (rebuild invalidation / engine
        re-attach); returns how many entries were evicted."""
        key = getattr(eng, "_exec_serial", None)
        if key is None:
            return 0
        dead = [k for k in self._fns if k[0] == key]
        for k in dead:
            del self._fns[k]
        self._traced = {t for t in self._traced if t[0][0] != key}
        self.cache.evictions += len(dead)
        return len(dead)

    def cache_size(self, eng=None) -> int:
        """Live fn-cache entries (optionally of one engine)."""
        if eng is None:
            return len(self._fns)
        key = getattr(eng, "_exec_serial", None)
        return sum(1 for k in self._fns if k[0] == key)

    # ------------------------------------------------------------------
    # plan execution
    # ------------------------------------------------------------------
    def execute(self, plan: QueryPlan, q, U=None):
        """Run one query batch under `plan`; returns the kind's result type
        with `plan` (accounting filled) attached."""
        if not isinstance(q, Query):
            q = Count(q, U)
        if plan.payload is None:       # hand-built plan: validate here
            payload = q.normalized(d=self.db.d)
            plan.payload = payload if isinstance(payload, tuple) \
                else (payload,)
        before = self.cache.snapshot()
        name, eng = self.db._get_engine(plan.engine)
        run = {"count": self._exec_count, "range": self._exec_range,
               "point": self._exec_point, "knn": self._exec_knn}[plan.kind]
        with obs.span("executor.execute", kind=plan.kind, engine=name):
            res = run(plan, q, name, eng)
        acct = plan.accounting
        acct.cache_hits += self.cache.hits - before.hits
        acct.cache_misses += self.cache.misses - before.misses
        acct.compiles += self.cache.compiles - before.compiles
        acct.escalations += res.escalations
        acct.cpu_fallbacks += res.cpu_fallbacks
        if res.stats is not None:
            acct.pages_scanned += res.stats.pages_accessed
        if obs.enabled():
            obs.inc("executor.queries", plan.Q, kind=plan.kind, engine=name)
            obs.inc("executor.escalations", res.escalations, kind=plan.kind)
            obs.inc("executor.cpu_fallbacks", res.cpu_fallbacks,
                    kind=plan.kind)
        return res

    # -- COUNT (also the device POINT lowering) ------------------------
    def _count_exact(self, plan, eng, Ls, Us):
        """Counts + overflow escalation along the plan's ladder, CPU net."""
        acct = plan.accounting
        eng.sync(eng.cfg.on_stale)
        counts, over, stats = eng.run(Ls, Us, max_cand=plan.max_cand)
        acct.device_calls += 1
        first_over = over.copy()
        rounds = 0
        fallbacks = 0
        if over.any():
            cb = eng.overflow_free_cand
            last = plan.max_cand
            self._stage = "escalate"
            try:
                for step in plan.ladder:
                    if not over.any():
                        break
                    mc = min(step.max_cand, cb)
                    if mc == last:
                        continue
                    last = mc
                    with obs.span("executor.escalate", kind=plan.kind,
                                  engine=eng.name):
                        idx = np.nonzero(over)[0]
                        c2, o2, _ = eng.run(Ls[idx], Us[idx], max_cand=mc)
                        acct.device_calls += 1
                        counts = counts.copy()
                        counts[idx] = c2
                        over = np.zeros_like(over)
                        over[idx] = o2
                    rounds += 1
            finally:
                self._stage = "first"
        if over.any() and plan.cpu_fallback:
            counts = counts.copy()
            with obs.span("executor.cpu_net", kind=plan.kind,
                          engine=eng.name):
                for i in np.nonzero(over)[0]:
                    counts[i] = query_count(self.db.index,
                                            Ls[i], Us[i]).result
                    fallbacks += 1
            over = np.zeros_like(over)
        return counts, first_over, over, rounds, fallbacks, stats

    def _exec_count(self, plan, q, name, eng) -> QueryResult:
        Ls, Us = plan.payload
        if name == "cpu":
            with obs.span("executor.device_call", engine=name,
                          kind=plan.kind, stage="first"):
                counts, over, stats = eng.run(Ls, Us)
            plan.accounting.device_calls += 1
            return QueryResult(counts=counts, engine=name,
                               epoch=self.db.store.epoch, stats=stats,
                               overflowed=over, plan=plan)
        counts, first_over, over, rounds, fallbacks, stats = \
            self._count_exact(plan, eng, Ls, Us)
        if stats is None:
            stats = QueryStats(result=int(counts.sum()), subqueries=len(Ls))
        return QueryResult(counts=counts, engine=name,
                           epoch=self.db.store.epoch, stats=stats,
                           overflowed=first_over, residual_overflow=over,
                           escalations=rounds, cpu_fallbacks=fallbacks,
                           plan=plan)

    # -- RANGE retrieval -----------------------------------------------
    def _range_exact(self, plan, eng, Ls, Us):
        """Row retrieval + two-dimensional escalation (candidate pages and
        the row-id buffer) along the plan's ladder, CPU walk as the net."""
        acct = plan.accounting
        eng.sync(eng.cfg.on_stale)
        rows_list, co, ho, stats = eng.run_range(
            Ls, Us, max_cand=plan.max_cand, max_hits=plan.max_hits)
        acct.device_calls += 1
        first_over = (co + ho).astype(np.int32)
        over = ((co > 0) | (ho > 0)).astype(np.int32)
        rounds = 0
        fallbacks = 0
        if over.any():
            cb = eng.overflow_free_cand
            hb = eng.overflow_free_hits
            last = (plan.max_cand, plan.max_hits)
            self._stage = "escalate"
            try:
                for step in plan.ladder:
                    if not over.any():
                        break
                    mc = min(step.max_cand, cb)
                    mh = min(step.max_hits or plan.max_hits, hb)
                    if (mc, mh) == last:
                        continue
                    last = (mc, mh)
                    with obs.span("executor.escalate", kind=plan.kind,
                                  engine=eng.name):
                        idx = np.nonzero(over)[0]
                        rl2, co2, ho2, _ = eng.run_range(
                            Ls[idx], Us[idx], max_cand=mc, max_hits=mh)
                        acct.device_calls += 1
                        for j, i in enumerate(idx):
                            rows_list[i] = rl2[j]
                        co = np.zeros_like(co)
                        ho = np.zeros_like(ho)
                        co[idx] = co2
                        ho[idx] = ho2
                        over = ((co > 0) | (ho > 0)).astype(np.int32)
                    rounds += 1
            finally:
                self._stage = "first"
        if over.any() and plan.cpu_fallback:
            with obs.span("executor.cpu_net", kind=plan.kind,
                          engine=eng.name):
                for i in np.nonzero(over)[0]:
                    rows_list[i] = query_range(self.db.index,
                                               Ls[i], Us[i])[0]
                    fallbacks += 1
            over = np.zeros_like(over)
        return rows_list, first_over, over, rounds, fallbacks, stats

    def _exec_range(self, plan, q, name, eng) -> RangeResult:
        Ls, Us = plan.payload
        if name == "cpu":
            with obs.span("executor.device_call", engine=name,
                          kind=plan.kind, stage="first"):
                rows_list, co, ho, stats = eng.run_range(Ls, Us)
            plan.accounting.device_calls += 1
            first_over, over, rounds, fallbacks = co, ho, 0, 0
        else:
            rows_list, first_over, over, rounds, fallbacks, stats = \
                self._range_exact(plan, eng, Ls, Us)
        with obs.span("executor.order_rows", engine=name):
            # canonical order
            rows_list = [lex_sorted_rows(r) for r in rows_list]
            rows, offsets = _concat_rows(rows_list, self.db.d)
        if stats is None:
            stats = QueryStats(result=int(offsets[-1]), subqueries=len(Ls))
        return RangeResult(rows=rows, offsets=offsets, engine=name,
                           epoch=self.db.store.epoch, stats=stats,
                           overflowed=first_over, residual_overflow=over,
                           escalations=rounds, cpu_fallbacks=fallbacks,
                           plan=plan)

    # -- POINT lookup --------------------------------------------------
    def _exec_point(self, plan, q, name, eng) -> PointResult:
        xs, = plan.payload
        epoch = self.db.store.epoch
        if name == "cpu":
            with obs.span("executor.device_call", engine=name,
                          kind=plan.kind, stage="first"):
                found = query_point(self.db.index, xs)
            return PointResult(found=found, engine=name, epoch=epoch,
                               plan=plan)
        # device engines: the whole (Q, d) probe batch is one degenerate
        # one-cell-per-query window batch — a single padded device call
        # through the same bucketed count path; exact by construction, so
        # found == (count > 0)
        counts, _, _, rounds, fallbacks, stats = \
            self._count_exact(plan, eng, xs, xs)
        return PointResult(found=counts > 0, engine=name, epoch=epoch,
                           stats=stats, escalations=rounds,
                           cpu_fallbacks=fallbacks, plan=plan)

    # -- kNN -----------------------------------------------------------
    def _exec_knn(self, plan, q, name, eng) -> KnnResult:
        """Exact kNN: seed an upper-bound radius from expanding page rings
        around each center's curve address, retrieve the covering box
        exactly through the engine's native range path, refine with exact
        integer distances (deterministic tie-break)."""
        db = self.db
        centers, = plan.payload
        k, metric = int(q.k), q.metric
        epoch = db.store.epoch
        if name == "cpu":
            stats = QueryStats()
            parts, dist_parts = [], []
            with obs.span("executor.device_call", engine=name,
                          kind=plan.kind, stage="first"):
                for c in centers:
                    rows, dd, st = query_knn(db.index, c, k, metric)
                    parts.append(rows)
                    dist_parts.append(dd)
                    stats.merge(st)
            rows, offsets, dd = _concat_rows(parts, db.d, dist_parts)
            return KnnResult(neighbors=rows, offsets=offsets, dists=dd,
                             k=k, metric=metric, engine=name, epoch=epoch,
                             stats=stats, plan=plan)
        eng.sync(eng.cfg.on_stale)
        total = eng.live_row_total()
        kk = min(k, total)
        if kk <= 0:
            rows, offsets, dd = _concat_rows([[]] * len(centers), db.d,
                                             [[]] * len(centers))
            return KnnResult(neighbors=rows, offsets=offsets, dists=dd,
                             k=k, metric=metric, engine=name, epoch=epoch,
                             plan=plan)
        with obs.span("executor.knn_seed", kind=plan.kind, engine=name):
            radius = eng.knn_radius(centers, k, metric)
            Ls = np.empty_like(centers)
            Us = np.empty_like(centers)
            for i, (c, r) in enumerate(zip(centers, radius)):
                Ls[i], Us[i] = knn_box(c, r, db.index.K)
        rows_list, first_over, over, rounds, fallbacks, stats = \
            self._range_exact(plan, eng, Ls, Us)
        box_rows = np.array([len(r) for r in rows_list], dtype=np.int64)
        obs.inc("executor.knn_box_rows", int(box_rows.sum()), engine=name)
        with obs.span("executor.knn_refine", kind=plan.kind, engine=name):
            parts, dist_parts = [], []
            for c, rows in zip(centers, rows_list):
                sel, dd = knn_select(rows, c, kk, metric)
                parts.append(sel)
                dist_parts.append(dd)
            rows, offsets, dd = _concat_rows(parts, db.d, dist_parts)
        return KnnResult(neighbors=rows, offsets=offsets, dists=dd, k=k,
                         metric=metric, engine=name, epoch=epoch,
                         stats=stats, escalations=rounds,
                         cpu_fallbacks=fallbacks, plan=plan,
                         overflowed=first_over, residual_overflow=over,
                         box_rows=box_rows)
