"""`Router` — one logical dataset served from N shard `Database`s.

Rows are partitioned across shards by a `ShardSpec` built on the
`repro_torch.dist` sharding rules: the row axis is treated as a batch axis over
the mesh's ``"data"`` dimension, so the divisibility policy is the one
``ShardingRules.batch_ax`` already enforces for the training substrate —
a row count that divides the shard count splits into equal contiguous
blocks (what GSPMD would do without padding); one that does not falls
back to near-even blocks instead of silent replication (replicated rows
would double-count every merge).

A query **scatters** to every shard (shards hold disjoint row subsets, so
each executes the *same* plan against its own data), then results
**merge** exactly:

  Count  — per-query sum of shard counts (disjoint rows)
  Range  — per-query offset-stitched concatenation, re-sorted into the
           canonical lexicographic order
  Point  — per-row OR of shard presence
  Knn    — union of each shard's exact top-k, globally re-ranked by the
           exact integer (distance, lexicographic row) tie-break — the
           same order an unsharded database produces, bit-for-bit

Every merge preserves "exact by construction": a shard result is exact,
disjointness makes the merge lossless, and the kNN re-rank recomputes
distances as exact python ints rather than trusting float64 round-trips.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ... import obs
from ...core.query import QueryStats, knn_select, lex_sorted_rows
from ...dist.sharding import P, ShardingRules
from ..queries import Count, Query
from ..result import KnnResult, PointResult, QueryResult, RangeResult
from .executor import _concat_rows
from .plan import ExecAccounting


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Row-partitioning spec for a `Router`, backed by the production
    mesh's sharding rules (`repro_torch.dist.sharding.ShardingRules`): shards
    are the ``"data"`` axis of a 1-wide-model mesh."""

    n_shards: int
    rules: ShardingRules = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1; got {self.n_shards}")
        if self.rules is None:
            object.__setattr__(
                self, "rules",
                ShardingRules(model_size=1, data_size=self.n_shards))

    def partition(self, n_rows: int) -> list:
        """Per-shard row-index arrays.  `batch_ax` decides the policy:
        divisible counts split into equal contiguous blocks ("data"-axis
        sharding); non-divisible counts fall back to near-even blocks
        (never replication — see module docstring)."""
        ids = np.arange(n_rows, dtype=np.int64)
        if self.rules.batch_ax(n_rows) is not None:
            return list(ids.reshape(self.n_shards, -1))
        return list(np.array_split(ids, self.n_shards))

    def spec(self, n_rows: int):
        """The partition spec the row axis shards under (None when the
        count is not divisible — the rules' replication fallback, which
        `partition` overrides with near-even blocks)."""
        return P(self.rules.batch_ax(n_rows))


@dataclasses.dataclass
class RouterPlan:
    """What `Router.explain` returns: the scatter (one structured
    `QueryPlan` per shard) plus the merge operator applied on gather.

    On an *executed* merged result (``result.plan``) `accounting` is the
    sum over all shards (`ExecAccounting.merged`), with the unsummed
    per-shard breakdown kept in ``accounting.per_shard`` — sharded runs
    report every device call and escalation, not just shard 0's."""

    kind: str
    merge: str                 # 'sum' | 'lex-stitch' | 'or' | 'rerank'
    shards: list               # per-shard QueryPlan
    accounting: ExecAccounting = None   # filled on executed plans only

    def describe(self) -> str:
        lines = [f"scatter {self.kind.upper()} to {len(self.shards)} "
                 f"shards, merge={self.merge}"]
        for i, p in enumerate(self.shards):
            lines.append(f"  shard {i}: " + p.describe().split("\n")[0])
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.describe()


_MERGE = {"count": "sum", "range": "lex-stitch", "point": "or",
          "knn": "rerank"}


class Router:
    """Serve one logical dataset from N shard Databases (module docstring
    has the scatter/merge semantics).  Shards can be built directly
    (`Router(shards)`) or partitioned from one array (`Router.build`)."""

    def __init__(self, shards, *, spec: ShardSpec = None):
        shards = list(shards)
        if not shards:
            raise ValueError("Router needs at least one shard Database")
        d = shards[0].d
        for i, s in enumerate(shards):
            if s.d != d:
                raise ValueError(
                    f"shard {i} is {s.d}-dimensional but shard 0 has d={d};"
                    f" all shards must index the same space")
        self.shards = shards
        self.spec = spec or ShardSpec(len(shards))
        self._rr = 0           # round-robin insert cursor

    @classmethod
    def build(cls, data, n_shards: int, *, spec: ShardSpec = None,
              **fit_kw) -> "Router":
        """Partition `data` by the spec and fit one shard Database per
        block (`fit_kw` forwards to `Database.fit` — e.g. ``workload=``,
        ``curve=``, ``learn=False``, ``device=``)."""
        from ..database import Database    # lazy: database imports exec
        data = np.asarray(data, dtype=np.uint64)
        spec = spec or ShardSpec(n_shards)
        parts = spec.partition(len(data))
        return cls([Database.fit(data[p], **fit_kw) for p in parts],
                   spec=spec)

    # ------------------------------------------------------------------
    @property
    def d(self) -> int:
        return self.shards[0].d

    @property
    def n(self) -> int:
        return sum(s.n for s in self.shards)

    def engine(self, name: str, config=None) -> "Router":
        """Attach an engine on every shard (chainable, like Database)."""
        for s in self.shards:
            s.engine(name, config)
        return self

    def session(self, *, engine: str = None, tick: int = None):
        """A micro-batching `Session` over the whole router: coalesced
        super-batches scatter to every shard and merge exactly, so
        results stay bit-identical to serial `Router.query` calls."""
        from .session import Session       # local: session is kind-agnostic
        return Session(self, engine=engine, tick=tick)

    def serve(self, *, slo=None, engine: str = None):
        """An async serving front (`repro_torch.serving.AsyncServer`) over the
        sharded dataset — same contract as `Database.serve`, with every
        super-batch scattered/merged across the shards."""
        from ...serving.server import AsyncServer  # lazy: serving imports api
        return AsyncServer(self, slo=slo, engine=engine)

    def stats(self, *, format: str = "json"):
        """Current observability snapshot (`repro_torch.obs`): every metric
        the process recorded — router scatter/merge spans included — as one
        flat JSON dict (``format="json"``) or in the Prometheus text
        exposition format (``format="prometheus"``).  Best-effort: empty
        until `repro_torch.obs.enable()` is called."""
        if format == "prometheus":
            return obs.prometheus_text()
        if format != "json":
            raise ValueError(f"unknown stats format {format!r}; expected "
                             f"'json' or 'prometheus'")
        return obs.snapshot()

    # ------------------------------------------------------------------
    def explain(self, q, U=None, *, engine: str = None) -> RouterPlan:
        """The scatter/merge plan: one structured per-shard `QueryPlan`
        plus the merge operator."""
        if not isinstance(q, Query):
            q = Count(q, U)
        q.normalized(d=self.d)
        return RouterPlan(kind=q.kind, merge=_MERGE[q.kind],
                          shards=[s.explain(q, engine=engine)
                                  for s in self.shards])

    def query(self, q, U=None, *, engine: str = None):
        """Scatter one query of the typed algebra across every shard,
        execute, and merge exactly.  Payloads are validated against the
        router's dimensionality up front, so a mixed-dimension submission
        raises `ValueError` before any shard (or device) sees it."""
        if not isinstance(q, Query):
            q = Count(q, U)
        elif U is not None:
            raise ValueError("U= applies only to the legacy (Ls, Us) COUNT "
                             "form, not to typed queries")
        q.normalized(d=self.d)             # reject bad payloads pre-scatter
        with obs.span("router.query", kind=q.kind,
                      shards=len(self.shards)):
            parts = []
            for i, s in enumerate(self.shards):
                with obs.span("router.shard", kind=q.kind, shard=i):
                    parts.append(s.query(q, engine=engine))
            merge = {"count": self._merge_count,
                     "range": self._merge_range,
                     "point": self._merge_point,
                     "knn": self._merge_knn}[q.kind]
            with obs.span("router.merge", kind=q.kind,
                          op=_MERGE[q.kind]):
                return merge(q, parts)

    # ------------------------------------------------------------------
    # merges
    # ------------------------------------------------------------------
    def _provenance(self, q, parts) -> dict:
        stats = QueryStats()
        for r in parts:
            if r.stats is not None:
                stats.merge(r.stats)
        # the merged result's plan: scatter structure + the SUM of every
        # shard's accounting (per_shard keeps the unsummed breakdown)
        shard_plans = [r.plan for r in parts]
        plan = RouterPlan(
            kind=q.kind, merge=_MERGE[q.kind], shards=shard_plans,
            accounting=ExecAccounting.merged(
                p.accounting for p in shard_plans if p is not None))
        return dict(
            engine=f"router[{len(parts)}x{parts[0].engine}]",
            epoch=max(r.epoch for r in parts), stats=stats,
            escalations=sum(r.escalations for r in parts),
            cpu_fallbacks=sum(r.cpu_fallbacks for r in parts),
            plan=plan)

    def _merge_count(self, q, parts) -> QueryResult:
        prov = self._provenance(q, parts)
        return QueryResult(
            counts=np.sum([r.counts for r in parts], axis=0),
            overflowed=np.sum([r.overflowed for r in parts], axis=0,
                              dtype=np.int32),
            residual_overflow=np.sum([r.residual_overflow for r in parts],
                                     axis=0, dtype=np.int32), **prov)

    def _merge_range(self, q, parts) -> RangeResult:
        nq = len(parts[0])
        merged = [lex_sorted_rows(
            np.concatenate([r.rows_for(i) for r in parts]))
            for i in range(nq)]
        rows, offsets = _concat_rows(merged, self.d)
        prov = self._provenance(q, parts)
        return RangeResult(
            rows=rows, offsets=offsets,
            overflowed=np.sum([r.overflowed for r in parts], axis=0,
                              dtype=np.int32),
            residual_overflow=np.sum([r.residual_overflow for r in parts],
                                     axis=0, dtype=np.int32), **prov)

    def _merge_point(self, q, parts) -> PointResult:
        prov = self._provenance(q, parts)
        found = parts[0].found.copy()
        for r in parts[1:]:
            found |= r.found
        return PointResult(found=found, **prov)

    def _merge_knn(self, q, parts) -> KnnResult:
        centers = q.normalized(d=self.d)
        kk = min(int(q.k), self.n)
        sel_parts, dist_parts = [], []
        for i, c in enumerate(centers):
            union = np.concatenate([r.neighbors_for(i) for r in parts])
            # re-rank on exact integer distances (not the shards' float64
            # dists) so global tie-breaks match the unsharded walk exactly
            sel, dd = knn_select(union, c, kk, q.metric)
            sel_parts.append(sel)
            dist_parts.append(dd)
        rows, offsets, dd = _concat_rows(sel_parts, self.d, dist_parts)
        prov = self._provenance(q, parts)
        # a center's box overflowed if it did on any shard; box rows add
        return KnnResult(
            neighbors=rows, offsets=offsets, dists=dd, k=int(q.k),
            metric=q.metric,
            overflowed=np.any([r.overflowed for r in parts],
                              axis=0).astype(np.int32),
            residual_overflow=np.any([r.residual_overflow for r in parts],
                                     axis=0).astype(np.int32),
            box_rows=np.sum([r.box_rows for r in parts], axis=0,
                            dtype=np.int64), **prov)

    # ------------------------------------------------------------------
    # updates: inserts round-robin across shards, deletes broadcast
    # ------------------------------------------------------------------
    def insert(self, x) -> int:
        """Scatter new rows round-robin across shards (keeps them
        balanced); returns the number of rows inserted."""
        x = np.asarray(x, dtype=np.uint64)
        if x.ndim == 1:
            x = x[None]
        n = len(self.shards)
        for j in range(n):
            part = x[(np.arange(len(x)) + self._rr) % n == j]
            if len(part):
                self.shards[j].insert(part)
        self._rr = (self._rr + len(x)) % n
        return len(x)

    def delete(self, x) -> int:
        """Broadcast tombstones; only the owning shard actually deletes.
        Returns how many rows were tombstoned across all shards."""
        return sum(s.delete(x) for s in self.shards)

    def __repr__(self):
        return (f"Router(shards={len(self.shards)}, n={self.n}, d={self.d}, "
                f"spec={self.spec.n_shards}-way)")
