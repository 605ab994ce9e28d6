"""First-class query plans: what `Database.explain` returns and what the
`Executor` runs.

A `QueryPlan` makes every dispatch-time decision inspectable *before*
anything executes: which engine serves the query (capability routing),
the padded device shapes (shape buckets — powers of two on the query
batch and on the candidate/hit budgets, so repeated traffic with varying
batch sizes hits a bounded set of query-fn shapes), and the full
overflow-escalation ladder down to the CPU exactness net.  Executing a
plan fills its `accounting` with per-stage costs (compiles, cache
hits/misses, escalation rounds, CPU fallbacks, pages scanned), so "what
did this query cost" is answerable from the result object.

The `Planner` absorbs the routing + escalation logic that used to be
inlined in ``Database._count_exact`` / ``_range_exact`` / ``_query_knn``:
an engine serves the kinds it declares in `capabilities`; everything else
routes to the CPU engine, so every query stays exact by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ... import obs
from ...core.serve import bucket_pow2
from ..engines import engine_capabilities
from ..queries import Count, Query


@dataclasses.dataclass(frozen=True)
class Step:
    """One rung of a plan's overflow-escalation ladder: the (bucketed)
    budgets a retry of the still-overflowed queries runs with.  `max_hits`
    is 0 for count-shaped plans (no row-id buffer)."""

    max_cand: int
    max_hits: int = 0


@dataclasses.dataclass
class ExecAccounting:
    """Per-stage costs recorded on the plan while it executes.

    Accountings are additive: `merge` / ``+=`` sum the counters, which is
    how the `Router` aggregates its shards' costs onto the merged
    result's plan (`per_shard` keeps the unsummed breakdown) — sharded
    runs report every device call and escalation, not just shard 0's.
    """

    compiles: int = 0        # new (query fn, input shape) combos launched
    cache_hits: int = 0      # query-fn cache hits
    cache_misses: int = 0    # query-fn cache misses (fresh builds)
    device_calls: int = 0    # engine batch launches (first pass + retries)
    escalations: int = 0     # doubled-budget retry rounds that ran
    cpu_fallbacks: int = 0   # queries resolved by the CPU exactness net
    pages_scanned: int = 0   # pages accessed (complete on the CPU engine)
    per_shard: tuple = None  # aggregated accountings only: the per-shard
                             #   breakdown this one is the sum of

    _COUNTERS = ("compiles", "cache_hits", "cache_misses", "device_calls",
                 "escalations", "cpu_fallbacks", "pages_scanned")

    def merge(self, other: "ExecAccounting") -> "ExecAccounting":
        """Add `other`'s counters into this accounting (in place)."""
        for f in self._COUNTERS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def __iadd__(self, other: "ExecAccounting") -> "ExecAccounting":
        return self.merge(other)

    @classmethod
    def merged(cls, accts) -> "ExecAccounting":
        """The sum of `accts`, keeping them as the `per_shard` breakdown."""
        accts = tuple(accts)
        out = cls(per_shard=accts)
        for a in accts:
            out.merge(a)
        return out


@dataclasses.dataclass
class QueryPlan:
    """The structured execution plan for one query batch.

    Shape fields are the *bucketed* values the device path actually
    launches at; `ladder` is the static escalation schedule (each rung a
    bucket boundary, so retries reuse cached query fns), and `cpu_fallback`
    is the final exactness net (always on for Point/Knn, which promise
    exactness unconditionally).
    """

    kind: str                     # 'count' | 'range' | 'point' | 'knn'
    engine: str                   # engine that will execute
    requested: str                # engine asked for (before routing)
    routed: bool                  # capability routing redirected to CPU
    Q: int                        # logical batch size
    d: int
    Q_pad: int                    # bucketed device batch (== Q on cpu)
    q_chunk: int                  # query chunk (0 on cpu)
    max_cand: int                 # bucketed initial candidate-page budget
    max_hits: int                 # bucketed initial row-id budget (0: n/a)
    cand_bound: int               # budget at/above which cand overflow
                                  #   cannot occur (padded page count)
    hit_bound: int                # same for the row-id buffer (live rows)
    ladder: Tuple[Step, ...]      # escalation rungs beyond the first pass
    cpu_fallback: bool            # final CPU exactness net enabled
    force_exact: bool             # kind promises exactness unconditionally
    accounting: ExecAccounting = dataclasses.field(
        default_factory=ExecAccounting)
    payload: tuple = dataclasses.field(default=None, repr=False)
                                  # the normalized query arrays ((Ls, Us)
                                  #   or (xs,)) — validated once at plan
                                  #   time, reused by the executor

    def describe(self) -> str:
        """Human-readable plan (the old string-only ``Database.plan`` told
        you only the engine name; this is the whole decision)."""
        head = (f"{self.kind.upper()} Q={self.Q} -> engine={self.engine!r}"
                + (f" (routed from {self.requested!r})" if self.routed
                   else ""))
        if self.engine == "cpu":
            return head + " [per-query exact walk; no padding, no ladder]"
        shapes = (f"  pad Q={self.Q}->{self.Q_pad} (q_chunk={self.q_chunk})"
                  f", max_cand={self.max_cand}/{self.cand_bound}"
                  + (f", max_hits={self.max_hits}/{self.hit_bound}"
                     if self.max_hits else ""))
        rungs = " -> ".join(
            f"({s.max_cand},{s.max_hits})" if s.max_hits else str(s.max_cand)
            for s in self.ladder) or "none"
        return (head + "\n" + shapes + f"\n  escalation ladder: {rungs}"
                f"\n  cpu fallback: {'on' if self.cpu_fallback else 'off'}")

    def __str__(self) -> str:
        return self.describe()


class Planner:
    """Produces `QueryPlan`s for a `Database`: capability routing, shape
    bucketing, and the escalation ladder, in one inspectable object."""

    def __init__(self, db):
        self.db = db

    def resolve(self, kind: str, engine: str = None) -> str:
        """Which engine serves a query kind: the requested (or the
        Database's default) engine if it declares the kind in its `capabilities`, else the CPU
        engine.  Unknown engine names pass through so attachment raises
        the canonical KeyError."""
        db = self.db
        requested = engine or db.default_engine
        eng = db._engines.get(requested)
        caps = (eng.capabilities if eng is not None
                else engine_capabilities().get(requested))
        if caps is None:
            return requested
        return requested if kind in caps else "cpu"

    def plan(self, q, U=None, *, engine: str = None) -> QueryPlan:
        """The structured plan for one query of the typed algebra (legacy
        ``(Ls, Us)`` bounds mean COUNT, as in `Database.query`).  Validates
        the payload against the index (shape, dimensionality, inverted
        bounds) as a side effect, so a plan that exists is executable."""
        if not isinstance(q, Query):
            q = Count(q, U)
        elif U is not None:
            raise ValueError("U= applies only to the legacy (Ls, Us) COUNT "
                             "form, not to typed queries")
        with obs.span("planner.plan", kind=q.kind) as sp:
            p = self._plan(q, engine)
            sp.label(engine=p.engine)
            return p

    def _plan(self, q: Query, engine: str = None) -> QueryPlan:
        db = self.db
        kind = q.kind
        requested = engine or db.default_engine
        resolved = self.resolve(kind, engine)
        payload = q.normalized(d=db.d)
        if not isinstance(payload, tuple):
            payload = (payload,)
        Q = len(payload[0])
        force = kind in ("point", "knn")
        routed = resolved != requested
        if resolved == "cpu":
            return QueryPlan(kind=kind, engine="cpu", requested=requested,
                             routed=routed, Q=Q, d=db.d, Q_pad=Q, q_chunk=0,
                             max_cand=0, max_hits=0, cand_bound=0,
                             hit_bound=0, ladder=(), cpu_fallback=False,
                             force_exact=force, payload=payload)
        name, eng = db._peek_engine(resolved)
        cfg = eng.cfg
        cb, hb = self._bounds(eng)
        mc = min(bucket_pow2(cfg.max_cand), cb)
        needs_hits = kind in ("range", "knn")
        mh = min(bucket_pow2(cfg.max_hits), hb) if needs_hits else 0
        ladder = []
        if cfg.escalate:
            c, h = mc, mh
            while c < cb or (needs_hits and h < hb):
                c = min(2 * c, cb)
                if needs_hits:
                    h = min(2 * h, hb)
                ladder.append(Step(c, h))
        return QueryPlan(kind=kind, engine=name, requested=requested,
                         routed=routed, Q=Q, d=db.d,
                         Q_pad=bucket_pow2(Q, cfg.q_chunk) if Q else 0,
                         q_chunk=cfg.q_chunk, max_cand=mc, max_hits=mh,
                         cand_bound=cb, hit_bound=hb, ladder=tuple(ladder),
                         cpu_fallback=bool(cfg.cpu_fallback or force),
                         force_exact=force, payload=payload)

    def _bounds(self, eng) -> tuple:
        """(cand_bound, hit_bound) without forcing a device pack: from the
        engine's packed host arrays when it has them, else derived from the
        index (same formulas `pack_serving_arrays` applies)."""
        host = getattr(eng, "_host", None)
        if host is not None:
            return (int(host.page_size.shape[0]),
                    max(1, int(host.page_size.sum())))
        db = self.db
        pad = eng.pad_pages_to
        cb = -(-db.index.num_pages // pad) * pad
        return cb, max(1, int(db.n))
