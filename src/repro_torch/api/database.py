"""`Database` — the paper's whole lifecycle behind one object.

    learn θ (SMBO)  →  build (LMSFCIndex)  →  query (any engine)
         →  insert/delete (LMSFCb DeltaStore)  →  refresh / rebuild (LMSFCa)

Quickstart::

    from repro_torch.api import (Database, EngineConfig, Count, Range,
                                 Point, Knn)

    db = Database.fit(data, workload=(Ls, Us))          # SMBO θ + build
    res = db.query(Ls_test, Us_test)                    # legacy form: COUNT
    db.engine("cuda", EngineConfig(max_cand=128))       # attach the kernels
    res = db.query(Count(Ls_test, Us_test))             # same counts
    rr  = db.query(Range(Ls_test, Us_test))             # the rows themselves
    pr  = db.query(Point(rows))                         # exact-match lookup
    nn  = db.query(Knn(centers, k=5, metric="l2"))      # exact kNN
    db.insert([x, y]); db.delete(old_row)               # LMSFCb deltas
    res = db.query(Ls_test, Us_test)                    # auto-refresh, exact
    print(db.explain(Count(Ls_test, Us_test)))          # the structured plan
    with db.session() as s:                             # micro-batcher
        t = s.submit(Count(Ls_test, Us_test))
    t.result().counts                                   # == serial execution

`query` dispatches on the typed algebra (`repro_torch.api.queries`); a
plain ``(Ls, Us)`` still means COUNT.  Planning and execution are
first-class (`repro_torch.api.exec`): the `Planner` routes kinds an engine
doesn't declare in `capabilities` to the CPU engine and lays out the shape
buckets + escalation ladder as an inspectable `QueryPlan` (`db.explain`),
and the `Executor` runs plans through a bounded shape-bucketed query-fn
cache (`db.executor.cache`).  Every engine is **exact by construction**:
queries whose candidate-page set (or, for retrieval, row-id buffer)
overflows its bound are automatically escalated (retried at the next
ladder rung, with a final CPU fallback), so results can be trusted
regardless of the engine or its tuning.

Devices: `fit` learns the curve on `device` and every device engine serves
there unless its `EngineConfig.device` says otherwise.  ``device=None``
means CUDA, as everywhere in the port (raising without a card); the CPU
runs ask for it with ``device="cpu"``, where the 'torch' engine serves
and the 'cuda' engine refuses to attach.  A query with no engine attached
or named runs on 'cuda' when the device is CUDA, and on 'cpu' only under
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from .. import obs
from ..core.curve import MonotonicCurve, as_curve, default_curve
from ..core.device import resolve_device
from ..core.index import IndexConfig, LMSFCIndex
from ..core.theta import Theta, default_K
from .deltas import DeltaStore, get_delta_store
from .engines import make_engine
from .exec.executor import Executor
from .exec.plan import Planner, QueryPlan
from .exec.session import Session
from .policy import FractionRebuildPolicy, RebuildPolicy
from .queries import norm_rects
from .result import EngineConfig

_FAMILIES = ("global", "piecewise")


def _learn_curve(data, workload, K, smbo=None, sample=3000, seed=0,
                 space="global", pool=None, iters=None, device=None):
    """Sample the data and run SMBO curve-learning (shared by fit/rebuild).

    `seed` drives BOTH the data sampling and the SMBO run itself (candidate
    generation, surrogate, acquisition tie-breaks), so a fixed seed makes
    the learned curve fully reproducible.  `pool`/`iters` override the
    conservative fit defaults; anything in `smbo` wins over both.
    `device` is where SMBO evaluates its candidate pools."""
    from ..core.smbo import learn_sfc         # heavy import, lazy
    Ls, Us = workload
    rng = np.random.default_rng(seed)
    samp = data[rng.choice(len(data), min(sample, len(data)), replace=False)]
    kw = dict(max_iters=3, n_init=5, evals_per_iter=2, space=space,
              seed=seed, device=device)
    if pool is not None:
        kw["pool_size"] = int(pool)
    if iters is not None:
        kw["max_iters"] = int(iters)
    kw.update(smbo or {})
    return learn_sfc(samp, np.asarray(Ls), np.asarray(Us), K=K, **kw)


def _resolve_curve_arg(curve, theta):
    """Normalize fit()'s curve/theta inputs to (fixed_curve, family).

    Accepted for `curve`: a family name ('global' | 'piecewise') selecting
    the SMBO search space, a `MonotonicCurve`, a legacy `Theta`, or curve
    JSON (`MonotonicCurve.to_json` round-trips through here).
    """
    if curve is not None and theta is not None:
        raise ValueError("pass either curve= or the legacy theta=, not both")
    if curve is None:
        return (as_curve(theta), "global") if theta is not None \
            else (None, "global")
    if isinstance(curve, str):
        if curve in _FAMILIES:
            return None, curve
        if not curve.lstrip().startswith("{"):
            raise ValueError(
                f"unknown curve family {curve!r}; expected one of "
                f"{_FAMILIES}, a MonotonicCurve/Theta instance, or curve "
                f"JSON from curve.to_json()")
    return as_curve(curve), "global"


# (Ls, Us) normalization + validation lives with the algebra now
_norm_rects = norm_rects


class Database:
    """Facade over index construction, query engines, and updates."""

    def __init__(self, index: LMSFCIndex, *, policy: RebuildPolicy = None,
                 workload=None, device=None):
        self.index = index
        self.policy = policy or FractionRebuildPolicy()
        self.workload = workload
        self.device = device            # device engines' default (None: CUDA)
        self._segment = None            # repro_torch.store.Segment if attached
        self.rebuild_pending = False
        self.fit_result = None          # SMBOResult when θ was learned
        self._engines = {}
        self._active = None
        self.executor = Executor(self)  # shape-bucketed compiled-fn cache
        self.planner = Planner(self)    # routing + escalation ladders

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def fit(cls, data, workload=None, *, cfg: IndexConfig = None,
            K: int = None, theta: Theta = None, curve=None,
            learn: bool = True, sample: int = 3000, pool: int = None,
            iters: int = None, smbo: dict = None,
            policy: RebuildPolicy = None, seed: int = 0,
            device=None) -> "Database":
        """SMBO curve-learning (when a training workload is given) + build.

        `curve` selects the SFC axis: a family name (``"global"`` — the
        paper's single θ, the default — or ``"piecewise"`` — BMTree-style
        per-region θ) names the SMBO search space, while a concrete
        `MonotonicCurve`, legacy `Theta`, or curve JSON string (from
        ``db.index.curve.to_json()``; round-trips exactly) pins the curve
        with no learning.  `workload` is the ``(Ls, Us)`` training
        workload; without it (or with ``learn=False``) the index is built
        on the pinned curve or the family's z-order member.

        SMBO knobs: `pool` (candidate pool size per iteration) and `iters`
        (SMBO iterations) override the conservative defaults — the pooled
        device evaluator makes larger values cheap; `seed` makes the whole
        fit reproducible (data sampling AND the SMBO run); `smbo` forwards
        any further kwargs to :func:`repro_torch.core.smbo.learn_sfc`
        (e.g. ``{"depth": 2}`` for deeper piecewise quadtrees) and wins
        over `pool`/`iters`.  `device` is where SMBO evaluates (CUDA
        unless the caller passes ``device="cpu"``) and the default device
        of every engine attached later.  Fit progress lands in the obs
        gauges ``smbo.best_cost`` / ``smbo.iteration`` (visible via
        :meth:`stats` once ``repro_torch.obs.enable()`` is on).
        """
        data = np.asarray(data, dtype=np.uint64)
        d = data.shape[1]
        fixed, family = _resolve_curve_arg(curve, theta)
        if fixed is not None and K is not None and K != fixed.K:
            raise ValueError(f"K={K} conflicts with the pinned curve's "
                             f"K={fixed.K}")
        K = K or default_K(d)
        fit_result = None
        with obs.span("database.fit", n=len(data), d=d) as sp:
            if fixed is None:
                if learn and workload is not None:
                    with obs.span("database.fit.learn", family=family):
                        fit_result = _learn_curve(data, workload, K,
                                                  smbo=smbo, sample=sample,
                                                  seed=seed, space=family,
                                                  pool=pool, iters=iters,
                                                  device=device)
                    fixed = fit_result.curve_best
                else:
                    fixed = default_curve(d, K, family=family,
                                          depth=(smbo or {}).get("depth", 1))
            sp.label(learned=fit_result is not None)
            with obs.span("database.fit.build"):
                index = LMSFCIndex.build(data, curve=fixed, cfg=cfg,
                                         workload=workload, device=device)
        db = cls(index, policy=policy, workload=workload, device=device)
        db.fit_result = fit_result
        return db

    @classmethod
    def from_segment(cls, segment, *, verify: str = "full",
                     cfg: IndexConfig = None, policy: RebuildPolicy = None,
                     workload=None, device=None) -> "Database":
        """Attach to an on-disk segment (`repro_torch.store`): the row
        store is memory-mapped, only page metadata is loaded, and queries
        serve through the regular engine surface — the CPU engine walks
        the memmap-backed index directly, and ``db.engine("store")`` adds
        the device path with an LRU of resident page groups on `device`
        (CUDA unless the caller passes ``device="cpu"``).

        `segment` is a segment directory path (built by
        `repro_torch.store.build_segment` / `write_segment_from_index`, or
        by the JAX package's: the format is shared) or an already-opened
        `repro_torch.store.Segment`; `verify` forwards to `open_segment`
        (``"full"`` checksums the row store too).
        """
        from ..store import open_segment          # lazy: store imports api
        from ..store import engine as _           # noqa: F401 — registers
        if isinstance(segment, str):
            segment = open_segment(segment, verify=verify)
        db = cls(segment.as_index(cfg), policy=policy, workload=workload,
                 device=device)
        db._segment = segment
        return db

    @property
    def segment(self):
        """The attached `repro_torch.store.Segment` (None on in-memory
        builds)."""
        return self._segment

    @property
    def curve(self) -> MonotonicCurve:
        """The index's space-filling curve (serialize via `.to_json()`)."""
        return self.index.curve

    # ------------------------------------------------------------------
    # engines
    # ------------------------------------------------------------------
    def engine(self, name: str, config: EngineConfig = None) -> "Database":
        """Attach (or re-attach with a new config) an execution engine and
        make it the default for `query`.  Chainable."""
        old = self._engines.get(name)
        if old is not None:
            self.executor.evict(old)    # don't leak the old engine's fns
        self._engines[name] = make_engine(name, self, config)
        self._active = name
        return self

    @property
    def active_engine(self) -> str:
        return self._active

    @property
    def engines(self) -> dict:
        return dict(self._engines)

    def _peek_engine(self, name: str):
        """Attach `name` with a default config on first use WITHOUT
        touching the active engine (planning must be side-effect-free on
        dispatch state — `explain` goes through here)."""
        if name not in self._engines:
            self._engines[name] = make_engine(name, self, EngineConfig())
        return name, self._engines[name]

    @property
    def default_engine(self) -> str:
        """The engine a query runs on when none is attached or named: the
        kernels (`cuda`) when the Database's device resolves to CUDA, the
        per-query `cpu` engine only when the caller asked for the host.
        Without a card and without ``device="cpu"`` this raises."""
        if self._active is not None:
            return self._active
        return "cuda" if resolve_device(self.device).type == "cuda" \
            else "cpu"

    def _get_engine(self, name: str = None):
        """Resolve a per-call engine override without changing the active
        engine (attaching with a default config on first use)."""
        name, eng = self._peek_engine(name or self.default_engine)
        if self._active is None:
            self._active = name
        return name, eng

    # ------------------------------------------------------------------
    # query (typed algebra; planned + executed by repro_torch.api.exec)
    # ------------------------------------------------------------------
    def explain(self, q, U=None, *, engine: str = None) -> QueryPlan:
        """The structured execution plan for one query — engine routing,
        padded shape buckets, candidate/hit budgets, and the full overflow
        escalation ladder — without executing anything (replaces the old
        string-only ``plan()``).  ``print(db.explain(q))`` pretty-prints;
        after ``db.query(q)``, ``result.plan.accounting`` holds what the
        execution actually cost (compiles, escalations, fallbacks)."""
        return self.planner.plan(q, U, engine=engine)

    def plan(self, kind: str, engine: str = None) -> str:
        """Deprecated: the old string-only planner surface.  Returns just
        the resolved engine name; use :meth:`explain` for the structured
        `QueryPlan` (shapes, budgets, escalation ladder)."""
        warnings.warn(
            "Database.plan(kind) is deprecated; use Database.explain(q) "
            "for the structured QueryPlan (this shim returns only the "
            "resolved engine name)", DeprecationWarning, stacklevel=2)
        return self.planner.resolve(kind, engine)

    def query(self, q, U=None, *, engine: str = None):
        """Run one query of the typed algebra (`repro_torch.api.queries`).

        `q` is a `Count`, `Range`, `Point`, or `Knn` value — or, for
        backward compatibility, plain ``(Ls, Us)`` / rect-array bounds,
        which mean COUNT (``db.query(Ls, Us)`` ≡ ``db.query(Count(Ls,
        Us))``).  `engine` overrides the active engine for this call; kinds
        the engine does not support natively are routed to the CPU engine
        by the planner.  Returns the kind's result type (`QueryResult`,
        `RangeResult`, `PointResult`, `KnnResult`) with the executed
        `QueryPlan` (per-stage accounting filled) attached as ``.plan``.
        """
        with obs.span("database.query") as sp:
            plan = self.planner.plan(q, U, engine=engine)
            sp.label(kind=plan.kind, engine=plan.engine)
            return self.executor.execute(plan, q, U)

    def session(self, *, engine: str = None, tick: int = None) -> Session:
        """A micro-batching `Session` over this database: interleaved
        multi-client Count/Range/Point/Knn submissions are coalesced into
        engine-shaped super-batches and demultiplexed in submission order
        (deterministic — bit-identical to serial execution)."""
        return Session(self, engine=engine, tick=tick)

    def serve(self, *, slo=None, engine: str = None):
        """An async serving front (`repro_torch.serving.AsyncServer`) over
        this database: thread-safe non-blocking ``submit(query)``
        returning futures, a background drain loop coalescing submissions
        into engine super-batches through the Session/Executor path,
        SLO-driven adaptive batching, admission control, and
        weighted-fair per-kind dequeue.  `slo` is a
        `repro_torch.serving.SLOConfig` (p99 target, queue bound, overload
        policy); results stay bit-identical to serial `query` calls.
        Close it (or use ``with``) to drain and stop."""
        from ..serving.server import AsyncServer   # lazy: serving imports api
        return AsyncServer(self, slo=slo, engine=engine)

    # ------------------------------------------------------------------
    # updates (LMSFCb deltas + LMSFCa rebuild)
    # ------------------------------------------------------------------
    @property
    def store(self) -> DeltaStore:
        return get_delta_store(self.index)

    def insert(self, x) -> int:
        """Insert one row (or an iterable of rows, batch-encoded); returns
        the last page id touched.  May trigger the rebuild policy."""
        x = np.asarray(x, dtype=np.uint64)
        if x.ndim == 1:
            x = x[None]
        pages = self.store.insert_many(x)
        self._after_mutation()
        return int(pages[-1]) if len(pages) else -1

    def delete(self, x) -> int:
        """Tombstone one row (or an iterable of rows, batch-encoded);
        returns how many rows were actually tombstoned."""
        x = np.asarray(x, dtype=np.uint64)
        if x.ndim == 1:
            x = x[None]
        n = self.store.delete_many(x)
        self._after_mutation()
        return n

    def _after_mutation(self) -> None:
        if self.policy.should_rebuild(self.index, self.store):
            if self.policy.auto:
                self.rebuild()
            else:
                self.rebuild_pending = True

    def refresh(self, engine: str = None) -> "Database":
        """Re-pack dirty pages into the device arrays of the named (or all
        attached) device engines."""
        targets = [engine] if engine else list(self._engines)
        for name in targets:
            self._engines[name].sync("refresh")
        return self

    def rebuild(self, *, workload=None, relearn: bool = False,
                smbo: dict = None, sample: int = 3000,
                seed: int = 0) -> "Database":
        """LMSFCa maintenance: merge deltas, drop tombstones, rebuild the
        index (optionally re-learning θ), and invalidate every engine."""
        data = self.store.merged_data()
        wl = workload if workload is not None else self.workload
        curve = self.index.curve
        if relearn and wl is not None:
            kw = dict(smbo or {})
            kw.setdefault("depth", getattr(curve, "depth", 1))
            self.fit_result = _learn_curve(data, wl, self.index.K, smbo=kw,
                                           sample=sample, seed=seed,
                                           space=curve.kind,
                                           device=self.device)
            curve = self.fit_result.curve_best
        self.index = LMSFCIndex.build(data, curve=curve, cfg=self.index.cfg,
                                      workload=wl, device=self.device)
        self.rebuild_pending = False
        if self._segment is not None:
            # the rebuilt index is in-memory; the on-disk snapshot no
            # longer backs it, so detach it (and the store engine with it
            # — persist again via repro_torch.store.write_segment_from_index)
            self._segment = None
            dead = self._engines.pop("store", None)
            if dead is not None and self._active == "store":
                self._active = None
        for eng in self._engines.values():
            eng.invalidate()
        return self

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        """Live logical row count (base + inserts − deletes)."""
        return self.index.n + self.store.n_inserted - self.store.n_deleted

    @property
    def d(self) -> int:
        return self.index.d

    @property
    def num_pages(self) -> int:
        return self.index.num_pages

    def stats(self, *, format: str = "json"):
        """Current observability snapshot (`repro_torch.obs`): every counter,
        gauge, and latency histogram (with exact p50/p95/p99) the process
        recorded, as one flat JSON dict (``format="json"``) or in the
        Prometheus text exposition format (``format="prometheus"``).
        Includes this database's executor cache stats under
        ``executor_cache``.  Best-effort: metrics are empty until
        `repro_torch.obs.enable()` is called."""
        if format == "prometheus":
            return obs.prometheus_text()
        if format != "json":
            raise ValueError(f"unknown stats format {format!r}; expected "
                             f"'json' or 'prometheus'")
        snap = obs.snapshot()
        snap["executor_cache"] = dataclasses.asdict(
            self.executor.cache.snapshot())
        return snap

    def __repr__(self) -> str:
        return (f"Database(n={self.index.n}, d={self.d}, "
                f"pages={self.num_pages}, epoch={self.store.epoch}, "
                f"engines={sorted(self._engines)}, active={self._active!r})")
