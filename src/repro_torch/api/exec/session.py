"""`Session` — the micro-batcher: many logical clients, one device batch.

The facade executes one homogeneous batch per `Database.query` call; a
serving loop instead sees interleaved Count / Range / Point / Knn
submissions from many clients.  A `Session` buffers those submissions,
coalesces compatible ones (same kind; same ``(k, metric)`` for kNN) into
engine-shaped super-batches per tick, executes them through the
planner/executor path, and demultiplexes results back in submission
order.

Guarantees:

* **Determinism** — results are bit-identical to serial per-query
  `Database.query` execution and independent of tick/coalescing
  boundaries (every engine is exact by construction, so batching can
  only change *cost*, never answers); tested in
  ``tests/test_torch_exec.py``.
* **Submit-time validation** — payloads are normalized against the index
  at `submit`, so a mixed-dimension or inverted-rect submission raises
  `ValueError` immediately, not at device execution inside a coalesced
  batch of other clients' queries.
* **Thread safety** — `submit`, `flush`, `discard`, and `len()` may be
  called from concurrent threads: submission order (the demux key) is
  allocated under a lock, and a flush drains an atomic snapshot of the
  queue while later submissions keep accumulating.  This is the
  substrate the async serving front (`repro_torch.serving.AsyncServer`)
  drives, but it holds as a standalone Session guarantee.

Quickstart::

    with db.session(engine="cuda") as s:
        t1 = s.submit(Count(Ls, Us), client="alice")
        t2 = s.submit(Knn(cs, k=5), client="bob")
        t3 = s.submit(Count(L2, U2), client="carol")   # coalesces with t1
    t1.result().counts     # the session flushed on exit
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ... import obs
from ..queries import Count, Knn, Point, Query, Range
from ..result import KnnResult, PointResult, QueryResult, RangeResult


class ServingTimeout(TimeoutError):
    """A ticket was not resolved in time: `Ticket.result(timeout=...)`
    gave up waiting, or a ticket is still unresolved after its session
    flushed (e.g. it was `Session.discard`ed, or another thread's flush
    holds it).  Also raised by the serving front's futures
    (`repro_torch.serving.ServerTicket.result`)."""


@dataclasses.dataclass
class _Pending:
    seq: int                  # submission order (demux key)
    client: str
    key: tuple                # coalescing-compatibility key
    kind: str
    payload: tuple            # normalized arrays ((Ls, Us) | (xs,))
    n: int                    # sub-queries this submission contributes
    ticket: "Ticket"
    t_submit: int = 0         # obs clock at submit (0 while obs disabled)


class Ticket:
    """Handle for one submission; `result()` flushes the session if the
    submission is still pending and returns the per-submission result
    (the kind's usual result type, sliced out of its super-batch)."""

    __slots__ = ("_session", "seq", "client", "_result", "_event")

    def __init__(self, session, seq, client):
        self._session = session
        self.seq = seq
        self.client = client
        self._result = None
        self._event = threading.Event()

    def _resolve(self, res) -> None:
        self._result = res
        self._event.set()

    def done(self) -> bool:
        """Non-blocking: has this submission been resolved?"""
        return self._result is not None

    def result(self, timeout: float = None):
        """The per-submission result, flushing the session if this
        submission is still pending.  When another thread owns the flush
        (the async serving drain loop, or a concurrent caller), waits up
        to `timeout` seconds for it to resolve the ticket; raises
        `ServingTimeout` if it is still unresolved after that."""
        if self._result is None:
            self._session.flush()
        if self._result is None and timeout is not None:
            self._event.wait(timeout)
        if self._result is None:
            raise ServingTimeout(
                f"ticket {self.seq} unresolved after flush" +
                (f" and a {timeout}s wait" if timeout is not None else ""))
        return self._result

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return f"Ticket(seq={self.seq}, client={self.client!r}, {state})"


class Session:
    """Micro-batching front-end over one `Database` (see module docstring).

    `tick` bounds how many submissions one coalescing window spans
    (default: all pending); results never depend on it.  `engine`
    overrides the database's active engine for every batch this session
    executes.
    """

    def __init__(self, db, *, engine: str = None, tick: int = None):
        if tick is not None and tick < 1:
            raise ValueError(f"tick must be >= 1; got {tick}")
        self.db = db
        self.engine = engine
        self.tick = tick
        self._pending = []
        self._seq = 0
        self._lock = threading.RLock()   # guards _pending/_seq (submission
                                         # order is the demux contract)
        self.ticks_run = 0
        self.batches_run = 0
        self.flush_failures = 0          # flushes that raised and requeued

    # ------------------------------------------------------------------
    def submit(self, q: Query, *, client: str = None) -> Ticket:
        """Buffer one typed query; validates (dimensionality, bounds)
        immediately and returns a `Ticket`."""
        if not isinstance(q, Query):
            raise TypeError(
                f"Session.submit takes a typed query (Count/Range/Point/"
                f"Knn); got {type(q).__name__} — wrap legacy (Ls, Us) "
                f"bounds in Count(...)")
        payload = q.normalized(d=self.db.d)    # raises on dim/bounds errors
        if not isinstance(payload, tuple):
            payload = (payload,)
        key = q.coalesce_key()
        with self._lock:
            ticket = Ticket(self, self._seq, client)
            self._pending.append(_Pending(
                seq=self._seq, client=client, key=key, kind=q.kind,
                payload=payload, n=len(payload[0]), ticket=ticket,
                t_submit=obs.clock_ns() if obs.enabled() else 0))
            self._seq += 1
            n_pending = len(self._pending)
        if obs.enabled():
            obs.inc("session.submissions", kind=q.kind)
            obs.set_gauge("session.pending", n_pending)
        return ticket

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    # ------------------------------------------------------------------
    def flush(self) -> int:
        """Coalesce + execute everything pending; resolves every ticket.
        Returns the number of engine super-batches executed.  If a batch
        raises, every not-yet-resolved submission is put back on the
        pending queue (submission order kept) before the exception
        propagates, so a failed flush can be retried.

        Thread-safe: drains an atomic snapshot of the queue; submissions
        arriving while the snapshot executes stay pending for the next
        flush (and on failure the requeued submissions go back in front
        of them, preserving submission order)."""
        with self._lock:
            pending, self._pending = self._pending, []
        batches = 0
        tick = self.tick or max(1, len(pending))
        try:
            for t0 in range(0, len(pending), tick):
                window = pending[t0:t0 + tick]
                with obs.span("session.tick", fill=len(window)):
                    if obs.enabled():
                        # fill factor: how full the coalescing window ran
                        obs.observe("session.tick_fill", len(window))
                        obs.set_gauge("session.tick_fill_factor",
                                      len(window) / tick)
                    groups = {}
                    for p in window:           # insertion order preserved
                        groups.setdefault(p.key, []).append(p)
                    for key, ps in groups.items():
                        self._run_group(key, ps)
                        batches += 1
                self.ticks_run += 1
        except BaseException:
            unresolved = [p for p in pending if not p.ticket.done()]
            with self._lock:
                self._pending = unresolved + self._pending
                self.flush_failures += 1
            if obs.enabled():
                obs.inc("session.requeues", len(unresolved))
            raise
        finally:
            self.batches_run += batches
        return batches

    def discard(self, tickets) -> int:
        """Drop the given tickets' submissions from the pending queue
        without executing them (they stay unresolved — `result()` on one
        raises `ServingTimeout`).  The serving front uses this to shed a
        batch whose flush kept failing past its retry budget; returns how
        many submissions were actually removed."""
        dead = {id(t) for t in tickets}
        with self._lock:
            before = len(self._pending)
            self._pending = [p for p in self._pending
                             if id(p.ticket) not in dead]
            return before - len(self._pending)

    def _run_group(self, key, ps) -> None:
        """Execute one coalesced super-batch and demux per submission."""
        kind = ps[0].kind
        live = obs.enabled()
        t_start = obs.clock_ns() if live else 0
        cat = [np.concatenate([p.payload[i] for p in ps])
               for i in range(len(ps[0].payload))]
        if kind == "count":
            q = Count((cat[0], cat[1]))
        elif kind == "range":
            q = Range((cat[0], cat[1]))
        elif kind == "point":
            q = Point(cat[0])
        else:
            q = Knn(cat[0], k=key[1], metric=key[2])
        with obs.span("session.group", kind=kind, size=len(ps)):
            res = self.db.query(q, engine=self.engine)
        starts = np.cumsum([0] + [p.n for p in ps])
        for p, a, b in zip(ps, starts[:-1], starts[1:]):
            p.ticket._resolve(_slice_result(res, int(a), int(b)))
        if live:
            t_done = obs.clock_ns()
            obs.observe("session.coalesce_size", len(ps), kind=kind)
            for p in ps:
                # per-ticket latency: queue wait = submit -> group start,
                # service = submit -> result resolved (both on tickets
                # submitted while obs was on; 0-stamped ones are skipped)
                if p.t_submit:
                    obs.observe("session.queue_wait_ns",
                                t_start - p.t_submit, kind=kind)
                    obs.observe("session.service_ns",
                                t_done - p.t_submit, kind=kind)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.flush()

    def __repr__(self):
        return (f"Session(pending={len(self)}, "
                f"engine={self.engine!r}, tick={self.tick}, "
                f"batches_run={self.batches_run})")


def _slice_result(res, a: int, b: int):
    """Submission [a, b) of a super-batch result, as its own result object
    (payload bit-identical to a serial per-query execution; provenance —
    engine, epoch, plan, escalation accounting — is the super-batch's)."""
    if isinstance(res, QueryResult):
        return QueryResult(
            counts=res.counts[a:b], engine=res.engine, epoch=res.epoch,
            stats=res.stats, overflowed=res.overflowed[a:b],
            residual_overflow=res.residual_overflow[a:b],
            escalations=res.escalations, cpu_fallbacks=res.cpu_fallbacks,
            plan=res.plan)
    if isinstance(res, PointResult):
        return PointResult(
            found=res.found[a:b], engine=res.engine, epoch=res.epoch,
            stats=res.stats, escalations=res.escalations,
            cpu_fallbacks=res.cpu_fallbacks, plan=res.plan)
    if isinstance(res, RangeResult):
        lo, hi = int(res.offsets[a]), int(res.offsets[b])
        return RangeResult(
            rows=res.rows[lo:hi], offsets=res.offsets[a:b + 1] - lo,
            engine=res.engine, epoch=res.epoch, stats=res.stats,
            overflowed=res.overflowed[a:b],
            residual_overflow=res.residual_overflow[a:b],
            escalations=res.escalations, cpu_fallbacks=res.cpu_fallbacks,
            plan=res.plan)
    if isinstance(res, KnnResult):
        lo, hi = int(res.offsets[a]), int(res.offsets[b])
        return KnnResult(
            neighbors=res.neighbors[lo:hi],
            offsets=res.offsets[a:b + 1] - lo, dists=res.dists[lo:hi],
            k=res.k, metric=res.metric, engine=res.engine, epoch=res.epoch,
            stats=res.stats, escalations=res.escalations,
            cpu_fallbacks=res.cpu_fallbacks, plan=res.plan,
            overflowed=res.overflowed[a:b],
            residual_overflow=res.residual_overflow[a:b],
            box_rows=res.box_rows[a:b])
    raise TypeError(f"unknown result type {type(res).__name__}")
