"""`AsyncServer` — the asynchronous serving front over a `Database` or
`Router`.

The Session micro-batcher is a synchronous tick loop: somebody has to
call `flush()`, and while they do, nobody submits.  The serving front
inverts that: clients call thread-safe, non-blocking `submit(query)` and
get a future-style `ServerTicket` back immediately, while a background
drain loop owns the flush cadence —

    client threads ──submit──▶ admission control (bounded queue,
                               reject/block)
                                 │ weighted-fair dequeue (per-kind)
                                 ▼
    drain thread   ── gather up to the controller's coalescing window ──▶
                   Session super-batches ──▶ Planner/Executor ──▶ engine
                                 │
                                 ▼ resolve tickets, feed latencies back
                               AdaptiveController (AIMD on the window)

Everything below the queue is the existing execution layer: submissions
coalesce through a `Session` into engine super-batches, so served
results are **bit-identical to serial** `Database.query` execution —
the server changes *when* queries run, never their answers.  The served
query log (`query_log()`) makes that auditable: replay it serially and
compare (`replay_serial`, `assert_bit_identical`).

On a card the drain thread launches the engine's CUDA kernels itself: the
kernel library loads under a lock (`kernels.cuda_lib.library`), launches
go to the thread's current stream (the device's default stream, the same
as the main thread's), and an engine fault raises out of the flush, so a
failed batch rejects its tickets and the loop serves the next one.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .. import obs
from ..api.exec.session import ServingTimeout
from ..api.queries import Query
from .slo import AdaptiveController, ServerOverloaded, SLOConfig, \
    WeightedFairQueue

#: Every payload field a result type can carry — the bit-identical
#: comparison surface shared by tests, the benchmark, and `replay_serial`.
RESULT_FIELDS = ("counts", "rows", "offsets", "found", "neighbors", "dists")


class ServerTicket:
    """Future for one admitted submission: `done()` is non-blocking,
    `result(timeout=...)` blocks until the drain loop resolves it (or
    raises `ServingTimeout`); a batch failed past its retry budget
    re-raises its error here."""

    __slots__ = ("seq", "client", "kind", "t_submit", "t_done",
                 "_event", "_result", "_error")

    def __init__(self, kind: str, client, t_submit: float):
        self.seq = -1               # admission order; set under server lock
        self.client = client
        self.kind = kind
        self.t_submit = t_submit    # server clock at submit
        self.t_done = None          # server clock at resolution
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _resolve(self, result, t_done: float) -> None:
        self._result = result
        self.t_done = t_done
        self._event.set()

    def _reject(self, error: BaseException, t_done: float) -> None:
        self._error = error
        self.t_done = t_done
        self._event.set()

    def done(self) -> bool:
        """Non-blocking: has the drain loop resolved (or failed) this
        submission?"""
        return self._event.is_set()

    def result(self, timeout: float = None):
        """The submission's result (its kind's usual result type, sliced
        out of its super-batch — bit-identical to serial execution).
        Blocks up to `timeout` seconds (forever when None); raises
        `ServingTimeout` on expiry and re-raises the batch error if the
        server failed this submission."""
        if not self._event.wait(timeout):
            raise ServingTimeout(
                f"serving ticket {self.seq} ({self.kind}) unresolved "
                f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def latency_s(self) -> float:
        """End-to-end submit → resolve seconds (None while pending)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def __repr__(self):
        state = ("failed" if self._error is not None else
                 "done" if self._event.is_set() else "pending")
        return (f"ServerTicket(seq={self.seq}, kind={self.kind!r}, "
                f"client={self.client!r}, {state})")


class AsyncServer:
    """Async serving front over one backend (module docstring).

    `backend` is anything with the Session substrate — a `Database` or a
    `Router` (`.d`, `.query`, `.session()`).  `slo` is the `SLOConfig`
    contract; `engine` pins the execution engine for every served batch.
    Use as a context manager (``with db.serve() as srv:``) or call
    `close()` — both drain the queue before stopping the loop.
    """

    def __init__(self, backend, *, slo: SLOConfig = None, engine: str = None,
                 clock=time.perf_counter):
        self.backend = backend
        self.slo = slo or SLOConfig()
        self.engine = engine
        self.controller = AdaptiveController(self.slo)
        self.queue = WeightedFairQueue(self.slo.weights, self.slo.max_queue)
        self._session = backend.session(engine=engine)
        self._clock = clock
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)    # queue went nonempty
        self._space = threading.Condition(self._lock)   # queue gained room
        self._closed = False
        self._log = []               # (seq, Query) in admission order
        self.submitted = 0           # admitted submissions
        self.served = 0              # resolved tickets
        self.failed = 0              # tickets rejected after retry budget
        self.shed = 0                # admissions refused (reject policy)
        self.retries = 0             # batch flush retries
        self.batches = 0             # drained batches
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="repro-torch-serving-drain",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, q: Query, *, client: str = None) -> ServerTicket:
        """Thread-safe, non-blocking submission of one typed query.

        Validates the payload in the caller's thread (bad submissions
        raise `ValueError` here, never inside someone else's batch), then
        runs admission control: with a full queue, policy ``reject``
        raises `ServerOverloaded` immediately and counts a shed, policy
        ``block`` parks this thread until the drain loop makes room
        (backpressure).  Returns the submission's `ServerTicket`.
        """
        if not isinstance(q, Query):
            raise TypeError(
                f"AsyncServer.submit takes a typed query (Count/Range/"
                f"Point/Knn); got {type(q).__name__}")
        q.normalized(d=self.backend.d)     # validate before admission
        ticket = ServerTicket(q.kind, client, self._clock())
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncServer is closed")
            while not self.queue.push(q.kind, (ticket, q)):
                if self.slo.overload == "reject":
                    self.shed += 1
                    obs.inc("serving.shed", kind=q.kind)
                    raise ServerOverloaded(
                        f"queue full ({self.queue.depth}/"
                        f"{self.slo.max_queue} submissions); shedding "
                        f"{q.kind} under the 'reject' overload policy")
                self._space.wait(timeout=0.05)
                if self._closed:
                    raise RuntimeError(
                        "AsyncServer closed while blocked on admission")
            ticket.seq = self.submitted
            self.submitted += 1
            self._log.append((ticket.seq, q))
            depth = self.queue.depth
            self._work.notify()
        if obs.enabled():
            obs.inc("serving.admitted", kind=q.kind)
            obs.set_gauge("serving.queue_depth", depth)
        return ticket

    def query_log(self) -> list:
        """The served query log: ``(seq, Query)`` in admission order —
        the replay key for the bit-identical-to-serial exactness gate
        (see `replay_serial`)."""
        with self._lock:
            return list(self._log)

    def stats(self) -> dict:
        """Serving counters + controller + queue state as one dict (the
        ``serving.*`` obs metrics carry the same numbers when the obs
        layer is enabled)."""
        with self._lock:
            return {
                "queue_depth": self.queue.depth,
                "queue_kind_depths": self.queue.kind_depths(),
                "submitted": self.submitted,
                "served": self.served,
                "failed": self.failed,
                "shed": self.shed,
                "retries": self.retries,
                "batches": self.batches,
                "controller": self.controller.snapshot(),
                "session_batches": self._session.batches_run,
            }

    def close(self, timeout: float = None) -> None:
        """Drain everything still queued, then stop the loop (idempotent).
        Blocked submitters are woken and raise."""
        with self._lock:
            self._closed = True
            self._work.notify_all()
            self._space.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "AsyncServer":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def __repr__(self):
        return (f"AsyncServer(backend={type(self.backend).__name__}, "
                f"depth={self.queue.depth}, submitted={self.submitted}, "
                f"served={self.served}, shed={self.shed}, "
                f"window={self.controller.window_ms:.2f}ms, "
                f"closed={self._closed})")

    # ------------------------------------------------------------------
    # drain loop (background thread)
    # ------------------------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            with self._lock:
                while self.queue.depth == 0 and not self._closed:
                    self._work.wait()
                if self.queue.depth == 0:          # closed and drained
                    return
                # adaptive gather: from first pending work, wait up to the
                # controller's window for the batch to fill (a closing
                # server drains immediately)
                window_s = (0.0 if self._closed
                            else self.controller.window_ms / 1e3)
                deadline = self._clock() + window_s
                while (self.queue.depth < self.slo.batch_max
                       and not self._closed):
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        break
                    self._work.wait(remaining)
                batch = self.queue.pop_batch(self.slo.batch_max)
                self._space.notify_all()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch) -> None:
        """Coalesce one weighted-fair batch through the Session, resolve
        tickets, and feed the controller."""
        pairs = [(ticket, self._session.submit(q, client=ticket.client))
                 for ticket, q in batch]
        tries = 0
        error = None
        while True:
            try:
                with obs.span("serving.batch", size=len(batch)):
                    self._session.flush()
                break
            except Exception as e:          # engine hiccup: session requeued
                tries += 1
                self.retries += 1
                obs.inc("serving.retries")
                if tries > self.slo.max_retries:
                    error = e
                    break
        now = self._clock()
        latencies_ms = []
        unresolved = []
        for ticket, st in pairs:
            if st.done():
                ticket._resolve(st._result, now)
                latencies_ms.append((now - ticket.t_submit) * 1e3)
                if obs.enabled():
                    obs.observe("serving.e2e_ns",
                                int((now - ticket.t_submit) * 1e9),
                                kind=ticket.kind)
            else:
                unresolved.append((ticket, st))
        if unresolved:
            # retry budget exhausted: drop the stragglers from the session
            # (they must not haunt the next batch) and fail their tickets
            self._session.discard([st for _, st in unresolved])
            for ticket, _ in unresolved:
                ticket._reject(error or ServingTimeout(
                    f"submission {ticket.seq} unresolved after "
                    f"{self.slo.max_retries} retries"), now)
        with self._lock:
            self.batches += 1
            self.served += len(latencies_ms)
            self.failed += len(unresolved)
        if obs.enabled():
            obs.observe("serving.batch_size", len(batch))
            obs.inc("serving.batches")
            obs.set_gauge("serving.queue_depth", self.queue.depth)
        self.controller.observe(latencies_ms)
        self.controller.update()


# ---------------------------------------------------------------------------
# the exactness oracle
# ---------------------------------------------------------------------------
def replay_serial(backend, log, *, engine: str = None) -> dict:
    """Serially re-execute a served query log — ``{seq: result}`` via one
    `backend.query` per entry, the oracle the server's results must match
    bit-for-bit."""
    return {seq: backend.query(q, engine=engine) for seq, q in log}


def assert_bit_identical(got, want, context: str = "") -> None:
    """Field-wise exact comparison of two results of the same kind."""
    for f in RESULT_FIELDS:
        if hasattr(want, f):
            np.testing.assert_array_equal(
                getattr(got, f), getattr(want, f),
                err_msg=f"served result != serial replay at {context}.{f}")
