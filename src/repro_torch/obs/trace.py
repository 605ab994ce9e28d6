"""Structured tracing: nested spans with ``perf_counter_ns`` timestamps.

A `Tracer` owns a bounded buffer of finished `Span` records and a
per-thread stack of open spans, so ``with trace.span("executor.device_call",
engine="xla"):`` blocks nest naturally and the export reconstructs the
Session -> Executor -> device-call containment from (start, duration,
depth) alone.

The clock is injectable (``Tracer(clock=...)``): tests drive a
deterministic fake ticker, production uses ``time.perf_counter_ns``.
Every finished span also feeds a latency histogram named
``<span name>_ns`` with the span's labels into the paired `Registry`, so
span timing shows up in quantile snapshots without a second call site.

The buffer is bounded (``max_spans``); once full, new spans still time
and feed histograms but their records are dropped and counted in
``spans_dropped`` — bounded memory, no silent truncation.

While a `torch.profiler` is recording, each live span also opens a
``record_function`` range of its own name, so the profiler's timeline
shows the program's stages above the device work they launched (and its
correlation ids link each kernel to its stage).  torch is looked up in
``sys.modules``, never imported: if it is not loaded, nothing records.

`gc_callback` is a ``gc.callbacks`` hook: each collection becomes a
``python.gc`` span (labelled by generation) on the thread it paused, so a
collector pause is not booked to the stage it interrupted.  It feeds no
histogram: the registry's series stay the same whenever the collector
runs.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time


@dataclasses.dataclass
class Span:
    """One finished span: a named, labeled [t0, t0+dur) interval."""

    name: str
    t0_ns: int
    dur_ns: int
    depth: int              # nesting depth at record time (0 = root)
    tid: int                # OS thread ident (trace-viewer lane)
    labels: dict

    @property
    def t1_ns(self) -> int:
        return self.t0_ns + self.dur_ns


class _SpanCtx:
    """The context manager `Tracer.span` returns when tracing is live."""

    __slots__ = ("_tracer", "name", "labels", "t0", "depth", "_range")

    def __init__(self, tracer, name, labels):
        self._tracer = tracer
        self.name = name
        self.labels = labels

    def __enter__(self):
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        # the range opens and closes inside the span: its cost is the
        # span's own, not its parent's
        self.t0 = self._tracer.clock()
        self._range = _profiler_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        dur = self._tracer.clock() - self.t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._finish(self, dur)

    def label(self, **labels) -> "_SpanCtx":
        """Attach labels discovered after the span opened (chainable)."""
        self.labels.update(labels)
        return self


def _profiler_range(name: str):
    """An entered ``torch.profiler.record_function(name)`` while a torch
    profiler records, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _NullSpan:
    """What `span` hands out while tracing is disabled: a shared, inert
    context manager (no allocation on the disabled hot path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass

    def label(self, **labels) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Tracer:
    """Span buffer + per-thread open-span stacks (module docstring)."""

    def __init__(self, clock=time.perf_counter_ns, registry=None,
                 max_spans: int = 200_000):
        self.clock = clock
        self.registry = registry
        self.max_spans = max_spans
        self.spans = []
        self.spans_dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._gc_t0 = None
        self._gc_done = collections.deque()   # python.gc spans to file

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **labels) -> _SpanCtx:
        return _SpanCtx(self, name, labels)

    def _keep(self, span: Span) -> None:
        """File one finished record (under `_lock`)."""
        if len(self.spans) < self.max_spans:
            self.spans.append(span)
        else:
            self.spans_dropped += 1

    def _file_gc(self) -> None:
        """File the collections `gc_callback` finished (under `_lock`)."""
        while self._gc_done:
            self._keep(self._gc_done.popleft())

    def _finish(self, ctx: _SpanCtx, dur_ns: int) -> None:
        with self._lock:
            self._file_gc()
            self._keep(Span(name=ctx.name, t0_ns=ctx.t0, dur_ns=dur_ns,
                            depth=ctx.depth, tid=threading.get_ident(),
                            labels=ctx.labels))
        if self.registry is not None:
            self.registry.histogram(ctx.name + "_ns",
                                    **ctx.labels).observe(dur_ns)

    def gc_callback(self, phase: str, info: dict) -> None:
        """The ``gc.callbacks`` hook (module docstring).  A collection can
        start while this thread holds `_lock` (any allocation may start
        one), so the hook takes no lock: the span waits in `_gc_done`
        until the next `_finish` or `snapshot` files it."""
        if phase == "start":
            self._gc_t0 = self.clock()
        elif self._gc_t0 is not None:
            t0, self._gc_t0 = self._gc_t0, None
            self._gc_done.append(Span(
                name="python.gc", t0_ns=t0, dur_ns=self.clock() - t0,
                depth=len(self._stack()), tid=threading.get_ident(),
                labels={"generation": info["generation"]}))

    def snapshot(self) -> list:
        with self._lock:
            self._file_gc()
            return list(self.spans)

    def reset(self) -> None:
        with self._lock:
            self._gc_done.clear()
            self.spans.clear()
            self.spans_dropped = 0

    def __len__(self) -> int:
        with self._lock:
            self._file_gc()
            return len(self.spans)
