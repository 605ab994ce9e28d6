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
"""
from __future__ import annotations

import dataclasses
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

    __slots__ = ("_tracer", "name", "labels", "t0", "depth")

    def __init__(self, tracer, name, labels):
        self._tracer = tracer
        self.name = name
        self.labels = labels

    def __enter__(self):
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = self._tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = self._tracer.clock() - self.t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._finish(self, dur)

    def label(self, **labels) -> "_SpanCtx":
        """Attach labels discovered after the span opened (chainable)."""
        self.labels.update(labels)
        return self


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

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **labels) -> _SpanCtx:
        return _SpanCtx(self, name, labels)

    def _finish(self, ctx: _SpanCtx, dur_ns: int) -> None:
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(Span(
                    name=ctx.name, t0_ns=ctx.t0, dur_ns=dur_ns,
                    depth=ctx.depth, tid=threading.get_ident(),
                    labels=ctx.labels))
            else:
                self.spans_dropped += 1
        if self.registry is not None:
            self.registry.histogram(ctx.name + "_ns",
                                    **ctx.labels).observe(dur_ns)

    def snapshot(self) -> list:
        with self._lock:
            return list(self.spans)

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.spans_dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)
