"""repro_torch.obs — observability for the plan/execute/serve stack.

A zero-dependency metrics registry (monotonic counters, gauges, and
fixed-bucket latency histograms with exact p50/p95/p99 extraction) plus
a structured tracing API producing nested span records, with two
exporters: a Chrome/Perfetto trace-event JSON writer and a flat snapshot
(Prometheus text + JSON dict).

**Off by default.** Every hook in the query path is a no-op until
`enable()` is called: `span()` hands back a shared inert context
manager, `observe()`/`inc()` return after one flag check, and nothing
allocates.  Metrics are best-effort measurements — they never change
query results (the exactness tests run with instrumentation on).
While enabled, the garbage collector's pauses are recorded as
``python.gc`` spans (a ``gc.callbacks`` hook that `disable()` removes),
and a recording `torch.profiler` sees every span as a ``record_function``
range of the same name.

Quickstart::

    from repro_torch import obs

    obs.enable()
    db.query(...)                         # instrumented transparently
    db.stats()                            # flat JSON snapshot
    print(obs.prometheus_text())          # Prometheus exposition format
    obs.export_trace("trace.json")        # load in ui.perfetto.dev
    obs.disable(); obs.reset()

The clock is injectable for deterministic tests
(``obs.enable(clock=fake_ns_counter)``); the default is
``time.perf_counter_ns``.
"""
from __future__ import annotations

import gc
import time

from .export import export_trace, prometheus_text, snapshot, trace_events
from .log import configure as configure_logging
from .log import get_logger
from .metrics import (Counter, Gauge, Histogram, Registry,
                      DEFAULT_BUCKETS_NS)
from .trace import NULL_SPAN, Span, Tracer

__all__ = [
    "enable", "disable", "enabled", "reset", "clock_ns", "span",
    "counter", "gauge", "histogram", "inc", "observe", "set_gauge",
    "registry", "tracer", "snapshot", "export_trace", "trace_events",
    "prometheus_text", "get_logger", "configure_logging",
    "Counter", "Gauge", "Histogram", "Registry", "Span", "Tracer",
    "DEFAULT_BUCKETS_NS",
]

_enabled = False
_clock = time.perf_counter_ns


def clock_ns() -> int:
    """Now, in nanoseconds, on the obs clock (injectable via `enable`)."""
    return _clock()


registry = Registry()
tracer = Tracer(clock=clock_ns, registry=registry)


def enable(clock=None) -> None:
    """Turn instrumentation on, optionally pinning a deterministic clock
    (a zero-arg callable returning integer nanoseconds)."""
    global _enabled, _clock
    if clock is not None:
        _clock = clock
    _enabled = True
    if tracer.gc_callback not in gc.callbacks:
        gc.callbacks.append(tracer.gc_callback)


def disable() -> None:
    """Back to the no-op posture (recorded data stays until `reset`)."""
    global _enabled, _clock
    _enabled = False
    _clock = time.perf_counter_ns
    if tracer.gc_callback in gc.callbacks:
        gc.callbacks.remove(tracer.gc_callback)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop every metric and span (the enabled/disabled state stays)."""
    registry.reset()
    tracer.reset()


# ---------------------------------------------------------------------------
# the hot-path hooks (single flag check + early return while disabled)
# ---------------------------------------------------------------------------
def span(name: str, **labels):
    """``with obs.span("executor.device_call", engine="cuda"): ...`` —
    records a nested span AND feeds the ``<name>_ns`` latency histogram;
    a shared no-op while disabled."""
    if not _enabled:
        return NULL_SPAN
    return tracer.span(name, **labels)


def counter(name: str, **labels) -> Counter:
    return registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return registry.gauge(name, **labels)


def histogram(name: str, buckets=None, **labels) -> Histogram:
    return registry.histogram(name, buckets=buckets, **labels)


def inc(name: str, n: int = 1, **labels) -> None:
    if _enabled:
        registry.counter(name, **labels).inc(n)


def observe(name: str, v, **labels) -> None:
    if _enabled:
        registry.histogram(name, **labels).observe(v)


def set_gauge(name: str, v, **labels) -> None:
    if _enabled:
        registry.gauge(name, **labels).set(v)
