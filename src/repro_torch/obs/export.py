"""Exporters: Chrome/Perfetto trace-event JSON, Prometheus text and JSON
snapshots.

`export_trace` writes the Chrome trace-event format (the ``traceEvents``
list of balanced ``"B"``/``"E"`` duration events) that both
``chrome://tracing`` and https://ui.perfetto.dev load directly;
timestamps are microseconds (float) per the spec, thread lanes come from
the recording thread, and span labels ride in ``args``.

`prometheus_text` renders the registry in the Prometheus exposition
format (``name{labels} value`` with ``_count`` / ``_sum`` / ``_bucket``
series for histograms; names carry the ``repro_`` prefix, the same
exposition as the JAX package's); `snapshot` is the same data as one
flat JSON dict.  Both are pull-style: call them whenever you want the
current state, nothing runs in the background.
"""
from __future__ import annotations

import json


def _global():
    from . import registry, tracer       # lazy: obs/__init__ imports us
    return registry, tracer


def trace_events(tracer=None) -> list:
    """The finished spans as a sorted, balanced B/E trace-event list."""
    if tracer is None:
        _, tracer = _global()
    events = []
    for s in tracer.snapshot():
        args = {str(k): str(v) for k, v in s.labels.items()}
        # sort keys: at equal timestamps close children before parents
        # (E before B, deeper E first, shallower B first) so the event
        # stream stays properly nested for the viewer
        events.append(((s.t0_ns, 1, s.depth),
                       {"name": s.name, "cat": "repro_torch", "ph": "B",
                        "pid": 1, "tid": s.tid, "ts": s.t0_ns / 1e3,
                        "args": args}))
        events.append(((s.t1_ns, 0, -s.depth),
                       {"name": s.name, "cat": "repro_torch", "ph": "E",
                        "pid": 1, "tid": s.tid, "ts": s.t1_ns / 1e3}))
    return [e for _, e in sorted(events, key=lambda kv: kv[0])]


def export_trace(path: str, tracer=None) -> int:
    """Write the Perfetto/Chrome-loadable trace JSON; returns the number
    of span records exported (dropped spans are noted in metadata)."""
    if tracer is None:
        _, tracer = _global()
    events = trace_events(tracer)
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"exporter": "repro_torch.obs",
                         "spans_dropped": tracer.spans_dropped}}
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events) // 2


def snapshot(registry=None, tracer=None) -> dict:
    """One flat JSON dict: every metric (+ histogram quantiles) plus the
    trace buffer's occupancy."""
    if registry is None or tracer is None:
        registry, tracer = _global()
    return {"metrics": registry.snapshot(),
            "trace": {"spans": len(tracer),
                      "spans_dropped": tracer.spans_dropped}}


def _prom_name(name: str) -> str:
    return "repro_" + "".join(c if c.isalnum() or c == "_" else "_"
                              for c in name)


def _prom_labels(labels: tuple, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry=None) -> str:
    """The registry in Prometheus exposition format."""
    if registry is None:
        registry, _ = _global()
    lines = []
    typed = set()
    for m in registry.metrics():
        pname = _prom_name(m.name)
        if pname not in typed:
            typed.add(pname)
            lines.append(f"# TYPE {pname} {m.kind}")
        if m.kind != "histogram":
            lines.append(f"{pname}{_prom_labels(m.labels)} {m.value}")
            continue
        acc = 0
        counts = list(m.bucket_counts)
        for bound, c in zip(m.buckets, counts[:-1]):
            acc += c
            le = 'le="%s"' % bound
            lines.append(f"{pname}_bucket{_prom_labels(m.labels, le)} {acc}")
        inf = 'le="+Inf"'
        lines.append(f"{pname}_bucket{_prom_labels(m.labels, inf)} {m.count}")
        lines.append(f"{pname}_sum{_prom_labels(m.labels)} {m.sum}")
        lines.append(f"{pname}_count{_prom_labels(m.labels)} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")
