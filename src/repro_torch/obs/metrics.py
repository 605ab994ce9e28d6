"""Zero-dependency metrics primitives: monotonic counters, gauges, and
fixed-bucket latency histograms with exact quantile extraction.

Everything here is plain stdlib + threading — no numpy, no torch — so the
`repro_torch.obs` layer can be imported (and stay a no-op) from any module
without adding import weight to the hot path.

Metrics live in a `Registry`, keyed by ``(name, labels)``; the same name
with different label values is a different time series (Prometheus
semantics).  A `Histogram` keeps two representations at once:

* **fixed buckets** — geometric (powers-of-two nanosecond) boundaries, so
  the Prometheus export is bounded-size whatever the traffic, and
* **a bounded raw-sample reservoir** — quantiles are *exact*
  (nearest-rank over the recorded samples) until the reservoir cap is
  hit; past the cap new samples still land in the buckets and quantiles
  fall back to bucket upper bounds, with ``samples_dropped`` recording
  exactly how many observations the exact path missed (no silent caps).

Both quantile paths are monotone by construction (p50 <= p95 <= p99),
which the ``obs-smoke`` CI job re-asserts on every push.
"""
from __future__ import annotations

import bisect
import threading

# default latency buckets: 1us .. ~137s in powers of two (ns), + overflow
DEFAULT_BUCKETS_NS = tuple(2 ** k for k in range(10, 38))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def format_labels(labels: tuple) -> str:
    """``{k="v",...}`` in sorted-key order ('' when unlabeled)."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Counter:
    """Monotonically increasing counter."""

    kind = "counter"
    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counters are monotonic; got inc({n})")
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """A value that can go up and down (queue depth, fill factor, ...)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += delta

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram + exact-quantile sample reservoir (see the
    module docstring for the exact-vs-bucket quantile contract)."""

    kind = "histogram"
    __slots__ = ("name", "labels", "buckets", "bucket_counts", "count",
                 "sum", "max_samples", "samples", "samples_dropped",
                 "_lock")

    def __init__(self, name: str, labels: tuple = (),
                 buckets=DEFAULT_BUCKETS_NS, max_samples: int = 65536):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +overflow
        self.count = 0
        self.sum = 0.0
        self.max_samples = max_samples
        self.samples = []
        self.samples_dropped = 0
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
            if len(self.samples) < self.max_samples:
                self.samples.append(v)
            else:
                self.samples_dropped += 1

    @property
    def exact(self) -> bool:
        """True while quantiles come from the raw samples, not buckets."""
        return self.samples_dropped == 0

    def percentile(self, p: float):
        """The p-th percentile (0 < p <= 100): exact nearest-rank over the
        recorded samples, or the bucket upper bound once the reservoir
        overflowed.  None when nothing was observed."""
        if not 0 < p <= 100:
            raise ValueError(f"percentile wants 0 < p <= 100; got {p}")
        with self._lock:
            if self.count == 0:
                return None
            rank = max(1, -(-self.count * p // 100))   # ceil, 1-based
            if self.samples_dropped == 0:
                return sorted(self.samples)[int(rank) - 1]
            seen = 0
            for i, c in enumerate(self.bucket_counts):
                seen += c
                if seen >= rank:
                    return (self.buckets[i] if i < len(self.buckets)
                            else float("inf"))
            return float("inf")     # unreachable: seen ends at count

    def quantiles(self) -> dict:
        return {"p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
            dropped = self.samples_dropped
        out = {"count": count, "sum": total, "exact": dropped == 0}
        if dropped:
            out["samples_dropped"] = dropped
        out.update(self.quantiles())
        return out


class Registry:
    """All live metrics of one obs instance; thread-safe get-or-create."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        kw = {"buckets": buckets} if buckets is not None else {}
        return self._get(Histogram, name, labels, **kw)

    def metrics(self) -> list:
        with self._lock:
            return sorted(self._metrics.values(),
                          key=lambda m: (m.name, m.labels))

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """Flat ``{"name{k=\"v\"}": value-or-histogram-dict}`` JSON dict."""
        return {m.name + format_labels(m.labels): m.snapshot()
                for m in self.metrics()}
