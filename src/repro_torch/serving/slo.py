"""SLO policy for the async serving front: targets, admission control,
weighted-fair queueing, and the adaptive batching controller.

Three pieces, all deterministic and engine-agnostic (they see only
latency samples and queue depths, never query payloads):

* `SLOConfig` — the declarative contract: a p99 latency target, a
  bounded queue depth with an overload policy (``reject`` sheds with
  `ServerOverloaded`, ``block`` applies backpressure to the submitting
  thread), per-kind weights for fair dequeue, and the coalescing-window
  bounds the controller may move within.
* `AdaptiveController` — AIMD on the coalescing window: *grow* the
  window additively while observed p99 sits comfortably under the target
  (bigger windows → fuller engine super-batches → throughput), *shrink*
  it multiplicatively the moment p99 crosses the target (pressure →
  latency wins).  Between ``headroom * target`` and ``target`` is a dead
  zone, so the controller settles instead of oscillating against its own
  measurement noise.
* `WeightedFairQueue` — per-kind bounded FIFOs drained by stride
  scheduling: each kind advances a virtual clock by ``1 / weight`` per
  dequeue, and the drain always picks the kind with the smallest clock.
  Cheap Point/Count traffic (high weight) keeps flowing while a backlog
  of expensive Range/Knn submissions (low weight) is worked through —
  no kind is ever starved, only slowed in proportion.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from .. import obs


class ServerOverloaded(RuntimeError):
    """Admission control rejected a submission: the server's bounded
    queue is full and the SLO's overload policy is ``reject``."""


#: Default weighted-fair dequeue weights: cheap point/count lookups get
#: 4x the service share of expensive range/knn retrievals.
DEFAULT_WEIGHTS = {"count": 4.0, "point": 4.0, "range": 1.0, "knn": 1.0}

_OVERLOAD_POLICIES = ("reject", "block")


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """The serving contract one `AsyncServer` runs under."""

    p99_target_ms: float = 25.0   # the latency SLO the controller defends
    max_queue: int = 1024         # bounded queue depth (submissions)
    overload: str = "reject"      # queue-full policy: 'reject' | 'block'
    batch_max: int = 64           # submissions per drain batch
    window_init_ms: float = 2.0   # initial coalescing window
    window_min_ms: float = 0.0    # controller floor (0 = drain immediately)
    window_max_ms: float = 50.0   # controller ceiling
    grow_ms: float = 0.5          # additive increase per calm update
    shrink: float = 0.5           # multiplicative decrease under pressure
    headroom: float = 0.8         # grow only while p99 < headroom * target
    sample_window: int = 256      # latency samples the controller sees
    min_samples: int = 16         # don't adapt before this many samples
    weights: dict = None          # per-kind fair-dequeue weights
    adaptive: bool = True         # False pins the window at window_init_ms
    max_retries: int = 2          # flush retries before a batch is failed

    def __post_init__(self):
        if self.p99_target_ms <= 0:
            raise ValueError(f"p99_target_ms must be > 0; got "
                             f"{self.p99_target_ms}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1; got {self.max_queue}")
        if self.overload not in _OVERLOAD_POLICIES:
            raise ValueError(f"unknown overload policy {self.overload!r}; "
                             f"expected one of {_OVERLOAD_POLICIES}")
        if self.batch_max < 1:
            raise ValueError(f"batch_max must be >= 1; got {self.batch_max}")
        if not (0 <= self.window_min_ms <= self.window_init_ms
                <= self.window_max_ms):
            raise ValueError(
                f"window bounds must satisfy 0 <= min <= init <= max; got "
                f"min={self.window_min_ms}, init={self.window_init_ms}, "
                f"max={self.window_max_ms}")
        if not (0 < self.shrink < 1):
            raise ValueError(f"shrink must be in (0, 1); got {self.shrink}")
        if self.grow_ms < 0:
            raise ValueError(f"grow_ms must be >= 0; got {self.grow_ms}")
        if not (0 < self.headroom <= 1):
            raise ValueError(f"headroom must be in (0, 1]; got "
                             f"{self.headroom}")
        if self.min_samples < 1 or self.sample_window < self.min_samples:
            raise ValueError(
                f"need 1 <= min_samples <= sample_window; got "
                f"min_samples={self.min_samples}, "
                f"sample_window={self.sample_window}")
        weights = {**DEFAULT_WEIGHTS, **(self.weights or {})}
        for k, w in weights.items():
            if not w > 0:
                raise ValueError(f"weight for {k!r} must be > 0; got {w}")
        object.__setattr__(self, "weights", weights)

    def to_dict(self) -> dict:
        """JSON-serializable form."""
        return dataclasses.asdict(self)


class AdaptiveController:
    """AIMD on the coalescing window, driven by observed p99 (module
    docstring).  Single-writer: only the server's drain loop calls
    `observe`/`update`; readers may sample `window_ms` freely."""

    def __init__(self, slo: SLOConfig):
        self.slo = slo
        self.window_ms = float(slo.window_init_ms)
        self._lat_ms = collections.deque(maxlen=slo.sample_window)
        self.updates = 0
        self.grows = 0
        self.shrinks = 0
        # (update #, window_ms, observed p99_ms) — bounded; the load
        # harness reports it as the controller trajectory
        self.trajectory = collections.deque(maxlen=4096)

    def observe(self, latencies_ms) -> None:
        """Feed per-submission end-to-end latencies (ms)."""
        self._lat_ms.extend(float(v) for v in latencies_ms)

    def p99_ms(self) -> float:
        if not self._lat_ms:
            return float("nan")
        return float(np.percentile(np.fromiter(self._lat_ms, dtype=float),
                                   99))

    def update(self) -> float:
        """One control step (after each drained batch); returns the new
        window.  Grows additively in calm, shrinks multiplicatively under
        pressure, holds inside the dead zone — and never moves outside
        ``[window_min_ms, window_max_ms]``."""
        self.updates += 1
        p99 = self.p99_ms()
        if (self.slo.adaptive and len(self._lat_ms) >= self.slo.min_samples
                and p99 == p99):                      # p99 != NaN
            if p99 > self.slo.p99_target_ms:
                self.window_ms = max(self.slo.window_min_ms,
                                     self.window_ms * self.slo.shrink)
                self.shrinks += 1
            elif p99 < self.slo.headroom * self.slo.p99_target_ms:
                self.window_ms = min(self.slo.window_max_ms,
                                     self.window_ms + self.slo.grow_ms)
                self.grows += 1
        self.trajectory.append((self.updates, round(self.window_ms, 4),
                                round(p99, 4) if p99 == p99 else None))
        obs.set_gauge("serving.window_ms", self.window_ms)
        return self.window_ms

    def snapshot(self) -> dict:
        return {"window_ms": self.window_ms, "p99_ms": self.p99_ms(),
                "updates": self.updates, "grows": self.grows,
                "shrinks": self.shrinks, "samples": len(self._lat_ms)}

    def __repr__(self):
        return (f"AdaptiveController(window={self.window_ms:.3f}ms, "
                f"p99={self.p99_ms():.3f}ms, updates={self.updates}, "
                f"grows={self.grows}, shrinks={self.shrinks})")


class WeightedFairQueue:
    """Bounded per-kind FIFOs drained by stride scheduling (module
    docstring).  NOT internally locked: the owning `AsyncServer`
    serializes every call under its own lock — keeping push/pop lock-free
    here means admission control and the drain loop share one critical
    section instead of nesting two."""

    def __init__(self, weights: dict, max_depth: int):
        self.weights = dict(weights)
        self.max_depth = int(max_depth)
        self._q = {}            # kind -> deque of items (FIFO per kind)
        self._pass = {}         # kind -> virtual finish time
        self._vt = 0.0          # global virtual clock
        self.depth = 0
        self.pushed = 0
        self.popped = 0

    def push(self, kind: str, item) -> bool:
        """Enqueue; returns False (untouched queue) when at max_depth —
        the caller applies the overload policy."""
        if self.depth >= self.max_depth:
            return False
        dq = self._q.get(kind)
        if dq is None:
            dq = self._q[kind] = collections.deque()
        if not dq:
            # (re)activating an idle kind: join at the current virtual
            # time, never in the past (an idle kind must not bank credit)
            self._pass[kind] = max(self._pass.get(kind, 0.0), self._vt)
        dq.append(item)
        self.depth += 1
        self.pushed += 1
        return True

    def pop(self):
        """Dequeue one item from the backlogged kind with the smallest
        virtual finish time (ties broken by kind name, deterministically);
        None when empty."""
        live = [k for k, dq in self._q.items() if dq]
        if not live:
            return None
        kind = min(live, key=lambda k: (self._pass[k], k))
        self._vt = self._pass[kind]
        self._pass[kind] += 1.0 / self.weights.get(kind, 1.0)
        self.depth -= 1
        self.popped += 1
        return self._q[kind].popleft()

    def pop_batch(self, n: int) -> list:
        """Up to `n` items in weighted-fair order."""
        out = []
        while len(out) < n:
            item = self.pop()
            if item is None:
                break
            out.append(item)
        return out

    def kind_depths(self) -> dict:
        return {k: len(dq) for k, dq in self._q.items() if dq}

    def __len__(self) -> int:
        return self.depth

    def __repr__(self):
        return (f"WeightedFairQueue(depth={self.depth}/{self.max_depth}, "
                f"kinds={self.kind_depths()})")
