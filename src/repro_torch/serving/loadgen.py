"""Open-loop load generation for the serving front.

Simulates hundreds of interleaved clients against an `AsyncServer`:

* **Open loop** — arrivals follow a Poisson process at the offered rate
  and are *scheduled up front*; the generator submits at the scheduled
  instants regardless of completions.  Latency is measured from the
  scheduled arrival (not the actual submit call), so queueing delay the
  server causes is charged to the server — the standard
  coordinated-omission-free methodology (wrk2, Flood's serving framing).
* **Zipfian spatial skew** — query centers are data rows drawn through a
  Zipf(``a``) rank distribution over a seeded permutation of the
  dataset: a handful of hot rows dominate, the tail stays warm — the
  skewed-access pattern a learned index actually serves.
* **Mixed kinds** — each arrival is a Count / Range / Point / Knn
  submission per the configured mix, labelled with one of `n_clients`
  client ids.

`make_query_log` is pure and fully seeded (same spec → same log, byte
for byte), which is what makes the serial-replay exactness gate and a
rate sweep reproducible; only `run_open_loop` touches the wall clock.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..api.queries import Count, Knn, Point, Query, Range
from ..core.theta import default_K
from .server import AsyncServer
from .slo import ServerOverloaded

DEFAULT_MIX = (("count", 0.45), ("range", 0.20), ("point", 0.25),
               ("knn", 0.10))


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One open-loop load point."""

    rate_qps: float               # offered load (submissions/sec)
    duration_s: float = 2.0
    n_clients: int = 200          # distinct client labels
    mix: tuple = DEFAULT_MIX      # ((kind, fraction), ...)
    zipf_a: float = 1.2           # spatial-skew exponent (> 1)
    width_scale: float = 0.03     # rect width as a fraction of the domain
    knn_k: int = 4
    seed: int = 0

    def __post_init__(self):
        if self.rate_qps <= 0 or self.duration_s <= 0:
            raise ValueError(f"rate_qps and duration_s must be > 0; got "
                             f"{self.rate_qps}, {self.duration_s}")
        if self.zipf_a <= 1:
            raise ValueError(f"zipf_a must be > 1; got {self.zipf_a}")
        total = sum(f for _, f in self.mix)
        if not np.isclose(total, 1.0):
            raise ValueError(f"kind mix must sum to 1; got {total}")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled submission."""

    t: float                      # seconds after the run starts
    client: str
    query: Query


def make_query_log(data: np.ndarray, spec: LoadSpec, K: int = None) -> list:
    """The deterministic open-loop schedule for one load point: a list of
    `Arrival`s sorted by scheduled time (Poisson arrivals, Zipf-skewed
    centers, mixed kinds — module docstring)."""
    rng = np.random.default_rng(spec.seed)
    d = data.shape[1]
    K = K or default_K(d)
    domain = float(2**K - 1)

    # Poisson process: exponential gaps at the offered rate, truncated at
    # the duration (draw with slack so truncation, not exhaustion, ends it)
    n_draw = max(16, int(spec.rate_qps * spec.duration_s * 2))
    gaps = rng.exponential(1.0 / spec.rate_qps, size=n_draw)
    times = np.cumsum(gaps)
    times = times[times < spec.duration_s]

    # Zipfian spatial skew: rank -> row through a seeded permutation
    perm = rng.permutation(len(data))
    ranks = (rng.zipf(spec.zipf_a, size=len(times)) - 1) % len(data)
    centers = data[perm[ranks]].astype(np.float64)

    kinds = rng.choice([k for k, _ in spec.mix], size=len(times),
                       p=[f for _, f in spec.mix])
    clients = rng.integers(0, spec.n_clients, size=len(times))
    widths = rng.uniform(0, spec.width_scale * domain,
                         size=(len(times), d))

    log = []
    for i, t in enumerate(times):
        c = centers[i]
        kind = kinds[i]
        if kind in ("count", "range"):
            lo = np.clip(c - widths[i] / 2, 0, domain).astype(np.uint64)
            hi = np.clip(c + widths[i] / 2, 0, domain).astype(np.uint64)
            q = (Count(lo[None], hi[None]) if kind == "count"
                 else Range(lo[None], hi[None]))
        elif kind == "point":
            q = Point(c.astype(np.uint64)[None])
        else:
            q = Knn(c.astype(np.uint64)[None], k=spec.knn_k, metric="l2")
        log.append(Arrival(t=float(t), client=f"c{clients[i]}", query=q))
    return log


def quantiles_ms(lat_ms) -> dict:
    """p50/p95/p99 (+ mean, count) of a latency sample, in ms."""
    lat = np.asarray(lat_ms, dtype=float)
    if len(lat) == 0:
        return {"count": 0, "mean": None, "p50": None, "p95": None,
                "p99": None}
    return {"count": int(len(lat)), "mean": float(lat.mean()),
            "p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99))}


def run_open_loop(server: AsyncServer, log: list, *,
                  result_timeout_s: float = 60.0) -> dict:
    """Replay one schedule against a live server and measure.

    Submits each arrival at its scheduled instant (sleeping the gaps,
    never waiting on completions — open loop), then collects every
    ticket.  Returns latencies (ms, measured from the *scheduled*
    arrival), the sustained completion rate, shed/served counts, and the
    per-seq results for the exactness replay.
    """
    clock = time.perf_counter
    t0 = clock()
    submitted = []                       # (Arrival, ServerTicket | None)
    for a in log:
        while True:
            dt = t0 + a.t - clock()
            if dt <= 0:
                break
            time.sleep(min(dt, 0.002))
        try:
            ticket = server.submit(a.query, client=a.client)
        except ServerOverloaded:
            ticket = None
        submitted.append((a, ticket))

    lat_ms = []
    results = {}                         # ticket seq -> result
    failed = 0
    t_last = t0
    for a, ticket in submitted:
        if ticket is None:
            continue
        try:
            res = ticket.result(timeout=result_timeout_s)
        except Exception:
            failed += 1
            continue
        results[ticket.seq] = res
        t_last = max(t_last, ticket.t_done)
        lat_ms.append((ticket.t_done - (t0 + a.t)) * 1e3)

    span_s = max(t_last - t0, 1e-9)
    return {
        "offered_qps": len(log) / max(log[-1].t, 1e-9) if log else 0.0,
        "scheduled": len(log),
        "admitted": sum(1 for _, t in submitted if t is not None),
        "shed": sum(1 for _, t in submitted if t is None),
        "failed": failed,
        "completed": len(lat_ms),
        "sustained_qps": len(lat_ms) / span_s,
        "span_s": span_s,
        "latency_ms": quantiles_ms(lat_ms),
        "lat_ms": lat_ms,
        "results": results,
    }


def sweep(backend, data: np.ndarray, rates, *, make_slo, engine: str = None,
          duration_s: float = 2.0, seed: int = 0, K: int = None,
          spec_kw: dict = None) -> list:
    """p50/p99-latency-vs-sustained-q/s curve: one fresh `AsyncServer`
    (same warm backend) per offered rate, in ascending-rate order.
    `make_slo` is a zero-arg factory (each point gets a fresh controller).
    Returns the per-point measurement dicts from `run_open_loop`, each
    annotated with server stats and the controller trajectory."""
    points = []
    for rate in rates:
        spec = LoadSpec(rate_qps=float(rate), duration_s=duration_s,
                        seed=seed + int(rate), **(spec_kw or {}))
        log = make_query_log(data, spec, K=K)
        server = AsyncServer(backend, slo=make_slo(), engine=engine)
        try:
            point = run_open_loop(server, log)
        finally:
            server.close()
        point["stats"] = server.stats()
        point["trajectory"] = list(server.controller.trajectory)
        point["spec_seed"] = spec.seed
        point["query_log"] = server.query_log()
        points.append(point)
    return points
