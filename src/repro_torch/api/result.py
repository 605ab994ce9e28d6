"""The unified query surface shared by every engine.

`EngineConfig` carries the knobs of every `make_query_fn` /
`make_range_fn` call site, plus the exactness policy (overflow
escalation, staleness handling).

One result type per query kind in the algebra
(`repro_torch.api.queries`), all carrying the same provenance (engine,
epoch) and overflow accounting so exactness is auditable regardless of
which engine served the batch:

  `QueryResult` — Count: exact (Q,) counts + aggregate mechanical stats
  `RangeResult` — Range: matching rows with per-query offsets
  `PointResult` — Point: per-row found flags
  `KnnResult`   — Knn: neighbors + exact distances with per-center offsets
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core.query import QueryStats


@dataclasses.dataclass
class EngineConfig:
    """Execution knobs for one attached engine."""

    k_maxsplit: int = 4        # recursive query splitting depth (§6.1)
    max_cand: int = 64         # initial per-query candidate-page bound
    max_hits: int = 1024       # initial per-query row-id buffer for Range
                               #   retrieval (escalated like max_cand)
    q_chunk: int = 16          # query chunk; queries are padded to a multiple
    backend: str = None        # filter/encode path: 'torch' (plain
                               #   twins) on the 'torch' engine, 'cuda'
                               #   (the hand-written kernels) on the
                               #   'cuda' engine; the 'store' and
                               #   'distributed' engines take either
                               #   ('cuda' on CUDA devices, the default
                               #   there; 'torch' the default only on a
                               #   CPU device)
    device: Any = None         # device engines: where the serving arrays
                               #   live (None: the Database's device, else
                               #   CUDA; the 'cuda' engine needs a CUDA one)
    mesh: Any = None           # distributed only: the devices, one page
                               #   shard each (default: every visible
                               #   CUDA device; the engine's device under
                               #   device="cpu")
    pad_pages_to: int = None   # page-count padding (defaults: 1, or mesh size)
    cap: int = None            # per-page point capacity (default: max page)
    escalate: bool = True      # retry overflowed queries with doubled max_cand
    cpu_fallback: bool = True  # final exactness net if escalation is exhausted
    on_stale: str = "refresh"  # when device arrays predate the DeltaStore
                               #   epoch: 'refresh' | 'error' | 'serve_stale'
    group_pages: int = None    # store engine: pages per cached device block
                               #   (default 64)
    cache_bytes: int = None    # store engine: page-group cache budget —
                               #   a hard resident-bytes bound (default 256MB)


@dataclasses.dataclass
class QueryResult:
    """What `Database.query` returns, identically shaped for every engine."""

    counts: np.ndarray         # (Q,) int64 — exact window-query counts
    engine: str                # engine name that served the batch
    epoch: int                 # DeltaStore epoch the batch was served at
    stats: QueryStats          # aggregate mechanical stats (complete on the
                               #   CPU engine; device engines fill `result`)
    overflowed: np.ndarray     # (Q,) int32 first-pass overflow events
                               #   (shard-additive on the distributed engine)
    residual_overflow: np.ndarray = None  # (Q,) after escalation; all-zero
                                          #   unless escalation was disabled
    escalations: int = 0       # doubled-max_cand retry rounds that ran
    cpu_fallbacks: int = 0     # queries resolved by the CPU exactness net
    plan: Any = None           # the executed QueryPlan (accounting filled)

    def __post_init__(self):
        if self.residual_overflow is None:
            self.residual_overflow = np.zeros_like(self.overflowed)

    @property
    def exact(self) -> bool:
        """True when every count is exact by construction."""
        return not np.any(self.residual_overflow)

    def __len__(self) -> int:
        return len(self.counts)


@dataclasses.dataclass
class RangeResult:
    """What `Database.query(Range(...))` returns: the matching rows.

    Rows of all queries are concatenated; query i owns
    ``rows[offsets[i]:offsets[i+1]]``, in lexicographic order (dim 0
    primary) on every engine, so cross-engine results compare bit-equal.
    """

    rows: np.ndarray           # (N, d) uint64 — all matching rows
    offsets: np.ndarray        # (Q+1,) int64 — per-query slices into `rows`
    engine: str                # engine name that served the batch
    epoch: int                 # DeltaStore epoch the batch was served at
    stats: QueryStats          # aggregate mechanical stats
    overflowed: np.ndarray     # (Q,) int32 first-pass overflow events
                               #   (candidate pages and/or hit buffer)
    residual_overflow: np.ndarray = None  # (Q,) after escalation
    escalations: int = 0       # doubled-bound retry rounds that ran
    cpu_fallbacks: int = 0     # queries resolved by the CPU exactness net
    plan: Any = None           # the executed QueryPlan (accounting filled)

    def __post_init__(self):
        if self.residual_overflow is None:
            self.residual_overflow = np.zeros_like(self.overflowed)

    @property
    def counts(self) -> np.ndarray:
        """(Q,) int64 — per-query match counts (== Count on these rects)."""
        return np.diff(self.offsets)

    @property
    def exact(self) -> bool:
        return not np.any(self.residual_overflow)

    def rows_for(self, i: int) -> np.ndarray:
        """Query i's matching rows, lexicographically sorted."""
        return self.rows[self.offsets[i]:self.offsets[i + 1]]

    def __len__(self) -> int:
        return len(self.offsets) - 1


@dataclasses.dataclass
class PointResult:
    """What `Database.query(Point(...))` returns: per-row presence.

    Point lookups are exact on every engine by construction (curve encode
    + page probe, or a degenerate one-cell window on device engines), so
    there is no residual-overflow dimension; `cpu_fallbacks`/`escalations`
    still audit how the batch was served.
    """

    found: np.ndarray          # (Q,) bool — row present (and not tombstoned)
    engine: str
    epoch: int
    stats: QueryStats = None
    escalations: int = 0
    cpu_fallbacks: int = 0
    plan: Any = None           # the executed QueryPlan (accounting filled)

    @property
    def exact(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.found)


@dataclasses.dataclass
class KnnResult:
    """What `Database.query(Knn(...))` returns: exact nearest neighbors.

    Neighbors of all centers are concatenated; center i owns
    ``neighbors[offsets[i]:offsets[i+1]]`` in ascending-distance order with
    a deterministic (distance, lexicographic row) tie-break — identical on
    every engine.  A center gets fewer than k neighbors only when the
    database holds fewer than k live rows.  `dists` are the exact integer
    distances (squared L2 for 'l2', Chebyshev for 'linf') as float64 —
    exact whenever they fit 53 bits; the *ordering* was always decided on
    exact integers.

    On device engines each center's covering box goes through the Range
    path: `overflowed` / `residual_overflow` are that box retrieval's flags
    (as on `RangeResult`; the CPU net is always on for kNN, so the residual
    is all-zero) and `box_rows` the rows its box returned.  The `cpu`
    engine retrieves no box through a device path: all three are zeros.
    """

    neighbors: np.ndarray      # (N, d) uint64
    offsets: np.ndarray        # (Q+1,) int64
    dists: np.ndarray          # (N,) float64 — see docstring
    k: int
    metric: str
    engine: str
    epoch: int
    stats: QueryStats = None
    escalations: int = 0
    cpu_fallbacks: int = 0
    plan: Any = None           # the executed QueryPlan (accounting filled)
    overflowed: np.ndarray = None         # (Q,) int32 box first-pass
                                          #   overflow events
    residual_overflow: np.ndarray = None  # (Q,) int32 after the ladder/net
    box_rows: np.ndarray = None           # (Q,) int64 rows each box returned

    def __post_init__(self):
        q = len(self.offsets) - 1
        if self.overflowed is None:
            self.overflowed = np.zeros(q, dtype=np.int32)
        if self.residual_overflow is None:
            self.residual_overflow = np.zeros_like(self.overflowed)
        if self.box_rows is None:
            self.box_rows = np.zeros(q, dtype=np.int64)

    @property
    def exact(self) -> bool:
        return not np.any(self.residual_overflow)

    def neighbors_for(self, i: int) -> np.ndarray:
        return self.neighbors[self.offsets[i]:self.offsets[i + 1]]

    def dists_for(self, i: int) -> np.ndarray:
        return self.dists[self.offsets[i]:self.offsets[i + 1]]

    def __len__(self) -> int:
        return len(self.offsets) - 1
