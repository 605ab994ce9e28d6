"""The typed query algebra behind `Database.query`.

Four query types — the standard workload suite of the multi-dimensional
learned-index literature (Flood; the "How Good Are Multi-dimensional
Learned Indices?" survey) — as small frozen values that `Database.query`
dispatches on:

    Count(rects)             COUNT(*) per window (the paper's §6 workload)
    Range(rects)             window retrieval: the matching rows themselves
    Point(xs)                exact-match lookup per row
    Knn(centers, k, metric)  k nearest neighbors, 'l2' or 'linf'

A plain ``(Ls, Us)`` / rect-array argument to `Database.query` still means
COUNT for backward compatibility.  Engines declare which types they execute
natively via ``BaseEngine.capabilities``; the Database planner routes
unsupported types to the CPU engine so every query stays exact by
construction.

Rectangles accept the same shapes the legacy surface did — ``(Ls, Us)``
pairs, a ``(Q, d, 2)`` uint64 array, or a single ``(qL, qU)`` — and are
normalized (and validated against the index) at dispatch time.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

METRICS = ("l2", "linf")


def norm_rects(rects, U=None, d: int = None):
    """Normalize to ((Q, d) Ls, (Q, d) Us) uint64.

    Validates: every ``Ls <= Us`` (empty-by-inversion rectangles are a
    silent-wrong-answer trap, not a query) and, when `d` is given, that the
    rect dimensionality matches the index.
    """
    if U is not None:
        Ls, Us = rects, U
    elif isinstance(rects, tuple) and len(rects) == 2:
        Ls, Us = rects
    else:
        r = np.asarray(rects, dtype=np.uint64)
        Ls, Us = r[..., 0], r[..., 1]
    Ls = np.atleast_2d(np.asarray(Ls, dtype=np.uint64))
    Us = np.atleast_2d(np.asarray(Us, dtype=np.uint64))
    if Ls.shape != Us.shape:
        raise ValueError(f"rect bounds disagree in shape: Ls{Ls.shape} vs "
                         f"Us{Us.shape}")
    if d is not None and Ls.shape[-1] != d:
        raise ValueError(f"rects are {Ls.shape[-1]}-dimensional but the "
                         f"index has d={d}")
    bad = Ls > Us
    if bad.any():
        q, dim = np.argwhere(bad)[0]
        raise ValueError(
            f"invalid rect: Ls > Us at query {q}, dim {dim} "
            f"({int(Ls[q, dim])} > {int(Us[q, dim])}); lower bounds must "
            f"not exceed upper bounds")
    return Ls, Us


def norm_points(xs, d: int = None) -> np.ndarray:
    """Normalize to a (Q, d) uint64 row batch (single rows broadcast)."""
    xs = np.atleast_2d(np.asarray(xs, dtype=np.uint64))
    if d is not None and xs.shape[-1] != d:
        raise ValueError(f"points are {xs.shape[-1]}-dimensional but the "
                         f"index has d={d}")
    return xs


@dataclasses.dataclass(frozen=True)
class Query:
    """Base of the algebra; `kind` is the capability an engine must declare
    (and the planner's routing key)."""

    kind = "?"

    def coalesce_key(self) -> tuple:
        """Submissions with equal keys may be coalesced into one engine
        super-batch by a `Session` (payload rows concatenate; per-query
        parameters must match).  Default: the kind alone."""
        return (self.kind,)


@dataclasses.dataclass(frozen=True, eq=False)
class Count(Query):
    """COUNT(*) for a batch of window queries -> `QueryResult`."""

    kind = "count"

    rects: Any
    U: Any = None

    def normalized(self, d=None):
        return norm_rects(self.rects, self.U, d=d)


@dataclasses.dataclass(frozen=True, eq=False)
class Range(Query):
    """Window retrieval: the matching rows, per-query offsets ->
    `RangeResult` (rows within each query in lexicographic order)."""

    kind = "range"

    rects: Any
    U: Any = None

    def normalized(self, d=None):
        return norm_rects(self.rects, self.U, d=d)


@dataclasses.dataclass(frozen=True, eq=False)
class Point(Query):
    """Exact-match lookup for a batch of rows -> `PointResult`."""

    kind = "point"

    xs: Any

    def normalized(self, d=None):
        return norm_points(self.xs, d=d)


@dataclasses.dataclass(frozen=True, eq=False)
class Knn(Query):
    """k nearest neighbors of each center ('l2' squared-Euclidean or 'linf'
    Chebyshev), exact with a deterministic (distance, lexicographic row)
    tie-break -> `KnnResult`."""

    kind = "knn"

    centers: Any
    k: int
    metric: str = "l2"

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"k must be >= 1; got {self.k}")
        if self.metric not in METRICS:
            raise ValueError(f"unknown metric {self.metric!r}; expected one "
                             f"of {METRICS}")

    def coalesce_key(self) -> tuple:
        """kNN batches share a device super-batch only at equal (k, metric)
        — those are per-batch parameters, not per-row payload."""
        return (self.kind, int(self.k), self.metric)

    def normalized(self, d=None):
        return norm_points(self.centers, d=d)
