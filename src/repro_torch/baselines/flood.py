"""Flood baseline [26] (simplified, honest): learned multi-dimensional grid.

Flood picks one *sort dimension* and lays a learned grid over the remaining
d−1 dimensions; cells are ordered row-major (with a learned dimension
order), points within a cell sorted by the sort dimension.  We learn the
per-dimension column counts by evaluating candidate layouts' scan cost on
the training workload (grid search over powers of two under a total-cell
budget) — the same "optimize layout against the workload" contract as the
original, with its CDF-model refinement omitted.  Fixed-size paging over the
flattened order, as the paper does for its comparison.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..core.query import QueryStats
from ..core.theta import default_K


@dataclasses.dataclass
class FloodIndex:
    xs: np.ndarray            # (n, d) points, grid-cell-major, sort-dim order
    sort_dim: int
    grid_dims: list           # d-1 dims, outer-to-inner
    cols: list                # column count per grid dim
    edges: list               # bin edges per grid dim (len cols+1)
    cell_starts: np.ndarray   # (n_cells + 1,)
    page_size: int            # points per (fixed) page
    K: int

    @property
    def n_cells(self) -> int:
        return len(self.cell_starts) - 1

    def index_size_bytes(self) -> int:
        return self.cell_starts.nbytes + sum(len(e) * 8 for e in self.edges) + 64

    # ------------------------------------------------------------------
    def _cell_ranges(self, qL, qU):
        """Cartesian product of intersecting column ranges -> flat cell ids."""
        ranges = []
        for dim, edges in zip(self.grid_dims, self.edges):
            lo = int(np.searchsorted(edges, qL[dim], side="right")) - 1
            hi = int(np.searchsorted(edges, qU[dim], side="right")) - 1
            lo = max(lo, 0)
            hi = min(hi, len(edges) - 2)
            ranges.append(range(lo, hi + 1))
        return ranges

    def query(self, qL, qU) -> QueryStats:
        st = QueryStats()
        qL = np.asarray(qL, np.uint64)
        qU = np.asarray(qU, np.uint64)
        ranges = self._cell_ranges(qL, qU)
        sd = self.sort_dim
        total = 0
        pages = set()
        other = [i for i in range(self.xs.shape[1]) if i != sd]
        for combo in itertools.product(*ranges):
            cell = 0
            for c, ncols in zip(combo, self.cols):
                cell = cell * ncols + c
            s, e = self.cell_starts[cell], self.cell_starts[cell + 1]
            if s == e:
                continue
            st.index_accesses += 1
            seg = self.xs[s:e]
            col = seg[:, sd]
            lo = int(np.searchsorted(col, qL[sd], "left"))
            hi = int(np.searchsorted(col, qU[sd], "right"))
            sub = seg[lo:hi]
            if len(sub) == 0:
                continue
            st.points_scanned += len(sub)
            ok = np.ones(len(sub), bool)
            for i in other:
                ok &= (sub[:, i] >= qL[i]) & (sub[:, i] <= qU[i])
            cnt = int(ok.sum())
            st.false_positives += len(sub) - cnt
            total += cnt
            pages.update(range((s + lo) // self.page_size,
                               (s + hi - 1) // self.page_size + 1))
        st.pages_accessed = len(pages)
        st.result = total
        return st


def _layout(data, sort_dim, grid_dims, cols, K):
    edges = []
    for dim, c in zip(grid_dims, cols):
        qs = np.quantile(data[:, dim].astype(np.float64),
                         np.linspace(0, 1, c + 1))
        qs[0], qs[-1] = -1.0, 2.0**K  # catch-all outer edges
        edges.append(np.unique(qs))
    # cell id per point
    cell = np.zeros(len(data), dtype=np.int64)
    for dim, e, c in zip(grid_dims, edges, cols):
        col = np.clip(np.searchsorted(e, data[:, dim], "right") - 1, 0, c - 1)
        cell = cell * c + col
    order = np.lexsort((data[:, sort_dim], cell))
    xs = data[order]
    cell_sorted = cell[order]
    n_cells = int(np.prod(cols))
    starts = np.searchsorted(cell_sorted, np.arange(n_cells + 1))
    return xs, edges, starts


def build_flood(data: np.ndarray, workload, *, K: int = None,
                page_bytes: int = 8192, sample: int = 20_000,
                budget_cells: int = None) -> FloodIndex:
    d = data.shape[1]
    K = K or default_K(d)
    Ls, Us = workload
    # sort dim: most selective (smallest mean relative width)
    widths = (Us.astype(np.float64) - Ls.astype(np.float64)).mean(axis=0)
    sort_dim = int(np.argmin(widths))
    grid_dims = sorted([i for i in range(d) if i != sort_dim],
                       key=lambda i: -widths[i])  # widest outermost
    page_size = page_bytes // (4 * d)
    budget_cells = budget_cells or max(4, len(data) // (4 * page_size))

    # candidate column counts: powers of two per grid dim under the budget
    per_dim = max(2, int(round(budget_cells ** (1 / max(1, d - 1)))))
    options = sorted({1, 2, per_dim // 2 or 1, per_dim, per_dim * 2})
    rng = np.random.default_rng(0)
    samp = data[rng.integers(0, len(data), min(sample, len(data)))]
    wl_idx = rng.integers(0, len(Ls), size=min(60, len(Ls)))

    best = None
    for combo in itertools.product(options, repeat=max(1, d - 1)):
        if np.prod(combo) > budget_cells * 4 or np.prod(combo) < 2:
            continue
        xs, edges, starts = _layout(samp, sort_dim, grid_dims, list(combo), K)
        fi = FloodIndex(xs=xs, sort_dim=sort_dim, grid_dims=grid_dims,
                        cols=list(combo), edges=edges, cell_starts=starts,
                        page_size=page_size, K=K)
        cost = 0.0
        for t in wl_idx:
            st = fi.query(Ls[t], Us[t])
            cost += st.pages_accessed + 0.02 * st.points_scanned \
                + 0.1 * st.index_accesses
        if best is None or cost < best[0]:
            best = (cost, list(combo))
    xs, edges, starts = _layout(data, sort_dim, grid_dims, best[1], K)
    return FloodIndex(xs=xs, sort_dim=sort_dim, grid_dims=grid_dims,
                      cols=best[1], edges=edges, cell_starts=starts,
                      page_size=page_size, K=K)
