"""Page-level sort dimensions (paper §5.4).

Unlike Flood's single global sort dimension, every page may pick its own:
for each page, over the training queries intersecting its MBR, estimate the
scan cost of sorting by each dimension δ — the expected fraction of the
page's δ-extent that the query's δ-range covers (that fraction of the page
must be scanned after the binary-search refinement) — and keep the argmin.
Pages with no intersecting query use the global default (the dimension with
the smallest average relative query width, Flood's choice).
"""
from __future__ import annotations

import numpy as np


def mbr_intersects(mbrs: np.ndarray, qL: np.ndarray, qU: np.ndarray) -> np.ndarray:
    """mbrs: (P, d, 2); qL/qU: (d,) -> (P,) bool."""
    return np.all((mbrs[:, :, 0] <= qU) & (mbrs[:, :, 1] >= qL), axis=1)


def default_sort_dim(queries_L: np.ndarray, queries_U: np.ndarray,
                     domain: int) -> int:
    """Globally most selective dimension (smallest mean relative width)."""
    widths = (queries_U - queries_L + 1).astype(np.float64) / float(domain)
    return int(np.argmin(widths.mean(axis=0)))


def choose_sort_dims(mbrs: np.ndarray, queries_L: np.ndarray,
                     queries_U: np.ndarray, domain: int) -> np.ndarray:
    """(P,) per-page sort dimension.

    Vectorized over the whole workload (SMBO builds one throwaway index per
    candidate curve, so this runs hundreds of times per learn).  The float
    accumulation must stay bit-identical to the original per-query loop —
    `cost[p] += frac` in query order — which `np.add.at` preserves: it
    applies additions sequentially in index order, and the (query, page)
    pairs from `nonzero` arrive query-major."""
    P, d, _ = mbrs.shape
    dflt = default_sort_dim(queries_L, queries_U, domain)
    out = np.full(P, dflt, dtype=np.int32)
    ext = (mbrs[:, :, 1] - mbrs[:, :, 0] + 1).astype(np.float64)  # (P, d)
    inter = np.all((mbrs[None, :, :, 0] <= queries_U[:, None]) &
                   (mbrs[None, :, :, 1] >= queries_L[:, None]), axis=2)
    qi, pi = np.nonzero(inter)                        # query-major order
    if len(qi) == 0:
        return out
    lo = np.maximum(mbrs[pi, :, 0], queries_L[qi])
    hi = np.minimum(mbrs[pi, :, 1], queries_U[qi])
    frac = (hi - lo + 1).astype(np.float64) / ext[pi]  # scanned fraction/dim
    cost = np.zeros((P, d), dtype=np.float64)
    np.add.at(cost, pi, frac)
    hits = np.bincount(pi, minlength=P)
    sel = hits > 0
    out[sel] = np.argmin(cost[sel], axis=1)
    return out


def apply_sort_dims(xs: np.ndarray, starts: np.ndarray,
                    sort_dims: np.ndarray) -> np.ndarray:
    """Reorder points inside each page by its sort dimension (stable, so
    z-order is preserved as tie-break).  Returns the reordered copy."""
    out = xs.copy()
    for p in range(len(starts) - 1):
        s, e = starts[p], starts[p + 1]
        seg = xs[s:e]
        order = np.argsort(seg[:, sort_dims[p]], kind="stable")
        out[s:e] = seg[order]
    return out
