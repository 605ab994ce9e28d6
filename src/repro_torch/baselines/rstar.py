"""R-tree baseline: STR bulk-loaded packed R-tree.

Query semantics match R*-tree exactly (recursive MBR intersection, leaf
scans); only the *construction* heuristic differs (sort-tile-recursive
packing instead of R*'s forced reinsertion).
Leaves are STR-tiled; internal levels group contiguous children (the
Kamel–Faloutsos packed construction), so the level arrays stay contiguous
and traversal is numpy-vectorized per level.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.query import QueryStats


@dataclasses.dataclass
class RTree:
    xs: np.ndarray           # (n, d) leaf-order points
    leaf_starts: np.ndarray  # (L+1,) point ranges per leaf
    leaf_mbrs: np.ndarray    # (L, d, 2)
    levels: list             # bottom-up list of (mbrs (M,d,2), child_starts (M+1,))

    def index_size_bytes(self) -> int:
        b = self.leaf_mbrs.nbytes + self.leaf_starts.nbytes
        for mbrs, cs in self.levels:
            b += mbrs.nbytes + cs.nbytes
        return b

    def query(self, qL, qU) -> QueryStats:
        st = QueryStats()
        qL = np.asarray(qL, np.int64)
        qU = np.asarray(qU, np.int64)
        frontier = (np.arange(len(self.levels[-1][0])) if self.levels
                    else np.arange(len(self.leaf_mbrs)))
        for mbrs, child_starts in reversed(self.levels):
            st.index_accesses += len(frontier)
            m = mbrs[frontier]
            hit = np.all((m[:, :, 0] <= qU) & (m[:, :, 1] >= qL), axis=1)
            nodes = frontier[hit]
            if len(nodes) == 0:
                frontier = np.empty(0, np.int64)
                break
            frontier = np.concatenate([
                np.arange(child_starts[nd], child_starts[nd + 1])
                for nd in nodes])
        total = 0
        if len(frontier):
            lm = self.leaf_mbrs[frontier]
            hit = np.all((lm[:, :, 0] <= qU) & (lm[:, :, 1] >= qL), axis=1)
            for lf in frontier[hit]:
                st.pages_accessed += 1
                s, e = self.leaf_starts[lf], self.leaf_starts[lf + 1]
                seg = self.xs[s:e].astype(np.int64)
                st.points_scanned += int(e - s)
                cnt = int(np.all((seg >= qL) & (seg <= qU), axis=1).sum())
                st.false_positives += int(e - s) - cnt
                total += cnt
        st.result = total
        return st


def _str_order(centers: np.ndarray, cap: int) -> np.ndarray:
    """Sort-tile-recursive ordering: returns a permutation such that
    consecutive groups of `cap` items form spatially compact tiles."""
    def rec(ids, dims):
        if len(dims) == 1 or len(ids) <= cap:
            return ids[np.argsort(centers[ids, dims[0]], kind="stable")]
        order = ids[np.argsort(centers[ids, dims[0]], kind="stable")]
        slabs = max(1, int(np.ceil((len(ids) / cap) ** (1 / len(dims)))))
        slab_sz = -(-len(order) // slabs)
        return np.concatenate([rec(order[i:i + slab_sz], dims[1:])
                               for i in range(0, len(order), slab_sz)])
    return rec(np.arange(len(centers)), list(range(centers.shape[1])))


def _reduceat_mbrs(mbrs_lo, mbrs_hi, starts):
    lo = np.minimum.reduceat(mbrs_lo, starts[:-1], axis=0)
    hi = np.maximum.reduceat(mbrs_hi, starts[:-1], axis=0)
    return np.stack([lo, hi], axis=-1)


def build_rtree(data: np.ndarray, *, page_bytes: int = 8192,
                fanout: int = 64) -> RTree:
    n, d = data.shape
    cap = page_bytes // (4 * d)
    order = _str_order(data.astype(np.float64), cap)
    xs = data[order]
    n_leaf = -(-n // cap)
    leaf_starts = np.minimum(np.arange(n_leaf + 1) * cap, n)
    xi = xs.astype(np.int64)
    leaf_mbrs = _reduceat_mbrs(xi, xi, leaf_starts)

    # internal levels bottom-up: levels[k] = (node MBRs, child ranges into
    # the level below; level -1 = leaves)
    levels = []
    cur = leaf_mbrs
    while len(cur) > fanout:
        n_grp = -(-len(cur) // fanout)
        cs = np.minimum(np.arange(n_grp + 1) * fanout, len(cur))
        grp = _reduceat_mbrs(cur[:, :, 0], cur[:, :, 1], cs)
        levels.append((grp, cs))
        cur = grp
    return RTree(xs=xs, leaf_starts=leaf_starts, leaf_mbrs=leaf_mbrs,
                 levels=levels)
