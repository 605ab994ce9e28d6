"""Random-forest regression surrogate for SMBO (paper §5.2 uses an RF
surrogate instead of a GP).  Pure numpy CART.

The split search is vectorized across the candidate features of a node (one
argsort/cumsum sweep over an (n, m) block instead of m per-feature passes):
SMBO refits the forest every iteration, and the per-feature python loop was
the single largest host cost left in `learn_sfc` after the pooled evaluator
landed.  Selection semantics are unchanged — first feature (in draw order)
achieving the minimum SSE wins, splits inside runs of equal x are invalid —
and all randomness flows through one injectable `np.random.Generator`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: "._Node" = None
    right: "._Node" = None
    value: float = 0.0


def _best_split(X, y, feats, min_leaf):
    """Best (sse, feature, thresh) over the candidate features, or None.
    Ties on SSE resolve to the first feature in `feats` order and the first
    split position, matching argmin's first-occurrence rule."""
    n = len(y)
    if n < 2 * min_leaf:
        return None
    ks = np.arange(min_leaf, n - min_leaf + 1)
    kk = ks[:, None]
    Xf = X[:, feats]                                  # (n, m)
    order = Xf.argsort(axis=0, kind="stable")
    cols = np.arange(len(feats))
    xs_s = Xf[order, cols]
    y_s = y[order]                                    # (n, m)
    csum = y_s.cumsum(axis=0)
    csq = (y_s * y_s).cumsum(axis=0)
    lsum, lsq = csum[ks - 1], csq[ks - 1]             # (nk, m)
    rsum, rsq = csum[-1] - lsum, csq[-1] - lsq
    sse = (lsq - lsum**2 / kk) + (rsq - rsum**2 / (n - kk))
    sse[xs_s[ks - 1] >= xs_s[ks]] = np.inf            # no splits inside ties
    j = sse.argmin(axis=0)                            # best position per feat
    fsse = sse[j, cols]
    fb = int(fsse.argmin())
    if not np.isfinite(fsse[fb]):
        return None
    k = int(j[fb])
    t = (xs_s[ks[k] - 1, fb] + xs_s[ks[k], fb]) / 2.0
    return float(fsse[fb]), int(feats[fb]), float(t)


def _build_tree(X, y, rng, depth, max_depth, min_leaf, n_feat):
    node = _Node(value=float(y.mean()))
    if depth >= max_depth or len(y) < 2 * min_leaf or y.min() == y.max():
        return node
    feats = rng.choice(X.shape[1], size=min(n_feat, X.shape[1]), replace=False)
    best = _best_split(X, y, feats, min_leaf)
    if best is None:
        return node
    _, f, t = best
    m = X[:, f] <= t
    node.feature, node.thresh = f, t
    node.left = _build_tree(X[m], y[m], rng, depth + 1, max_depth, min_leaf, n_feat)
    node.right = _build_tree(X[~m], y[~m], rng, depth + 1, max_depth, min_leaf, n_feat)
    return node


def _predict_tree(node, X):
    out = np.empty(len(X))
    stack = [(node, np.arange(len(X)))]
    while stack:
        nd, idx = stack.pop()
        if nd.feature < 0 or nd.left is None:
            out[idx] = nd.value
            continue
        m = X[idx, nd.feature] <= nd.thresh
        stack.append((nd.left, idx[m]))
        stack.append((nd.right, idx[~m]))
    return out


class RandomForest:
    def __init__(self, n_trees: int = 32, max_depth: int = 10,
                 min_leaf: int = 2, seed: int = 0,
                 rng: np.random.Generator = None):
        """`rng` (when given) is used directly — SMBO threads its one
        run-level generator through so same-seed runs are bit-reproducible;
        `seed` is the standalone fallback."""
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.trees = []

    def fit(self, X: np.ndarray, y: np.ndarray):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n_feat = max(1, int(np.ceil(X.shape[1] / 3)))
        self.trees = []
        for _ in range(self.n_trees):
            idx = self.rng.integers(0, len(y), size=len(y))
            self.trees.append(_build_tree(X[idx], y[idx], self.rng, 0,
                                          self.max_depth, self.min_leaf, n_feat))
        return self

    def predict(self, X: np.ndarray):
        """(mean, std) across trees, batched over the rows of X — SMBO calls
        this once per iteration with the whole candidate pool stacked."""
        X = np.asarray(X, np.float64)
        preds = np.stack([_predict_tree(t, X) for t in self.trees])
        return preds.mean(axis=0), preds.std(axis=0)
