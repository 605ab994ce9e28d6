"""Query workload generation (paper §7.1).

Centers: 90% *skewed* (sampled data points) + 10% *uniform* (sampled from the
data space).  Widths per dimension uniform in (0, scale·domain]; windows
clipped to the data space.  Selectivity / aspect-ratio variants for §7.3/§7.5.
"""
from __future__ import annotations

import numpy as np

from ..core.theta import default_K


def make_workload(data: np.ndarray, n_queries: int, seed: int = 0,
                  width_scale: float = 0.05, skew_frac: float = 0.9,
                  K: int = None):
    """Returns (Ls, Us) uint64 arrays of shape (n_queries, d)."""
    rng = np.random.default_rng(seed)
    d = data.shape[1]
    K = K or default_K(d)
    domain = 2**K - 1
    n_skew = int(round(n_queries * skew_frac))
    centers = np.empty((n_queries, d), dtype=np.float64)
    idx = rng.integers(0, len(data), size=n_skew)
    centers[:n_skew] = data[idx].astype(np.float64)
    centers[n_skew:] = rng.uniform(0, domain, size=(n_queries - n_skew, d))
    widths = rng.uniform(0, width_scale * domain, size=(n_queries, d))
    lo = np.clip(centers - widths / 2, 0, domain)
    hi = np.clip(centers + widths / 2, 0, domain)
    return lo.astype(np.uint64), hi.astype(np.uint64)


def scale_to_selectivity(data: np.ndarray, Ls, Us, target: float,
                         K: int = None, iters: int = 12):
    """Uniformly scale windows so that mean selectivity ≈ target (§7.3).
    Binary search on a global width multiplier using a data sample."""
    d = data.shape[1]
    K = K or default_K(d)
    domain = 2**K - 1
    sample = data[np.random.default_rng(0).integers(0, len(data), size=min(len(data), 50_000))]
    centers = (Ls.astype(np.float64) + Us.astype(np.float64)) / 2
    widths = (Us.astype(np.float64) - Ls.astype(np.float64))
    widths = np.maximum(widths, 1.0)
    lo_m, hi_m = 1e-4, 1e4

    def sel(mult):
        L = np.clip(centers - widths * mult / 2, 0, domain)
        U = np.clip(centers + widths * mult / 2, 0, domain)
        hits = [(np.all((sample >= L[t]) & (sample <= U[t]), axis=1)).mean()
                for t in range(min(64, len(L)))]
        return float(np.mean(hits))

    for _ in range(iters):
        mid = np.sqrt(lo_m * hi_m)
        if sel(mid) < target:
            lo_m = mid
        else:
            hi_m = mid
    mult = np.sqrt(lo_m * hi_m)
    L = np.clip(centers - widths * mult / 2, 0, domain)
    U = np.clip(centers + widths * mult / 2, 0, domain)
    return L.astype(np.uint64), U.astype(np.uint64)


def with_aspect_ratio(Ls, Us, ratio: float, dim: int = 0, K: int = None):
    """Stretch one dimension by `ratio`, shrink the others to keep the
    volume ≈ constant (§7.5)."""
    d = Ls.shape[1]
    K = K or default_K(d)
    domain = 2**K - 1
    centers = (Ls.astype(np.float64) + Us.astype(np.float64)) / 2
    widths = np.maximum(Us.astype(np.float64) - Ls.astype(np.float64), 1.0)
    shrink = ratio ** (-1.0 / max(1, d - 1))
    widths = widths * shrink
    widths[:, dim] *= ratio / shrink
    L = np.clip(centers - widths / 2, 0, domain)
    U = np.clip(centers + widths / 2, 0, domain)
    return L.astype(np.uint64), U.astype(np.uint64)
