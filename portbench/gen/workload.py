"""Window-query workloads of the LMSFC paper (section 7.1), frozen here so
that the benchmark's traffic cannot move with the program.

Centres: a share `skew_frac` of them on data points (skewed), the rest
uniform over the data space.  Widths a dimension uniform in
(0, width_scale * domain]; windows clipped to the data space.  Then every
window is scaled by one multiplier so that the mean selectivity is the
target (the paper's Fig. 7 levels).

The same arithmetic as `repro_torch.data.workload` for the same seed; the
selectivity probe runs in torch, on the harness's device, so that it can
probe more windows (`probes`) in little time: 64 windows, the original
count, leave the multiplier noisy from seed to seed.  The rows may be a
numpy array or a torch tensor on any device; only the rows drawn as
centres and the probe's sample leave it.
"""
from __future__ import annotations

import numpy as np
import torch

from .synth import default_K


def _take(data, idx: np.ndarray) -> np.ndarray:
    """Rows `idx` of `data` (numpy or torch) as float64 on the host."""
    if isinstance(data, torch.Tensor):
        data = data[torch.from_numpy(idx).to(data.device)].cpu().numpy()
    else:
        data = data[idx]
    return data.astype(np.float64)


def make_workload(data, n_queries: int, seed: int,
                  width_scale: float = 0.05, skew_frac: float = 0.9,
                  K: int = None):
    """(Ls, Us) uint64 arrays of shape (n_queries, d)."""
    rng = np.random.default_rng(seed)
    d = data.shape[1]
    K = K or default_K(d)
    domain = 2**K - 1
    n_skew = int(round(n_queries * skew_frac))
    centers = np.empty((n_queries, d), dtype=np.float64)
    idx = rng.integers(0, len(data), size=n_skew)
    centers[:n_skew] = _take(data, idx)
    centers[n_skew:] = rng.uniform(0, domain, size=(n_queries - n_skew, d))
    widths = rng.uniform(0, width_scale * domain, size=(n_queries, d))
    lo = np.clip(centers - widths / 2, 0, domain)
    hi = np.clip(centers + widths / 2, 0, domain)
    return lo.astype(np.uint64), hi.astype(np.uint64)


def _mean_selectivity(sample: torch.Tensor, L: torch.Tensor,
                      U: torch.Tensor, block: int = 128) -> float:
    """Mean over the windows of the share of `sample` rows inside each
    (float64 compares, as numpy makes them for uint64 rows against float
    bounds)."""
    total = 0.0
    for s in range(0, len(L), block):
        lo, hi = L[s:s + block, None], U[s:s + block, None]
        inside = ((sample[None] >= lo) & (sample[None] <= hi)).all(-1)
        total += inside.to(torch.float64).mean(1).sum().item()
    return total / len(L)


def scale_to_selectivity(data, Ls, Us, target: float,
                         K: int = None, iters: int = 12, probes: int = 64,
                         device="cpu"):
    """Scale every window by one multiplier so that the mean selectivity
    of the first `probes` windows, over a fixed 50,000-row sample of the
    data, is about `target` (a binary search on the multiplier)."""
    d = data.shape[1]
    K = K or default_K(d)
    domain = 2**K - 1
    sample = _take(data, np.random.default_rng(0).integers(
        0, len(data), size=min(len(data), 50_000)))
    centers = (Ls.astype(np.float64) + Us.astype(np.float64)) / 2
    widths = (Us.astype(np.float64) - Ls.astype(np.float64))
    widths = np.maximum(widths, 1.0)
    lo_m, hi_m = 1e-4, 1e4
    dev = torch.device(device)
    t_sample = torch.from_numpy(sample).to(dev)
    t_c = torch.from_numpy(centers[:probes]).to(dev)
    t_w = torch.from_numpy(widths[:probes]).to(dev)

    def sel(mult):
        L = torch.clamp(t_c - t_w * mult / 2, 0, domain)
        U = torch.clamp(t_c + t_w * mult / 2, 0, domain)
        return _mean_selectivity(t_sample, L, U)

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
