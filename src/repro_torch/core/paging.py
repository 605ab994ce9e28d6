"""Cost-based paging (paper §5.3).

Given points sorted by z-address, partition them into pages of
``smin..smax`` points (smin = f·B/4d, smax = B/4d) minimizing the density
score  S(P) = vol(MBR(P)) / |P|  summed over pages.

Three methods:
  * ``fixed_paging``      — RSMI-style fixed-size packing (baseline).
  * ``heuristic_paging``  — the paper's Algorithm 3 (α-bounded greedy),
                            vectorized: one numpy call per *page*.
  * ``dp_paging_np``      — the paper's Algorithm 2, exact O(n·(smax-smin))
                            with sparse-table range-MBR queries.
  * ``dp_paging_torch``   — the same DP on a device for large n, in blocks
                            of ``smin`` positions; same boundaries.

Volumes are normalized to [0,1]^d (extent+1 unit cells / 2^K) so scores are
well-conditioned for any K.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device


def page_capacity(d: int, page_bytes: int = 8192, fill_factor: float = 0.25,
                  bytes_per_int: int = 4):
    """(smin, smax) in points; the paper assumes 4-byte ints, B=8192, f=.25."""
    smax = page_bytes // (bytes_per_int * d)
    smin = max(1, int(fill_factor * smax))
    return smin, smax


# ---------------------------------------------------------------------------
# MBR helpers
# ---------------------------------------------------------------------------


def compute_mbrs(xs: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """xs: (n, d) sorted; starts: (P+1,) boundaries -> (P, d, 2) [lo, hi]."""
    P = len(starts) - 1
    d = xs.shape[1]
    mbrs = np.zeros((P, d, 2), dtype=np.int64)
    for p in range(P):
        seg = xs[starts[p]:starts[p + 1]]
        mbrs[p, :, 0] = seg.min(axis=0)
        mbrs[p, :, 1] = seg.max(axis=0)
    return mbrs


def _norm_vol(lo: np.ndarray, hi: np.ndarray, K: int) -> np.ndarray:
    """normalized volume of [lo, hi] (inclusive), unit cell = 1/2^K."""
    ext = (hi - lo + 1).astype(np.float64) / float(2**K)
    return np.prod(ext, axis=-1)


def total_score(xs: np.ndarray, starts: np.ndarray, K: int) -> float:
    mbrs = compute_mbrs(xs, starts)
    vols = _norm_vol(mbrs[:, :, 0], mbrs[:, :, 1], K)
    sizes = np.diff(starts).astype(np.float64)
    return float(np.sum(vols / sizes))


# ---------------------------------------------------------------------------
# fixed-size paging (RSMI / ZM-index baseline)
# ---------------------------------------------------------------------------


def fixed_paging(n: int, cap: int) -> np.ndarray:
    starts = list(range(0, n, cap))
    starts.append(n)
    return np.asarray(starts, dtype=np.int64)


# ---------------------------------------------------------------------------
# heuristic paging — paper Algorithm 3
# ---------------------------------------------------------------------------


def heuristic_paging(xs: np.ndarray, smin: int, smax: int, K: int,
                     alpha: float = 1.5) -> np.ndarray:
    """Greedy α-bounded packing; one vectorized pass per page."""
    n = len(xs)
    starts = [0]
    s0 = 0
    while s0 < n:
        w = min(smax, n - s0)
        seg = xs[s0:s0 + w].astype(np.int64)
        run_lo = np.minimum.accumulate(seg, axis=0)
        run_hi = np.maximum.accumulate(seg, axis=0)
        vols = _norm_vol(run_lo, run_hi, K)  # vols[t] = vol of first t+1 pts
        end = w
        if w > smin:
            grow = vols[smin:w] >= alpha * vols[smin - 1:w - 1]
            idx = np.nonzero(grow)[0]
            if len(idx):
                end = smin + int(idx[0])
        s0 += max(end, 1)
        starts.append(s0)
    return np.asarray(starts, dtype=np.int64)


# ---------------------------------------------------------------------------
# sparse table for range-MBR queries (shared by both DP variants)
# ---------------------------------------------------------------------------


def _build_sparse_table(xs: np.ndarray, kmax: int):
    """tables[k]: (n - 2^k + 1, d, 2) min/max over xs[i : i + 2^k]."""
    cur_lo = xs.astype(np.int64)
    cur_hi = xs.astype(np.int64)
    tables = {0: (cur_lo, cur_hi)}
    for k in range(1, kmax + 1):
        h = 1 << (k - 1)
        cur_lo = np.minimum(cur_lo[:-h], cur_lo[h:])
        cur_hi = np.maximum(cur_hi[:-h], cur_hi[h:])
        tables[k] = (cur_lo, cur_hi)
    return tables


def _range_vols(tables, l: np.ndarray, r: np.ndarray, K: int) -> np.ndarray:
    """vol of MBR(xs[l:r]) for vectors l, r (r > l)."""
    L = r - l
    ks = np.floor(np.log2(L)).astype(np.int64)
    vols = np.empty(len(l), dtype=np.float64)
    for k in np.unique(ks):
        m = ks == k
        h = 1 << int(k)
        tlo, thi = tables[int(k)]
        lo = np.minimum(tlo[l[m]], tlo[r[m] - h])
        hi = np.maximum(thi[l[m]], thi[r[m] - h])
        vols[m] = _norm_vol(lo, hi, K)
    return vols


# ---------------------------------------------------------------------------
# DP paging — paper Algorithm 2 (exact)
# ---------------------------------------------------------------------------


def dp_paging_np(xs: np.ndarray, smin: int, smax: int, K: int) -> np.ndarray:
    n = len(xs)
    if n <= smax:
        return np.asarray([0, n], dtype=np.int64)
    kmax = int(np.floor(np.log2(smax)))
    tables = _build_sparse_table(xs, kmax)
    OPT = np.full(n + 1, np.inf)
    OPT[0] = 0.0
    choice = np.zeros(n + 1, dtype=np.int64)
    # prefix pages smaller than smin (at most one undersized page allowed)
    for i in range(1, min(smin, n + 1)):
        seg = xs[:i].astype(np.int64)
        OPT[i] = _norm_vol(seg.min(0), seg.max(0), K) / i
        choice[i] = i
    s_full = np.arange(smin, smax + 1)
    for i in range(smin, n + 1):
        s = s_full[s_full <= i]
        vols = _range_vols(tables, i - s, np.full(len(s), i), K)
        cand = OPT[i - s] + vols / s
        k = int(np.argmin(cand))
        OPT[i] = cand[k]
        choice[i] = s[k]
    # backtrack
    bounds = [n]
    i = n
    while i > 0:
        i -= int(choice[i])
        bounds.append(i)
    return np.asarray(bounds[::-1], dtype=np.int64)


def _prefix_opt(xs: np.ndarray, smin: int, K: int) -> np.ndarray:
    """OPT[1 .. smin-1]: the one undersized first page, as `dp_paging_np`
    scores it (running MBR of the first i rows over i)."""
    m = min(smin, len(xs) + 1) - 1
    seg = xs[:m].astype(np.int64)
    lo = np.minimum.accumulate(seg, axis=0)
    hi = np.maximum.accumulate(seg, axis=0)
    return _norm_vol(lo, hi, K) / np.arange(1, m + 1)


def dp_paging_torch(xs: np.ndarray, smin: int, smax: int, K: int,
                    device=None) -> np.ndarray:
    """`dp_paging_np`'s recurrence on `device` (CUDA unless the caller
    passes ``device="cpu"``), with the same boundaries.

    Every candidate of OPT[i] reads OPT[i - s] with s >= smin, so the smin
    values OPT[i0 .. i0+smin-1] depend only on entries below i0: each step
    scores one (smin, smax-smin+1) tile of (position, page size) candidates
    at once, n/smin steps in all.  The arithmetic is `dp_paging_np`'s:
    float64 throughout, extents formed in int64 before the cast, the d
    factors multiplied left to right, OPT[i - s] + vol / s, and the first
    (smallest s) of equal minima."""
    n = len(xs)
    if n <= smax:
        return np.asarray([0, n], dtype=np.int64)
    dev = resolve_device(device)
    d = xs.shape[1]
    kmax = int(np.floor(np.log2(smax)))
    # sparse table, level k at rows [k*n, (k+1)*n): min/max over
    # xs[i : i + 2^k] (rows past n - 2^k are never read)
    x = torch.from_numpy(np.ascontiguousarray(xs, dtype=np.int64)).to(dev)
    tlo = torch.zeros(((kmax + 1) * n, d), dtype=torch.int64, device=dev)
    thi = torch.zeros_like(tlo)
    tlo[:n] = x
    thi[:n] = x
    for k in range(1, kmax + 1):
        h, m = 1 << (k - 1), n - (1 << k) + 1
        prev, cur = (k - 1) * n, k * n
        torch.minimum(tlo[prev:prev + m], tlo[prev + h:prev + h + m],
                      out=tlo[cur:cur + m])
        torch.maximum(thi[prev:prev + m], thi[prev + h:prev + h + m],
                      out=thi[cur:cur + m])
    del x
    s_np = np.arange(smin, smax + 1)
    k_np = np.floor(np.log2(s_np)).astype(np.int64)
    s = torch.from_numpy(s_np).to(dev)
    s_f = s.to(torch.float64)
    # flat table rows of the window [i - s, i) for position i: base + i
    base_l = torch.from_numpy(k_np * n - s_np).to(dev)
    base_r = torch.from_numpy(k_np * n - (1 << k_np)).to(dev)
    # OPT shifted by smax, so that OPT[i - s] is read at i + (smax - s) >= 0
    opt = torch.full((smax + n + 1,), float("inf"), dtype=torch.float64,
                     device=dev)
    opt[smax] = 0.0
    opt[smax + 1:smax + smin] = torch.from_numpy(_prefix_opt(xs, smin, K))
    base_o = smax - s
    choice = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    scale = float(2**K)
    steps = torch.arange(smin, device=dev)
    for i0 in range(smin, n + 1, smin):
        B = min(smin, n + 1 - i0)
        i = (steps[:B] + i0)[:, None]                       # (B, 1)
        a, b = base_l + i, base_r + i                        # (B, S)
        ext = (torch.maximum(thi[a], thi[b]) - torch.minimum(tlo[a], tlo[b])
               + 1).to(torch.float64) / scale                # (B, S, d)
        vol = ext[..., 0]
        for j in range(1, d):
            vol = vol * ext[..., j]
        cand = opt[base_o + i] + vol / s_f
        cand = torch.where(s <= i, cand, float("inf"))
        best = torch.argmin(cand, dim=1)
        opt[smax + i0:smax + i0 + B] = cand.gather(1, best[:, None])[:, 0]
        choice[i0:i0 + B] = s[best]
    choice = choice.cpu().numpy()
    choice[1:smin] = np.arange(1, min(smin, n + 1))
    bounds = [n]
    i = n
    while i > 0:
        i -= int(choice[i])
        bounds.append(i)
    return np.asarray(bounds[::-1], dtype=np.int64)


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Paging:
    starts: np.ndarray      # (P+1,)
    mbrs: np.ndarray        # (P, d, 2)
    method: str

    @property
    def num_pages(self) -> int:
        return len(self.starts) - 1

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.starts)


def make_paging(xs_sorted: np.ndarray, method: str, K: int,
                page_bytes: int = 8192, fill_factor: float = 0.25,
                alpha: float = 1.5, device=None) -> Paging:
    """Page `xs_sorted` by `method`.  ``"dp"`` above 200k rows runs
    `dp_paging_torch` on `device` (CUDA unless the caller passes
    ``device="cpu"``); every other case stays on the host and never
    resolves a device."""
    d = xs_sorted.shape[1]
    smin, smax = page_capacity(d, page_bytes, fill_factor)
    n = len(xs_sorted)
    if method == "fixed":
        starts = fixed_paging(n, smax)
    elif method == "heuristic":
        starts = heuristic_paging(xs_sorted, smin, smax, K, alpha)
    elif method == "dp":
        if n <= 200_000:
            starts = dp_paging_np(xs_sorted, smin, smax, K)
        else:
            starts = dp_paging_torch(xs_sorted, smin, smax, K, device=device)
    else:
        raise ValueError(method)
    return Paging(starts=starts, mbrs=compute_mbrs(xs_sorted, starts), method=method)
