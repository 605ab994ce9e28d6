"""The plain reference for window queries: closed-rectangle Count and
Range over the raw rows, in torch on any device.

It takes the benchmark's rows and windows and nothing the program made:
no curve, no page, no candidate list.  The rows are put in lexicographic
order once (stable sorts, last dimension first); a window's rows then lie
in the slice whose dimension-0 value is in [L0, U0] (two binary
searches), and a row matches when every coordinate c has L <= c <= U.
The matching rows of a window come out in lexicographic order, which is
the order `RangeResult` promises.

`lossy_K` gives the control: every coordinate and bound rounded to a
float type that cannot hold K bits (float32 where K > 24, else bfloat16)
before the comparisons, the precision below the configuration's exact
K-bit integers.
"""
from __future__ import annotations

import numpy as np
import torch


def lossy_dtype(K: int) -> torch.dtype:
    """The nearest float type that loses bits of a K-bit coordinate."""
    return torch.float32 if K > 24 else torch.bfloat16


class WindowReference:
    """Rows held once on `device`, lexicographically sorted; `count` and
    `rows` answer batches of windows.  `lossy_K` set: the control."""

    def __init__(self, data: np.ndarray, device="cpu", lossy_K: int = None):
        pts = torch.from_numpy(np.ascontiguousarray(data).astype(np.int64))
        pts = pts.to(device)
        for i in range(pts.shape[1] - 1, -1, -1):
            pts = pts[torch.sort(pts[:, i], stable=True).indices]
        self.pts = pts
        self.col0 = pts[:, 0].contiguous()
        self.device = pts.device
        self.dtype = None if lossy_K is None else lossy_dtype(lossy_K)
        # the control's slice is widened so that it holds every row that
        # its rounded compares can take in
        self.slack = 0 if lossy_K is None else 1 << max(0, lossy_K - round(
            -np.log2(torch.finfo(self.dtype).eps)))
        self.key = pts if self.dtype is None else pts.to(self.dtype)

    def _bounds(self, Ls: np.ndarray, Us: np.ndarray):
        """Per window: its slice [a, b) of the sorted rows, and its bounds
        in the compare type, on the device."""
        L = torch.from_numpy(Ls.astype(np.int64)).to(self.device)
        U = torch.from_numpy(Us.astype(np.int64)).to(self.device)
        a = torch.searchsorted(self.col0, L[:, 0] - self.slack)
        b = torch.searchsorted(self.col0, U[:, 0] + self.slack, right=True)
        if self.dtype is not None:
            L, U = L.to(self.dtype), U.to(self.dtype)
        return a.tolist(), b.tolist(), L, U

    def _mask(self, a: int, b: int, lo, hi) -> torch.Tensor:
        rows = self.key[a:b]
        return ((rows >= lo) & (rows <= hi)).all(dim=1)

    def count(self, Ls: np.ndarray, Us: np.ndarray) -> np.ndarray:
        """(Q,) int64: the rows inside each closed window."""
        a, b, L, U = self._bounds(Ls, Us)
        out = torch.zeros(len(a), dtype=torch.int64, device=self.device)
        for t in range(len(a)):
            if b[t] > a[t]:
                out[t] = self._mask(a[t], b[t], L[t], U[t]).sum()
        return out.cpu().numpy()

    def rows(self, Ls: np.ndarray, Us: np.ndarray) -> list:
        """One (m, d) uint64 array a window: its rows, in lexicographic
        order."""
        a, b, L, U = self._bounds(Ls, Us)
        parts = [self.pts[a[t]:b[t]][self._mask(a[t], b[t], L[t], U[t])]
                 for t in range(len(a))]
        sizes = [len(p) for p in parts]
        flat = (torch.cat(parts) if parts else self.pts[:0]).cpu().numpy()
        return np.split(flat.astype(np.uint64), np.cumsum(sizes)[:-1])
