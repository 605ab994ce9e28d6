"""The yardstick of the window kernels: the card's peak and the least
bytes a call's windows need, counted from the windows and the index's
page bounding boxes and sizes, never from the program's candidate list.

A coordinate is 4 bytes (K <= 32 bits), a window 2 * d coordinates, a
count or a row id 4 bytes.  Bytes are counted once a call, whatever the
kernels read again: a page that several windows need is read once.

  Count (window_filter): the rows of every page whose box meets some
    window of the call without lying inside that window (a page inside a
    window is counted by its size, unread), the windows, the counts.
  Range (window_match): the rows of every page whose box meets some
    window (Range has no containment shortcut), the windows, the row ids
    of the matches and a count a window.
"""
from __future__ import annotations

import numpy as np
import torch

COORD_BYTES = 4
# HBM bandwidth by `torch.cuda.get_device_name()`: NVIDIA's data sheet,
# H100 SXM, at its 700 W limit
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str):
    """The card's peak bandwidth, or None for a device not in the table."""
    return HBM_BYTES_PER_S.get(kind)


def page_masks(mbrs: torch.Tensor, Ls: np.ndarray, Us: np.ndarray,
               block: int = 64) -> tuple:
    """(P,) bool each: pages whose box meets some window, and pages that
    meet some window without lying inside it.  `mbrs` (P, d, 2) int64 on
    the device that computes."""
    dev = mbrs.device
    L = torch.from_numpy(Ls.astype(np.int64)).to(dev)
    U = torch.from_numpy(Us.astype(np.int64)).to(dev)
    mlo, mhi = mbrs[None, :, :, 0], mbrs[None, :, :, 1]
    meets = torch.zeros(mbrs.shape[0], dtype=torch.bool, device=dev)
    partial = torch.zeros_like(meets)
    for s in range(0, len(L), block):
        lo, hi = L[s:s + block, None], U[s:s + block, None]
        m = ((mlo <= hi) & (lo <= mhi)).all(-1)
        inside = ((lo <= mlo) & (mhi <= hi)).all(-1)
        meets |= m.any(0)
        partial |= (m & ~inside).any(0)
    return meets, partial


def filter_bytes(mbrs, sizes, Ls, Us) -> int:
    """Least bytes of one Count call's window_filter work."""
    _, partial = page_masks(mbrs, Ls, Us)
    Q, d = Ls.shape
    rows = int(sizes[partial].sum().item())
    return (rows * d + Q * 2 * d) * COORD_BYTES + Q * 4


def match_bytes(mbrs, sizes, Ls, Us, hits: int) -> int:
    """Least bytes of one Range call's window_match work (`hits`: the
    matching rows of the call)."""
    meets, _ = page_masks(mbrs, Ls, Us)
    Q, d = Ls.shape
    rows = int(sizes[meets].sum().item())
    return (rows * d + Q * 2 * d) * COORD_BYTES + (hits + Q) * 4
