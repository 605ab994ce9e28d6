"""Plain-torch twins of the window-filter (points-in-rectangle) kernels."""
from __future__ import annotations

import torch

from ...core.zorder64 import u32_le


def window_filter_ref(pts, rect, size):
    """pts: (G, d, cap) int32 (unsigned coords); rect: (G, d, 2) int32
    [lo, hi]; size: (G,) int32 valid-point count.  -> (G,) int32 counts."""
    return window_match_ref(pts, rect, size).sum(dim=-1).to(torch.int32)


def window_match_ref(pts, rect, size):
    """Per-point membership: the (G, cap) bool mask of valid points inside
    their rectangle (same inputs as `window_filter_ref`)."""
    lo = rect[:, :, 0:1]
    hi = rect[:, :, 1:2]
    inside = u32_le(lo, pts) & u32_le(pts, hi)  # (G, d, cap)
    ok = inside.all(dim=1)  # (G, cap)
    slot = torch.arange(pts.shape[-1], device=pts.device)
    return ok & (slot[None, :] < size[:, None])
