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


def gather_pages(points, page_size, queries, cand, n_cand):
    """The candidate pages gathered for the filter kernels' (G, ...)
    contract: points (P, d, cap), page_size (P,), queries (Qc, d, 2), cand
    (Qc, C), n_cand (Qc,) -> pts (Qc*C, d, cap), rect (Qc*C, d, 2), size
    (Qc*C,) int32, 0 past each query's candidate count."""
    Qc, C = cand.shape
    cand_valid = (torch.arange(C, device=cand.device)[None, :]
                  < torch.clamp(n_cand, max=C)[:, None])
    cl = cand.to(torch.int64)
    pts = points[cl]                              # (Qc, C, d, cap)
    size = torch.where(cand_valid, page_size[cl], 0)
    _, _, d, cap = pts.shape
    rect = queries[:, None].expand(Qc, C, d, 2)
    return (pts.reshape(-1, d, cap), rect.reshape(-1, d, 2).contiguous(),
            size.reshape(-1).to(torch.int32).contiguous())


def window_filter_paged_ref(points, page_size, queries, cand, n_cand):
    """Twin of the paged filter: `gather_pages`, `window_filter_ref`, and
    the per-query sum -> (Qc,) int32."""
    Qc, C = cand.shape
    cnt = window_filter_ref(*gather_pages(points, page_size, queries, cand,
                                          n_cand))
    return cnt.reshape(Qc, C).sum(dim=1).to(torch.int32)
