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


def compact_rows(mask: torch.Tensor, values: torch.Tensor, width: int,
                 fill: int):
    """Top-`width` compaction of each row of `mask` (Qc, N): returns the
    (Qc, width) int32 buffer of `values` at the first `width` set
    positions (`fill` elsewhere) and the (Qc,) int64 number set.  Writes
    past `width` go to a spare row that is sliced off (the reference's
    scatter with ``mode="drop"``), never to a real row."""
    Qc, N = mask.shape
    pos = torch.cumsum(mask, dim=1) - 1           # (Qc, N) int64
    n_set = pos[:, -1] + 1 if N else torch.zeros(Qc, dtype=torch.int64,
                                                 device=mask.device)
    ok = mask & (pos < width)
    rows = torch.where(ok, torch.arange(Qc, device=mask.device)[:, None], Qc)
    cols = torch.where(ok, pos, 0)
    out = torch.full((Qc + 1, width), fill, dtype=torch.int32,
                     device=mask.device)
    if width == 0:
        return out[:Qc], n_set
    out.index_put_((rows.reshape(-1), cols.reshape(-1)),
                   values.expand(Qc, N).reshape(-1).to(torch.int32))
    return out[:Qc], n_set


def window_match_paged_ref(points, page_size, queries, cand, n_cand,
                           max_hits: int):
    """Twin of the paged match: `gather_pages`, `window_match_ref`, and
    the compaction of each query's matches (candidate c, slot s in order)
    as row ids cand[q, c] * cap + s -> ids (Qc, max_hits) int32, -1
    padded, and n_hits (Qc,) int64, every match counted."""
    Qc, C = cand.shape
    cap = points.shape[2]
    mask = window_match_ref(*gather_pages(points, page_size, queries, cand,
                                          n_cand))
    gid = (cand[:, :, None] * cap
           + torch.arange(cap, dtype=torch.int32, device=cand.device))
    return compact_rows(mask.reshape(Qc, C * cap), gid.reshape(Qc, C * cap),
                        max_hits, -1)
