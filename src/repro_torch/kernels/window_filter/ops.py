"""Public wrappers for the window-filter kernels (csrc/window_filter.cu).

``backend="cuda"`` launches the CUDA kernel for CUDA tensors and uses the
plain-torch twin only for CPU tensors; ``backend="torch"`` always uses the
twin.  There is no fallback from a CUDA tensor to the twin.  On ``meta``
tensors the kernel route allocates the kernel's outputs and launches
nothing (a shape-only run); on either device each call is one op to an
active step counter (`filter_work`, `filter_work_paged`,
`match_work_paged`).

`window_filter_paged` counts, for each query, the hits in its candidate
pages read by id from the index's page array; `window_filter` (the TPU
kernel's contract, pages gathered by the caller) launches the same kernel
with each page its own query.  Both count under ``"window_filter"``.
`window_match_paged` writes each query's matching row ids, its candidate
pages read by id (two launches: the ring kernel's hit words, then the
ids); `window_match` (the TPU contract's byte mask) launches the ring
kernel alone with each page its own query.  Both count every launch
under ``"window_match"``.
"""
from __future__ import annotations

import torch

from .. import cuda_lib
from .ref import (window_filter_paged_ref, window_filter_ref,
                  window_match_paged_ref, window_match_ref)

BACKENDS = ("cuda", "torch")


def _use_ref(pts: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    return backend == "torch" or pts.device.type == "cpu"


def _check(pts, rect, size) -> tuple:
    cuda_lib.check_cuda_int32("pts", pts, 3)
    cuda_lib.check_cuda_int32("rect", rect, 3)
    cuda_lib.check_cuda_int32("size", size, 1)
    G, d, cap = pts.shape
    if tuple(rect.shape) != (G, d, 2) or tuple(size.shape) != (G,):
        raise ValueError(f"shapes disagree: pts {tuple(pts.shape)}, rect "
                         f"{tuple(rect.shape)}, size {tuple(size.shape)}")
    if rect.device != pts.device or size.device != pts.device:
        raise ValueError("pts, rect and size must be on one device")
    return G, d, cap


def filter_work(G: int, d: int, cap: int, out_bytes: int) -> int:
    """Bytes a filter call of G pages moves with every slot valid: the
    points, rectangles and sizes in once, `out_bytes` out.  (The bound in
    `chip_smoke.py` counts only the valid slots of its data; this count is
    from shapes alone, so a shape-only run gives it too.)"""
    return G * d * cap * 4 + G * d * 2 * 4 + G * 4 + out_bytes


def filter_work_paged(P: int, Qc: int, C: int, d: int, cap: int,
                      n_cand_bytes: int = 8) -> int:
    """Bytes a paged filter call moves, from shapes alone: Qc * C candidate
    ids name at most min(Qc * C, P) distinct pages, each read once (a page
    two queries share is one input byte read once, as a bound counts it)
    with every slot valid, with its size; the (Qc, d, 2) rectangles, the
    (Qc, C) int32 ids and the (Qc,) live counts (`n_cand_bytes` each) in
    once; the (Qc,) int32 counts out.  Which ids are live, and how full
    their pages are, is data: `chip_smoke.py`'s bound counts those."""
    pages = min(Qc * C, P)
    return (pages * (d * cap * 4 + 4) + Qc * d * 2 * 4 + Qc * C * 4
            + Qc * n_cand_bytes + Qc * 4)


def _count(key: str, pts, rect, size, out) -> None:
    G, d, cap = pts.shape
    cuda_lib.count_kernel(key, lambda: (
        0, filter_work(G, d, cap, out.numel() * out.element_size()),
        (tuple(pts.shape), tuple(rect.shape), tuple(size.shape)), out))


def window_filter(pts, rect, size, *, backend: str = "cuda"):
    """pts: (G, d, cap) int32; rect: (G, d, 2); size: (G,) -> (G,) int32.
    On the card: the paged kernel with each page its own query (no ids,
    every page live)."""
    if _use_ref(pts, backend):
        return window_filter_ref(pts, rect, size)
    G, d, cap = _check(pts, rect, size)
    out = torch.empty(G, dtype=torch.int32, device=pts.device)
    if G:
        if cuda_lib.on_card(pts):
            cuda_lib.launch("window_filter_launch", pts.data_ptr(),
                            size.data_ptr(), rect.data_ptr(), None, None,
                            out.data_ptr(), G, G, 1, d, cap)
            cuda_lib.LAUNCHES["window_filter"] += 1
        _count("window_filter", pts, rect, size, out)
    return out


def _check_paged(points, page_size, queries, cand, n_cand) -> tuple:
    for name, t, ndim in (("points", points, 3), ("page_size", page_size, 1),
                          ("queries", queries, 3), ("cand", cand, 2)):
        cuda_lib.check_cuda_int32(name, t, ndim)
    cuda_lib.check_cuda("n_cand", n_cand, torch.int64, 1)
    P, d, cap = points.shape
    Qc, C = cand.shape
    if (tuple(page_size.shape) != (P,) or tuple(queries.shape) != (Qc, d, 2)
            or tuple(n_cand.shape) != (Qc,)):
        raise ValueError(
            f"shapes disagree: points {tuple(points.shape)}, page_size "
            f"{tuple(page_size.shape)}, queries {tuple(queries.shape)}, cand "
            f"{tuple(cand.shape)}, n_cand {tuple(n_cand.shape)}")
    if any(t.device != points.device
           for t in (page_size, queries, cand, n_cand)):
        raise ValueError("points, page_size, queries, cand and n_cand must "
                         "be on one device")
    if Qc * C >= 2**31:
        raise ValueError(f"Qc * C = {Qc * C} items; the kernel takes fewer "
                         f"than 2^31")
    return P, d, cap, Qc, C


def window_filter_paged(points, page_size, queries, cand, n_cand, *,
                        backend: str = "cuda"):
    """Hits of each query in its candidate pages, read by id.

    points (P, d, cap) int32 (unsigned coordinates), page_size (P,) int32,
    queries (Qc, d, 2) int32 [lo, hi], cand (Qc, C) int32 page ids in
    [0, P), n_cand (Qc,) integer -> (Qc,) int32: for each query q the
    number of (c, s) with c < min(n_cand[q], C), s < clamp(page_size[p],
    0, cap) for p = cand[q, c], and lo <= points[p, :, s] <= hi in every
    dimension, compared unsigned.  Equal bit for bit to gathering the
    pages (`ref.gather_pages`), `window_filter` and a sum per query.  One
    kernel launch; a (query, candidate) past n_cand reads nothing.  On the
    card a live id outside [0, P) stops the kernel, as torch's index
    assert does: the error is raised at the next synchronizing call and
    leaves the CUDA context unusable."""
    if _use_ref(points, backend):
        return window_filter_paged_ref(points, page_size, queries, cand,
                                       n_cand)
    n_cand = n_cand.to(torch.int64)
    P, d, cap, Qc, C = _check_paged(points, page_size, queries, cand, n_cand)
    if not (Qc and C):
        return torch.zeros(Qc, dtype=torch.int32, device=points.device)
    out = torch.empty(Qc, dtype=torch.int32, device=points.device)
    if cuda_lib.on_card(points):
        cuda_lib.launch("window_filter_launch", points.data_ptr(),
                        page_size.data_ptr(), queries.data_ptr(),
                        cand.data_ptr(), n_cand.data_ptr(), out.data_ptr(),
                        P, Qc, C, d, cap)
        cuda_lib.LAUNCHES["window_filter"] += 1
    cuda_lib.count_kernel("window_filter", lambda: (
        0, filter_work_paged(P, Qc, C, d, cap, n_cand.element_size()),
        (tuple(points.shape), tuple(page_size.shape), tuple(queries.shape),
         tuple(cand.shape), tuple(n_cand.shape)), out))
    return out


def match_work_paged(P: int, Qc: int, C: int, d: int, cap: int,
                     max_hits: int, n_cand_bytes: int = 8) -> int:
    """Bytes a paged match call moves, from shapes alone: what
    `filter_work_paged` reads in (min(Qc * C, P) whole pages with their
    sizes, the rectangles, ids and live counts), and out the (Qc,
    max_hits) int32 id buffer and the (Qc,) int64 match counts."""
    pages = min(Qc * C, P)
    return (pages * (d * cap * 4 + 4) + Qc * d * 2 * 4 + Qc * C * 4
            + Qc * n_cand_bytes + Qc * max_hits * 4 + Qc * 8)


def window_match_paged(points, page_size, queries, cand, n_cand,
                       max_hits: int, *, backend: str = "cuda"):
    """Matching row ids of each query in its candidate pages, read by id.

    Inputs as `window_filter_paged`; max_hits >= 0 -> ids (Qc, max_hits)
    int32 and n_hits (Qc,) int64.  A match is (c, s) with c <
    min(n_cand[q], C), s < clamp(page_size[p], 0, cap) for p = cand[q, c],
    and lo <= points[p, :, s] <= hi in every dimension, compared unsigned;
    its id is p * cap + s.  ids holds each query's first max_hits matches
    in (c, s) order, -1 after them; n_hits counts every match, past
    max_hits too.  Equal bit for bit to gathering the pages
    (`ref.gather_pages`), `window_match` and the cumsum compaction
    (`ref.window_match_paged_ref`).  Needs P * cap < 2^31 (int32 ids).
    Two kernel launches (one when C is 0): the ring kernel stores each
    live item's hit count and hit words, then one pass turns them into
    ids.  On the card a live id outside [0, P) stops the kernel, as
    `window_filter_paged` does."""
    if max_hits < 0:
        raise ValueError(f"max_hits must be >= 0; got {max_hits}")
    if points.dim() == 3 and points.shape[0] * points.shape[2] >= 2**31:
        raise ValueError(f"row ids need pages*cap < 2^31; got "
                         f"{points.shape[0]} pages x cap {points.shape[2]}")
    if _use_ref(points, backend):
        return window_match_paged_ref(points, page_size, queries, cand,
                                      n_cand, max_hits)
    n_cand = n_cand.to(torch.int64)
    P, d, cap, Qc, C = _check_paged(points, page_size, queries, cand, n_cand)
    dev = points.device
    ids = torch.empty((Qc, max_hits), dtype=torch.int32, device=dev)
    n_hits = torch.empty(Qc, dtype=torch.int64, device=dev)
    # the ring pass's per-item counts and hit words
    counts = torch.empty(Qc * C, dtype=torch.int32, device=dev)
    bits = torch.empty((Qc * C, (cap + 31) // 32), dtype=torch.int32,
                       device=dev)
    if Qc and cuda_lib.on_card(points):
        if C:
            cuda_lib.launch("window_match_launch", points.data_ptr(),
                            page_size.data_ptr(), queries.data_ptr(),
                            cand.data_ptr(), n_cand.data_ptr(),
                            counts.data_ptr(), bits.data_ptr(), None, P, Qc,
                            C, d, cap)
            cuda_lib.LAUNCHES["window_match"] += 1
        cuda_lib.launch("window_match_ids_launch", counts.data_ptr(),
                        bits.data_ptr(), cand.data_ptr(), n_cand.data_ptr(),
                        ids.data_ptr(), n_hits.data_ptr(), Qc, C, cap,
                        max_hits)
        cuda_lib.LAUNCHES["window_match"] += 1
    cuda_lib.count_kernel("window_match", lambda: (
        0, match_work_paged(P, Qc, C, d, cap, max_hits,
                            n_cand.element_size()),
        (tuple(points.shape), tuple(page_size.shape), tuple(queries.shape),
         tuple(cand.shape), tuple(n_cand.shape), tuple(ids.shape)),
        (ids, n_hits)))
    return ids, n_hits


def window_match(pts, rect, size, *, backend: str = "cuda"):
    """Index-emitting variant of `window_filter`: the (G, cap) bool
    membership mask of valid points inside their rectangle.  On the card:
    the ring kernel with each page its own query, writing bytes."""
    if _use_ref(pts, backend):
        return window_match_ref(pts, rect, size)
    G, d, cap = _check(pts, rect, size)
    out = torch.empty((G, cap), dtype=torch.bool, device=pts.device)
    if G:
        if cuda_lib.on_card(pts):
            cuda_lib.launch("window_match_launch", pts.data_ptr(),
                            size.data_ptr(), rect.data_ptr(), None, None,
                            None, None, out.data_ptr(), G, G, 1, d, cap)
            cuda_lib.LAUNCHES["window_match"] += 1
        _count("window_match", pts, rect, size, out)
    return out
