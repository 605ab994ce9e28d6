"""Vectorized BatchEval: the whole sampled workload evaluated at once.

`run_workload` (core/query.py) is a faithful per-query Python loop — fine
for serving a handful of ad-hoc queries on the CPU engine, but it *is* the
SMBO objective (Algorithm 1, line 4 evaluates every candidate curve by
replaying the sampled workload), so its interpreter overhead directly caps
how many candidates θ-learning can afford.  This module re-expresses the
identical computation as whole-workload numpy:

  split    — `recursive_split_np_batch`: the (Q, 2^k) static sub-query
             tensor with validity masks (same leaf multiset per query as
             the per-query recursion, same cut rule and tie-breaks)
  project  — batched curve encode of every sub-query corner + one PGM
             `page_of` probe over all (Q·S) z-bounds (Theorem 1)
  mask     — (Q, P) candidate-page masks: PGM range ∧ z-overlap, reduced
             over sub-queries; MBR disjoint/containment classification
  account  — page- and row-level boolean algebra for pages accessed,
             points scanned, false positives and exact counts

and, for a whole SMBO candidate pool, as one torch program on the device
(`run_workload_pool`, engine "torch").

Exactness: every statistic in the returned `QueryStats` (and therefore
every cost value in cost.py) is bit-identical to the per-query evaluator.
Workloads that need the delta store or FNZ skipping go to the per-query
engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..kernels.sfc_encode.ops import sfc_encode_pool
from .curve import CurvePool, device_curve_pool
from .device import resolve_device
from .index import LMSFCIndex
from .query import QueryStats, run_workload
from .split import _split_once_enc, recursive_split_np_batch, zrange_pairs
from .zorder64 import u32_of, u64_to_z64, z64_key, z64_searchsorted

# element budget per query chunk (bools/int64 intermediates); keeps the
# (C, S, P) and (C, n) tensors comfortably in cache-friendly territory
_CHUNK_BUDGET = 8_000_000
# (queries x rows) elements per chunk of the pooled program's row-level
# accounting: bounds its (C, n) masks on the device
_ROW_BUDGET = 1 << 25


def _needs_fallback(index: LMSFCIndex) -> bool:
    if index.cfg.skipping == "fnz":
        return True
    store = getattr(index, "_delta_store", None)
    return store is not None and bool(store.deltas or store.tombstones)


def run_workload_batched(index: LMSFCIndex, Ls: np.ndarray, Us: np.ndarray):
    """Drop-in replacement for `run_workload`: (counts, aggregated stats),
    bit-identical results, no per-query Python loop."""
    if _needs_fallback(index):
        return run_workload(index, Ls, Us)
    Ls = np.atleast_2d(np.asarray(Ls, dtype=np.uint64))
    Us = np.atleast_2d(np.asarray(Us, dtype=np.uint64))
    Q, d = Ls.shape
    agg = QueryStats()
    counts = np.zeros(Q, dtype=np.int64)
    if Q == 0:
        return counts, agg

    cfg = index.cfg
    k = cfg.k_maxsplit if (cfg.use_query_split and cfg.skipping == "rqs") else 0
    P = index.num_pages
    n = index.n
    S = 1 << k
    chunk = int(np.clip(_CHUNK_BUDGET // max(S * P, 2 * n, P * d, 1), 8, 1024))

    xs = index.xs                                    # (n, d) uint64
    sizes = np.diff(index.starts).astype(np.int64)   # (P,)
    row_page = np.repeat(np.arange(P, dtype=np.int64), sizes)
    sd_row = index.sort_dims[row_page]               # (n,)
    mbr_lo = index.mbrs[..., 0]                      # (P, d) int64
    mbr_hi = index.mbrs[..., 1]
    page_ar = np.arange(P, dtype=np.int64)

    for c0 in range(0, Q, chunk):
        qL = Ls[c0:c0 + chunk]                       # (C, d)
        qU = Us[c0:c0 + chunk]
        C = len(qL)
        # ---- split + projection (Theorem 1) -----------------------------
        rects, valid = recursive_split_np_batch(qL, qU, index.curve, k)
        leaves = valid.sum(axis=1).astype(np.int64)  # (C,)
        zlo = index.curve.encode_np(rects[..., 0])   # (C, S)
        zhi = index.curve.encode_np(rects[..., 1])
        plo = index.page_of(zlo.ravel()).reshape(C, S)
        phi = index.page_of(zhi.ravel()).reshape(C, S)
        # ---- candidate-page masks ---------------------------------------
        inrange = ((plo[..., None] <= page_ar) &
                   (page_ar <= phi[..., None]))      # (C, S, P)
        zov = ((index.page_zmax >= zlo[..., None]) &
               (index.page_zmin <= zhi[..., None]))
        cand = np.any(inrange & zov & valid[..., None], axis=1)  # (C, P)
        # ---- MBR classification (same compares as _scan_page) -----------
        disjoint = ((mbr_lo > qU[:, None, :]) |
                    (mbr_hi < qL[:, None, :])).any(axis=-1)      # (C, P)
        contained = ((mbr_lo >= qL[:, None, :]) &
                     (mbr_hi <= qU[:, None, :])).all(axis=-1)
        accessed = cand & ~disjoint
        fullpg = accessed & contained
        partial = accessed & ~contained
        base = fullpg.astype(np.int64) @ sizes       # (C,)
        # ---- row-level accounting for partial pages ---------------------
        # only rows living on a page some query hits partially matter —
        # mirroring the legacy engine, which never reads the other pages
        rows_sel = np.flatnonzero(partial.any(axis=0)[row_page])
        xsel = xs[rows_sel]                          # (m, d)
        ok_full = np.ones((C, len(rows_sel)), dtype=bool)
        sd_ok = np.zeros_like(ok_full)
        sd_sel = sd_row[rows_sel]
        for i in range(d):
            wi = ((xsel[:, i] >= qL[:, i:i + 1]) &
                  (xsel[:, i] <= qU[:, i:i + 1]))    # (C, m)
            ok_full &= wi
            sd_ok |= wi & (sd_sel == i)
        partial_row = partial[:, row_page[rows_sel]]  # (C, m)
        scanned = (partial_row & sd_ok).sum(axis=1).astype(np.int64)
        matches = (partial_row & ok_full).sum(axis=1).astype(np.int64)
        # ---- reduce ------------------------------------------------------
        counts[c0:c0 + C] = base + matches
        agg.pages_accessed += int(accessed.sum())
        agg.irrelevant_pages += int((cand & disjoint).sum())
        agg.points_scanned += int(scanned.sum())
        agg.false_positives += int((scanned - matches).sum())
        agg.index_accesses += int(2 * leaves.sum())
        agg.subqueries += int(leaves.sum())
        agg.result += int((base + matches).sum())
    return counts, agg


# ---------------------------------------------------------------------------
# pooled evaluation: the whole SMBO candidate pool as one device program
# ---------------------------------------------------------------------------
#
# Every candidate replays the same workload against its own mini-index.  The
# reference maps one candidate at a time (`lax.map`); here the pool axis is
# batched wherever the curve encode runs, so each encode of the program is
# ONE `sfc_encode_pool` launch over all candidates (the curve layouts as
# data, their lookup tables built once per round): one per split level and
# one for both z-range corners.  The page masks are (P, Q, pages) tensors.
# All device arithmetic is integer (int64 order keys for Z64, unsigned
# 32-bit words held in int64, bool mask algebra); the float cost
# combination happens on the host from the returned integer stats, which is
# what makes the pooled costs equal to the per-candidate paths to the last
# ulp.
#
# Shape contract (pool axis leading; pages padded to the pool's maximum):
#   pool                            — CurvePool, pos/reg/lut on the device
#   xs (P, n, d) int64              — page-ordered coords (unsigned values)
#   row_page / sd_row (P, n) int64  — row -> page / page sort-dim per row
#   sizes (P, Pmax) int64           — page sizes (0 past a candidate's pages)
#   mbr_lo / mbr_hi (P, Pmax, d)    — page MBRs (impossible hi < lo padding)
#   pzmin / pzmax (P, Pmax, 2)      — page z-ranges as Z64 (+inf/0 padding)
#   n_pages (P,) int64              — real page count per candidate


@dataclasses.dataclass
class _PackedPool:
    pool: CurvePool
    xs: torch.Tensor
    row_page: torch.Tensor
    sd_row: torch.Tensor
    sizes: torch.Tensor
    mbr_lo: torch.Tensor
    mbr_hi: torch.Tensor
    pzmin: torch.Tensor
    pzmax: torch.Tensor
    n_pages: torch.Tensor


def _pack_index_pool(indexes, device, pool: CurvePool = None) -> _PackedPool:
    """Stack P candidate indexes (same rows, same d) into the padded pool
    tensors above, on `device`; `pool` is their curves' `device_curve_pool`
    when the caller built it already."""
    if pool is None:
        pool = device_curve_pool([ix.curve for ix in indexes], device)
    if len(pool) != len(indexes):
        raise ValueError(f"{len(pool)} curves for {len(indexes)} indexes")
    P, n, d = len(indexes), indexes[0].n, indexes[0].d
    Pmax = max(ix.num_pages for ix in indexes)
    xs32 = np.empty((P, n, d), np.int32)
    sort_dims = np.zeros((P, Pmax), np.int64)
    sizes = np.zeros((P, Pmax), np.int64)
    mbr_lo = np.full((P, Pmax, d), 2**32 - 1, np.int64)  # > any hi of 0
    mbr_hi = np.zeros((P, Pmax, d), np.int64)
    pzmin = np.full((P, Pmax), 2**64 - 1, np.uint64)     # +inf: never overlaps
    pzmax = np.zeros((P, Pmax), np.uint64)
    n_pages = np.empty(P, np.int64)
    for p, ix in enumerate(indexes):
        np_ = ix.num_pages
        xs32[p] = ix.xs.astype(np.uint32).view(np.int32)
        sort_dims[p, :np_] = ix.sort_dims
        sizes[p, :np_] = np.diff(ix.starts)
        mbr_lo[p, :np_] = ix.mbrs[..., 0]
        mbr_hi[p, :np_] = ix.mbrs[..., 1]
        pzmin[p, :np_] = ix.page_zmin
        pzmax[p, :np_] = ix.page_zmax
        n_pages[p] = np_
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    sizes_t, sort_dims_t = up(sizes), up(sort_dims)
    page_ar = torch.arange(Pmax, device=device)
    row_page = torch.stack([torch.repeat_interleave(page_ar, sizes_t[p],
                                                    output_size=n)
                            for p in range(P)])
    return _PackedPool(
        pool=pool, xs=u32_of(up(xs32)), row_page=row_page,
        sd_row=torch.gather(sort_dims_t, 1, row_page), sizes=sizes_t,
        mbr_lo=up(mbr_lo), mbr_hi=up(mbr_hi), pzmin=up(u64_to_z64(pzmin)),
        pzmax=up(u64_to_z64(pzmax)), n_pages=up(n_pages))


def _pool_program(pk: _PackedPool, qL: torch.Tensor, qU: torch.Tensor,
                  k: int, backend: str) -> torch.Tensor:
    """Whole-workload stats of every candidate: (P, 6, Q) int64 rows
    (counts, pages accessed, irrelevant pages, scanned, matches, leaves).
    Mirrors `run_workload_batched` line by line; the row-level accounting
    runs over all n rows with a partial-page mask instead of gathering the
    dynamic row subset (identical sums).  qL/qU: (Q, d) int64 unsigned."""
    P, n, d = pk.xs.shape
    Q = qL.shape[0]
    Pmax = pk.sizes.shape[1]
    dev = qL.device

    def encode(x):
        """(P·Q, ..., d) int32 corners, candidate-major -> (..., 2) Z64:
        one pooled launch, candidate p encoding its own points."""
        z = sfc_encode_pool(x.reshape(P, -1, d).contiguous(), pk.pool,
                            backend=backend)
        return z.reshape(*x.shape[:-1], 2)

    # ---- split + projection (Theorem 1) ---------------------------------
    rects = torch.stack([qL, qU], dim=-1)               # (Q, d, 2)
    rects = rects.expand(P, Q, d, 2).reshape(P * Q, 1, d, 2)
    valid = torch.ones((P * Q, 1), dtype=torch.bool, device=dev)
    for _ in range(k):
        rects, valid = _split_once_enc(rects, valid, d, encode)
    S = rects.shape[1]
    z = zrange_pairs(rects, encode)                     # (P·Q, 2, S, 2)
    zlo = z[:, 0].reshape(P, Q * S, 2)
    zhi = z[:, 1].reshape(P, Q * S, 2)
    last = (pk.n_pages - 1)[:, None]
    plo = torch.minimum(
        (z64_searchsorted(pk.pzmin, zlo, side="right") - 1).clamp(min=0),
        last).reshape(P, Q, S)
    phi = torch.minimum(
        (z64_searchsorted(pk.pzmin, zhi, side="right") - 1).clamp(min=0),
        last).reshape(P, Q, S)
    klo = z64_key(zlo).reshape(P, Q, S)
    khi = z64_key(zhi).reshape(P, Q, S)
    kmin = z64_key(pk.pzmin)[:, None]                   # (P, 1, Pmax)
    kmax = z64_key(pk.pzmax)[:, None]
    valid = valid.reshape(P, Q, S)
    # ---- candidate-page masks, reduced over sub-queries -----------------
    page_ar = torch.arange(Pmax, device=dev)
    candp = torch.zeros((P, Q, Pmax), dtype=torch.bool, device=dev)
    for s in range(S):
        candp |= ((plo[..., s, None] <= page_ar) &
                  (page_ar <= phi[..., s, None]) &
                  (klo[..., s, None] <= kmax) &
                  (kmin <= khi[..., s, None]) & valid[..., s, None])
    # ---- MBR classification ---------------------------------------------
    qLb, qUb = qL[None, :, None], qU[None, :, None]     # (1, Q, 1, d)
    lo, hi = pk.mbr_lo[:, None], pk.mbr_hi[:, None]     # (P, 1, Pmax, d)
    disjoint = ((qUb < lo) | (hi < qLb)).any(-1)        # (P, Q, Pmax)
    contained = ((qLb <= lo) & (hi <= qUb)).all(-1)
    accessed = candp & ~disjoint
    fullpg = accessed & contained
    partial = accessed & ~contained
    base = torch.where(fullpg, pk.sizes[:, None], 0).sum(-1)   # (P, Q)
    # ---- row-level accounting for partial pages -------------------------
    scanned = torch.zeros((P, Q), dtype=torch.int64, device=dev)
    matches = torch.zeros_like(scanned)
    chunk = max(1, _ROW_BUDGET // max(n, 1))
    for p in range(P):
        for c0 in range(0, Q, chunk):
            c1 = min(Q, c0 + chunk)
            prow = partial[p, c0:c1][:, pk.row_page[p]]        # (C, n)
            ok_full = torch.ones_like(prow)
            sd_ok = torch.zeros_like(prow)
            for i in range(d):
                xi = pk.xs[p, :, i]
                wi = (qL[c0:c1, i:i + 1] <= xi) & (xi <= qU[c0:c1, i:i + 1])
                ok_full &= wi
                sd_ok |= wi & (pk.sd_row[p] == i)
            scanned[p, c0:c1] = (prow & sd_ok).sum(-1)
            matches[p, c0:c1] = (prow & ok_full).sum(-1)
    return torch.stack([base + matches, accessed.sum(-1),
                        (candp & disjoint).sum(-1), scanned, matches,
                        valid.sum(-1)], dim=1)           # (P, 6, Q)


def run_workload_pool(indexes, Ls: np.ndarray, Us: np.ndarray,
                      engine: str = "torch", *, device=None,
                      backend: str = "cuda", pool: CurvePool = None):
    """Evaluate the same workload against P candidate indexes at once.

    Returns a list of per-candidate ``(counts, QueryStats)`` pairs, each
    bit-identical to `run_workload_batched(index, Ls, Us)` (and therefore to
    the legacy per-query evaluator).  ``engine="torch"`` runs the pooled
    program on `device` (CUDA unless the caller passes ``device="cpu"``;
    `backend` picks the `sfc_encode_pool` kernel or its plain twin;
    `pool` is the candidates' `device_curve_pool` when the caller built
    it already); ``engine="np"`` is the numpy loop on the host."""
    if engine not in ("torch", "np"):
        raise ValueError(f"unknown pool engine {engine!r}; "
                         f"expected 'torch' or 'np'")
    indexes = list(indexes)
    if not indexes:
        return []
    cfg = indexes[0].cfg
    same = all(ix.cfg is cfg or (ix.cfg.k_maxsplit == cfg.k_maxsplit and
                                 ix.cfg.use_query_split == cfg.use_query_split
                                 and ix.cfg.skipping == cfg.skipping)
               for ix in indexes)
    if (engine == "np" or not same
            or any(_needs_fallback(ix) for ix in indexes)):
        return [run_workload_batched(ix, Ls, Us) for ix in indexes]
    Ls = np.atleast_2d(np.asarray(Ls, dtype=np.uint64))
    Us = np.atleast_2d(np.asarray(Us, dtype=np.uint64))
    Q, d = Ls.shape
    if Q == 0:
        return [(np.zeros(0, np.int64), QueryStats()) for _ in indexes]
    k = cfg.k_maxsplit if (cfg.use_query_split and cfg.skipping == "rqs") \
        else 0
    dev = resolve_device(device)
    qL = torch.from_numpy(Ls.astype(np.uint32).astype(np.int64)).to(dev)
    qU = torch.from_numpy(Us.astype(np.uint32).astype(np.int64)).to(dev)
    out = _pool_program(_pack_index_pool(indexes, dev, pool), qL, qU, k,
                        backend).cpu().numpy()
    if obs.enabled():
        obs.inc("smbo.pool_eval.dispatches")
        obs.inc("smbo.pool_eval.candidates", len(indexes))
    res = []
    for p in range(len(indexes)):
        counts, pages, irr, scanned, matches, leaves = out[p]
        agg = QueryStats(
            pages_accessed=int(pages.sum()),
            irrelevant_pages=int(irr.sum()),
            points_scanned=int(scanned.sum()),
            false_positives=int((scanned - matches).sum()),
            index_accesses=int(2 * leaves.sum()),
            subqueries=int(leaves.sum()),
            result=int(counts.sum()))
        res.append((counts, agg))
    return res
