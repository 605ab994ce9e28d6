"""Vectorized window-query serving on the device (torch/CUDA).

The paper's per-query page walk is re-expressed as a static-shape pipeline
(the split once for the whole batch, the rest chunk by chunk over it):

  split      — recursive query splitting (§6.1) into (Q, 2^k) sub-queries
               and their z-ranges: one `split_zranges` launch a batch
  prune      — page-level candidate mask: z-range overlap with any sub-query
               AND MBR intersection (metadata-only compares)
  contain    — pages whose MBR ⊆ query contribute size() with *no* gather
               (the paper's containment shortcut; Count only)
  compact    — top-C candidate page ids per query (static bound)
  filter     — points-in-rectangle count or matching row ids, the
               candidate pages read by id: Count's window_filter kernel
               (one launch a chunk), Range's window_match (two: the hit
               words, then the ids written into the static buffer)

Every function here takes ``backend``: ``"cuda"`` (default) runs the
hand-written kernels for the split with its z-ranges and for the filter;
``"torch"`` runs their plain-torch twins.  Outputs are bit-identical either
way.  Exactness: the sub-rectangles partition the query, so filtering with the
*full* query rectangle counts every point exactly once.

The distributed engine range-shards the pages over a mesh (a sequence of
devices, one page shard each; one process drives them all); queries are
replicated, and the shards' int32 partial counts are summed on the mesh's
first device (the reference's psum).  Page shards are disjoint, so the
sum is exact.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from .. import obs
from ..dist.sharding import P
from ..kernels.sfc_encode.ops import split_zranges
from ..kernels.window_filter.ops import (window_filter_paged,
                                        window_match_paged)
from ..kernels.window_filter.ref import compact_rows
from .curve import as_curve
from .device import resolve_device
from .index import LMSFCIndex
from .zorder64 import u32_le, u64_to_z64, z64_le, z64_to_u64

# ---------------------------------------------------------------------------
# serving arrays
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingArrays:
    """Page-major arrays (numpy on the host, or torch on a device)."""
    points: object      # (P, d, cap) int32 — transposed for the filter kernel
    page_zmin: object   # (P, 2) int32 Z64
    page_zmax: object   # (P, 2) int32
    page_mbr: object    # (P, d, 2) int32
    page_size: object   # (P,) int32

    def map(self, fn) -> "ServingArrays":
        return ServingArrays(**{f.name: fn(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


def pack_serving_arrays(index: LMSFCIndex, pad_pages_to: int = 1,
                        cap: int | None = None) -> ServingArrays:
    """Materialize padded page-major **host** (numpy) arrays from a built
    index.  Small-page regimes (large page counts) pack via one bulk flat
    scatter per dimension instead of a Python loop over pages; with few
    large pages the per-page block copy is pure memcpy and stays faster."""
    if pad_pages_to is None or pad_pages_to < 1:
        raise ValueError(f"pad_pages_to must be >= 1 (the page count is "
                         f"rounded up to a multiple of it); got "
                         f"{pad_pages_to!r}")
    Pn = index.num_pages
    d = index.d
    sizes = np.diff(index.starts).astype(np.int64)
    max_size = int(sizes.max())
    cap = cap or max_size
    if cap < max_size:
        raise ValueError(f"cap={cap} < largest page ({max_size} rows); "
                         f"points would be dropped")
    P_pad = -(-Pn // pad_pages_to) * pad_pages_to
    pts = np.zeros((P_pad, d, cap), dtype=np.uint32)
    size = np.zeros(P_pad, dtype=np.int32)
    size[:Pn] = sizes
    if index.n < 128 * Pn:          # measured crossover: ~100 rows/page
        # bulk scatter: row r of page p, dim i lands at
        # pts[p, i, slot] == flat[p*d*cap + i*cap + slot]
        page_of_row = np.repeat(np.arange(Pn, dtype=np.int64), sizes)
        slot_of_row = (np.arange(index.n, dtype=np.int64)
                       - np.repeat(index.starts[:-1].astype(np.int64), sizes))
        flat = pts.reshape(-1)
        base = page_of_row * (d * cap) + slot_of_row
        xs32 = index.xs.astype(np.uint32)
        for i in range(d):
            flat[base + i * cap] = xs32[:, i]
    else:
        for p in range(Pn):
            s, e = index.starts[p], index.starts[p + 1]
            pts[p, :, :e - s] = index.xs[s:e].astype(np.uint32).T
    mbr = np.zeros((P_pad, d, 2), dtype=np.uint32)
    mbr[:Pn] = index.mbrs.astype(np.uint32)
    # padded pages: impossible MBR (lo > hi) so they never match
    mbr[Pn:, :, 0] = np.uint32(0xFFFFFFFF)
    zmin = np.full((P_pad, 2), np.int32(-1))   # 0xFFFF.. = +inf unsigned
    zmax = np.zeros((P_pad, 2), dtype=np.int32)
    zmin[:Pn] = u64_to_z64(index.page_zmin)
    zmax[:Pn] = u64_to_z64(index.page_zmax)
    return ServingArrays(
        points=pts.view(np.int32),
        page_zmin=zmin,
        page_zmax=zmax,
        page_mbr=mbr.view(np.int32),
        page_size=size,
    )


def upload_serving_arrays(host: ServingArrays, device=None) -> ServingArrays:
    """Host (numpy) serving arrays -> torch tensors on `device` (CUDA
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return host.map(lambda a: torch.from_numpy(
        np.ascontiguousarray(a)).to(device))


def build_serving_arrays(index: LMSFCIndex, pad_pages_to: int = 1,
                         cap: int | None = None, *,
                         device=None) -> ServingArrays:
    """Padded page-major device arrays from a built index."""
    device = resolve_device(device)
    host = pack_serving_arrays(index, pad_pages_to=pad_pages_to, cap=cap)
    return upload_serving_arrays(host, device)


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------


def bucket_pow2(n: int, multiple: int = 1) -> int:
    """Smallest ``multiple * 2**j >= max(n, 1)`` — the shape-bucket boundary
    that keeps varying batch sizes on a bounded set of shapes."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1; got {multiple}")
    chunks = -(-max(int(n), 1) // multiple)
    return multiple * (1 << (chunks - 1).bit_length())


def pack_query_rects(Ls, Us, Q_pad: int = None) -> np.ndarray:
    """Pack uint64 rect bounds as the (Q_pad, d, 2) int32 host array the
    query fns consume, padded up to `Q_pad` by repeating the last rect (a
    repeated query is exact and cheap; results beyond Q are sliced off).
    `Q_pad` must be a q_chunk multiple."""
    rect = np.stack([np.asarray(Ls), np.asarray(Us)],
                    axis=-1).astype(np.uint32)            # (Q, d, 2)
    Q = rect.shape[0]
    if Q_pad is not None and Q_pad != Q:
        if Q_pad < Q:
            raise ValueError(f"Q_pad={Q_pad} < batch size {Q}")
        if Q == 0:
            raise ValueError("cannot pad an empty query batch")
        rect = np.concatenate([rect, np.repeat(rect[-1:], Q_pad - Q, axis=0)])
    return rect.view(np.int32)


# ---------------------------------------------------------------------------
# single-shard batched query engine
# ---------------------------------------------------------------------------


def _as_queries(arrays: ServingArrays, queries) -> torch.Tensor:
    """(Q, d, 2) int32 query rects on the arrays' device."""
    q = torch.as_tensor(queries, device=arrays.points.device)
    if q.dtype != torch.int32 or q.dim() != 3 or q.shape[2] != 2:
        raise ValueError(f"queries must be (Q, d, 2) int32; got "
                         f"{tuple(q.shape)} {q.dtype}")
    return q


def _live_pages(arrays: ServingArrays, queries, valid, zlo, zhi):
    """Prune: (Qc, P) bool of pages whose z-range overlaps a live
    sub-query (valid (Qc, S), zlo/zhi (Qc, S, 2)) and whose MBR intersects
    the query, plus the query/MBR bounds for the containment test."""
    pz_min = arrays.page_zmin                     # (P, 2)
    pz_max = arrays.page_zmax
    ov = (z64_le(zlo[:, :, None, :], pz_max[None, None]) &
          z64_le(pz_min[None, None], zhi[:, :, None, :]))  # (Qc, S, P)
    ov = torch.any(ov & valid[:, :, None], dim=1)  # (Qc, P)
    qlo = queries[:, None, :, 0]                  # (Qc, 1, d)
    qhi = queries[:, None, :, 1]
    mlo = arrays.page_mbr[None, :, :, 0]          # (1, P, d)
    mhi = arrays.page_mbr[None, :, :, 1]
    intersect = torch.all(u32_le(mlo, qhi) & u32_le(qlo, mhi), dim=-1)
    return ov & intersect, (qlo, qhi, mlo, mhi)


def _chunks(arrays: ServingArrays, queries, curve, k_maxsplit: int,
            q_chunk: int, backend: str) -> list:
    """The batch in q_chunk pieces, each with its split state: (queries,
    valid (Qc, S), zlo, zhi (Qc, S, 2)).  The split and the z-ranges run
    once on the whole batch (one `split_zranges` launch); they are per
    query, so each piece's state is what its own split would give.  An
    empty batch is one empty piece, so it yields empty outputs of the right
    shapes, as the reference does."""
    queries = _as_queries(arrays, queries)
    Q = queries.shape[0]
    if Q % q_chunk:
        raise ValueError(f"batch size {Q} is not a multiple of q_chunk="
                         f"{q_chunk}; pad with pack_query_rects")
    with obs.span("serve.split", backend=backend):
        valid, zlo, zhi = split_zranges(queries, curve, k_maxsplit,
                                        backend=backend)
    return list(zip(*(t.split(q_chunk) for t in (queries, valid, zlo, zhi))))


def _count_candidates(arrays: ServingArrays, queries, valid, zlo, zhi, *,
                      max_cand: int):
    """A Count chunk's prune, containment shortcut and compaction: the
    (Qc,) sizes of the live pages inside each query (`base`), the (Qc,
    max_cand) int32 ids of its first partial pages and the (Qc,) int64
    number of them (which may exceed max_cand: overflow)."""
    live, (qlo, qhi, mlo, mhi) = _live_pages(arrays, queries, valid, zlo,
                                             zhi)
    contained = torch.all(u32_le(qlo, mlo) & u32_le(mhi, qhi), dim=-1)
    full = live & contained
    partial = live & ~contained
    # ---- containment shortcut -------------------------------------------
    base = torch.sum(torch.where(full, arrays.page_size[None, :], 0), dim=1)
    # ---- compact: top-C partial candidates -------------------------------
    pidx = torch.arange(partial.shape[1], device=partial.device)[None]
    cand, n_cand = compact_rows(partial, pidx, max_cand, 0)
    return base, cand, n_cand


def make_query_fn(curve, *, k_maxsplit: int = 4, max_cand: int = 64,
                  q_chunk: int = 16, backend: str = "cuda"):
    """Returns query_batch(arrays, queries (Q, d, 2) int32) -> (counts (Q,)
    int32, overflowed (Q,) int32 0/1: the candidate pages exceeded
    `max_cand`, so the count is a lower bound).  Q % q_chunk == 0.
    `curve` is any `MonotonicCurve` (legacy `Theta` values are coerced)."""
    curve = as_curve(curve)

    def _chunk(arrays: ServingArrays, queries, *split):
        with obs.span("serve.prune", kind="count"):
            base, cand, n_cand = _count_candidates(arrays, queries, *split,
                                                   max_cand=max_cand)
        overflow = n_cand > max_cand
        # ---- filter the candidate pages, read by id ----------------------
        with obs.span("serve.kernel", kind="count"):
            cnt = window_filter_paged(arrays.points, arrays.page_size,
                                      queries.contiguous(), cand, n_cand,
                                      backend=backend)
        counts = base + cnt
        return counts.to(torch.int32), overflow.to(torch.int32)

    def query_batch(arrays: ServingArrays, queries):
        outs = [_chunk(arrays, *piece) for piece in _chunks(
            arrays, queries, curve, k_maxsplit, q_chunk, backend)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    return query_batch


# ---------------------------------------------------------------------------
# range retrieval: gather matching row ids into a static output buffer
# ---------------------------------------------------------------------------


def make_range_fn(curve, *, k_maxsplit: int = 4, max_cand: int = 64,
                  max_hits: int = 1024, q_chunk: int = 16,
                  backend: str = "cuda"):
    """The retrieval twin of `make_query_fn`: matching rows are compacted
    on the device into a static per-query id buffer (global row id =
    page * cap + slot, so the host resolves rows from its packed copy with
    one gather).

    Returns query_batch(arrays, queries (Q, d, 2) int32) ->
      ids       (Q, max_hits) int32 — matching global row ids, -1 padded
      n_hits    (Q,) int32 — total matches within the candidate-page set
      cand_over (Q,) int32 — candidate pages overflowed max_cand
      hit_over  (Q,) int32 — matches overflowed max_hits (ids truncated)

    There is no containment shortcut: contained pages' rows must be
    emitted too, so every live page is a candidate.  Exact iff both
    overflow flags are 0.  Raises unless pages*cap < 2^31 (ids are int32).
    """
    curve = as_curve(curve)

    def _chunk(arrays: ServingArrays, queries, *split):
        with obs.span("serve.prune", kind="range"):
            live, _ = _live_pages(arrays, queries, *split)
            # ---- compact: top-C candidate pages --------------------------
            pidx = torch.arange(live.shape[1], device=live.device)[None]
            cand, n_cand = compact_rows(live, pidx, max_cand, 0)
        cand_over = n_cand > max_cand
        # ---- match the candidate pages, read by id, into the id buffer ---
        with obs.span("serve.kernel", kind="range"):
            ids, n_hits = window_match_paged(
                arrays.points, arrays.page_size, queries.contiguous(), cand,
                n_cand, max_hits, backend=backend)
        hit_over = n_hits > max_hits
        return (ids, n_hits.to(torch.int32), cand_over.to(torch.int32),
                hit_over.to(torch.int32))

    def query_batch(arrays: ServingArrays, queries):
        P_pad, _, cap = arrays.points.shape
        if P_pad * cap >= 2**31:
            raise ValueError(
                f"range retrieval needs pages*cap < 2^31 for int32 row "
                f"ids; got {P_pad} pages x cap {cap}")
        outs = [_chunk(arrays, *piece) for piece in _chunks(
            arrays, queries, curve, k_maxsplit, q_chunk, backend)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(4))

    return query_batch


# ---------------------------------------------------------------------------
# kNN seeding: page-ring expansion around each center's curve address,
# vectorized over centers (host-side, over the packed serving arrays)
# ---------------------------------------------------------------------------


def knn_seed_radius(host: ServingArrays, curve, centers: np.ndarray,
                    k: int, metric: str = "l2") -> list:
    """Upper-bound each center's k-th-NN distance by expanding page rings
    around its curve address over the *packed* (host numpy) serving arrays.

    Ring r covers pages [p0 - r, p0 + r]; r doubles until a ring holds at
    least min(k, total_live) live rows (or the whole index).  The exact
    k-th candidate distance then bounds the true k-th-NN distance, and the
    returned per-center box half-width is inflated past any float64
    rounding, so the box [c - r, c + r] provably contains the k nearest.
    Vectorized over all still-active centers per ring round.
    """
    centers = np.atleast_2d(np.asarray(centers, dtype=np.uint64))
    pts_u32 = np.ascontiguousarray(host.points).view(np.uint32)  # (P, d, cap)
    Pn, d, cap = pts_u32.shape
    sizes = np.asarray(host.page_size, dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(sizes)])
    kk = min(int(k), int(csum[-1]))
    Q = len(centers)
    if kk <= 0:
        return [0] * Q
    zmin_u64 = z64_to_u64(np.asarray(host.page_zmin))  # padded pages: +inf
    zc = as_curve(curve).encode_np(centers)
    p0 = np.clip(np.searchsorted(zmin_u64, zc, side="right") - 1, 0, Pn - 1)
    radius = [0] * Q
    active = np.ones(Q, dtype=bool)
    w = 1
    slot = np.arange(cap)
    while active.any():
        idxs = np.nonzero(active)[0]
        lo = np.maximum(p0[idxs] - w, 0)
        hi = np.minimum(p0[idxs] + w, Pn - 1)
        ready = ((csum[hi + 1] - csum[lo] >= kk)
                 | ((lo == 0) & (hi == Pn - 1)))
        ridx = idxs[ready]
        if len(ridx):
            offs = np.arange(-w, w + 1)
            pg = p0[ridx, None] + offs[None, :]       # (R, W)
            okp = (pg >= 0) & (pg < Pn)
            pgc = np.clip(pg, 0, Pn - 1)
            blk = pts_u32[pgc]                        # (R, W, d, cap)
            bsz = np.where(okp, sizes[pgc], 0)
            valid = slot[None, None, :] < bsz[:, :, None]   # (R, W, cap)
            R = len(ridx)
            if metric == "linf":
                diff = np.abs(blk.astype(np.int64)
                              - centers[ridx].astype(np.int64)[:, None, :, None])
                dist = np.where(valid, diff.max(axis=2),
                                np.iinfo(np.int64).max)
                kth = np.partition(dist.reshape(R, -1), kk - 1)[:, kk - 1]
                for i, v in zip(ridx, kth):           # L∞: exact, no slop
                    radius[i] = int(v)
            else:
                c = centers[ridx].astype(np.float64)[:, None, :, None]
                diff = blk.astype(np.float64) - c
                d2 = np.where(valid, np.sum(diff * diff, axis=2), np.inf)
                kth = np.partition(d2.reshape(R, -1), kk - 1)[:, kk - 1]
                for i, v in zip(ridx, kth):
                    # float64 may round the exact integer d2 either way;
                    # inflate so the half-width stays an upper bound
                    safe = float(v) * (1 + 1e-9) + 1.0
                    radius[i] = int(math.ceil(math.sqrt(safe))) + 1
            active[ridx] = False
        w *= 2
    return radius


# ---------------------------------------------------------------------------
# distributed engine (pages sharded over a mesh of devices)
# ---------------------------------------------------------------------------

MESH_AXIS = "pages"   # the one axis of a mesh: page shards


def mesh_devices(mesh) -> tuple:
    """A mesh — a sequence of devices (or their names), one page shard each
    — as a tuple of `torch.device`.  A device may repeat: its shards then
    run one after another on it."""
    devs = tuple(torch.device(d) for d in mesh)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


class PageShards:
    """One `ServingArrays` field split over the mesh: `parts[i]` is the
    i-th contiguous equal block of the page axis, on the mesh's i-th
    device (the reference's ``P(axes)`` over axis 0)."""

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def shape(self) -> tuple:
        """The global shape (the page axis summed over the shards)."""
        rest = tuple(self.parts[0].shape[1:])
        return (sum(int(p.shape[0]) for p in self.parts), *rest)


def _on(dev: torch.device):
    """Make `dev` current while a shard launches (its kernels go to that
    device's current stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _shard_rows(arrays: ServingArrays, n: int) -> int:
    P_pad = int(np.shape(arrays.page_size)[0])
    if P_pad % n:
        raise ValueError(f"{P_pad} pages do not split into {n} equal "
                         f"shards; pack with pad_pages_to={n}")
    return P_pad // n


def shard_serving_arrays(arrays: ServingArrays, mesh) -> ServingArrays:
    """Split serving arrays (host numpy or torch) into contiguous equal
    page blocks, block i on the mesh's i-th device: a `ServingArrays` of
    `PageShards`.  The page count must be a multiple of the shard count
    (`pack_serving_arrays(..., pad_pages_to=len(mesh))`)."""
    devs = mesh_devices(mesh)
    per = _shard_rows(arrays, len(devs))
    return arrays.map(lambda a: PageShards(
        torch.as_tensor(a[i * per:(i + 1) * per]).to(dev)
        for i, dev in enumerate(devs)))


def refresh_shards(sharded: ServingArrays, host: ServingArrays, mesh,
                   pages) -> None:
    """Copy `pages` (global ids) of the host arrays into the shards that
    hold them, in place; every other page stays as it was uploaded."""
    devs = mesh_devices(mesh)
    per = _shard_rows(host, len(devs))
    pages = np.unique(np.asarray(list(pages), dtype=np.int64))
    for i, dev in enumerate(devs):
        sel = pages[(pages >= i * per) & (pages < (i + 1) * per)]
        if not len(sel):
            continue
        idx = torch.from_numpy(sel - i * per).to(dev)
        for f in dataclasses.fields(host):
            block = torch.from_numpy(getattr(host, f.name)[sel]).to(dev)
            getattr(sharded, f.name).parts[i].index_copy_(0, idx, block)


def make_distributed_query_fn(curve, mesh, *, k_maxsplit: int = 4,
                              max_cand: int = 64, q_chunk: int = 16,
                              backend: str = "cuda"):
    """Every shard prunes and scans its own pages for the full (replicated)
    query batch with `make_query_fn` on its own device; counts and
    overflow flags are summed over the shards.

    Returns ``(query_batch, shard_layout)``: query_batch(sharded arrays
    from `shard_serving_arrays`, queries (Q, d, 2) int32) -> (counts (Q,)
    int32, overflowed (Q,) int32 — the number of shards whose candidate
    pages exceeded `max_cand`), both on the mesh's first device;
    shard_layout is each field's partition spec, ``P("pages")``.  Backend
    'cuda' needs every mesh device to be a CUDA device: it never runs the
    twins."""
    devs = mesh_devices(mesh)
    if backend == "cuda" and any(d.type != "cuda" for d in devs):
        raise ValueError(f"backend 'cuda' runs the CUDA kernels on every "
                         f"shard; the mesh holds {[str(d) for d in devs]} "
                         f"(use backend='torch' for the plain-torch twins)")
    local = make_query_fn(curve, k_maxsplit=k_maxsplit, max_cand=max_cand,
                          q_chunk=q_chunk, backend=backend)

    def query_batch(arrays: ServingArrays, queries):
        queries = torch.as_tensor(queries)
        outs = []
        for i, dev in enumerate(devs):     # launch every shard first
            with _on(dev):
                outs.append(local(arrays.map(lambda s: s.parts[i]),
                                  queries.to(dev)))
        # the psum: int32 sums in shard order on the first device
        counts = outs[0][0].to(devs[0])
        over = outs[0][1].to(devs[0])
        for c, o in outs[1:]:
            counts = counts + c.to(devs[0])
            over = over + o.to(devs[0])
        return counts, over

    layout = ServingArrays(**{f.name: P(MESH_AXIS)
                              for f in dataclasses.fields(ServingArrays)})
    return query_batch, layout
