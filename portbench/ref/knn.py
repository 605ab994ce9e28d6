"""The plain reference for exact kNN: each centre's k nearest rows under
squared L2 over the raw rows, in torch on any device.

It takes the rows of `ref.window.WindowReference` (held in lexicographic
order) and the centres, and nothing the program made: no curve, no page,
no seed radius, no box.  The answer of a centre is its k nearest rows in
ascending exact distance, ties broken by the lexicographic order of the
rows, each with its exact distance as float64 (the Python integer
rounded to nearest), which is what `KnnResult` promises.

A plain sort of every row's exact distance would answer the same.  Two
departures make it fit a 10^7-row check:

- the centres go in blocks, and float64 squared distances over every row
  pick a candidate set per centre: the rows whose float64 distance is at
  most the k-th smallest float64 distance times (1 + REL_MARGIN).  The
  coordinates (below 2^53) and their differences are exact in float64;
  each square and each sum rounds by at most a relative 2^-53, so a
  float64 distance f of an exact distance D lies within d·2^-53·D of it
  (d the dimensions).  Every row whose D is at most the k-th exact
  distance then has f at most the k-th float64 distance times
  (1 + 2·d·2^-53) to first order.  REL_MARGIN, 2^-40, holds that for
  every d up to 4,096 with room for the rounding of the threshold's own
  product, so no row that ties or beats the k-th neighbour is left out,
  however far the distances pass 2^53 (at K 32 they reach 2^65);
- within that set Python integers give the exact distances, and a sort
  by (distance, row) decides the order and the ties.

`ref.dtype` set (the control, `lossy_K`): the same blocks in the float
type below the configuration's K-bit integers, over `ref.key` (every
coordinate rounded to it) and the centres rounded alike, with no margin
and no exact pass: the k smallest rounded distances, ties by row order,
their rows and the rounded distances as float64.
"""
from __future__ import annotations

import numpy as np
import torch

REL_MARGIN = 2.0 ** -40
BLOCK_ELEMS = 1 << 27          # (centres, rows) distances a block


def nearest(ref, centres: np.ndarray, k: int,
            block_elems: int = BLOCK_ELEMS) -> list:
    """One (rows (m, d) uint64, dists (m,) float64) pair a centre, m =
    min(k, rows): `ref`'s k nearest rows to each centre under squared L2
    (`ref`: a `WindowReference`, or its control)."""
    pts = ref.pts
    n, d = pts.shape
    centres = np.atleast_2d(np.asarray(centres)).astype(np.int64)
    kk = min(int(k), n)
    if kk <= 0:
        empty = (np.empty((0, d), dtype=np.uint64), np.empty(0))
        return [empty] * len(centres)
    dtype = ref.dtype or torch.float64
    cols = [ref.key[:, j].to(dtype) for j in range(d)]
    c_all = torch.from_numpy(centres).to(pts.device).to(dtype)
    block = max(1, block_elems // n)
    out = []
    for s in range(0, len(centres), block):
        c = c_all[s:s + block]
        d2 = torch.zeros((len(c), n), dtype=dtype, device=pts.device)
        for j in range(d):
            diff = cols[j][None, :] - c[:, j:j + 1]
            d2 += diff * diff
        kth = torch.topk(d2, kk, dim=1, largest=False).values[:, -1]
        if ref.dtype is None:
            kth = kth * (1 + REL_MARGIN)
        b, idx = torch.nonzero(d2 <= kth[:, None], as_tuple=True)
        vals = d2[b, idx].to(torch.float64).cpu().numpy()
        rows = pts[idx].cpu().numpy()
        b, idx = b.cpu().numpy(), idx.cpu().numpy()
        for i in range(len(c)):
            mine = b == i
            if ref.dtype is None:
                out.append(_exact_top(rows[mine], centres[s + i], kk))
            else:        # the rows are in lexicographic order: by index
                order = np.lexsort((idx[mine], vals[mine]))[:kk]
                out.append((rows[mine][order].astype(np.uint64),
                            vals[mine][order]))
    return out


def _exact_top(rows: np.ndarray, centre: np.ndarray, k: int):
    """The k nearest of candidate `rows` (int64) by exact integer squared
    distance, ties by lexicographic row."""
    c = centre.tolist()
    keyed = sorted((sum((x - y) * (x - y) for x, y in zip(r, c)), r)
                   for r in rows.tolist())[:k]
    top = np.array([r for _, r in keyed], dtype=np.uint64).reshape(
        -1, rows.shape[1])
    return top, np.array([float(dist) for dist, _ in keyed],
                         dtype=np.float64)
