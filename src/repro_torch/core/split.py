"""Recursive query splitting (paper §6, Lemma 2), generic over the curve.

Optimal 1-split: for each dimension δ with qL^(δ) < qU^(δ), the best cut is
v* = (qU^(δ) >> l) << l with l = MSB of qL^(δ) XOR qU^(δ); the split removes
the z-gap (f(L) − f(U)) from the scanned range, where
U = (qU with δ ↦ v*−1) and L = (qL with δ ↦ v*).  Choose the δ with the
largest positive gap; recurse up to k_maxsplit times.

Three execution strategies, one algorithm:
  * per-query recursion  — faithful to Algorithm 4 (CPU engine)
  * numpy batch          — (Q, 2^k) static sub-query tensor with validity
                           masks, identical leaf sets to the recursion
  * torch batch          — the same tensorization in torch, encoding
                           through `kernels.sfc_encode` (CUDA kernel or its
                           plain-torch twin, per `backend`): the twin of the
                           split kernel `kernels.sfc_encode.ops.split_zranges`
                           (the serving path's) and SMBO's batch evaluation

The torch batch holds unsigned 32-bit coordinates as int64 values in
[0, 2^32): torch's int32 ``>>`` is arithmetic and coordinates reach 2^32-1
at d=2, K=32.  The reference's uint32 wraparound (``v - 1`` at v = 0) is
reproduced by masking to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.sfc_encode.ops import sfc_encode
from .curve import MonotonicCurve, as_curve
from .zorder64 import MASK32, i32_of, u32_of

# ---------------------------------------------------------------------------
# per-query recursion (faithful Algorithm 4)
# ---------------------------------------------------------------------------


def optimal_1split(qL, qU, curve):
    """Return (delta, v, gap) for the best single split, or None if no
    positive-gap split exists (delegates to the curve's split hook)."""
    return as_curve(curve).optimal_1split(qL, qU)


def _rsplit(qL: list, qU: list, curve: MonotonicCurve, k: int, out: list):
    best = curve.optimal_1split(qL, qU) if k > 0 else None
    if best is None:
        out.append((np.asarray(qL, np.uint64), np.asarray(qU, np.uint64)))
        return
    delta, v, _ = best
    U = list(qU)
    U[delta] = v - 1
    L = list(qL)
    L[delta] = v
    _rsplit(qL, U, curve, k - 1, out)
    _rsplit(L, qU, curve, k - 1, out)


def recursive_split(qL, qU, curve, k_maxsplit: int = 4):
    """List of (qL, qU) uint64 sub-rectangles (Algorithm 4)."""
    out = []
    _rsplit([int(v) for v in qL], [int(v) for v in qU], as_curve(curve),
            k_maxsplit, out)
    return out


# ---------------------------------------------------------------------------
# numpy batch (whole-workload splitting)
# ---------------------------------------------------------------------------


def _split_once_np(rects, valid, curve: MonotonicCurve):
    """rects: (Q, S, d, 2) uint64 [lo, up]; valid: (Q, S) bool.
    Returns (rects', valid') with S doubled.  Mirrors `_rsplit` exactly:
    same cut rule, same strict-gap test, same first-max tie-break."""
    d = curve.d
    qL = rects[..., 0]  # (Q, S, d)
    qU = rects[..., 1]
    splittable = qL < qU
    v = curve.split_cuts_np(qL, qU)  # placeholder 1 where not splittable

    eye = np.eye(d, dtype=bool)
    U_all = np.where(eye, (v - np.uint64(1))[..., :, None], qU[..., None, :])
    L_all = np.where(eye, v[..., :, None], qL[..., None, :])
    fU = curve.encode_np(U_all)  # (Q, S, d)
    fL = curve.encode_np(L_all)
    pos = (fL > fU) & splittable
    gap = np.where(pos, fL - fU, np.uint64(0))
    delta = np.argmax(gap, axis=-1)  # first max == recursion's strict >
    any_split = pos.any(axis=-1) & valid

    sel = np.arange(d) == delta[..., None]  # (Q, S, d)
    v_sel = np.take_along_axis(v, delta[..., None], axis=-1)  # (Q, S, 1)

    do = any_split[..., None]
    child0_U = np.where(sel & do, v_sel - np.uint64(1), qU)
    child1_L = np.where(sel & do, v_sel, qL)

    c0 = np.stack([qL, child0_U], axis=-1)  # (Q, S, d, 2)
    c1 = np.stack([child1_L, qU], axis=-1)
    rects2 = np.stack([c0, c1], axis=2)  # (Q, S, 2, d, 2)
    valid2 = np.stack([valid, any_split], axis=2)  # (Q, S, 2)

    Q, S = valid.shape
    return rects2.reshape(Q, 2 * S, d, 2), valid2.reshape(Q, 2 * S)


def recursive_split_np_batch(Ls, Us, curve, k_maxsplit: int = 4):
    """Whole-workload splitting: (Q, d) uint64 bounds ->
    (rects (Q, 2^k, d, 2) uint64, valid (Q, 2^k) bool).

    The valid leaves equal `recursive_split`'s output per query (a node that
    cannot split carries its rect forward in child 0 with child 1 invalid,
    and re-attempting a split is deterministic), so stats derived from the
    leaf multiset — index accesses, candidate pages — match the recursion.
    """
    curve = as_curve(curve)
    Ls = np.asarray(Ls, dtype=np.uint64)
    Us = np.asarray(Us, dtype=np.uint64)
    rects = np.stack([Ls, Us], axis=-1)[:, None]  # (Q, 1, d, 2)
    valid = np.ones(rects.shape[:2], dtype=bool)
    for _ in range(k_maxsplit):
        rects, valid = _split_once_np(rects, valid, curve)
    return rects, valid


# ---------------------------------------------------------------------------
# torch (vectorized, static shapes; unsigned words held in int64)
# ---------------------------------------------------------------------------


def _msb_u32(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for int64 v in [1, 2^32): bit smear + SWAR popcount
    (torch has no popcount; every intermediate stays below 2^53)."""
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF) - 1


def _encoder(curve: MonotonicCurve, backend: str):
    """(..., d) int32 -> (..., 2) int32 Z64 through the `sfc_encode` kernel
    wrapper (flattened to its (n, d) contract)."""
    def encode(x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        z = sfc_encode(x.reshape(-1, x.shape[-1]).contiguous(), curve,
                       backend=backend)
        return z.reshape(*lead, 2)
    return encode


def _split_once_enc(rects, valid, d: int, encode):
    """rects: (Q, S, d, 2) int64 unsigned words [lo, up]; valid: (Q, S)
    bool.  Returns (rects', valid') with S doubled.  `encode` maps
    (..., d) int32 coords to (..., 2) int32 Z64."""
    qL = rects[..., 0]  # (Q, S, d)
    qU = rects[..., 1]
    splittable = qL < qU
    x = qL ^ qU
    l = _msb_u32(torch.clamp(x, min=1))
    v = (qU >> l) << l  # candidate cut per dim (Lemma 2)

    # corner points per candidate dim delta: (Q, S, d_delta, d_coord)
    eye = torch.eye(d, dtype=torch.bool, device=rects.device)
    U_all = torch.where(eye, ((v - 1) & MASK32)[..., :, None],
                        qU[..., None, :])
    L_all = torch.where(eye, v[..., :, None], qL[..., None, :])
    # one encode for both corner sets, paired on axis 1 so the leading
    # query (or candidate-major) axis stays first
    f = encode(i32_of(torch.stack([U_all, L_all], dim=1)))  # (Q, 2, S, d, 2)
    fU, fL = f[:, 0], f[:, 1]
    fUh, fUl = u32_of(fU[..., 0]), u32_of(fU[..., 1])
    fLh, fLl = u32_of(fL[..., 0]), u32_of(fL[..., 1])
    pos = ((fUh < fLh) | ((fUh == fLh) & (fUl < fLl))) & splittable
    borrow = (fLl < fUl).to(torch.int64)
    ghi = torch.where(pos, (fLh - fUh - borrow) & MASK32, 0)
    glo = torch.where(pos, (fLl - fUl) & MASK32, 0)

    # Exact lexicographic argmax over dims of the 64-bit gap without u64:
    # (1) max of hi word, (2) max of lo word among hi-ties, (3) first match.
    mhi = ghi.amax(dim=-1, keepdim=True)
    tie1 = pos & (ghi == mhi)
    mlo = torch.where(tie1, glo, 0).amax(dim=-1, keepdim=True)
    tie2 = tie1 & (glo == mlo)
    delta = torch.argmax(tie2.to(torch.int32), dim=-1)  # first max
    any_split = pos.any(dim=-1) & valid

    sel = torch.arange(d, device=rects.device) == delta[..., None]
    v_sel = torch.gather(v, -1, delta[..., None])  # (Q, S, 1)

    do = any_split[..., None]
    child0_U = torch.where(sel & do, (v_sel - 1) & MASK32, qU)
    child1_L = torch.where(sel & do, v_sel, qL)

    c0 = torch.stack([qL, child0_U], dim=-1)  # (Q, S, d, 2)
    c1 = torch.stack([child1_L, qU], dim=-1)
    rects2 = torch.stack([c0, c1], dim=2)  # (Q, S, 2, d, 2)
    valid2 = torch.stack([valid, any_split], dim=2)  # (Q, S, 2)

    Q, S = valid.shape
    return rects2.reshape(Q, 2 * S, d, 2), valid2.reshape(Q, 2 * S)


def recursive_split_torch(queries: torch.Tensor, curve, k_maxsplit: int = 4,
                          backend: str = "cuda"):
    """queries: (Q, d, 2) int32 (unsigned bit patterns) -> (rects
    (Q, 2^k, d, 2) int64 holding the reference's uint32 values, valid
    (Q, 2^k) bool)."""
    curve = as_curve(curve)
    encode = _encoder(curve, backend)
    rects = u32_of(queries)[:, None]  # (Q, 1, d, 2)
    valid = torch.ones(rects.shape[:2], dtype=torch.bool,
                       device=queries.device)
    for _ in range(k_maxsplit):
        rects, valid = _split_once_enc(rects, valid, curve.d, encode)
    return rects, valid


def zranges_torch(rects: torch.Tensor, curve, backend: str = "cuda"):
    """Z64 ranges for each sub-query of rects (Q, S, d, 2): (zlo, zhi),
    each (Q, S, 2) int32, from one encode of both corners."""
    z = zrange_pairs(rects, _encoder(as_curve(curve), backend))
    return z[:, 0], z[:, 1]


def zrange_pairs(rects: torch.Tensor, encode) -> torch.Tensor:
    """Both corners of rects (Q, S, d, 2) in one `encode`, paired on axis 1
    (low corner first): (Q, 2, S, 2) int32 Z64."""
    return encode(i32_of(rects.movedim(-1, 1)))
