"""Plain-torch twins of the SFC encode kernels (any curve kind)."""
from __future__ import annotations

import torch

from ...core.curve import CurvePool, as_curve, pack_curve_pool
from ...core.sfc import encode_pool_torch


def sfc_encode_ref(x, curve):
    """x: (n, d) int32 (unsigned semantics) -> (n, 2) int32 Z64 (hi, lo).
    `curve` is any `MonotonicCurve` (or a legacy `Theta`)."""
    return as_curve(curve).encode_torch(x)


def pool_tables(pool, device) -> tuple:
    """A `CurvePool` (or a list of curves, packed here) as its ``pos``
    (P, R, T) and ``reg`` (P, M) int32 tensors on `device`.  A pool whose
    arrays are already int32 tensors there is used without a copy."""
    if not isinstance(pool, CurvePool):
        pool = pack_curve_pool(pool)
    return (torch.as_tensor(pool.pos, dtype=torch.int32, device=device),
            torch.as_tensor(pool.reg, dtype=torch.int32, device=device))


def sfc_encode_pool_ref(x, pool):
    """Candidate-batched twin: x (n, d) int32 shared by every curve, or
    (P, n, d) with one point set per curve, and a `CurvePool` (or a list of
    curves) -> (P, n, 2) int32 Z64; row p is curve p's encode."""
    pos, reg = pool_tables(pool, x.device)
    return encode_pool_torch(x, pos, reg)
