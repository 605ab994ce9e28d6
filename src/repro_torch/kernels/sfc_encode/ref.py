"""Plain-torch twins of the SFC encode kernels (any curve kind)."""
from __future__ import annotations

import torch

from ...core.curve import CurvePool, as_curve, pack_curve_pool
from ...core.sfc import encode_pool_torch, lut_tables
from ...core.zorder64 import MASK32, i32_of


def sfc_encode_ref(x, curve):
    """x: (n, d) int32 (unsigned semantics) -> (n, 2) int32 Z64 (hi, lo).
    `curve` is any `MonotonicCurve` (or a legacy `Theta`)."""
    return as_curve(curve).encode_torch(x)


def pool_tables(pool, device) -> tuple:
    """A `CurvePool` (or a list of curves, packed here) as the kernel's
    inputs on `device`: ``reg`` (P, M) int32 and ``lut`` (P, R, d, C, 16)
    int64 (the pool's own ``lut`` if it carries one, else built here from
    its ``pos``).  Arrays already on `device` with those types are used
    without a copy."""
    if not isinstance(pool, CurvePool):
        pool = pack_curve_pool(pool)
    reg = torch.as_tensor(pool.reg, dtype=torch.int32, device=device)
    if pool.lut is not None:
        return reg, torch.as_tensor(pool.lut, device=device)
    pos = torch.as_tensor(pool.pos, dtype=torch.int32, device=device)
    return reg, lut_tables(pos, pool.d, pool.K)


def sfc_encode_pool_ref(x, pool):
    """Candidate-batched twin: x (n, d) int32 shared by every curve, or
    (P, n, d) with one point set per curve, and a `CurvePool` (or a list of
    curves) -> (P, n, 2) int32 Z64; row p is curve p's encode."""
    if not isinstance(pool, CurvePool):
        pool = pack_curve_pool(pool)
    return encode_pool_torch(
        x, torch.as_tensor(pool.pos, dtype=torch.int32, device=x.device),
        torch.as_tensor(pool.reg, dtype=torch.int32, device=x.device))


def encode_lut_torch(x, lut, reg, K: int):
    """The CUDA kernel's arithmetic, step by step: x (..., d) int32, one
    curve's `lut_tables` (R, d, C, 16) and ``reg`` (M,) -> (..., 2) int32
    Z64.  Region bit m is bit `shift` of coordinate `dim` for reg[m] =
    dim*K + shift < d*K and 0 otherwise; the point's word is the OR of its
    d*C nibble entries in its region's tables."""
    R, d, C, _ = lut.shape
    lut = lut.to(device=x.device, dtype=torch.int64)
    xu = x.to(torch.int64) & MASK32
    r = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for m, t in enumerate(torch.as_tensor(reg).tolist()):
        if 0 <= t < d * K:
            r |= ((xu[..., t // K] >> (t % K)) & 1) << m
    z = torch.zeros_like(r)
    for i in range(d):
        for c in range(C):
            z |= lut[r, i, c, (xu[..., i] >> (4 * c)) & 15]
    return torch.stack([i32_of(z >> 32), i32_of(z)], dim=-1)
