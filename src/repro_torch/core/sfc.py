"""SFC mapping f(x; θ) — numpy uint64 oracle and torch dual-uint32 versions.

Encode = "scramble the bits of x according to θ" (paper §4.3).  The numpy
path is the correctness oracle (and serves index *construction*); the torch
path is the device serving path (Z64 = (hi, lo) int32 pairs, see
zorder64.py).

This module is the θ-level backend; consumers should go through the
`MonotonicCurve` protocol (core/curve.py), whose `GlobalTheta` delegates
here and whose `PiecewiseCurve` composes these per-region.
"""
from __future__ import annotations

import numpy as np
import torch

from .theta import Theta
from .zorder64 import MASK32, i32_of

# ---------------------------------------------------------------------------
# numpy oracle (uint64)
# ---------------------------------------------------------------------------


def encode_np_ref(x: np.ndarray, theta: Theta) -> np.ndarray:
    """Reference bit-loop encode (oracle for the table-driven fast path)."""
    x = np.asarray(x, dtype=np.uint64)
    dim = theta.dim_of_pos
    bit = theta.bit_of_pos
    z = np.zeros(x.shape[:-1], dtype=np.uint64)
    for l in range(theta.d * theta.K):
        b = (x[..., dim[l]] >> np.uint64(bit[l])) & np.uint64(1)
        z |= b << np.uint64(l)
    return z


_TABLE_CACHE = {}


def _spread_tables(theta: Theta):
    """Per-dim 16-bit-chunk lookup tables: table[i][c][v] = the scattered
    z-bits of chunk c of dimension i holding value v.  Encode then becomes
    a handful of numpy gathers (the 64-step bit loop is ~100x slower for
    the per-query single-point encodes in splitting/skipping)."""
    key = (theta.d, theta.K, theta.seq)
    t = _TABLE_CACHE.get(key)
    if t is not None:
        return t
    pos = theta.pos_of_bit  # (d, K)
    n_chunks = -(-theta.K // 16)
    tables = np.zeros((theta.d, n_chunks, 65536), dtype=np.uint64)
    v = np.arange(65536, dtype=np.uint64)
    for i in range(theta.d):
        for c in range(n_chunks):
            acc = np.zeros(65536, dtype=np.uint64)
            for j in range(16 * c, min(theta.K, 16 * (c + 1))):
                b = (v >> np.uint64(j - 16 * c)) & np.uint64(1)
                acc |= b << np.uint64(pos[i, j])
            tables[i, c] = acc
    _TABLE_CACHE[key] = tables
    return tables


# Below this many points, the 64-step bit loop beats building (and caching)
# a fresh set of spread tables for each new θ: SMBO evaluates hundreds of
# throwaway candidate curves over small sampled datasets, where eager table
# builds would dominate the learn loop.
_TABLE_BREAKEVEN = 50_000


def encode_np(x: np.ndarray, theta: Theta) -> np.ndarray:
    """x: (..., d) unsigned ints (values < 2^K) -> (...,) uint64 z-address."""
    x = np.asarray(x, dtype=np.uint64)
    if ((theta.d, theta.K, theta.seq) not in _TABLE_CACHE
            and x.size < _TABLE_BREAKEVEN * theta.d):
        return encode_np_ref(x, theta)
    tables = _spread_tables(theta)
    z = np.zeros(x.shape[:-1], dtype=np.uint64)
    n_chunks = tables.shape[1]
    for i in range(theta.d):
        xi = x[..., i]
        for c in range(n_chunks):
            chunk = (xi >> np.uint64(16 * c)) & np.uint64(0xFFFF)
            z |= tables[i, c][chunk.astype(np.int64)]
    return z


def decode_np(z: np.ndarray, theta: Theta) -> np.ndarray:
    """uint64 z-address -> (..., d) uint64 coordinates (inverse of encode)."""
    z = np.asarray(z, dtype=np.uint64)
    dim = theta.dim_of_pos
    bit = theta.bit_of_pos
    x = np.zeros(z.shape + (theta.d,), dtype=np.uint64)
    for l in range(theta.d * theta.K):
        b = (z >> np.uint64(l)) & np.uint64(1)
        x[..., dim[l]] |= b << np.uint64(bit[l])
    return x


# ---------------------------------------------------------------------------
# torch path (int32 coords in, Z64 out)
# ---------------------------------------------------------------------------


def encode_table_torch(x: torch.Tensor, pos: torch.Tensor,
                       reg: torch.Tensor) -> torch.Tensor:
    """Table-driven Z64 encode; the plain-torch body behind every curve's
    `encode_torch` and the contract of the CUDA `sfc_encode` kernel.

    x:   (..., d) int32 coords (unsigned semantics, values < 2^K)
    pos: (R, T) integer — output position of flat input bit t = i*K + j in
         region r (R = 1 for a global θ)
    reg: (M,) integer — flat input-bit index feeding region-code bit m;
         index T (or any index >= T) reads a constant-zero bit

    Returns (..., 2) int32 Z64.  Bits above K are ignored, as in the
    reference chain.  Exact: every output bit lands in a distinct position,
    so the int64 sum of shifted bits is their bitwise OR (no carries).
    """
    R, T = pos.shape
    d = x.shape[-1]
    K = T // d
    lead = x.shape[:-1]
    pos = pos.to(device=x.device, dtype=torch.int64)
    reg = reg.to(device=x.device, dtype=torch.int64)
    xu = x.to(torch.int64) & MASK32                              # (..., d)
    shifts = torch.arange(K, device=x.device, dtype=torch.int64)
    bits = ((xu[..., :, None] >> shifts) & 1).reshape(*lead, T)   # (..., T)
    if R > 1:
        planes = torch.cat([bits, bits.new_zeros(*lead, 1)], dim=-1)
        rbits = planes[..., reg.clamp(max=T)]                     # (..., M)
        weights = torch.arange(reg.shape[0], device=x.device,
                               dtype=torch.int64)
        r = (rbits << weights).sum(-1)
        p = pos[r]                                                # (..., T)
    else:
        p = pos[0]
    z = (bits << p).sum(-1)
    return torch.stack([i32_of(z >> 32), i32_of(z)], dim=-1)


def lut_tables(pos: torch.Tensor, d: int, K: int) -> torch.Tensor:
    """The CUDA `sfc_encode` kernel's nibble lookup tables from `pack_curve_
    pool` position tables: pos (..., R, T) integer, T = d*K ->
    (..., R, d, C, 16) int64, C = ceil(K / 4).  Entry [r, i, c, v] is the
    64-bit word (two's complement) with bit j of v at pos[r, i*K + 4c + j];
    bits with 4c + j >= K add nothing.  Exact: every bit lands in a distinct
    position, so the int64 sum of shifted bits is their bitwise OR."""
    pos = torch.as_tensor(pos).to(torch.int64)
    lead = pos.shape[:-1]
    C = -(-K // 4)
    p = pos.reshape(*lead, d, K)
    p = torch.cat([p, p.new_zeros(*lead, d, 4 * C - K)], dim=-1)
    p = p.reshape(*lead, d, C, 1, 4)
    j = torch.arange(4, device=pos.device)
    bits = (torch.arange(16, device=pos.device)[:, None] >> j) & 1  # (16, 4)
    live = (torch.arange(4 * C, device=pos.device) < K).reshape(C, 1, 4)
    return ((bits * live) << p).sum(-1)                       # (..., d, C, 16)


def encode_pool_torch(x: torch.Tensor, pos: torch.Tensor,
                      reg: torch.Tensor) -> torch.Tensor:
    """Data-driven encode under every curve of a pool; the plain-torch twin
    of the reference's `encode_z64_dyn` with a pool axis, and the contract
    of the CUDA `sfc_encode_pool` kernel.

    x:   (n, d) int32 points shared by every curve, or (P, n, d) int32 with
         one point set per curve
    pos: (P, R, T) and reg (P, M) integer — `pack_curve_pool` layouts

    Returns (P, n, 2) int32 Z64; row p is `encode_table_torch` under curve
    p's tables (rows of `pos` past a curve's own region count are never
    selected, since its region code stays below that count)."""
    P = pos.shape[0]
    if x.dim() == 3 and x.shape[0] != P:
        raise ValueError(f"x has {x.shape[0]} point sets for {P} curves")
    return torch.stack([encode_table_torch(x[p] if x.dim() == 3 else x,
                                           pos[p], reg[p])
                        for p in range(P)])


def encode_torch(x: torch.Tensor, theta: Theta) -> torch.Tensor:
    """x: (..., d) int32 (unsigned semantics, values < 2^K) -> (..., 2) Z64.
    Same contract as the reference's static ≤64-step chain `encode_jax`."""
    pos = torch.as_tensor(theta.pos_of_bit.reshape(1, -1), device=x.device)
    reg = torch.zeros(0, dtype=torch.int64, device=x.device)
    return encode_table_torch(x, pos, reg)


# ---------------------------------------------------------------------------
# properties (used by tests / assertions)
# ---------------------------------------------------------------------------


_PY_TABLE_CACHE = {}


def _spread_tables_py(theta: Theta):
    """Nested python-int lists of the spread tables (list indexing beats
    numpy scalar indexing ~5x on the per-corner encodes in splitting)."""
    key = (theta.d, theta.K, theta.seq)
    t = _PY_TABLE_CACHE.get(key)
    if t is None:
        tables = _spread_tables(theta)
        t = [[tables[i, c].tolist() for c in range(tables.shape[1])]
             for i in range(theta.d)]
        _PY_TABLE_CACHE[key] = t
    return t


def encode_scalar(coords, theta: Theta) -> int:
    """Single-point encode on python ints via the spread tables (the
    query-splitting hot path)."""
    tables = _spread_tables_py(theta)
    z = 0
    for i in range(theta.d):
        v = int(coords[i])
        for c, tc in enumerate(tables[i]):
            z |= tc[(v >> (16 * c)) & 0xFFFF]
    return z


def is_monotonic_pair(theta: Theta, a: np.ndarray, b: np.ndarray) -> bool:
    """Check Thm 1's premise on one pair: a<=b (componentwise) => f(a)<=f(b)."""
    if not np.all(a <= b):
        return True
    return encode_np(a[None], theta)[0] <= encode_np(b[None], theta)[0]
