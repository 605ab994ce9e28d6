"""64-bit z-address arithmetic as dual-uint32 ("Z64") on torch tensors.

Every public z-address keeps the reference layout: an int32 tensor with a
trailing dim of 2, ``[..., 0] = hi, [..., 1] = lo``, compared unsigned via
the sign-flip trick.  Wrapping arithmetic is done in int64 and wrapped back
to int32 explicitly, so no result depends on signed int32 overflow.

The numpy uint64 <-> Z64 conversions are kept here too, so tests and the
host-side packing code can move between the two representations.
"""
from __future__ import annotations

import numpy as np
import torch

SIGN = -(2**31)
MASK32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# numpy <-> Z64 conversions
# ---------------------------------------------------------------------------


def u64_to_z64(z: np.ndarray) -> np.ndarray:
    """uint64 array -> int32 array with trailing dim 2 (hi, lo)."""
    z = np.asarray(z, dtype=np.uint64)
    hi = (z >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (z & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return np.stack([hi, lo], axis=-1)


def z64_to_u64(z: np.ndarray) -> np.ndarray:
    """int32 (..., 2) -> uint64 array."""
    z = np.asarray(z)
    hi = z[..., 0].view(np.int32).astype(np.int64).view(np.uint64) & np.uint64(0xFFFFFFFF)
    lo = z[..., 1].view(np.int32).astype(np.int64).view(np.uint64) & np.uint64(0xFFFFFFFF)
    return (hi << np.uint64(32)) | lo


# ---------------------------------------------------------------------------
# int32 <-> unsigned word conversions (torch)
# ---------------------------------------------------------------------------


def u32_of(a: torch.Tensor) -> torch.Tensor:
    """int32 word -> int64 holding its unsigned value in [0, 2^32)."""
    return a.to(torch.int64) & MASK32


def i32_of(u: torch.Tensor) -> torch.Tensor:
    """int64 value (any; taken mod 2^32) -> int32 word with the same low
    32 bits, i.e. the bit cast the reference gets from ``.astype(int32)``
    of a uint32."""
    u = u & MASK32
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


# ---------------------------------------------------------------------------
# unsigned helpers on int32 words
# ---------------------------------------------------------------------------


def u32_lt(a, b):
    """unsigned a < b on int32 words."""
    return (a ^ SIGN) < (b ^ SIGN)


def u32_le(a, b):
    return (a ^ SIGN) <= (b ^ SIGN)


# ---------------------------------------------------------------------------
# Z64 comparisons (trailing dim 2)
# ---------------------------------------------------------------------------


def z64_lt(a, b):
    """lexicographic unsigned < on (..., 2) int32."""
    ahi, alo = a[..., 0], a[..., 1]
    bhi, blo = b[..., 0], b[..., 1]
    return u32_lt(ahi, bhi) | ((ahi == bhi) & u32_lt(alo, blo))


def z64_le(a, b):
    ahi, alo = a[..., 0], a[..., 1]
    bhi, blo = b[..., 0], b[..., 1]
    return u32_lt(ahi, bhi) | ((ahi == bhi) & u32_le(alo, blo))


def z64_eq(a, b):
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def z64_max(a, b):
    take_a = z64_lt(b, a)
    return torch.where(take_a[..., None], a, b)


def z64_min(a, b):
    take_a = z64_lt(a, b)
    return torch.where(take_a[..., None], a, b)


# ---------------------------------------------------------------------------
# Z64 arithmetic (mod 2^64)
# ---------------------------------------------------------------------------


def z64_sub(a, b):
    """a - b (mod 2^64) on (..., 2) int32.  Callers ensure a >= b when the
    difference is interpreted as a magnitude."""
    ahi, alo = u32_of(a[..., 0]), u32_of(a[..., 1])
    bhi, blo = u32_of(b[..., 0]), u32_of(b[..., 1])
    borrow = (alo < blo).to(torch.int64)
    return torch.stack([i32_of(ahi - bhi - borrow), i32_of(alo - blo)], dim=-1)


def z64_add(a, b):
    ahi, alo = u32_of(a[..., 0]), u32_of(a[..., 1])
    bhi, blo = u32_of(b[..., 0]), u32_of(b[..., 1])
    lo = alo + blo
    carry = lo >> 32
    return torch.stack([i32_of(ahi + bhi + carry), i32_of(lo)], dim=-1)


def z64_to_f32(z):
    """Approximate float32 magnitude (for cost heuristics only): each
    unsigned word rounded to float32, then hi * 2^32 + lo in float32."""
    hi = u32_of(z[..., 0]).to(torch.float32)
    lo = u32_of(z[..., 1]).to(torch.float32)
    return hi * 2.0**32 + lo


# ---------------------------------------------------------------------------
# order-preserving int64 keys and search over a sorted Z64 array
# ---------------------------------------------------------------------------


def z64_key(z: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 Z64 -> (...,) int64 holding the 64-bit value minus
    2^63, so signed int64 order is the unsigned Z64 order (the all-ones
    +inf padding maps to the int64 maximum)."""
    hi = (z[..., 0] ^ SIGN).to(torch.int64)       # hi_u - 2^31
    return hi * 2**32 + (z[..., 1].to(torch.int64) & MASK32)


def z64_searchsorted(keys: torch.Tensor, query: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Like ``np.searchsorted(keys, query, side)`` for Z64, exact.

    keys: (n, 2) int32 sorted ascending (unsigned), or (B, n, 2) with one
    sorted row per batch entry; query: (..., 2) int32, or (B, ..., 2) when
    the keys are batched.  Returns int64 indices in [0, n]."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right'; got {side!r}")
    k, q = z64_key(keys), z64_key(query)
    lead = q.shape
    q = q.reshape(-1) if keys.dim() == 2 else q.reshape(k.shape[0], -1)
    return torch.searchsorted(k.contiguous(), q.contiguous(),
                              right=side == "right").reshape(lead)
