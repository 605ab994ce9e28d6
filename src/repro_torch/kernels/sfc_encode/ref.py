"""Plain-torch twin of the SFC encode kernel (any curve kind)."""
from __future__ import annotations

from ...core.curve import as_curve


def sfc_encode_ref(x, curve):
    """x: (n, d) int32 (unsigned semantics) -> (n, 2) int32 Z64 (hi, lo).
    `curve` is any `MonotonicCurve` (or a legacy `Theta`)."""
    return as_curve(curve).encode_torch(x)
