"""FindNextZaddress / BIGMIN lazy skipping (Tropf & Herzog [36], UB-tree [29]).

Generalized to *any* monotone SFC in our θ family: the classic bit-walk is
agnostic to which dimension owns each output bit as long as per-dimension bit
order is preserved (constraint 3), which is exactly what θ guarantees.

``next_jump_in(z, qL, qU, θ)`` returns min{ f(x) : x ∈ q, f(x) >= z } or None.
Used by the ZM+FNZ / LMSFC+FNZ rows of the paper's Table 3.
"""
from __future__ import annotations

import numpy as np

from ..core.curve import GlobalTheta
from ..core.index import LMSFCIndex
from ..core.query import QueryStats, _scan_page
from ..core.sfc import encode_np, encode_scalar
from ..core.theta import Theta


def _load_1000(v: int, j: int) -> int:
    """set bit j, clear bits below j."""
    return (v & ~((1 << (j + 1)) - 1)) | (1 << j)


def _load_0111(v: int, j: int) -> int:
    """clear bit j, set bits below j."""
    return (v & ~((1 << (j + 1)) - 1)) | ((1 << j) - 1)


def next_jump_in(z, qL: np.ndarray, qU: np.ndarray, theta: Theta):
    """BIGMIN with >= semantics: smallest z-address >= z inside the query."""
    z = int(z)
    minv = [int(v) for v in qL]
    maxv = [int(v) for v in qU]
    dim = theta.dim_of_pos
    bit = theta.bit_of_pos
    bigmin = None

    def f_of(coords):
        return encode_scalar(coords, theta)

    for pos in range(theta.d * theta.K - 1, -1, -1):
        i, j = int(dim[pos]), int(bit[pos])
        zb = (z >> pos) & 1
        lb = (minv[i] >> j) & 1
        hb = (maxv[i] >> j) & 1
        if zb == 0 and lb == 0 and hb == 0:
            continue
        if zb == 0 and lb == 0 and hb == 1:
            cand = list(minv)
            cand[i] = _load_1000(cand[i], j)
            bigmin = f_of(cand)
            maxv[i] = _load_0111(maxv[i], j)
            continue
        if zb == 0 and lb == 1:
            return f_of(minv)  # whole remaining query range > z prefix
        if zb == 1 and hb == 0:
            return bigmin  # whole remaining range < z prefix
        if zb == 1 and lb == 0 and hb == 1:
            minv[i] = _load_1000(minv[i], j)
            continue
        # zb == 1, lb == 1, hb == 1
        continue
    return z  # z itself decodes into the query window


def fnz_query(index: LMSFCIndex, qL: np.ndarray, qU: np.ndarray) -> QueryStats:
    """UB-tree style scan: after each page, jump to the next true-positive
    z-address (one forward-index access per true-positive page)."""
    stats = QueryStats()
    if not isinstance(index.curve, GlobalTheta):
        # BIGMIN's bit-walk assumes ONE fixed (dim, bit) per output position;
        # piecewise curves change that per region, so the walk is undefined.
        raise TypeError(
            f"FNZ skipping requires a GlobalTheta curve, got "
            f"{type(index.curve).__name__}; use skipping='rqs'")
    theta = index.theta
    zlo = int(encode_np(qL[None], theta)[0])
    zhi = int(encode_np(qU[None], theta)[0])
    total = 0
    z = zlo
    while z is not None and z <= zhi:
        p = int(index.page_of(np.uint64(z))[0])
        stats.index_accesses += 1
        total += _scan_page(index, p, qL, qU, stats)
        if p + 1 >= index.num_pages:
            break
        z_next = int(index.page_zmin[p + 1])
        if z_next > zhi:
            break
        z = next_jump_in(z_next, qL, qU, theta)
    stats.result = total
    stats.subqueries = 1
    return stats
