"""Query rectangles for the split tests, on the CPU and on the card (no
JAX here, so the card tests can import it)."""
import numpy as np


def queries(seed, Q, d, K):
    """(Q, d, 2) uint64 rects, including dims with qL == qU, dims pinned
    at 0, and (at K = 32) bounds with bit 31 set."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**K, size=(Q, d), dtype=np.uint64)
    b = rng.integers(0, 2**K, size=(Q, d), dtype=np.uint64)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[0, 0] = hi[0, 0]                        # qL == qU
    lo[1, :], hi[1, :] = 0, 0                  # qU == 0 in every dim
    lo[2, -1], hi[2, -1] = 0, 0
    lo[3], hi[3] = 0, 2**K - 1                 # the whole domain
    return np.stack([lo, hi], axis=-1)
