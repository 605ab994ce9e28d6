"""Synthetic datasets shaped like the paper's three real datasets (§7.1).

The container is offline, so we generate distribution-matched surrogates:
  * osm   — 2-D, heavy spatial clustering (GMM of city-like clusters over a
            continent-scale bounding box) — matches OSM North America's
            clustered GPS points.
  * nyc   — 3-D (pickup-location-1D-projected, trip distance, total amount):
            correlated, heavy-tailed marginals.
  * stock — 4-D (high, low, adj-close, volume): near-degenerate correlation
            between price columns + log-normal volume.

All datasets are scaled to duplicate-free integers in [0, 2^K - 1]^d with
K = default_K(d), mirroring the paper's preprocessing.
"""
from __future__ import annotations

import numpy as np

from ..core.theta import default_K


def _to_int_grid(x: np.ndarray, K: int) -> np.ndarray:
    """Scale each column to [0, 2^K-1] integers; drop duplicate rows."""
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    scaled = (x - lo) / span * (2.0**K - 1.0)
    ints = np.minimum(np.floor(scaled), 2.0**K - 1.0).astype(np.uint64)
    ints = np.unique(ints, axis=0)  # paper removes duplicates
    return ints


def make_osm(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_clusters = 64
    centers = rng.uniform(0, 1, size=(n_clusters, 2))
    weights = rng.pareto(1.2, n_clusters) + 0.05
    weights /= weights.sum()
    sizes = rng.multinomial(int(n * 0.9), weights)
    pts = []
    for c, s in zip(range(n_clusters), sizes):
        sigma = rng.uniform(0.002, 0.03)
        pts.append(centers[c] + rng.normal(0, sigma, size=(s, 2)))
    pts.append(rng.uniform(0, 1, size=(n - sum(sizes), 2)))  # rural noise
    x = np.clip(np.concatenate(pts), 0, 1)
    return _to_int_grid(x, default_K(2))


def make_nyc(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # pickup location along a few dense corridors
    loc = np.concatenate([
        rng.normal(0.4, 0.05, size=int(n * 0.6)),
        rng.normal(0.7, 0.08, size=int(n * 0.3)),
        rng.uniform(0, 1, size=n - int(n * 0.6) - int(n * 0.3)),
    ])
    dist = rng.gamma(2.0, 1.5, size=n)                     # trip miles
    fare = 2.5 + 2.6 * dist + rng.gamma(2.0, 2.0, size=n)  # correlated amount
    x = np.stack([np.clip(loc, 0, 1), dist, fare], axis=1)
    return _to_int_grid(x, default_K(3))


def make_stock(n: int, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.exp(rng.normal(3.0, 1.2, size=n))            # price level
    spread = np.abs(rng.normal(0, 0.03, size=n)) * base
    high = base + spread
    low = base - spread
    close = low + rng.uniform(0, 1, size=n) * (high - low)
    vol = np.exp(rng.normal(11.0, 2.0, size=n))
    x = np.stack([high, low, close, vol], axis=1)
    return _to_int_grid(np.log1p(x), default_K(4))


DATASETS = {"osm": make_osm, "nyc": make_nyc, "stock": make_stock}


def make_dataset(name: str, n: int, seed: int = 0) -> np.ndarray:
    return DATASETS[name](n, seed)


# ---------------------------------------------------------------------------
# chunked generation (out-of-core builds: repro.store, bench_scale)
# ---------------------------------------------------------------------------

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in/out, wrapping)."""
    x = (np.asarray(x, dtype=np.uint64) + _SM_GAMMA)
    x = (x ^ (x >> np.uint64(30))) * _SM_M1
    x = (x ^ (x >> np.uint64(27))) * _SM_M2
    return x ^ (x >> np.uint64(31))


def iter_chunks(n: int, chunk: int, seed: int = 0, *, d: int = 3,
                K: int = None):
    """Yield `n` clustered, duplicate-free rows in (at most) `chunk`-row
    pieces, deterministically — the streaming producer for 10M+-row
    `repro.store` builds and `bench_scale.py`, where materializing the
    dataset is exactly what we must not do.

    Every row is a pure function of ``(seed, row id)`` (splitmix64
    hashing), so the stream is independent of `chunk`: any chunking of
    the same ``(n, seed, d, K)`` yields the same rows in the same order,
    and a subsampled prefix can serve as an in-memory oracle for the
    full build.  Duplicate-freedom is by construction: each dimension's
    low ``b = ceil(log2(n)/d)`` bits carry a disjoint slice of the row
    id, while the high ``K - b`` bits are OSM-like clustered noise (64
    Pareto-ish weighted centers + triangular jitter).
    """
    if n < 1 or chunk < 1:
        raise ValueError(f"need n >= 1 and chunk >= 1; got n={n}, "
                         f"chunk={chunk}")
    K = K or default_K(d)
    b = -(-max(int(n) - 1, 1).bit_length() // d)
    if b >= K:
        raise ValueError(f"n={n} rows need {b} id bits/dim but K={K} "
                         f"leaves no room for structure; raise K or d")
    top = K - b
    n_clusters = 64
    # scalar seed mixes wrap in python ints (numpy warns on scalar wrap)
    mask64 = (1 << 64) - 1
    seed_c = np.uint64((int(seed) * 0xD1342543DE82EF95) & mask64)
    seed_h = np.uint64((int(seed) * int(_SM_M1)) & mask64)
    base = _splitmix64(seed_c + np.arange(n_clusters * d, dtype=np.uint64))
    centers = (base % (np.uint64(1) << np.uint64(top))).reshape(
        n_clusters, d)
    # Pareto-ish cluster weights via a power-law rank map (deterministic)
    rank = _splitmix64(np.uint64(seed) + np.arange(n_clusters,
                                                   dtype=np.uint64))
    order = np.argsort(rank, kind="stable")
    width = np.uint64(max(1, (1 << top) // 16))
    lim = np.int64(1 << top) - 1
    bmask = (np.uint64(1) << np.uint64(b)) - np.uint64(1)
    for s in range(0, int(n), int(chunk)):
        gid = np.arange(s, min(s + chunk, n), dtype=np.uint64)
        h = _splitmix64(gid ^ seed_h)
        # power-law cluster pick: square a uniform rank so low ranks
        # (heavy clusters) dominate
        u = (h >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        cid = order[np.minimum((u * u * n_clusters).astype(np.int64),
                               n_clusters - 1)]
        out = np.empty((len(gid), d), dtype=np.uint64)
        for i in range(d):
            hi = _splitmix64(h + np.uint64((i * int(_SM_GAMMA)) & mask64))
            off = ((hi % width).astype(np.int64)
                   + ((hi >> np.uint64(20)) % width).astype(np.int64)
                   - np.int64(width))
            topv = np.clip(centers[cid, i].astype(np.int64) + off, 0, lim)
            low = (gid >> np.uint64(i * b)) & bmask
            out[:, i] = (topv.astype(np.uint64) << np.uint64(b)) | low
        yield out
