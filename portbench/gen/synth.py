"""Synthetic datasets shaped like the LMSFC paper's three real datasets
(section 7.1), frozen here so that the benchmark's data cannot move with
the program, and drawn on the device in a few large calls.

  * osm   - 2-d, heavy spatial clustering (64 city-like Gaussian clusters
            with Pareto weights over a continent-scale box, 10% uniform
            rural noise), like OSM North America's GPS points.
  * nyc   - 3-d (pickup location projected to 1-d, trip distance, total
            amount): correlated, heavy-tailed marginals, like NYC taxi trips.
  * stock - 4-d (high, low, adjusted close, volume): near-degenerate
            correlation between the prices and a log-normal volume.

Each is scaled to duplicate-free integers in [0, 2^K - 1]^d with
K = default_K(d), the paper's preprocessing.  The distributions are those
of `repro_torch.data.synth`; the draws are torch's (a `torch.Generator`
on the device, seeded from the run's seed), not numpy's.

osm's geography (the clusters' centres, weights, row counts and widths)
is drawn from `layout_seed`, which the configuration fixes, with numpy as
the original draws it; the run's seed draws the rows.

The integer grid is the deployment's too (`Deployment`): each column is
scaled by the least and greatest value of the rows drawn from the layout
seed (the reference rows), and a run's rows are put on that grid, values
beyond it clamped to its edges.  The original scales each draw by its own
extremes, so nyc's grid, set by its heavy-tailed distance and fare, moved
with the seed, and with it the share of rows a fixed window holds.
"""
from __future__ import annotations

import numpy as np
import torch


def default_K(d: int) -> int:
    """Bits a dimension: 64-bit addresses, K = floor(64/d), at most 32."""
    return min(32, 64 // d)


def unique_rows(ints: torch.Tensor, K: int) -> torch.Tensor:
    """The distinct rows of (n, d) int64 `ints` in [0, 2^K), in
    lexicographic order, on their device (`np.unique(rows, axis=0)`).
    Rows of d*K <= 64 bits are packed into one int64 key with dimension 0
    in the high bits and sorted once; at d*K == 64 dimension 0 is shifted
    down by 2^(K-1) first, so that signed key order is row order."""
    n, d = ints.shape
    if d * K > 64:
        return torch.unique(ints, dim=0)
    shift0 = (1 << (K - 1)) if d * K == 64 else 0
    key = ints[:, 0] - shift0
    for i in range(1, d):
        key = (key << K) | ints[:, i]
    key = torch.unique(key, sorted=True)
    out = torch.empty((len(key), d), dtype=torch.int64, device=key.device)
    mask = (1 << K) - 1
    for i in range(d - 1, 0, -1):
        out[:, i] = key & mask
        key = key >> K
    out[:, 0] = key + shift0
    return out


def to_grid(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            K: int) -> torch.Tensor:
    """Float64 rows `x` scaled column by column from [lo, hi] to integers
    in [0, 2^K-1] (values beyond clamped), duplicates dropped: (m, d)
    int64 on `x`'s device, in lexicographic order."""
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    scaled = (x - lo) / span * (2.0**K - 1.0)
    ints = torch.clamp(torch.floor(scaled), 0.0, 2.0**K - 1.0)
    return unique_rows(ints.to(torch.int64), K)


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def osm_layout(n: int, layout_seed: int) -> tuple:
    """The 64 clusters' centres (64, 2), row counts (64,) and widths (64,),
    drawn as `repro_torch.data.synth.make_osm` draws them (the widths
    after the counts, not between the clusters' rows)."""
    rng = np.random.default_rng(layout_seed)
    n_clusters = 64
    centers = rng.uniform(0, 1, size=(n_clusters, 2))
    weights = rng.pareto(1.2, n_clusters) + 0.05
    weights /= weights.sum()
    sizes = rng.multinomial(int(n * 0.9), weights)
    sigmas = rng.uniform(0.002, 0.03, size=n_clusters)
    return centers, sizes, sigmas


def draw_osm(n: int, seed: int, device="cpu", layout_seed: int = 0):
    centers, sizes, sigmas = osm_layout(n, layout_seed)
    g = _gen(seed, device)
    cid = torch.repeat_interleave(torch.arange(len(sizes), device=device),
                                  torch.from_numpy(sizes).to(device))
    c = torch.from_numpy(centers).to(device)[cid]
    s = torch.from_numpy(sigmas).to(device)[cid, None]
    pts = c + s * torch.randn(len(cid), 2, generator=g, device=device,
                              dtype=torch.float64)
    rural = torch.rand(n - len(cid), 2, generator=g, device=device,
                       dtype=torch.float64)
    return torch.clamp(torch.cat([pts, rural]), 0, 1)


def _normal(n, mean, std, g, device):
    return mean + std * torch.randn(n, generator=g, device=device,
                                    dtype=torch.float64)


def _gamma2(n, scale, g, device):
    """Gamma(shape 2, `scale`): the sum of two exponentials."""
    e = torch.empty(2, n, device=device, dtype=torch.float64)
    return scale * e.exponential_(1.0, generator=g).sum(0)


def draw_nyc(n: int, seed: int, device="cpu", layout_seed: int = None):
    g = _gen(seed, device)
    # pickup location along a few dense corridors
    n1, n2 = int(n * 0.6), int(n * 0.3)
    loc = torch.cat([
        _normal(n1, 0.4, 0.05, g, device),
        _normal(n2, 0.7, 0.08, g, device),
        torch.rand(n - n1 - n2, generator=g, device=device,
                   dtype=torch.float64)])
    dist = _gamma2(n, 1.5, g, device)                      # trip miles
    fare = 2.5 + 2.6 * dist + _gamma2(n, 2.0, g, device)   # correlated amount
    return torch.stack([torch.clamp(loc, 0, 1), dist, fare], dim=1)


def draw_stock(n: int, seed: int, device="cpu", layout_seed: int = None):
    g = _gen(seed, device)
    base = torch.exp(_normal(n, 3.0, 1.2, g, device))      # price level
    spread = torch.abs(_normal(n, 0.0, 0.03, g, device)) * base
    high = base + spread
    low = base - spread
    close = low + torch.rand(n, generator=g, device=device,
                             dtype=torch.float64) * (high - low)
    vol = torch.exp(_normal(n, 11.0, 2.0, g, device))
    return torch.log1p(torch.stack([high, low, close, vol], dim=1))


DATASETS = {"osm": draw_osm, "nyc": draw_nyc, "stock": draw_stock}


class Deployment:
    """A deployment's rows: its reference rows, drawn from `layout_seed`
    (the grid's bounds, the SMBO sample and the windows come from them),
    and the rows of any seed on the same grid."""

    def __init__(self, name: str, n: int, layout_seed: int = 0,
                 device="cpu"):
        if name not in DATASETS:
            raise ValueError(f"unknown generator {name!r}; expected one "
                             f"of {sorted(DATASETS)}")
        self.name, self.n, self.device = name, int(n), device
        self.layout_seed = int(layout_seed)
        x = self._draw(self.layout_seed)
        self.lo, self.hi = x.min(dim=0).values, x.max(dim=0).values
        self.K = default_K(x.shape[1])
        self.rows = to_grid(x, self.lo, self.hi, self.K)   # int64, device

    def _draw(self, seed: int) -> torch.Tensor:
        return DATASETS[self.name](self.n, seed, device=self.device,
                                   layout_seed=self.layout_seed)

    def rows_of(self, seed: int) -> np.ndarray:
        """(rows, d) uint64 on the host: the rows of `seed` on the grid,
        duplicate-free, lexicographically sorted."""
        rows = to_grid(self._draw(seed), self.lo, self.hi, self.K)
        return rows.cpu().numpy().astype(np.uint64)


def make_dataset(name: str, n: int, seed: int, device="cpu",
                 layout_seed: int = 0) -> np.ndarray:
    """(rows, d) uint64, duplicate-free, lexicographically sorted: the
    rows of `seed` on the grid of the deployment `layout_seed` fixes."""
    return Deployment(name, n, layout_seed, device).rows_of(seed)
