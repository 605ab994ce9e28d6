"""The pluggable monotonic-SFC layer: one `MonotonicCurve` protocol spanning
the numpy oracle, the torch/CUDA serving path, and the SMBO search surface.

LMSFC's thesis is that the *curve* is the learnable object.  The seed repo
hard-wired one family (a single global bit permutation `Theta`) by concrete
type through every layer; this module turns the curve into an interface so
splitting, cost evaluation, SMBO, index construction, and all serving
engines are generic over it.

Implementations
---------------
`GlobalTheta`
    The paper's family (§4.3): one bit permutation applied everywhere.
    Thin adapter over `core.theta.Theta` + `core.sfc`.

`PiecewiseCurve`
    A BMTree-style piecewise curve (PAPERS.md: Li et al., "Towards Designing
    and Learning Piecewise Space-Filling Curves"): the key space is cut into
    a uniform quadtree of `2^(d*depth)` regions by the top `depth` bits of
    every dimension, each leaf region carries an *independent* θ over the
    remaining low bits, and regions are ordered by a monotone bit-interleaved
    prefix occupying the top `d*depth` output bits.

    Theorem-1 monotonicity is enforced **by construction**: every region's
    effective full-width permutation is ``leaf_seq + prefix_order*depth``,
    a valid multiset permutation (validated by `Theta.__post_init__`), and
    all regions assign the *same* output positions to the prefix bits.  For
    componentwise a <= b: walk the output bits from the MSB down.  While the
    emitted bits agree, both points follow the same prefix path, so for each
    dimension the consumed bits are exactly its top bits, contiguously; at
    the first disagreement, equal higher bits of that dimension plus
    a[i] <= b[i] force bit(a) = 0 < 1 = bit(b), hence f(a) < f(b).  If no
    prefix bit disagrees, both points land in the same region and the leaf θ
    (a valid monotone member of the paper's family) decides.  ∎
    (Property-tested in tests/test_curve.py.)

Protocol surface
----------------
encode_np / decode_np   — uint64 oracle (index construction, CPU engine)
encode_scalar           — python-int single-point encode (split hot path)
encode_torch            — (..., d) int32 -> (..., 2) int32 Z64 (device serving)
curve_tables            — the curve as (pos, reg) data (the plain encode)
curve_lut               — its nibble lookup tables, for the CUDA kernel
split_cut/split_cuts_np — Lemma-2 cut candidates (scalar + vectorized)
optimal_1split          — best single split for the recursive splitter
features/neighbors/random — the SMBO search surface
to_json / curve_from_json — registry-dispatched round-trip serialization
"""
from __future__ import annotations

import dataclasses
import json
from typing import ClassVar

import numpy as np
import torch

from . import sfc as sfc_mod
from . import theta as theta_mod
from .theta import Theta

_CURVE_KINDS = {}


def register_curve(cls):
    """Class decorator: make `cls` JSON round-trippable via its `kind`."""
    _CURVE_KINDS[cls.kind] = cls
    return cls


class MonotonicCurve:
    """A monotone map f: [0, 2^K)^d -> [0, 2^(dK)) (Theorem 1 by construction).

    Subclasses provide `d`/`K` attributes plus the encode/decode quartet and
    the SMBO surface; the split hooks below have generic defaults valid for
    any bit-aligned monotone curve.
    """

    kind: ClassVar[str] = "?"

    # -- encode/decode ------------------------------------------------------
    def encode_np(self, x: np.ndarray) -> np.ndarray:
        """(..., d) unsigned ints (< 2^K) -> (...,) uint64 z-address."""
        raise NotImplementedError

    def decode_np(self, z: np.ndarray) -> np.ndarray:
        """(...,) uint64 z-address -> (..., d) uint64 coords (inverse)."""
        raise NotImplementedError

    def encode_scalar(self, coords) -> int:
        """Single-point encode on python ints (query-splitting hot path)."""
        raise NotImplementedError

    def encode_torch(self, x):
        """(..., d) int32 (unsigned semantics) -> (..., 2) int32 Z64."""
        raise NotImplementedError

    # -- split hooks (paper §6, Lemma 2) ------------------------------------
    def split_cut(self, lo: int, up: int) -> int:
        """Lemma-2 cut for one dimension's bounds lo < up:
        v* = (up >> l) << l with l = MSB(lo XOR up)."""
        l = (lo ^ up).bit_length() - 1
        return (up >> l) << l

    def split_cuts_np(self, qL: np.ndarray, qU: np.ndarray) -> np.ndarray:
        """Vectorized `split_cut` over (..., d) uint64 bounds; entries with
        qL >= qU get a placeholder cut of 1 (callers mask on qL < qU)."""
        qL = np.asarray(qL, dtype=np.uint64)
        qU = np.asarray(qU, dtype=np.uint64)
        l = _msb_u64(np.maximum(qL ^ qU, np.uint64(1)))
        v = (qU >> l) << l
        return np.where(qL < qU, v, np.uint64(1))

    def optimal_1split(self, qL, qU):
        """Best (delta, v, gap) single split, or None when no split removes
        a positive z-gap.  Scalar-int hot path, called ~2^k times/query."""
        qLl = [int(v) for v in qL]
        qUl = [int(v) for v in qU]
        best = None
        for delta in range(self.d):
            lo, up = qLl[delta], qUl[delta]
            if lo >= up:
                continue
            v = self.split_cut(lo, up)
            U = list(qUl)
            U[delta] = v - 1
            L = list(qLl)
            L[delta] = v
            fU = self.encode_scalar(U)
            fL = self.encode_scalar(L)
            if fL > fU:
                gap = fL - fU
                if best is None or gap > best[2]:
                    best = (delta, v, gap)
        return best

    # -- SMBO search surface -------------------------------------------------
    def features(self) -> np.ndarray:
        """Fixed-length float feature vector for the SMBO surrogate."""
        raise NotImplementedError

    def neighbors(self, rng: np.random.Generator, n: int = 8,
                  max_swaps: int = 3) -> list:
        """Local perturbations (SMBO candidate generation)."""
        raise NotImplementedError

    @classmethod
    def random(cls, rng: np.random.Generator, d: int, K: int, **kw):
        """A uniform random member of this curve family."""
        raise NotImplementedError

    # -- serialization -------------------------------------------------------
    def _to_dict(self) -> dict:
        raise NotImplementedError

    @classmethod
    def _from_dict(cls, o: dict) -> "MonotonicCurve":
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps({"kind": self.kind, **self._to_dict()})


def curve_from_json(s: str) -> MonotonicCurve:
    """Inverse of `MonotonicCurve.to_json` (registry-dispatched on `kind`)."""
    o = json.loads(s)
    kind = o.get("kind")
    if kind not in _CURVE_KINDS:
        raise ValueError(f"unknown curve kind {kind!r}; "
                         f"registered: {sorted(_CURVE_KINDS)}")
    return _CURVE_KINDS[kind]._from_dict(o)


def as_curve(c) -> MonotonicCurve:
    """Coerce legacy θ objects / JSON strings to a curve (None passes)."""
    if c is None or isinstance(c, MonotonicCurve):
        return c
    if isinstance(c, Theta):
        return GlobalTheta(c)
    if isinstance(c, str):
        return curve_from_json(c)
    raise TypeError(f"cannot interpret {type(c).__name__} as a MonotonicCurve")


def _popcount_u64(v: np.ndarray) -> np.ndarray:
    """SWAR popcount for numpy < 2.0 (no np.bitwise_count)."""
    v = v - ((v >> np.uint64(1)) & np.uint64(0x5555555555555555))
    v = ((v & np.uint64(0x3333333333333333)) +
         ((v >> np.uint64(2)) & np.uint64(0x3333333333333333)))
    v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return (v * np.uint64(0x0101010101010101)) >> np.uint64(56)


_popcount = getattr(np, "bitwise_count", _popcount_u64)


def _msb_u64(v: np.ndarray) -> np.ndarray:
    """Exact floor(log2(v)) for uint64 v > 0 (bit smear + popcount; float64
    log2 is NOT exact above 53 bits)."""
    v = np.asarray(v, dtype=np.uint64)
    for s in (1, 2, 4, 8, 16, 32):
        v = v | (v >> np.uint64(s))
    return (_popcount(v).astype(np.uint64) - np.uint64(1))


# ---------------------------------------------------------------------------
# GlobalTheta — the paper's single bit permutation, as one curve family
# ---------------------------------------------------------------------------


@register_curve
@dataclasses.dataclass(frozen=True)
class GlobalTheta(MonotonicCurve):
    """One global θ (paper §4.3) applied over the whole key space."""

    kind: ClassVar[str] = "global"

    theta: Theta

    @property
    def d(self) -> int:
        return self.theta.d

    @property
    def K(self) -> int:
        return self.theta.K

    # -- encode/decode ------------------------------------------------------
    def encode_np(self, x):
        return sfc_mod.encode_np(x, self.theta)

    def decode_np(self, z):
        return sfc_mod.decode_np(z, self.theta)

    def encode_scalar(self, coords) -> int:
        return sfc_mod.encode_scalar(coords, self.theta)

    def encode_torch(self, x):
        return sfc_mod.encode_torch(x, self.theta)

    # -- SMBO surface --------------------------------------------------------
    def features(self) -> np.ndarray:
        return self.theta.features()

    def neighbors(self, rng, n=8, max_swaps=3):
        return [GlobalTheta(t)
                for t in theta_mod.neighbors(self.theta, rng, n=n,
                                             max_swaps=max_swaps)]

    @classmethod
    def random(cls, rng, d, K, **kw):
        return cls(theta_mod.random_theta(rng, d, K))

    # -- serialization -------------------------------------------------------
    def _to_dict(self):
        return {"d": self.d, "K": self.K,
                "seq": [int(v) for v in self.theta.seq]}

    @classmethod
    def _from_dict(cls, o):
        return cls(Theta(o["d"], o["K"], tuple(o["seq"])))


# ---------------------------------------------------------------------------
# PiecewiseCurve — BMTree-style quadtree of per-region θ
# ---------------------------------------------------------------------------


@register_curve
@dataclasses.dataclass(frozen=True)
class PiecewiseCurve(MonotonicCurve):
    """Uniform quadtree partition with an independent θ per leaf region.

    The top `depth` bits of every dimension select one of `2^(d*depth)`
    regions; those bits occupy the top `d*depth` output positions in
    `prefix_order` interleave (the monotone inter-region prefix), and the
    low `K-depth` bits of each dimension are scrambled by that region's
    `leaf_thetas[r]` into the low output positions.  See the module
    docstring for the by-construction Theorem-1 proof.
    """

    kind: ClassVar[str] = "piecewise"

    d: int
    K: int
    depth: int
    leaf_thetas: tuple      # 2^(d*depth) members of Theta(d, K - depth)
    prefix_order: tuple = None  # per-level dim interleave, LSB-first

    def __post_init__(self):
        if self.prefix_order is None:
            object.__setattr__(self, "prefix_order", tuple(range(self.d)))
        else:
            object.__setattr__(self, "prefix_order",
                               tuple(int(v) for v in self.prefix_order))
        if not (1 <= self.depth < self.K):
            raise ValueError(f"depth must be in [1, K); got depth={self.depth}"
                             f" with K={self.K}")
        if self.d * self.depth > 31:
            raise ValueError(f"d*depth={self.d * self.depth} > 31: region "
                             f"codes must fit an int32 on the device path")
        if sorted(self.prefix_order) != list(range(self.d)):
            raise ValueError(f"prefix_order must be a permutation of "
                             f"range({self.d}); got {self.prefix_order}")
        if len(self.leaf_thetas) != self.num_regions:
            raise ValueError(f"need {self.num_regions} leaf thetas "
                             f"(2^(d*depth)); got {len(self.leaf_thetas)}")
        for t in self.leaf_thetas:
            if not isinstance(t, Theta) or t.d != self.d or \
                    t.K != self.K - self.depth:
                raise ValueError(f"every leaf must be a Theta(d={self.d}, "
                                 f"K={self.K - self.depth}); got {t!r}")
        object.__setattr__(self, "_full_cache", {})

    # -- structure ----------------------------------------------------------
    @property
    def num_regions(self) -> int:
        return 1 << (self.d * self.depth)

    @property
    def _low_bits(self) -> int:
        return self.K - self.depth

    @property
    def _prefix_shift(self) -> int:
        """Output position where the region prefix starts."""
        return self.d * self._low_bits

    def full_theta(self, r: int) -> Theta:
        """Region r's effective full-width permutation — a *valid* member of
        the paper's family, which is what makes monotonicity constructive."""
        t = self._full_cache.get(r)
        if t is None:
            seq = tuple(self.leaf_thetas[r].seq) + self.prefix_order * self.depth
            t = Theta(self.d, self.K, seq)
            self._full_cache[r] = t
        return t

    # -- region resolution ---------------------------------------------------
    def region_np(self, x: np.ndarray) -> np.ndarray:
        """(..., d) uint64 -> (...,) uint64 region code (== z >> prefix_shift)."""
        x = np.asarray(x, dtype=np.uint64)
        low = self._low_bits
        r = np.zeros(x.shape[:-1], dtype=np.uint64)
        for m in range(self.d * self.depth):
            i = self.prefix_order[m % self.d]
            j = low + m // self.d
            r |= ((x[..., i] >> np.uint64(j)) & np.uint64(1)) << np.uint64(m)
        return r

    def _region_scalar(self, coords) -> int:
        low = self._low_bits
        r = 0
        for m in range(self.d * self.depth):
            i = self.prefix_order[m % self.d]
            j = low + m // self.d
            r |= ((int(coords[i]) >> j) & 1) << m
        return r

    # -- encode/decode ------------------------------------------------------
    def encode_np(self, x):
        x = np.asarray(x, dtype=np.uint64)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.d)
        r = self.region_np(x2)
        z = np.zeros(len(x2), dtype=np.uint64)
        for code in np.unique(r):
            m = r == code
            z[m] = sfc_mod.encode_np(x2[m], self.full_theta(int(code)))
        return z.reshape(lead)

    def decode_np(self, z):
        z = np.asarray(z, dtype=np.uint64)
        lead = z.shape
        z2 = z.reshape(-1)
        r = z2 >> np.uint64(self._prefix_shift)
        x = np.zeros((len(z2), self.d), dtype=np.uint64)
        for code in np.unique(r):
            m = r == code
            x[m] = sfc_mod.decode_np(z2[m], self.full_theta(int(code)))
        return x.reshape(lead + (self.d,))

    def encode_scalar(self, coords) -> int:
        return sfc_mod.encode_scalar(
            coords, self.full_theta(self._region_scalar(coords)))

    def encode_torch(self, x):
        # The region code picks one row of the (R, T) position table (each
        # row is that region's full-width θ); one gather replaces the
        # reference's R mask-selected low-bit chains with the same result.
        pos, reg = curve_tables(self, x.device)
        return sfc_mod.encode_table_torch(x, pos, reg)

    # -- SMBO surface --------------------------------------------------------
    def features(self) -> np.ndarray:
        return np.concatenate([t.features() for t in self.leaf_thetas])

    def neighbors(self, rng, n=8, max_swaps=3):
        out = []
        for _ in range(n):
            leaves = list(self.leaf_thetas)
            for _ in range(int(rng.integers(1, max_swaps + 1))):
                li = int(rng.integers(0, len(leaves)))
                leaves[li] = theta_mod.neighbors(leaves[li], rng, n=1,
                                                 max_swaps=1)[0]
            out.append(dataclasses.replace(self, leaf_thetas=tuple(leaves)))
        return out

    @classmethod
    def random(cls, rng, d, K, *, depth: int = 1, prefix_order=None, **kw):
        n_leaves = 1 << (d * depth)
        leaves = tuple(theta_mod.random_theta(rng, d, K - depth)
                       for _ in range(n_leaves))
        return cls(d, K, depth, leaves, prefix_order)

    @classmethod
    def uniform(cls, leaf_theta: Theta, *, depth: int = 1, prefix_order=None):
        """All regions share `leaf_theta` — the piecewise embedding of a
        global curve (useful as an SMBO anchor)."""
        d, lk = leaf_theta.d, leaf_theta.K
        n_leaves = 1 << (d * depth)
        return cls(d, lk + depth, depth, (leaf_theta,) * n_leaves,
                   prefix_order)

    # -- serialization -------------------------------------------------------
    def _to_dict(self):
        return {"d": self.d, "K": self.K, "depth": self.depth,
                "prefix_order": list(self.prefix_order),
                "leaves": [[int(v) for v in t.seq] for t in self.leaf_thetas]}

    @classmethod
    def _from_dict(cls, o):
        leaves = tuple(Theta(o["d"], o["K"] - o["depth"], tuple(s))
                       for s in o["leaves"])
        return cls(o["d"], o["K"], o["depth"], leaves,
                   tuple(o["prefix_order"]))


# ---------------------------------------------------------------------------
# candidate pools — curves packed as arrays for device-resident evaluation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CurvePool:
    """P candidate curves packed as plain int32 arrays, so one program (the
    table-driven `sfc.encode_table_torch` and the CUDA `sfc_encode` kernel)
    encodes under any of them without per-curve compilation.

    Shape contract (the pool axis is always leading):
      pos (P, R, T) — output position of flat input bit t = i*K + j, per
                      region; R = max region count over the pool, rows past
                      a curve's own count repeat row 0 (unreachable padding)
      reg (P, M)    — flat input-bit index feeding region-code bit m; the
                      sentinel index T selects a constant-zero bit plane, so
                      global curves (and shallower quadtrees) pad with T and
                      keep region code 0
      lut (P, R, d, C, 16) int64, optional — `sfc.lut_tables(pos, d, K)`,
                      the CUDA kernel's nibble tables; a caller that encodes
                      under one pool many times builds it once
    """

    pos: np.ndarray         # (P, R, T) int32
    reg: np.ndarray         # (P, M) int32
    d: int
    K: int
    lut: object = None

    def __len__(self) -> int:
        return len(self.pos)


def pack_curve_pool(curves) -> CurvePool:
    """Pack a mixed global/piecewise candidate pool (shared d and K) into a
    `CurvePool`.  Cost: one `pos_of_bit` layout per region per curve."""
    curves = [as_curve(c) for c in curves]
    if not curves:
        raise ValueError("empty candidate pool")
    d, K = curves[0].d, curves[0].K
    for c in curves:
        if c.d != d or c.K != K:
            raise ValueError(f"pool mixes shapes: ({c.d}, {c.K}) vs ({d}, {K})")
    T = d * K
    R = max((c.num_regions if isinstance(c, PiecewiseCurve) else 1)
            for c in curves)
    M = max([d * c.depth for c in curves
             if isinstance(c, PiecewiseCurve)] + [1])
    pos = np.zeros((len(curves), R, T), dtype=np.int32)
    reg = np.full((len(curves), M), T, dtype=np.int32)   # default: zero plane
    for p, c in enumerate(curves):
        if isinstance(c, PiecewiseCurve):
            low = c.K - c.depth
            for m in range(c.d * c.depth):
                i = c.prefix_order[m % c.d]
                reg[p, m] = i * K + (low + m // c.d)
            for r in range(c.num_regions):
                pos[p, r] = c.full_theta(r).pos_of_bit.ravel()
        elif isinstance(c, GlobalTheta):
            pos[p, :] = c.theta.pos_of_bit.ravel()
        else:
            raise TypeError(f"cannot pack curve kind {type(c).__name__!r}")
        if isinstance(c, PiecewiseCurve) and c.num_regions < R:
            pos[p, c.num_regions:] = pos[p, 0]
    return CurvePool(pos=pos, reg=reg, d=d, K=K)


def device_curve_pool(curves, device) -> CurvePool:
    """`pack_curve_pool` of `curves` with ``pos`` and ``reg`` on `device`
    and its ``lut`` built there once, for a caller that encodes under one
    pool many times (an SMBO round: the key encode, then every encode of
    the pooled program)."""
    cp = pack_curve_pool(curves)
    pos = torch.as_tensor(cp.pos, device=device)
    return CurvePool(pos=pos, reg=torch.as_tensor(cp.reg, device=device),
                     d=cp.d, K=cp.K, lut=sfc_mod.lut_tables(pos, cp.d, cp.K))


def curve_tables(curve, device) -> tuple:
    """One curve as data: its `pack_curve_pool` row, ``pos`` (R, T) and
    ``reg`` (M,) int32 tensors on `device`.  Cached on the curve object
    (curves are frozen, so the tables never go stale)."""
    curve = as_curve(curve)
    cache = curve.__dict__.setdefault("_tables", {})
    key = str(torch.device(device))
    if key not in cache:
        pool = pack_curve_pool([curve])
        cache[key] = (torch.as_tensor(pool.pos[0], device=device),
                      torch.as_tensor(pool.reg[0], device=device))
    return cache[key]


def curve_lut(curve, device) -> torch.Tensor:
    """The curve's nibble lookup tables (R, d, C, 16) int64 on `device`
    (`sfc.lut_tables` of its ``pos``), cached beside `curve_tables`."""
    curve = as_curve(curve)
    cache = curve.__dict__.setdefault("_tables", {})
    key = ("lut", str(torch.device(device)))
    if key not in cache:
        pos, _ = curve_tables(curve, device)
        cache[key] = sfc_mod.lut_tables(pos, curve.d, curve.K)
    return cache[key]


# ---------------------------------------------------------------------------
# family factories (shared by SMBO init and the Database facade)
# ---------------------------------------------------------------------------


def default_curve(d: int, K: int, family: str = "global",
                  depth: int = 1) -> MonotonicCurve:
    """The family's canonical member (z-order / uniform z-order leaves)."""
    if family == "global":
        return GlobalTheta(theta_mod.zorder(d, K))
    if family == "piecewise":
        return PiecewiseCurve.uniform(theta_mod.zorder(d, K - depth),
                                      depth=depth)
    raise ValueError(f"unknown curve family {family!r}; "
                     f"expected 'global' or 'piecewise'")


def init_curves(d: int, K: int, family: str = "global",
                depth: int = 1) -> list:
    """Deterministic SMBO design anchors for a family (Algorithm 1, line 1):
    z-order plus the per-dimension major orders — for the piecewise family,
    their uniform leaf embeddings."""
    orders = [theta_mod.zorder, theta_mod.major_order,
              lambda d_, K_: theta_mod.major_order(d_, K_,
                                                   list(reversed(range(d_))))]
    if family == "global":
        return [GlobalTheta(f(d, K)) for f in orders]
    if family == "piecewise":
        return [PiecewiseCurve.uniform(f(d, K - depth), depth=depth)
                for f in orders]
    raise ValueError(f"unknown curve family {family!r}")


def random_curve(rng: np.random.Generator, d: int, K: int,
                 family: str = "global", depth: int = 1) -> MonotonicCurve:
    if family == "global":
        return GlobalTheta.random(rng, d, K)
    if family == "piecewise":
        return PiecewiseCurve.random(rng, d, K, depth=depth)
    raise ValueError(f"unknown curve family {family!r}")
