"""The parameterized monotonic SFC family (paper §4.3).

A parameter θ assigns every input bit (dimension i, bit j) to a distinct
output bit position l of the z-address, subject to the paper's three
constraints:

  (1) θ_j^(i) ∈ {2^0 .. 2^{Kd-1}}          — positions are powers of two
  (2) all θ_j^(i) distinct                  — bijective
  (3) j < j' ⇒ θ_j^(i) < θ_j'^(i)           — per-dimension bit order kept

which is exactly the set of *multiset permutations*: a sequence
``seq ∈ {0..d-1}^{Kd}`` with each dimension appearing K times, where
``seq[l]`` names the dimension whose next-lowest unused bit lands at output
position l (l = 0 is the least significant output bit).  Constraint (3) holds
by construction; (1)/(2) because each l is used exactly once.

|family| = (Kd)!/(K!)^d  (paper Lemma 1).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class Theta:
    """A monotonic SFC parameter."""

    d: int
    K: int
    seq: tuple  # length K*d, values in [0, d), each value appears K times

    def __post_init__(self):
        seq = np.asarray(self.seq, dtype=np.int64)
        if seq.shape != (self.d * self.K,):
            raise ValueError(f"seq must have length K*d={self.d * self.K}")
        counts = np.bincount(seq, minlength=self.d)
        if not np.all(counts == self.K):
            raise ValueError("each dimension must appear exactly K times")

    # -- derived layouts ----------------------------------------------------
    @property
    def dim_of_pos(self) -> np.ndarray:
        """(Kd,) dimension index feeding output position l."""
        return np.asarray(self.seq, dtype=np.int32)

    @property
    def bit_of_pos(self) -> np.ndarray:
        """(Kd,) source bit index j (within its dimension) at position l.

        out[l] = rank of l among the positions owned by seq[l].  A stable
        argsort groups each dimension's K positions contiguously in position
        order, so the within-group rank is just the sorted index mod K (this
        runs once per SMBO candidate per surrogate fit — the per-position
        Python counter loop it replaces showed up in learn_sfc profiles).
        """
        seq = self.dim_of_pos
        out = np.empty_like(seq)
        out[np.argsort(seq, kind="stable")] = \
            np.arange(seq.size, dtype=np.int32) % self.K
        return out

    @property
    def pos_of_bit(self) -> np.ndarray:
        """(d, K) output position of bit (i, j)."""
        out = np.zeros((self.d, self.K), dtype=np.int32)
        out[self.dim_of_pos, self.bit_of_pos] = np.arange(self.d * self.K)
        return out

    def theta_values(self) -> np.ndarray:
        """The paper's θ_j^(i) = 2^pos as uint64 (d, K).  Requires Kd <= 64."""
        return (np.uint64(1) << self.pos_of_bit.astype(np.uint64))

    # -- features for the SMBO surrogate ------------------------------------
    def features(self) -> np.ndarray:
        """(d*K,) normalized output position of each input bit, MSB-aligned
        per dimension (fixed-length, permutation-equivariant per dim)."""
        return (self.pos_of_bit.astype(np.float64) / (self.d * self.K - 1)).ravel()

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"d": self.d, "K": self.K, "seq": list(map(int, self.seq))})

    @staticmethod
    def from_json(s: str) -> "Theta":
        o = json.loads(s)
        return Theta(o["d"], o["K"], tuple(o["seq"]))


# ---------------------------------------------------------------------------
# well-known family members
# ---------------------------------------------------------------------------


def zorder(d: int, K: int) -> Theta:
    """Classic bit-interleaved z-order: θ_j^(i) = 2^{(j-1)d + (i-1)}."""
    return Theta(d, K, tuple(int(l % d) for l in range(K * d)))


def major_order(d: int, K: int, order=None) -> Theta:
    """Row/column-major family: dims listed in ``order`` from *least* to
    *most* significant.  major_order(d,K,[1,0]) == column-major of Fig 2(c)
    for d=2 (dim 0 owns the top bits)."""
    if order is None:
        order = list(range(d))
    seq = []
    for i in order:
        seq.extend([int(i)] * K)
    return Theta(d, K, tuple(seq))


def random_theta(rng: np.random.Generator, d: int, K: int) -> Theta:
    seq = np.repeat(np.arange(d), K)
    rng.shuffle(seq)
    return Theta(d, K, tuple(int(v) for v in seq))


def neighbors(theta: Theta, rng: np.random.Generator, n: int = 8,
              max_swaps: int = 3) -> list:
    """Local perturbations: 1..max_swaps random transpositions of unequal
    labels (SMBO candidate generation)."""
    out = []
    seq = np.asarray(theta.seq)
    for _ in range(n):
        s = seq.copy()
        for _ in range(int(rng.integers(1, max_swaps + 1))):
            a, b = rng.integers(0, len(s), size=2)
            s[a], s[b] = s[b], s[a]
        out.append(Theta(theta.d, theta.K, tuple(int(v) for v in s)))
    return out


def default_K(d: int) -> int:
    """Paper §7.1: 64-bit addresses, K = floor(64/d) (capped at 32/dim)."""
    return min(32, 64 // d)
