"""LM training data pipeline with LMSFC-indexed sample selection.

This is where the paper's index becomes a first-class training-framework
feature: every training example carries multi-dimensional metadata
(length, domain, quality, age) stored in an LMSFC index; each curriculum
phase is a *window query* (e.g. "quality ∈ [0.7, 1.0] ∧ length ∈ [1k, 4k]"),
answered in sub-linear time instead of a full metadata scan.

The pipeline is deterministic (seeded), resumable (state = (phase, cursor)),
and yields fixed-shape (B, S) token batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.index import IndexConfig, LMSFCIndex
from ..core.theta import default_K

META_DIMS = ("length", "domain", "quality", "age")


@dataclasses.dataclass
class CurriculumPhase:
    name: str
    window_lo: tuple   # len(META_DIMS) values in [0, 1]
    window_hi: tuple
    steps: int


def synth_corpus(n_docs: int, vocab: int, max_len: int, seed: int = 0):
    """Synthetic corpus: token arrays + 4-D metadata in [0,1]^4."""
    rng = np.random.default_rng(seed)
    meta = np.stack([
        rng.beta(2, 4, n_docs),            # length (relative)
        rng.integers(0, 8, n_docs) / 8.0,   # domain bucket
        rng.beta(5, 2, n_docs),            # quality
        rng.uniform(0, 1, n_docs),         # age
    ], axis=1)
    lengths = (32 + meta[:, 0] * (max_len - 32)).astype(np.int64)
    docs = [rng.integers(1, vocab, size=l).astype(np.int32) for l in lengths]
    return docs, meta


class IndexedDataset:
    """Metadata index + window-query sample selection.

    Selection is served through the `Database` Range query path (exact by
    construction on every engine), not a full metadata scan: the window's
    matching *unique* metadata rows come back from the index, and a
    one-time curve-order permutation of the corpus maps each row to its
    doc ids with two binary searches — O(hits · log n) per select instead
    of the old O(n · d) mask sweep (which "used" the index only inside an
    ``assert``, i.e. not at all under ``python -O``).

    Pass `database=` to serve selections from an existing store-backed
    `Database` (`Database.from_segment`) whose index holds this corpus's
    unique metadata rows; by default an in-memory Database is built over
    them on `device` (CUDA unless the caller passes ``device="cpu"``), so
    a select is a Range on the `cuda` engine on a card and on the `cpu`
    engine only under ``device="cpu"``; `learn_curve` learns the curve
    there too.  ``verify_selects=True`` cross-checks every select against
    the brute-force metadata mask and raises `RuntimeError` on any
    mismatch — a real guard (asserts are stripped under ``-O``) for
    debugging, off by default because it reintroduces the full scan it
    exists to audit.
    """

    def __init__(self, docs, meta01, seed: int = 0, learn_curve: bool = False,
                 workload=None, database=None, verify_selects: bool = False,
                 device=None):
        self.docs = docs
        d = meta01.shape[1]
        self.K = min(16, default_K(d))
        self.meta_int = np.floor(meta01 * (2**self.K - 1)).astype(np.uint64)
        self.verify_selects = verify_selects
        from ..api.database import Database      # lazy: api imports core
        if database is not None:
            self.db = database
            self.index = database.index
        else:
            theta = None
            if learn_curve and workload is not None:
                from ..core.smbo import learn_sfc     # heavy import, lazy
                Ls, Us = workload
                res = learn_sfc(self.meta_int, Ls, Us, K=self.K,
                                max_iters=3, n_init=4, evals_per_iter=2,
                                seed=seed, device=device)
                theta = res.theta_best
            self.index = LMSFCIndex.build(
                np.unique(self.meta_int, axis=0), theta=theta,
                cfg=IndexConfig(paging="heuristic", page_bytes=2048),
                K=self.K)
            self.db = Database(self.index, device=device)
        # curve-order permutation of the corpus: doc ids for any returned
        # metadata row are one contiguous slice of `_order` (the curve is
        # injective over the K-bit grid, so equal z <=> equal row)
        self._doc_z = self.index.curve.encode_np(self.meta_int)
        self._order = np.argsort(self._doc_z, kind="stable")
        self._z_sorted = self._doc_z[self._order]
        self.rng = np.random.default_rng(seed)

    def select(self, lo01, hi01) -> np.ndarray:
        """Doc ids whose metadata falls in the window (exact, ascending)."""
        from ..api.queries import Range          # lazy: api imports core
        lo = np.floor(np.asarray(lo01) * (2**self.K - 1)).astype(np.uint64)
        hi = np.floor(np.asarray(hi01) * (2**self.K - 1)).astype(np.uint64)
        res = self.db.query(Range(lo[None], hi[None]))
        z = self.index.curve.encode_np(res.rows)
        left = np.searchsorted(self._z_sorted, z, side="left")
        right = np.searchsorted(self._z_sorted, z, side="right")
        ids = (np.sort(np.concatenate(
            [self._order[l:r] for l, r in zip(left, right)]))
            if len(z) else np.empty(0, dtype=np.int64))
        if self.verify_selects:
            m = np.all((self.meta_int >= lo) & (self.meta_int <= hi), axis=1)
            want = np.nonzero(m)[0]
            if not np.array_equal(ids, want):
                raise RuntimeError(
                    f"IndexedDataset.select mismatch: index path returned "
                    f"{len(ids)} doc ids, exact mask {len(want)} "
                    f"(window {lo.tolist()}..{hi.tolist()})")
        return ids


class TokenBatcher:
    """Packs selected docs into fixed (B, S) token batches, resumable."""

    def __init__(self, dataset: IndexedDataset, phases, batch: int,
                 seq_len: int, seed: int = 0):
        self.ds = dataset
        self.phases = phases
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self.state = {"phase": 0, "step_in_phase": 0}

    def set_state(self, state: dict):
        self.state = dict(state)

    def __iter__(self):
        while self.state["phase"] < len(self.phases):
            ph = self.phases[self.state["phase"]]
            ids = self.ds.select(ph.window_lo, ph.window_hi)
            if len(ids) == 0:
                self.state = {"phase": self.state["phase"] + 1,
                              "step_in_phase": 0}
                continue
            while self.state["step_in_phase"] < ph.steps:
                chosen = self.rng.choice(ids, size=self.batch)
                out = np.zeros((self.batch, self.seq_len), np.int32)
                for i, c in enumerate(chosen):
                    toks = self.ds.docs[int(c)][:self.seq_len]
                    out[i, :len(toks)] = toks
                self.state["step_in_phase"] += 1
                yield {"tokens": out}, dict(self.state)
            self.state = {"phase": self.state["phase"] + 1,
                          "step_in_phase": 0}
