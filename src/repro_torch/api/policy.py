"""Pluggable LMSFCa rebuild policies (paper §7.11).

A policy looks at the index + its DeltaStore after every mutation and
decides when the accumulated deltas justify a full rebuild.  The default
mirrors the paper's maintenance rule: rebuild once inserts exceed a
fraction of the base data.  `auto=True` makes `Database` run the rebuild
inline; otherwise `Database.rebuild_pending` is set so a serving loop can
schedule it off the hot path.
"""
from __future__ import annotations

import dataclasses


class RebuildPolicy:
    """Interface: return True when an LMSFCa rebuild should happen."""

    auto: bool = False

    def should_rebuild(self, index, store) -> bool:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class FractionRebuildPolicy(RebuildPolicy):
    """Rebuild when inserts exceed `frac` of the base row count — the
    paper's periodic-maintenance trigger."""

    frac: float = 0.1
    auto: bool = False

    def should_rebuild(self, index, store) -> bool:
        return store.n_inserted > self.frac * index.n


@dataclasses.dataclass
class NeverRebuild(RebuildPolicy):
    """Delta-only operation (callers rebuild explicitly)."""

    auto: bool = False

    def should_rebuild(self, index, store) -> bool:
        return False
