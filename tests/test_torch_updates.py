"""Paper §7.11 in the port: insertion via delta pages (LMSFCb), tombstone
deletion and periodic rebuild (LMSFCa), through `repro_torch.api.Database`
and through the legacy free-function shims, against the reference.

Twins of `tests/test_updates.py`.  `Pair` (from `tests/test_torch_api.py`)
runs every step on the reference's `Database` and the port's (``device=
"cpu"``) and holds each result equal, exactly (counts, overflow flags,
escalations, fallbacks, plans, `CacheStats`); the reference test's checks
against brute force run on the port's side.  The reference's `pallas`
case (its kernels in interpret mode) is held against the port's `torch`
engine, whose plain twins are the kernels' CPU counterparts; the `cuda`
engine runs only on a card (`tests/test_torch_cuda.py`).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import index as rindex_mod
from repro.core.index import IndexConfig as RConfig
from repro.core.index import LMSFCIndex as RIndex
from repro.core.query import brute_force_count
from repro.core.query import query_count as r_query_count
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch import api as tapi
from repro_torch.api.deltas import rows_in_set
from repro_torch.core import index as index_mod
from repro_torch.core.index import IndexConfig, LMSFCIndex
from repro_torch.core.query import query_count
from test_torch_api import Pair


def _update_fixture(seed=11, n=3000, n_new=300):
    rng = np.random.default_rng(0)
    data = make_dataset("osm", n, seed=seed)
    K = default_K(2)
    Ls, Us = make_workload(data, 30, seed=seed, K=K)
    new_pts = np.unique(rng.integers(0, 2**K, size=(n_new, 2),
                                     dtype=np.uint64), axis=0)
    mask = ~np.any(np.all(new_pts[:, None] == data[None, :400], axis=2), 1)
    return data, (Ls, Us), new_pts[mask], K


def _logical(data, new_pts, deleted):
    logical = np.concatenate([data, new_pts])
    dset = {tuple(int(v) for v in x) for x in deleted}
    keep = np.asarray([tuple(int(v) for v in r) not in dset for r in logical])
    return np.unique(logical[keep], axis=0)


def test_database_insert_delete_rebuild_exact():
    data, (Ls, Us), new_pts, K = _update_fixture()
    pair = Pair(data, (Ls, Us), K=K, page_bytes=2048,
                policy=tapi.FractionRebuildPolicy(frac=0.05, auto=False))
    pair.both("insert", new_pts)                  # 10% new rows
    deleted = [data[5], data[77], new_pts[0], new_pts[1]]
    pair.both("delete", deleted)
    logical = _logical(data, new_pts, deleted)

    res = pair.query(lambda a: (Ls, Us))          # CPU engine, delta-aware
    want = np.asarray([brute_force_count(logical, l, u)
                       for l, u in zip(Ls, Us)])
    np.testing.assert_array_equal(res.counts, want)
    assert res.exact

    db = pair.port
    assert db.rebuild_pending                     # the 5% policy tripped
    pair.both("rebuild")
    assert db.store.epoch == 0 and not db.store.deltas
    np.testing.assert_array_equal(pair.query(lambda a: (Ls, Us)).counts,
                                  want)


@pytest.mark.parametrize("name,cfg", [
    ("cpu", None),
    ("xla", dict(q_chunk=8, max_cand=24)),
    ("pallas", dict(q_chunk=8, max_cand=24)),
])
def test_updates_under_piecewise_curve_cross_engine(name, cfg):
    """Insert/delete → exact query parity on every engine when the index
    was built on a `PiecewiseCurve` (per-region θ; the delta path must
    stay correct under the region-dispatched encode)."""
    data, (Ls, Us), new_pts, K = _update_fixture(seed=23, n=2000, n_new=150)
    pair = Pair(data, (Ls, Us), K=K, curve="piecewise", page_bytes=2048)
    db = pair.port
    assert db.curve.kind == "piecewise"
    assert db.curve.to_json() == pair.ref.curve.to_json()
    new_pts = new_pts[~rows_in_set(new_pts, data)]
    pair.both("insert", new_pts)
    deleted = np.stack([data[5], data[77], new_pts[0]])
    assert pair.both("delete", deleted) == 3
    logical = _logical(data, new_pts, deleted)
    want = np.asarray([brute_force_count(logical, l, u)
                       for l, u in zip(Ls, Us)])
    if cfg is not None:
        pair.engine(name, **cfg)
    res = pair.query(lambda a: (Ls, Us), engine=name)
    assert res.exact
    np.testing.assert_array_equal(res.counts, want)
    # a rebuild folds the deltas and keeps the piecewise curve
    pair.both("rebuild")
    assert db.curve.kind == "piecewise"
    res = pair.query(lambda a: (Ls, Us), engine=name)
    assert res.exact
    np.testing.assert_array_equal(res.counts, want)


def test_legacy_insert_delete_rebuild_exact():
    """Pre-facade free functions still work (thin shims over DeltaStore),
    and agree with the reference's shims."""
    data, (Ls, Us), new_pts, K = _update_fixture()
    cfg = dict(paging="heuristic", page_bytes=2048)
    idx = LMSFCIndex.build(data, cfg=IndexConfig(**cfg), workload=(Ls, Us),
                           K=K)
    ridx = RIndex.build(data, cfg=RConfig(**cfg), workload=(Ls, Us), K=K)
    for x in new_pts:
        assert index_mod.insert(idx, x) == rindex_mod.insert(ridx, x)
    deleted = [data[5], data[77], new_pts[0], new_pts[1]]
    for x in deleted:
        index_mod.delete(idx, x)
        rindex_mod.delete(ridx, x)
    logical = _logical(data, new_pts, deleted)

    for qL, qU in zip(Ls, Us):
        st = query_count(idx, qL, qU)
        assert st.result == brute_force_count(logical, qL, qU)
        assert dataclasses.asdict(st) == \
            dataclasses.asdict(r_query_count(ridx, qL, qU))

    assert index_mod.needs_rebuild(idx, frac=0.05)
    idx2 = index_mod.rebuild(idx, workload=(Ls, Us))
    np.testing.assert_array_equal(
        idx2.xs, rindex_mod.rebuild(ridx, workload=(Ls, Us)).xs)
    for qL, qU in zip(Ls, Us):
        assert query_count(idx2, qL, qU).result == \
            brute_force_count(logical, qL, qU)
