"""The port's typed query algebra (`repro_torch.api.queries`) against the
reference's: COUNT / RANGE retrieval / POINT / kNN parity across engines —
including after inserts and deletes — with kNN and retrieval also held
against brute-force numpy oracles.

Twins of `tests/test_query_surface.py`.  `Pair` (from
`tests/test_torch_api.py`) serves every query through the reference's
`Database` (`cpu`, `xla`) and the port's (`cpu`, `torch` with
``device="cpu"``) on the same seeded data and holds every output equal,
exactly: rows, offsets, counts, found flags, kNN rows and exact distances,
overflow flags, escalations, fallbacks, plans and `CacheStats`.  The
reference's `pallas` cases (interpret mode) are held against the port's
`torch` engine in `tests/test_torch_api.py` and
`tests/test_torch_updates.py`; its `distributed` routing case runs
here on the port's `distributed` engine (one page shard on the CPU),
against the reference's.
"""
import numpy as np
import pytest

from repro import api as rapi
from repro.core.query import (brute_force_count, brute_force_knn,
                              brute_force_range)
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch import api as tapi
from repro_torch.api.deltas import rows_in_set
from test_torch_api import Pair

ENGINES = ["cpu", "xla"]
XLA = dict(q_chunk=8, max_cand=16, max_hits=256)


@pytest.fixture(scope="module")
def fixture():
    data = make_dataset("osm", 2500, seed=0)
    K = default_K(2)
    Ls, Us = make_workload(data, 8, seed=1, K=K)
    pair = Pair(data, (Ls, Us), K=K, page_bytes=1024)
    pair.engine("xla", **XLA)
    return pair, data, (Ls, Us)


# ---------------------------------------------------------------------------
# COUNT: the typed object is the legacy surface
# ---------------------------------------------------------------------------


def test_count_object_equals_legacy_form(fixture):
    pair, data, (Ls, Us) = fixture
    want = np.asarray([brute_force_count(data, l, u) for l, u in zip(Ls, Us)])
    legacy = pair.query(lambda a: (Ls, Us), engine="cpu")
    two_arg = pair.query(lambda a: [Ls, Us], engine="cpu")
    typed = pair.query(lambda a: a.Count(Ls, Us), engine="cpu")
    for res in (legacy, two_arg, typed):
        assert res.exact
        np.testing.assert_array_equal(res.counts, want)


# ---------------------------------------------------------------------------
# RANGE retrieval: rows themselves, oracle-exact, identical on every engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENGINES)
def test_range_retrieval_matches_oracle(fixture, name):
    pair, data, (Ls, Us) = fixture
    res = pair.query(lambda a: a.Range(Ls, Us), engine=name)
    assert res.exact
    assert res.offsets[0] == 0 and res.offsets[-1] == len(res.rows)
    for i, (qL, qU) in enumerate(zip(Ls, Us)):
        np.testing.assert_array_equal(res.rows_for(i),
                                      brute_force_range(data, qL, qU),
                                      err_msg=f"{name} q{i}")
    counts = pair.query(lambda a: a.Count(Ls, Us), engine=name).counts
    np.testing.assert_array_equal(res.counts, counts)


def test_range_overflow_escalation_stays_exact(fixture):
    """max_cand=1 and max_hits=1 force both overflow dimensions; doubling
    escalation (with the CPU net) must still return the exact rows."""
    pair, data, (Ls, Us) = fixture
    pair.engine("xla", q_chunk=8, max_cand=1, max_hits=1)
    try:
        res = pair.query(lambda a: a.Range(Ls, Us))
        assert res.exact
        assert np.any(res.overflowed > 0)
        assert res.escalations > 0 or res.cpu_fallbacks > 0
        for i, (qL, qU) in enumerate(zip(Ls, Us)):
            np.testing.assert_array_equal(res.rows_for(i),
                                          brute_force_range(data, qL, qU))
    finally:
        pair.engine("xla", **XLA)   # restore the module fixture's config


# ---------------------------------------------------------------------------
# POINT lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENGINES)
def test_point_lookup_present_and_absent(fixture, name):
    pair, data, _ = fixture
    present = data[::500]
    absent = np.asarray([[1, 2], [0, 0]], dtype=np.uint64)
    absent = absent[~rows_in_set(absent, data)]
    xs = np.concatenate([present, absent])
    res = pair.query(lambda a: a.Point(xs), engine=name)
    assert res.exact
    assert res.found[:len(present)].all(), name
    assert not res.found[len(present):].any(), name


# ---------------------------------------------------------------------------
# kNN: brute-force numpy oracle, both metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("metric", ["l2", "linf"])
def test_knn_matches_bruteforce_oracle(fixture, name, metric):
    pair, data, _ = fixture
    centers = np.concatenate([data[5:8], np.asarray([[7, 9]], np.uint64)])
    res = pair.query(lambda a: a.Knn(centers, k=6, metric=metric),
                     engine=name)
    for i, c in enumerate(centers):
        want, wdists = brute_force_knn(data, c, 6, metric)
        np.testing.assert_array_equal(res.neighbors_for(i), want,
                                      err_msg=f"{name}/{metric} c{i}")
        np.testing.assert_array_equal(res.dists_for(i),
                                      np.asarray(wdists, dtype=np.float64))
        # ascending-distance order within each center
        assert np.all(np.diff(res.dists_for(i)) >= 0)


def test_knn_k_exceeding_live_rows_returns_all(fixture):
    pair, data, _ = fixture
    small = Pair(data[:7], K=pair.port.index.K)
    res = small.query(lambda a: a.Knn(data[0], k=100))
    assert len(res.neighbors_for(0)) == 7


# ---------------------------------------------------------------------------
# parity after inserts and deletes (the LMSFCb delta path)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mutated():
    data = make_dataset("osm", 2000, seed=3)
    K = default_K(2)
    Ls, Us = make_workload(data, 8, seed=4, K=K)
    pair = Pair(data, (Ls, Us), K=K, page_bytes=2048)
    pair.engine("xla", **XLA)
    rng = np.random.default_rng(5)
    new = np.unique(rng.integers(0, 2**K, size=(150, 2), dtype=np.uint64),
                    axis=0)
    new = new[~rows_in_set(new, data)]
    pair.both("insert", new)
    dead = np.stack([data[5], data[50], new[0]])
    assert pair.both("delete", dead) == 3
    logical = np.concatenate([data, new])
    logical = np.unique(logical[~rows_in_set(logical, dead)], axis=0)
    return pair, logical, new, dead, (Ls, Us)


@pytest.mark.parametrize("name", ENGINES)
def test_range_and_point_parity_after_updates(mutated, name):
    pair, logical, new, dead, (Ls, Us) = mutated
    res = pair.query(lambda a: a.Range(Ls, Us), engine=name)
    assert res.exact
    for i, (qL, qU) in enumerate(zip(Ls, Us)):
        np.testing.assert_array_equal(res.rows_for(i),
                                      brute_force_range(logical, qL, qU),
                                      err_msg=f"{name} q{i}")
    xs = np.concatenate([new[1:4], dead])
    pt = pair.query(lambda a: a.Point(xs), engine=name)
    assert pt.found[:3].all(), name       # delta rows are found
    assert not pt.found[3:].any(), name   # tombstoned rows are not


@pytest.mark.parametrize("name", ENGINES)
def test_knn_parity_after_updates(mutated, name):
    pair, logical, new, dead, _ = mutated
    centers = np.stack([new[1], dead[0], logical[17]])
    res = pair.query(lambda a: a.Knn(centers, k=5), engine=name)
    for i, c in enumerate(centers):
        want, _ = brute_force_knn(logical, c, 5, "l2")
        np.testing.assert_array_equal(res.neighbors_for(i), want,
                                      err_msg=f"{name} c{i}")


# ---------------------------------------------------------------------------
# planner: capability-declared routing, CPU exactness net
# ---------------------------------------------------------------------------


def test_capability_matrix_registered():
    # the store engines register on first use in both packages
    from repro.store import engine as _r_store  # noqa: F401
    from repro_torch.store import engine as _t_store  # noqa: F401
    caps = tapi.engine_capabilities()
    assert caps["cpu"] == {"count", "range", "point", "knn"}
    assert caps["torch"] == caps["cuda"] == caps["store"] == caps["cpu"]
    rcaps = rapi.engine_capabilities()
    assert caps["cpu"] == rcaps["cpu"]
    assert caps["torch"] == rcaps["xla"] and caps["cuda"] == rcaps["pallas"]
    assert caps["store"] == rcaps["store"]
    assert "count" in caps["distributed"]
    assert "range" not in caps["distributed"]
    assert caps["distributed"] == rcaps["distributed"]


def test_planner_routes_unsupported_kinds_to_cpu(fixture):
    pair, data, (Ls, Us) = fixture
    ref = rapi.Database.fit(data, (Ls, Us), K=pair.ref.index.K, learn=False,
                            cfg=pair.ref.index.cfg)
    db = tapi.Database.fit(data, (Ls, Us), K=pair.port.index.K, learn=False,
                           cfg=pair.port.index.cfg, device="cpu")
    cfg = dict(q_chunk=8, max_cand=db.num_pages)
    ref.engine("distributed", rapi.EngineConfig(**cfg))
    db.engine("distributed", tapi.EngineConfig(**cfg))
    mk = [lambda a: a.Count(Ls, Us), lambda a: a.Range(Ls, Us),
          lambda a: a.Knn(data[3], k=3), lambda a: a.Point(data[3])]
    cnt, rr, nn, pt = [db.query(m(tapi)) for m in mk]
    rcnt, rrr, rnn, rpt = [ref.query(m(rapi)) for m in mk]
    assert cnt.engine == "distributed" and cnt.exact
    assert rr.engine == "cpu"              # planner fallback
    for i, (qL, qU) in enumerate(zip(Ls, Us)):
        np.testing.assert_array_equal(rr.rows_for(i),
                                      brute_force_range(data, qL, qU))
    assert nn.engine == "cpu"
    assert pt.engine == "distributed" and pt.found[0]
    np.testing.assert_array_equal(cnt.counts, rcnt.counts)
    np.testing.assert_array_equal(rr.rows, rrr.rows)
    np.testing.assert_array_equal(nn.neighbors, rnn.neighbors)
    np.testing.assert_array_equal(pt.found, rpt.found)
    for got, want in ((cnt, rcnt), (pt, rpt)):
        assert got.plan.describe() == want.plan.describe()
    assert (rr.engine, nn.engine) == (rrr.engine, rnn.engine)


# ---------------------------------------------------------------------------
# input validation: bad rects fail loudly, not wrongly
# ---------------------------------------------------------------------------


def test_inverted_rect_raises(fixture):
    pair, data, (Ls, Us) = fixture
    for db in (pair.port, pair.ref):
        with pytest.raises(ValueError, match="Ls > Us"):
            db.query((Us, Ls), engine="cpu")
    with pytest.raises(ValueError, match="Ls > Us"):
        pair.port.query(tapi.Range(Us, Ls), engine="cpu")


def test_dim_mismatch_raises(fixture):
    pair, data, _ = fixture
    bad = np.zeros((2, 3), dtype=np.uint64)
    with pytest.raises(ValueError, match="dimension"):
        pair.port.query((bad, bad), engine="cpu")
    with pytest.raises(ValueError, match="dimension"):
        pair.port.query(tapi.Point(np.zeros(3, dtype=np.uint64)),
                        engine="cpu")


def test_knn_constructor_validation():
    with pytest.raises(ValueError, match="metric"):
        tapi.Knn(np.zeros((1, 2), dtype=np.uint64), k=3, metric="cosine")
    with pytest.raises(ValueError, match="k must be"):
        tapi.Knn(np.zeros((1, 2), dtype=np.uint64), k=0)
