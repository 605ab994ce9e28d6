"""The port's multi-shard `Router` (`repro_torch.api.exec.router`) against
the reference's (`repro.api.exec.router`).

Twins of the Router and `ShardSpec` cases of `tests/test_exec.py`, of
`tests/test_obs.py::test_instrumented_router_exact_with_per_shard_accounting`
and of `tests/test_serving.py::test_server_over_router_matches_unsharded_oracle`.
Each scenario builds the same seeded data into a Router (and an unsharded
oracle `Database`) in both packages — the port's with ``device="cpu"`` —
and holds every merged output equal exactly (tolerance 0): counts, rows
and offsets, found flags, kNN rows and distances (tie-breaks across shard
boundaries included), overflow flags, escalations, CPU fallbacks, epochs,
the engine label, the `RouterPlan` (`describe()`, the summed accounting
and its per-shard breakdown).  The reference's `xla` engine is the port's
`torch` engine; the reference test's own checks run on the port's side.
The `cuda` engine on every shard is driven on a card by
`tests/test_torch_cuda.py`.
"""
import dataclasses

import numpy as np
import pytest

from repro import api as rapi
from repro import obs as robs
from repro import serving as rsrv
from repro.api.exec.plan import ExecAccounting as RAccounting
from repro.core.index import IndexConfig as RConfig
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch import serving as tsrv
from repro_torch.api.deltas import rows_in_set
from repro_torch.api.exec.plan import ExecAccounting
from repro_torch.core.index import IndexConfig
from repro_torch.core.theta import default_K
from repro_torch.data.synth import make_dataset
from repro_torch.data.workload import make_workload
from repro_torch.dist.sharding import P, ShardingRules

FIELDS = ("counts", "rows", "offsets", "found", "neighbors", "dists",
          "overflowed", "residual_overflow")
SCALARS = ("escalations", "cpu_fallbacks", "epoch", "k", "metric")


def _port_name(s: str) -> str:
    return s.replace("xla", "torch")


def same(got, want, ctx=""):
    """A merged port result equals the reference's on every output, its
    label and its `RouterPlan`."""
    for f in FIELDS:
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{ctx} {f}")
    for f in SCALARS:
        if hasattr(want, f):
            assert getattr(got, f) == getattr(want, f), (ctx, f)
    assert got.engine == _port_name(want.engine), ctx
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    gp, wp = got.plan, want.plan
    assert (gp.kind, gp.merge) == (wp.kind, wp.merge), ctx
    assert gp.describe() == _port_name(wp.describe()), ctx
    ga, wa = gp.accounting, wp.accounting
    for f in RAccounting._COUNTERS:
        assert getattr(ga, f) == getattr(wa, f), (ctx, f)
    assert len(ga.per_shard) == len(wa.per_shard)
    for gs, ws in zip(ga.per_shard, wa.per_shard):
        assert dataclasses.asdict(gs) == dataclasses.asdict(ws), ctx


def _both(data, n_shards, **fit_kw):
    """The same Router in both packages (the port's on the CPU)."""
    rcfg = fit_kw.pop("cfg", None)
    ref = rapi.Router.build(data, n_shards, cfg=rcfg and RConfig(**rcfg),
                            **fit_kw)
    port = tapi.Router.build(data, n_shards,
                             cfg=rcfg and IndexConfig(**rcfg),
                             device="cpu", **fit_kw)
    return ref, port


@pytest.fixture(scope="module")
def sharded():
    """The reference test's fixture in both packages: 2,400 rows in 3
    shards and an unsharded oracle."""
    data = make_dataset("osm", 2400, seed=3)
    K = default_K(2)
    Ls, Us = make_workload(data, 10, seed=4, K=K)
    cfg = dict(paging="heuristic", page_bytes=1024)
    oracle = tapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                               cfg=IndexConfig(**cfg), device="cpu")
    ref, port = _both(data, 3, K=K, learn=False, cfg=cfg)
    return ref, port, oracle, data, (Ls, Us)


def test_router_count_range_point_match_unsharded_oracle(sharded):
    ref, router, oracle, data, (Ls, Us) = sharded
    xs = np.concatenate([data[::400], [[7, 9]]]).astype(np.uint64)
    for mk in (lambda a: a.Count(Ls, Us), lambda a: a.Range(Ls, Us),
               lambda a: a.Point(xs)):
        got = router.query(mk(tapi))
        same(got, ref.query(mk(rapi)), got.plan.kind)
        want = oracle.query(mk(tapi))
        for f in ("counts", "rows", "offsets", "found"):
            if hasattr(want, f):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
    assert router.query(tapi.Count(Ls, Us)).engine == "router[3xcpu]"


@pytest.mark.parametrize("metric", ["l2", "linf"])
def test_router_knn_matches_oracle_including_tie_breaks(sharded, metric):
    ref, router, oracle, data, _ = sharded
    centers = np.concatenate([data[5:8], [[50, 50]]]).astype(np.uint64)
    rk = router.query(tapi.Knn(centers, k=6, metric=metric))
    same(rk, ref.query(rapi.Knn(centers, k=6, metric=metric)), metric)
    ok = oracle.query(tapi.Knn(centers, k=6, metric=metric))
    for f in ("neighbors", "dists", "offsets"):
        np.testing.assert_array_equal(getattr(rk, f), getattr(ok, f))


def test_router_knn_tie_breaks_across_shard_boundaries():
    """Symmetric points equidistant from the center land on different
    shards; the merged order must still be the exact (dist, lex) one."""
    c = np.asarray([100, 100], dtype=np.uint64)
    ring = np.asarray([[100, 90], [100, 110], [90, 100], [110, 100],
                       [93, 93], [107, 107], [93, 107], [107, 93]],
                      dtype=np.uint64)
    K = default_K(2)
    rng = np.random.default_rng(9)
    filler = np.unique(rng.integers(0, 2**K, size=(400, 2),
                                    dtype=np.uint64), axis=0)
    filler = filler[~rows_in_set(filler, np.concatenate([ring, c[None]]))]
    data = np.concatenate([ring, filler])
    cfg = dict(paging="heuristic", page_bytes=512)
    oracle = tapi.Database.fit(data, K=K, learn=False,
                               cfg=IndexConfig(**cfg), device="cpu")
    ref, router = _both(data, 2, K=K, learn=False, cfg=cfg)
    for k in (2, 4, 8):
        rk = router.query(tapi.Knn(c, k=k))
        same(rk, ref.query(rapi.Knn(c, k=k)), str(k))
        ok = oracle.query(tapi.Knn(c, k=k))
        np.testing.assert_array_equal(rk.neighbors, ok.neighbors,
                                      err_msg=str(k))
        np.testing.assert_array_equal(rk.dists, ok.dists, err_msg=str(k))


def test_router_device_engines_and_updates():
    """The reference's `xla` engine on every shard against the port's
    `torch` engine, then round-robin inserts and a broadcast delete."""
    data = make_dataset("osm", 2400, seed=3)
    K = default_K(2)
    Ls, Us = make_workload(data, 10, seed=4, K=K)
    cfg = dict(paging="heuristic", page_bytes=1024)
    oracle = tapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                               cfg=IndexConfig(**cfg), device="cpu")
    ref, router = _both(data, 3, K=K, learn=False, cfg=cfg)
    knobs = dict(q_chunk=8, max_cand=16, max_hits=128)
    ref.engine("xla", rapi.EngineConfig(**knobs))
    router.engine("torch", tapi.EngineConfig(**knobs))
    res = router.query(tapi.Count(Ls, Us), engine="torch")
    same(res, ref.query(rapi.Count(Ls, Us), engine="xla"))
    assert res.engine == "router[3xtorch]" and res.exact
    np.testing.assert_array_equal(res.counts,
                                  oracle.query(tapi.Count(Ls, Us)).counts)
    # updates: inserts scatter round-robin, deletes broadcast; the port's
    # shards serve them on `torch`, the reference's answers come from its
    # `cpu` engines (the same rows; no further XLA compiles)
    new = np.asarray([[11, 13], [17, 19], [23, 29]], dtype=np.uint64)
    n0 = router.n
    assert router.insert(new) == ref.insert(new) == 3
    assert router.n == ref.n == n0 + 3
    assert [s.n for s in router.shards] == [s.n for s in ref.shards]

    def answers(make):
        got = router.query(make(tapi))
        assert got.engine == "router[3xtorch]" and got.exact
        tsrv.assert_bit_identical(got, ref.query(make(rapi), engine="cpu"))
        return got

    for mk in (lambda a: a.Count(Ls, Us), lambda a: a.Range(Ls, Us)):
        answers(mk)
    assert answers(lambda a: a.Point(new)).found.all()
    assert router.delete(new[0]) == ref.delete(new[0]) == 1
    assert not answers(lambda a: a.Point(new[:1])).found[0]


def test_router_rejects_mixed_dimension_submissions_before_scatter(sharded):
    ref, router, *_ = sharded
    for api, r in ((tapi, router), (rapi, ref)):
        with pytest.raises(ValueError, match="dimension"):
            r.query(api.Point(np.zeros((2, 5), dtype=np.uint64)))
        with pytest.raises(ValueError, match="dimension"):
            r.explain(api.Count(np.zeros((2, 5), np.uint64),
                                np.ones((2, 5), np.uint64)))
        with pytest.raises(ValueError, match="U="):
            r.query(api.Count(np.zeros((1, 2), np.uint64),
                              np.ones((1, 2), np.uint64)),
                    np.ones((1, 2), np.uint64))


def test_router_explain_scatters_per_shard_plans(sharded):
    ref, router, oracle, data, (Ls, Us) = sharded
    rp = router.explain(tapi.Knn(data[:2], k=3))
    assert rp.kind == "knn" and rp.merge == "rerank"
    assert len(rp.shards) == 3
    assert all(isinstance(p, tapi.QueryPlan) for p in rp.shards)
    assert "scatter KNN to 3 shards" in rp.describe()
    assert isinstance(rp, tapi.RouterPlan)
    for mk in (lambda a: a.Knn(data[:2], k=3), lambda a: a.Count(Ls, Us),
               lambda a: a.Range(Ls, Us), lambda a: a.Point(data[:4])):
        assert router.explain(mk(tapi)).describe() == \
            ref.explain(mk(rapi)).describe()
    assert str(router.explain(Ls, Us)) == str(ref.explain(Ls, Us))


def test_shard_spec_reuses_dist_sharding_rules():
    from jax.sharding import PartitionSpec as RP
    spec, rspec = tapi.ShardSpec(4), rapi.ShardSpec(4)
    assert isinstance(spec.rules, ShardingRules)
    assert spec.rules.data_size == 4 and spec.rules.model_size == 1
    parts = spec.partition(16)
    assert [len(p) for p in parts] == [4, 4, 4, 4]
    assert spec.spec(16) == P("data") == RP("data")
    assert tuple(spec.spec(16)) == tuple(rspec.spec(16))
    np.testing.assert_array_equal(np.concatenate(parts), np.arange(16))
    parts = spec.partition(18)
    assert sorted(len(p) for p in parts) == [4, 4, 5, 5]
    assert spec.spec(18) == P(None)
    assert tuple(spec.spec(18)) == tuple(rspec.spec(18))
    assert sum(len(p) for p in parts) == 18
    for n in (16, 18, 7):
        for a, b in zip(spec.partition(n), rspec.partition(n)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="n_shards"):
        tapi.ShardSpec(0)
    with pytest.raises(ValueError, match="at least one shard"):
        tapi.Router([])
    d2 = tapi.Database.fit(make_dataset("osm", 300, seed=1), learn=False,
                           device="cpu")
    d3 = tapi.Database.fit(make_dataset("nyc", 300, seed=1), learn=False,
                           device="cpu")
    with pytest.raises(ValueError, match="same space"):
        tapi.Router([d2, d3])


def test_exec_accounting_merge_and_router_per_shard_breakdown():
    """Accountings are additive, and a Router's merged result's plan
    aggregates every shard's costs with the unsummed `per_shard`
    breakdown, equal to the reference's."""
    a = ExecAccounting(device_calls=2, escalations=1, pages_scanned=10)
    b = ExecAccounting(device_calls=3, cache_hits=4, pages_scanned=5)
    a += b
    assert (a.device_calls, a.escalations, a.cache_hits,
            a.pages_scanned) == (5, 1, 4, 15)
    m = ExecAccounting.merged([ExecAccounting(device_calls=2),
                               ExecAccounting(device_calls=3)])
    assert m.device_calls == 5 and len(m.per_shard) == 2

    data = make_dataset("osm", 1200, seed=3)
    K = default_K(2)
    Ls, Us = make_workload(data, 6, seed=4, K=K)
    ref, router = _both(data, 3, learn=False,
                        cfg=dict(paging="heuristic", page_bytes=1024))
    knobs = dict(q_chunk=8, max_cand=16, max_hits=128)
    ref.engine("xla", rapi.EngineConfig(**knobs))
    router.engine("torch", tapi.EngineConfig(**knobs))
    res = router.query(tapi.Count(Ls, Us))
    same(res, ref.query(rapi.Count(Ls, Us)))
    acct = res.plan.accounting
    assert res.plan.kind == "count" and res.plan.merge == "sum"
    assert len(acct.per_shard) == 3
    for f in ExecAccounting._COUNTERS:
        assert getattr(acct, f) == sum(getattr(s, f)
                                       for s in acct.per_shard), f
    assert acct.device_calls >= 3


def test_instrumented_router_exact_with_per_shard_accounting():
    """Twin of the reference's obs case: the router's scatter and merge
    spans are recorded under the reference's names."""
    data = make_dataset("osm", 1200, seed=7)
    K = default_K(2)
    Ls, Us = make_workload(data, 6, seed=8, K=K)
    oracle = tapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                               cfg=IndexConfig(paging="heuristic",
                                               page_bytes=1024),
                               device="cpu")
    want = oracle.query(tapi.Count(Ls, Us)).counts
    ref, router = _both(data, 2, learn=False,
                        cfg=dict(paging="heuristic", page_bytes=1024))
    names = {}
    for api, o, r in ((tapi, tobs, router), (rapi, robs, ref)):
        o.reset()
        o.enable()
        try:
            res = r.query(api.Count(Ls, Us))
        finally:
            o.disable()
        np.testing.assert_array_equal(res.counts, want)
        assert len(res.plan.accounting.per_shard) == 2
        names[api] = {k.split("{")[0] for k in r.stats()["metrics"]}
        if api is tapi:
            assert "router_query" in r.stats(format="prometheus")
        o.reset()
    assert {"router.query_ns", "router.shard_ns",
            "router.merge_ns"} <= names[tapi]
    assert {n for n in names[rapi] if n.startswith("router.")} == \
        {n for n in names[tapi] if n.startswith("router.")}
    with pytest.raises(ValueError, match="stats format"):
        router.stats(format="xml")


def _mixed_queries(api, data, Ls, Us, n=16, seed=7):
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        j = int(rng.integers(0, len(Ls)))
        kind = i % 4
        if kind == 0:
            qs.append(api.Count(Ls[j:j + 1], Us[j:j + 1]))
        elif kind == 1:
            qs.append(api.Range(Ls[j:j + 1], Us[j:j + 1]))
        elif kind == 2:
            qs.append(api.Point(data[j:j + 1]))
        else:
            qs.append(api.Knn(data[j:j + 1], k=3, metric="l2"))
    return qs


@pytest.mark.parametrize("engine", [None, "torch"])
def test_server_over_router_matches_unsharded_oracle(engine):
    """The async server over a Router: every served result equals the
    unsharded oracle's `cpu` answer, serial replay on the Router, and the
    reference's server over its Router (on its shards' `cpu` engines),
    bit for bit — the port's shards serving on `cpu` and on `torch`."""
    data = make_dataset("osm", 2000, seed=0)
    K = default_K(2)
    Ls, Us = make_workload(data, 10, seed=1, K=K)
    cfg = dict(paging="heuristic", page_bytes=1024)
    oracle = tapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                               cfg=IndexConfig(**cfg), device="cpu")
    ref, router = _both(data, 3, K=K, learn=False, cfg=cfg)
    if engine:
        router.engine(engine, tapi.EngineConfig(q_chunk=8))
    out = {}
    for api, srv_mod, r, e in ((tapi, tsrv, router, engine),
                               (rapi, rsrv, ref, None)):
        qs = _mixed_queries(api, data, Ls, Us)
        with r.serve(slo=srv_mod.SLOConfig(window_init_ms=1.0),
                     engine=e) as srv:
            assert isinstance(srv, srv_mod.AsyncServer)
            tickets = [srv.submit(q) for q in qs]
            results = [t.result(timeout=60) for t in tickets]
        replay = srv_mod.replay_serial(r, srv.query_log(), engine=e)
        for t, res in zip(tickets, results):
            srv_mod.assert_bit_identical(res, replay[t.seq],
                                         context=f"seq{t.seq}")
        out[api] = (qs, results)
    for q, got, want in zip(out[tapi][0], out[tapi][1], out[rapi][1]):
        tsrv.assert_bit_identical(got, oracle.query(q, engine="cpu"),
                                  context=q.kind)
        tsrv.assert_bit_identical(got, want, context=q.kind)
        assert got.engine == want.engine.replace("cpu", engine or "cpu")
