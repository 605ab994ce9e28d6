"""The port's serving front (`repro_torch.serving`) against the
reference's (`repro.serving`).

Twins of `tests/test_serving.py` (its Router case is in
`tests/test_torch_router.py`).  Every scenario runs through both packages
on the same seeded data: the SLO contract's validation, the AIMD controller's trajectory,
the weighted-fair queue's order, the server's exactness (served results
equal serial replay bit for bit, and equal the reference's), its
overload, backpressure, timeout and failed-batch contracts, the Session
substrate, and the open-loop load harness (the same seeded query log in
both packages).  Outputs are held equal exactly (tolerance 0).  Where a
scenario depends on the wall clock (how many submissions a full queue
sheds), each package is held to the reference test's invariants.  The
port's server also runs over its device engine (`torch` with
``device="cpu"``) and over the `store` engine here; on the CUDA kernels
it is driven on a card by `tests/test_torch_cuda.py`.
"""
import threading
import time

import numpy as np
import pytest

from repro import api as rapi
from repro import obs as robs
from repro import serving as rsrv
from repro.core.index import IndexConfig as RConfig
from repro.serving.slo import AdaptiveController as RController
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch import serving as tsrv
from repro_torch.core.index import IndexConfig
from repro_torch.core.theta import default_K
from repro_torch.data.synth import make_dataset
from repro_torch.data.workload import make_workload
from repro_torch.serving.slo import AdaptiveController as TController

FIELDS = tsrv.RESULT_FIELDS


@pytest.fixture(scope="module")
def dbs():
    """The reference test's fixture in both packages."""
    data = make_dataset("osm", 2000, seed=0)
    K = default_K(2)
    Ls, Us = make_workload(data, 10, seed=1, K=K)
    kw = dict(K=K, learn=False)
    ref = rapi.Database.fit(data, (Ls, Us), cfg=RConfig(
        paging="heuristic", page_bytes=1024), **kw)
    port = tapi.Database.fit(data, (Ls, Us), cfg=IndexConfig(
        paging="heuristic", page_bytes=1024), device="cpu", **kw)
    return ref, port, data, (Ls, Us)


SIDES = ((rapi, rsrv), (tapi, tsrv))


def _pick(dbs, api):
    return dbs[0] if api is rapi else dbs[1]


def _mixed_queries(api, data, Ls, Us, n=24, seed=0):
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


def _same(got, want, ctx=""):
    for f in FIELDS:
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{ctx}.{f}")


class _Patched:
    """Replace `db.query` with `wrap(orig)` for the block's duration."""

    def __init__(self, db, wrap):
        self.db, self.wrap = db, wrap

    def __enter__(self):
        self.orig = self.db.query
        self.db.query = self.wrap(self.orig)
        return self.orig

    def __exit__(self, *exc):
        self.db.query = self.orig


# ---------------------------------------------------------------------------
# SLOConfig + AdaptiveController
# ---------------------------------------------------------------------------


def test_slo_config_validates_and_fills_weights():
    for _, srv in SIDES:
        slo = srv.SLOConfig(weights={"range": 2.0})
        assert slo.weights["range"] == 2.0 and slo.weights["count"] == 4.0
        for kw in ({"p99_target_ms": 0}, {"max_queue": 0},
                   {"overload": "drop"}, {"batch_max": 0},
                   {"window_init_ms": 99.0, "window_max_ms": 50.0},
                   {"shrink": 1.0}, {"grow_ms": -1.0}, {"headroom": 0.0},
                   {"min_samples": 0}, {"sample_window": 4, "min_samples": 8},
                   {"weights": {"count": 0.0}}):
            with pytest.raises(ValueError):
                srv.SLOConfig(**kw)
    assert tsrv.SLOConfig().to_dict() == rsrv.SLOConfig().to_dict()


def test_controller_aimd_grow_shrink_deadzone_and_clamp():
    trajectories = []
    for srv, ctrl in ((rsrv, RController), (tsrv, TController)):
        slo = srv.SLOConfig(p99_target_ms=10.0, window_init_ms=2.0,
                            window_min_ms=1.0, window_max_ms=4.0,
                            grow_ms=1.0, shrink=0.5, headroom=0.5,
                            min_samples=4, sample_window=64)
        c = ctrl(slo)
        c.update()
        assert c.window_ms == 2.0 and c.grows == c.shrinks == 0
        c.observe([1.0, 1.0, 1.0, 1.0])
        for _ in range(5):
            c.update()
        assert c.window_ms == 4.0 and c.grows == 5
        c.observe([50.0] * 64)
        c.update()
        assert c.window_ms == 2.0 and c.shrinks == 1
        for _ in range(4):
            c.update()
        assert c.window_ms == 1.0
        c2 = ctrl(slo)
        c2.observe([7.0] * 16)
        c2.update()
        assert c2.window_ms == 2.0 and c2.grows == 0 and c2.shrinks == 0
        assert c2.trajectory[-1][1] == 2.0
        trajectories.append((list(c.trajectory), c.snapshot(),
                             list(c2.trajectory)))
    assert trajectories[1] == trajectories[0]


def test_controller_adaptive_false_pins_window():
    for srv, ctrl in ((rsrv, RController), (tsrv, TController)):
        slo = srv.SLOConfig(adaptive=False, window_init_ms=5.0,
                            window_max_ms=50.0, min_samples=1)
        c = ctrl(slo)
        c.observe([1000.0] * 8)
        for _ in range(10):
            c.update()
        assert c.window_ms == 5.0 and c.grows == 0 and c.shrinks == 0


# ---------------------------------------------------------------------------
# WeightedFairQueue
# ---------------------------------------------------------------------------


def test_wfq_weighted_interleave_fifo_and_bound():
    orders = []
    for _, srv in SIDES:
        q = srv.WeightedFairQueue({"count": 4.0, "range": 1.0}, max_depth=16)
        for i in range(8):
            assert q.push("count", ("count", i))
        for i in range(8):
            assert q.push("range", ("range", i))
        assert not q.push("count", "overflow") and q.depth == 16
        order = q.pop_batch(16)
        assert q.depth == 0 and q.pop() is None
        first8 = [k for k, _ in order[:8]]
        assert first8.count("count") >= 6
        assert [k for k, _ in order].count("range") == 8
        for kind in ("count", "range"):
            seq = [i for k, i in order if k == kind]
            assert seq == sorted(seq)
        orders.append(order)
    assert orders[1] == orders[0]


def test_wfq_idle_kind_banks_no_credit():
    for _, srv in SIDES:
        q = srv.WeightedFairQueue({"count": 1.0, "range": 1.0}, max_depth=64)
        for i in range(8):
            q.push("count", i)
        q.pop_batch(8)
        q.push("range", "late")
        q.push("count", 99)
        assert q.pop() == "late" and q.pop() == 99


# ---------------------------------------------------------------------------
# AsyncServer: exactness, admission control, failure paths
# ---------------------------------------------------------------------------


def test_server_results_bit_identical_to_serial(dbs):
    _, _, data, (Ls, Us) = dbs
    served = []
    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        qs = _mixed_queries(api, data, Ls, Us, n=24)
        with d.serve(slo=srv_mod.SLOConfig(window_init_ms=1.0),
                     engine="cpu") as srv:
            tickets = [srv.submit(q, client=f"c{i % 5}")
                       for i, q in enumerate(qs)]
            results = [t.result(timeout=30) for t in tickets]
        assert [t.seq for t in tickets] == list(range(24))
        oracle = srv_mod.replay_serial(d, srv.query_log(), engine="cpu")
        for t, res in zip(tickets, results):
            srv_mod.assert_bit_identical(res, oracle[t.seq],
                                         context=f"seq{t.seq}")
        st = srv.stats()
        assert st["served"] == 24 and st["failed"] == 0 and st["shed"] == 0
        served.append(results)
    for i, (got, want) in enumerate(zip(served[1], served[0])):
        _same(got, want, f"seq{i}")


def test_server_concurrent_submitters_all_exact(dbs):
    ref, port, data, (Ls, Us) = dbs
    per_thread = 6
    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        tickets = {}

        def client(name, srv):
            qs = _mixed_queries(api, data, Ls, Us, n=per_thread,
                                seed=int(name[1:]) * 37)
            tickets[name] = [(q, srv.submit(q, client=name)) for q in qs]

        with d.serve(slo=srv_mod.SLOConfig(window_init_ms=2.0),
                     engine="cpu") as srv:
            threads = [threading.Thread(target=client, args=(f"t{i}", srv))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            all_pairs = [p for pairs in tickets.values() for p in pairs]
            resolved = [(q, t, t.result(timeout=30)) for q, t in all_pairs]
        seqs = sorted(t.seq for _, t, _ in resolved)
        assert seqs == list(range(8 * per_thread))
        for q, t, res in resolved:
            srv_mod.assert_bit_identical(res, d.query(q, engine="cpu"),
                                         context=f"seq{t.seq}")
            if api is tapi:      # the same payload through the reference
                rq = type(q).__name__
                _same(res, ref.query(_to_ref(q), engine="cpu"), rq)


def _to_ref(q):
    """The reference's query with the port query's payload."""
    if isinstance(q, tapi.Count):
        return rapi.Count(q.rects, q.U)
    if isinstance(q, tapi.Range):
        return rapi.Range(q.rects, q.U)
    if isinstance(q, tapi.Point):
        return rapi.Point(q.xs)
    return rapi.Knn(q.centers, k=q.k, metric=q.metric)


def test_server_reject_policy_sheds_under_overload(dbs):
    _, _, data, (Ls, Us) = dbs

    def slow(orig):
        def f(q, U=None, **kw):
            time.sleep(0.05)
            return orig(q, U, **kw)
        return f

    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        with _Patched(d, slow):
            slo = srv_mod.SLOConfig(max_queue=2, batch_max=1,
                                    overload="reject", window_init_ms=0.0,
                                    window_max_ms=1.0, adaptive=False)
            with srv_mod.AsyncServer(d, slo=slo, engine="cpu") as srv:
                admitted, shed = [], 0
                for i in range(12):
                    try:
                        admitted.append(srv.submit(api.Count(Ls[:1],
                                                             Us[:1])))
                    except srv_mod.ServerOverloaded:
                        shed += 1
                results = [t.result(timeout=30) for t in admitted]
        assert shed > 0 and srv.stats()["shed"] == shed
        assert len(results) == len(admitted) == 12 - shed


def test_server_block_policy_applies_backpressure(dbs):
    _, _, data, (Ls, Us) = dbs

    def slow(orig):
        def f(q, U=None, **kw):
            time.sleep(0.02)
            return orig(q, U, **kw)
        return f

    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        with _Patched(d, slow):
            slo = srv_mod.SLOConfig(max_queue=1, batch_max=1,
                                    overload="block", window_init_ms=0.0,
                                    window_max_ms=1.0, adaptive=False)
            with srv_mod.AsyncServer(d, slo=slo, engine="cpu") as srv:
                tickets = [srv.submit(api.Count(Ls[:1], Us[:1]))
                           for _ in range(6)]
                results = [t.result(timeout=30) for t in tickets]
            st = srv.stats()
        assert st["shed"] == 0 and st["served"] == 6 and len(results) == 6


def test_server_ticket_done_and_timeout(dbs):
    _, _, data, (Ls, Us) = dbs
    counts = []
    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        release = threading.Event()

        def gated(orig):
            def f(q, U=None, **kw):
                release.wait(timeout=30)
                return orig(q, U, **kw)
            return f

        with _Patched(d, gated) as orig:
            with srv_mod.AsyncServer(d, slo=srv_mod.SLOConfig(
                    window_init_ms=0.0), engine="cpu") as srv:
                t = srv.submit(api.Count(Ls[:1], Us[:1]))
                assert not t.done() and t.latency_s() is None
                with pytest.raises(srv_mod.ServingTimeout,
                                   match="unresolved"):
                    t.result(timeout=0.05)
                release.set()
                res = t.result(timeout=30)
            assert t.done() and t.latency_s() > 0
            np.testing.assert_array_equal(
                res.counts, orig(api.Count(Ls[:1], Us[:1]),
                                 engine="cpu").counts)
        counts.append(res.counts)
    np.testing.assert_array_equal(counts[1], counts[0])


def test_server_failed_batch_rejects_tickets_after_retry_budget(dbs):
    _, _, data, (Ls, Us) = dbs

    def broken(orig):
        def f(q, U=None, **kw):
            raise RuntimeError("engine down")
        return f

    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        with _Patched(d, broken):
            slo = srv_mod.SLOConfig(window_init_ms=0.0, max_retries=1)
            with srv_mod.AsyncServer(d, slo=slo, engine="cpu") as srv:
                t = srv.submit(api.Count(Ls[:1], Us[:1]))
                with pytest.raises(RuntimeError, match="engine down"):
                    t.result(timeout=30)
                # the drain loop outlives the failed batch
                t2 = srv.submit(api.Count(Ls[:1], Us[:1]))
                with pytest.raises(RuntimeError, match="engine down"):
                    t2.result(timeout=30)
            st = srv.stats()
            assert st["failed"] == 2 and st["served"] == 0
            assert st["retries"] == 2 * (slo.max_retries + 1)
            assert len(srv._session) == 0


def test_server_rejects_bad_submissions_in_caller_thread(dbs):
    _, _, data, (Ls, Us) = dbs
    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        with d.serve(engine="cpu") as srv:
            with pytest.raises(TypeError, match="typed query"):
                srv.submit((Ls, Us))
            with pytest.raises(ValueError):
                srv.submit(api.Count(Us, Ls))
            assert srv.stats()["submitted"] == 0
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(api.Count(Ls[:1], Us[:1]))


def test_server_takes_a_database_and_names_roadmap_for_a_router(dbs):
    """As the reference's, the port's server takes any backend with the
    Session substrate: its `Database` and its `Router` (the ported
    multi-shard path), each serving results equal to the reference's
    server over the reference's Router."""
    ref, port, data, (Ls, Us) = dbs
    routers = {tapi: tapi.Router.build(data, 2, K=port.index.K,
                                       learn=False, device="cpu"),
               rapi: rapi.Router.build(data, 2, K=port.index.K,
                                       learn=False)}
    served = {}
    for api, srv_mod in SIDES:
        for backend in (routers[api], _pick(dbs, api)):
            with srv_mod.AsyncServer(backend, engine="cpu") as srv:
                qs = _mixed_queries(api, data, Ls, Us, n=8, seed=3)
                served[api, type(backend).__name__] = [
                    t.result(timeout=30) for t in
                    [srv.submit(q) for q in qs]]
    for kind in ("Router", "Database"):
        for got, want in zip(served[tapi, kind], served[rapi, kind]):
            tsrv.assert_bit_identical(got, want, context=kind)
            assert got.engine == want.engine
    for a, b in zip(served[tapi, "Router"], served[tapi, "Database"]):
        tsrv.assert_bit_identical(a, b, context="router vs database")


def test_server_over_device_and_store_engines_matches_serial(dbs, tmp_path):
    """The drain thread serving through the port's batched engines — the
    `torch` engine on the host, and the `store` engine over a segment of
    the same rows — equals serial replay on each and the `cpu` engine."""
    from repro_torch.store import write_segment_from_index
    ref, port, data, (Ls, Us) = dbs
    seg = tapi.Database.from_segment(
        write_segment_from_index(port.index, str(tmp_path / "seg")),
        device="cpu")
    seg.engine("store", tapi.EngineConfig(q_chunk=8, group_pages=4))
    port.engine("torch", tapi.EngineConfig(q_chunk=8))
    qs = _mixed_queries(tapi, data, Ls, Us, n=32, seed=5)
    for d, engine in ((port, "torch"), (seg, "store")):
        with d.serve(slo=tsrv.SLOConfig(window_init_ms=1.0),
                     engine=engine) as srv:
            tickets = [srv.submit(q, client=f"c{i % 3}")
                       for i, q in enumerate(qs)]
            results = [t.result(timeout=60) for t in tickets]
        oracle = tsrv.replay_serial(d, srv.query_log(), engine=engine)
        for t, res in zip(tickets, results):
            tsrv.assert_bit_identical(res, oracle[t.seq], f"seq{t.seq}")
            _same(res, port.query(qs[t.seq], engine="cpu"), f"seq{t.seq}")
            assert res.engine == engine


# ---------------------------------------------------------------------------
# Session substrate: thread safety + discard (the serving prerequisites)
# ---------------------------------------------------------------------------


def test_session_concurrent_submits_unique_seqs_and_exact(dbs):
    _, _, data, (Ls, Us) = dbs
    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        s = d.session(engine="cpu")
        out = {}

        def worker(name):
            qs = _mixed_queries(api, data, Ls, Us, n=5,
                                seed=int(name[1:]) * 13)
            out[name] = [(q, s.submit(q, client=name)) for q in qs]

        threads = [threading.Thread(target=worker, args=(f"w{i}",))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        pairs = [p for v in out.values() for p in v]
        assert sorted(t.seq for _, t in pairs) == list(range(40))
        s.flush()
        for q, t in pairs:
            assert t.done()
            srv_mod.assert_bit_identical(t.result(), d.query(q, engine="cpu"),
                                         context=f"seq{t.seq}")


def test_session_discard_drops_pending_and_times_out(dbs):
    _, _, data, (Ls, Us) = dbs
    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        s = d.session(engine="cpu", tick=10_000)
        keep = s.submit(api.Count(Ls[:1], Us[:1]))
        drop = s.submit(api.Count(Ls[1:2], Us[1:2]))
        assert s.discard([drop]) == 1 and len(s) == 1
        with pytest.raises(srv_mod.ServingTimeout):
            drop.result(timeout=0.05)
        np.testing.assert_array_equal(
            keep.result().counts,
            d.query(api.Count(Ls[:1], Us[:1]), engine="cpu").counts)
        assert s.discard([drop]) == 0


def test_session_flush_failure_counters_and_requeue_accounting(dbs):
    _, _, data, (Ls, Us) = dbs
    for api, obs in ((rapi, robs), (tapi, tobs)):
        d = _pick(dbs, api)
        s = d.session(engine="cpu", tick=10_000)
        tickets = [s.submit(api.Count(Ls[i:i + 1], Us[i:i + 1]),
                            client=f"c{i}") for i in range(4)]
        t_pt = s.submit(api.Point(data[:2]))
        calls = {"n": 0}

        def fails_once(orig):
            def f(q, U=None, **kw):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("transient engine failure")
                return orig(q, U, **kw)
            return f

        obs.enable()
        try:
            with _Patched(d, fails_once):
                assert s.flush_failures == 0
                with pytest.raises(RuntimeError, match="transient"):
                    s.flush()
                assert s.flush_failures == 1 and len(s) == 5
                assert not any(t.done() for t in tickets + [t_pt])
                assert obs.registry.snapshot().get("session.requeues") == 5
                s.flush()
        finally:
            obs.disable()
            obs.reset()
        assert all(t.done() for t in tickets + [t_pt]) and len(s) == 0
        assert s.flush_failures == 1
        for i, t in enumerate(tickets):
            np.testing.assert_array_equal(
                t.result().counts,
                d.query(api.Count(Ls[i:i + 1], Us[i:i + 1]),
                        engine="cpu").counts)
        np.testing.assert_array_equal(
            t_pt.result().found,
            d.query(api.Point(data[:2]), engine="cpu").found)


# ---------------------------------------------------------------------------
# load harness
# ---------------------------------------------------------------------------


def _payload(q):
    return (q.kind,) + tuple(
        np.asarray(getattr(q, f)).tobytes()
        for f in ("rects", "U", "xs", "centers") if hasattr(q, f)) + (
        getattr(q, "k", None), getattr(q, "metric", None))


def test_make_query_log_deterministic_and_well_formed(dbs):
    _, _, data, _ = dbs
    logs = []
    for _, srv in SIDES:
        spec = srv.LoadSpec(rate_qps=500.0, duration_s=0.5, n_clients=20,
                            seed=3)
        log1 = srv.make_query_log(data, spec)
        log2 = srv.make_query_log(data, spec)
        assert len(log1) == len(log2) > 0
        for a1, a2 in zip(log1, log2):
            assert a1.t == a2.t and a1.client == a2.client
            assert _payload(a1.query) == _payload(a2.query)
        times = [a.t for a in log1]
        assert times == sorted(times) and times[-1] < spec.duration_s
        assert {a.query.kind for a in log1} == {"count", "range", "point",
                                                "knn"}
        assert len({a.client for a in log1}) > 1
        other = srv.make_query_log(data, srv.LoadSpec(
            rate_qps=500.0, duration_s=0.5, n_clients=20, seed=4))
        assert [a.t for a in other] != times
        with pytest.raises(ValueError, match="rate_qps"):
            srv.LoadSpec(rate_qps=0.0)
        with pytest.raises(ValueError, match="zipf_a"):
            srv.LoadSpec(rate_qps=1.0, zipf_a=1.0)
        with pytest.raises(ValueError, match="mix"):
            srv.LoadSpec(rate_qps=1.0, mix=(("count", 0.5),))
        logs.append(log1)
    assert [(a.t, a.client, _payload(a.query)) for a in logs[1]] == \
        [(a.t, a.client, _payload(a.query)) for a in logs[0]]


def test_run_open_loop_end_to_end_exact(dbs):
    _, _, data, _ = dbs
    by_query = []
    for api, srv_mod in SIDES:
        d = _pick(dbs, api)
        spec = srv_mod.LoadSpec(rate_qps=300.0, duration_s=0.4,
                                n_clients=16, seed=5)
        log = srv_mod.make_query_log(data, spec)
        srv = srv_mod.AsyncServer(d, slo=srv_mod.SLOConfig(
            window_init_ms=1.0), engine="cpu")
        try:
            point = srv_mod.run_open_loop(srv, log)
        finally:
            srv.close()
        assert point["scheduled"] == len(log)
        assert point["completed"] == point["admitted"] == len(log)
        assert point["failed"] == 0 and point["sustained_qps"] > 0
        lat = point["latency_ms"]
        assert lat["count"] == len(log)
        assert lat["p50"] <= lat["p95"] <= lat["p99"]
        served_log = dict(srv.query_log())
        oracle = srv_mod.replay_serial(d, srv.query_log(), engine="cpu")
        for seq, res in point["results"].items():
            srv_mod.assert_bit_identical(res, oracle[seq],
                                         context=f"seq{seq}")
        # admission order may differ between the runs: key by payload
        by_query.append({_payload(served_log[s]): r
                         for s, r in point["results"].items()})
    assert by_query[1].keys() == by_query[0].keys()
    for k, want in by_query[0].items():
        _same(by_query[1][k], want, k[0])


def test_quantiles_ms_empty_and_ordered():
    for _, srv in SIDES:
        assert srv.quantiles_ms([])["count"] == 0
        q = srv.quantiles_ms(list(range(100)))
        assert q["count"] == 100 and q["p50"] <= q["p95"] <= q["p99"]
    assert tsrv.quantiles_ms(list(range(37))) == \
        rsrv.quantiles_ms(list(range(37)))
