"""The port's Session micro-batcher (`repro_torch.api.exec.session`)
against the reference's: results bit-identical to serial execution under
any coalescing, compatible kinds coalesced, Point probes in one device
call, failed flushes requeued, bad submissions rejected at submit time.

Twins of the Session cases of `tests/test_exec.py`.  Every submission
stream runs through a Session of the reference's `Database` (`cpu`,
`xla`) and of the port's (`cpu`, `torch` with ``device="cpu"``) on the
same seeded data; each ticket's result must equal the other package's and
serial `query`, exactly (rows, counts, found flags, kNN rows and
distances, overflow flags, escalations, plans).
"""
import numpy as np
import pytest

from repro import api as rapi
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch import api as tapi
from test_torch_api import PORT_ENGINE, Pair, assert_same


def _pair(n=2500, n_q=12, seed=0, page_bytes=1024, **eng):
    data = make_dataset("osm", n, seed=seed)
    K = default_K(2)
    Ls, Us = make_workload(data, n_q, seed=seed + 1, K=K)
    pair = Pair(data, (Ls, Us), K=K, page_bytes=page_bytes)
    if eng:
        pair.engine("xla", **eng)
    return pair, data, (Ls, Us)


@pytest.fixture(scope="module")
def small():
    """The reference test's `_db(n=1500, n_q=8, q_chunk=8)`."""
    return _pair(n=1500, n_q=8, q_chunk=8)


# ---------------------------------------------------------------------------
# Session: determinism under any coalescing
# ---------------------------------------------------------------------------


def _mixed_workload(a, data, Ls, Us):
    """An interleaved multi-client mixed-kind submission stream."""
    return [
        ("alice", a.Count(Ls[:3], Us[:3])),
        ("bob", a.Knn(data[5:7], k=3)),
        ("carol", a.Range(Ls[3:6], Us[3:6])),
        ("alice", a.Point(np.concatenate([data[::500],
                                          [[3, 1]]]).astype(np.uint64))),
        ("bob", a.Count(Ls[6:], Us[6:])),
        ("carol", a.Knn(data[40:41], k=5, metric="linf")),
        ("alice", a.Knn(data[8:10], k=3)),          # coalesces with bob's
        ("bob", a.Range(Ls[:2], Us[:2])),
        ("carol", a.Count(Ls[2:4], Us[2:4])),
    ]


FIELDS = ("counts", "rows", "offsets", "found", "neighbors", "dists")


def _assert_same_result(got, want, ctx=""):
    for f in FIELDS:
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{ctx} field {f}")


@pytest.mark.parametrize("engine", ["cpu", "xla"])
def test_session_bit_identical_to_serial_any_tick(engine):
    pair, data, (Ls, Us) = _pair(q_chunk=8, max_cand=8, max_hits=64)
    n = len(_mixed_workload(tapi, data, Ls, Us))
    serial = [pair.query(lambda a, i=i: _mixed_workload(a, data, Ls, Us)[i][1],
                         engine=engine) for i in range(n)]
    for tick in (None, 1, 2, 4, n):
        got = {}
        for side, api, name in ((pair.port, tapi, PORT_ENGINE[engine]),
                                (pair.ref, rapi, engine)):
            s = side.session(engine=name, tick=tick)
            tickets = [s.submit(q, client=c)
                       for c, q in _mixed_workload(api, data, Ls, Us)]
            s.flush()
            assert all(t.done() for t in tickets)
            got[api] = [t.result(timeout=60) for t in tickets]
        for i, (t, r, want) in enumerate(zip(got[tapi], got[rapi], serial)):
            _assert_same_result(t, want, ctx=f"{engine} tick={tick} sub#{i}")
            assert_same(t, r, ctx=f"{engine} tick={tick} sub#{i}")


def test_session_coalesces_compatible_kinds(small):
    pair, data, (Ls, Us) = small
    for db, a in ((pair.port, tapi), (pair.ref, rapi)):
        s = db.session()
        s.submit(a.Count(Ls[:2], Us[:2]))
        s.submit(a.Count(Ls[2:5], Us[2:5]))
        s.submit(a.Knn(data[:1], k=3))
        s.submit(a.Knn(data[1:2], k=3))
        s.submit(a.Knn(data[2:3], k=4))    # different k: its own batch
        assert s.flush() == 3              # count + knn(k=3) + knn(k=4)


def test_session_point_submissions_coalesce_to_one_device_call():
    pair, data, _ = _pair(q_chunk=8, max_cand=64)
    pair.query(lambda a: a.Point(data[:1]))  # warm the fn
    got = {}
    for db, a, name in ((pair.port, tapi, "torch"), (pair.ref, rapi, "xla")):
        s = db.session(engine=name)
        tickets = [s.submit(a.Point(data[i * 7:i * 7 + 3]), client=f"c{i}")
                   for i in range(4)]
        assert s.flush() == 1              # 12 probes, one super-batch
        got[a] = [t.result(timeout=60) for t in tickets]
    res = got[tapi][0]
    assert res.plan.accounting.device_calls == 1
    for i, (t, r) in enumerate(zip(got[tapi], got[rapi])):
        assert t.found.all(), i
        assert_same(t, r, ctx=f"ticket {i}")


def test_session_flush_failure_requeues_unresolved_submissions(small):
    """A batch that raises mid-flush must not strand the other clients'
    tickets: unresolved submissions go back on the queue and a retry
    resolves them (the same steps on both packages keep their caches in
    step)."""
    pair, data, (Ls, Us) = small
    results = {}
    for db, api in ((pair.port, tapi), (pair.ref, rapi)):
        s = db.session(tick=1)
        t1 = s.submit(api.Count(Ls[:2], Us[:2]), client="a")
        t2 = s.submit(api.Count(Ls[2:4], Us[2:4]), client="b")
        t3 = s.submit(api.Count(Ls[4:], Us[4:]), client="c")
        orig = db.query
        calls = {"n": 0}

        def flaky(q, U=None, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("transient engine failure")
            return orig(q, U, **kw)

        db.query = flaky
        try:
            with pytest.raises(RuntimeError, match="transient"):
                s.flush()
            assert t1.done() and not t2.done() and not t3.done()
            assert len(s) == 2               # requeued, not dropped
            assert s.flush_failures == 1
            s.flush()                        # retry succeeds
        finally:
            del db.query
        results[api] = [t.result(timeout=60) for t in (t1, t2, t3)]
    for t, r, (a, b) in zip(results[tapi], results[rapi],
                            ((0, 2), (2, 4), (4, len(Ls)))):
        assert_same(t, r)
        np.testing.assert_array_equal(
            t.counts,
            pair.query(lambda api: api.Count(Ls[a:b], Us[a:b])).counts)


def test_session_rejects_bad_submissions_at_submit_time(small):
    pair, data, (Ls, Us) = small
    for db, api in ((pair.port, tapi), (pair.ref, rapi)):
        s = db.session()
        with pytest.raises(ValueError, match="dimension"):
            s.submit(api.Count(np.zeros((2, 3), np.uint64),
                               np.ones((2, 3), np.uint64)))
        with pytest.raises(ValueError, match="Ls > Us"):
            s.submit(api.Range(Us, Ls))
        with pytest.raises(TypeError, match="typed query"):
            s.submit((Ls, Us))
        assert len(s) == 0                 # nothing half-enqueued
        t = s.submit(api.Count(Ls, Us))
        assert len(s) == 1 and t.result(timeout=60).exact
        dead = s.submit(api.Count(Ls, Us))
        assert s.discard([dead]) == 1
        with pytest.raises(api.ServingTimeout):
            dead.result(timeout=0.01)
