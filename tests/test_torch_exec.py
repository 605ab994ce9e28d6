"""The port's execution layer (`repro_torch.api.exec`) against the
reference's: structured plans, the shape-bucketed query-fn cache (bounded,
no per-budget leak), executed-plan accounting, and Session micro-batching
determinism.

Twins of `tests/test_exec.py` (those of its Session cases are in
`tests/test_torch_session.py`, of its Router cases in
`tests/test_torch_router.py`, of its `distributed` routing cases in
`tests/test_torch_dist.py`).  `Pair` (from `tests/test_torch_api.py`)
serves every query through the reference's `Database` (`cpu`, `xla`) and
the port's (`cpu`, `torch` with ``device="cpu"``) on the same seeded data
and holds results, plans (`describe()`, accounting) and `CacheStats`
equal, exactly; the reference test's own checks run on the port's side.
Each reference `xla` configuration is built once, in a module-scoped
fixture, so its XLA compiles are paid once in this file; a fixture whose
test needs the cold cache runs the cold queries itself and keeps their
results.
"""
import math

import numpy as np
import pytest

from repro import api as rapi
from repro.core.serve import bucket_pow2 as r_bucket_pow2
from repro.core.serve import pack_query_rects as r_pack_query_rects
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch import api as tapi
from repro_torch.api.deltas import rows_in_set
from repro_torch.api.exec.plan import ExecAccounting
from repro_torch.core.serve import bucket_pow2, pack_query_rects
from test_torch_api import Pair


def _pair(n=2500, n_q=12, seed=0, page_bytes=1024, **eng):
    data = make_dataset("osm", n, seed=seed)
    K = default_K(2)
    Ls, Us = make_workload(data, n_q, seed=seed + 1, K=K)
    pair = Pair(data, (Ls, Us), K=K, page_bytes=page_bytes)
    if eng:
        pair.engine("xla", **eng)
    return pair, data, (Ls, Us)


@pytest.fixture(scope="module")
def ladder():
    """max_cand=1 / max_hits=1: every batch takes the whole escalation
    ladder.  The cold Count and Range run here, once."""
    pair, data, wl = _pair(q_chunk=8, max_cand=1, max_hits=1)
    cold = {"count": pair.query(lambda a: a.Count(*wl)),
            "range": pair.query(lambda a: a.Range(*wl))}
    return pair, data, wl, cold


@pytest.fixture(scope="module")
def roomy():
    """The reference test's `_db(q_chunk=8, max_cand=64)`."""
    return _pair(q_chunk=8, max_cand=64)


@pytest.fixture(scope="module")
def small():
    """The reference test's `_db(n=1500, n_q=8, q_chunk=8)`."""
    return _pair(n=1500, n_q=8, q_chunk=8)


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------


def test_bucket_pow2():
    assert [bucket_pow2(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert bucket_pow2(9, 8) == 16 and bucket_pow2(8, 8) == 8
    assert bucket_pow2(17, 8) == 32 and bucket_pow2(0, 4) == 4
    for n in range(70):
        for m in (1, 3, 8):
            assert bucket_pow2(n, m) == r_bucket_pow2(n, m)
    with pytest.raises(ValueError):
        bucket_pow2(4, 0)


def test_pack_query_rects_pads_by_repeating_last():
    Ls = np.asarray([[1, 2], [3, 4]], dtype=np.uint64)
    Us = Ls + np.uint64(5)
    rect = pack_query_rects(Ls, Us, 4)
    assert rect.shape == (4, 2, 2) and rect.dtype == np.int32
    np.testing.assert_array_equal(rect[2], rect[1])
    np.testing.assert_array_equal(rect[3], rect[1])
    np.testing.assert_array_equal(rect, r_pack_query_rects(Ls, Us, 4))
    with pytest.raises(ValueError, match="Q_pad"):
        pack_query_rects(Ls, Us, 1)
    empty = np.empty((0, 2), dtype=np.uint64)
    with pytest.raises(ValueError, match="empty"):
        pack_query_rects(empty, empty, 8)


def test_empty_batches_skip_the_device_entirely():
    pair, data, _ = _pair(n=1500, n_q=6, q_chunk=8)
    empty = np.empty((0, 2), dtype=np.uint64)
    res = pair.query(lambda a: a.Count(empty, empty))
    assert len(res) == 0 and res.exact and res.engine == "torch"
    rr = pair.query(lambda a: a.Range(empty, empty))
    assert len(rr) == 0 and rr.rows.shape == (0, 2)
    pt = pair.query(lambda a: a.Point(empty))
    assert len(pt) == 0
    # no off-bucket (0, d, 2) shape was launched for any of the above
    db = pair.port
    assert db.executor.cache.compiles == 0
    assert all(t[1][0] != 0 for t in db.executor._traced)


# ---------------------------------------------------------------------------
# explain: the structured plan (and the deprecated string shim)
# ---------------------------------------------------------------------------


def test_explain_returns_structured_plan():
    pair, data, (Ls, Us) = _pair(q_chunk=8, max_cand=2, max_hits=16)
    db = pair.port
    plan = db.explain(tapi.Range(Ls, Us))
    rplan = pair.ref.explain(rapi.Range(Ls, Us))
    assert isinstance(plan, tapi.QueryPlan)
    assert plan.kind == "range" and plan.engine == "torch" and not plan.routed
    assert plan.Q == len(Ls) and plan.Q_pad == bucket_pow2(len(Ls), 8)
    assert plan.max_cand == 2 and plan.max_hits == 16
    # the ladder doubles both budgets (bucket values) up to the bounds
    cands = [s.max_cand for s in plan.ladder]
    assert cands and cands[-1] == plan.cand_bound
    assert all(b in (2 * a, plan.cand_bound) for a, b in zip(cands, cands[1:]))
    assert plan.ladder[-1].max_hits == plan.hit_bound
    assert plan.cpu_fallback
    assert "escalation ladder" in plan.describe()
    assert plan.describe() == rplan.describe().replace("'xla'", "'torch'")
    assert [(s.max_cand, s.max_hits) for s in plan.ladder] == \
        [(s.max_cand, s.max_hits) for s in rplan.ladder]
    # nothing executed yet
    assert plan.accounting.device_calls == 0
    # cpu plan: no padding, no ladder
    cplan = db.explain(tapi.Count(Ls, Us), engine="cpu")
    assert cplan.engine == "cpu" and cplan.Q_pad == cplan.Q
    assert cplan.ladder == ()
    assert cplan.describe() == \
        pair.ref.explain(rapi.Count(Ls, Us), engine="cpu").describe()


def test_explain_does_not_flip_the_active_engine():
    pair, data, (Ls, Us) = _pair(n=1500, n_q=6)   # no engine attached
    db = pair.port
    assert db.active_engine is None
    plan = db.explain(tapi.Count(Ls, Us), engine="torch")
    assert plan.engine == "torch"
    assert db.active_engine is None               # planning is side-effect-free
    assert plan.describe() == pair.ref.explain(
        rapi.Count(Ls, Us), engine="xla").describe().replace("'xla'",
                                                             "'torch'")
    assert pair.query(lambda a: a.Count(Ls, Us)).engine == "cpu"


def test_plan_string_shim_deprecated(small):
    pair, data, _ = small
    db = pair.port
    with pytest.warns(DeprecationWarning, match="explain"):
        assert db.plan("count") == "torch"
    with pytest.warns(DeprecationWarning):
        assert db.plan("knn", engine="cpu") == "cpu"


def test_invalid_payload_rejected_at_plan_time(small):
    pair, data, (Ls, Us) = small
    db = pair.port
    with pytest.raises(ValueError, match="dimension"):
        db.explain(tapi.Point(np.zeros(3, dtype=np.uint64)))
    with pytest.raises(ValueError, match="Ls > Us"):
        db.explain(tapi.Count(Us, Ls))


def test_query_attaches_executed_plan_with_accounting(ladder):
    pair, data, (Ls, Us), cold = ladder
    res = cold["count"]
    assert res.exact and isinstance(res.plan, tapi.QueryPlan)
    acct = res.plan.accounting
    assert acct.device_calls >= 1
    assert acct.escalations == res.escalations
    assert acct.cpu_fallbacks == res.cpu_fallbacks
    assert acct.cache_misses >= 1          # cold cache built something
    cpu = pair.query(lambda a: a.Count(Ls, Us), engine="cpu")
    assert cpu.plan.accounting.pages_scanned > 0


# ---------------------------------------------------------------------------
# executor cache: bounded, bucketed, shared (no per-budget leak)
# ---------------------------------------------------------------------------


def test_escalation_budgets_stay_on_buckets_and_cache_is_bounded(ladder):
    """max_cand=1 / max_hits=1 force the full escalation ladder on every
    batch; the query-fn cache must only ever hold bucket shapes, so its
    size stays <= the bucket count instead of growing per budget pair."""
    pair, data, (Ls, Us), cold = ladder
    db = pair.port
    eng = db.engines["torch"]
    r1, r2 = cold["count"], cold["range"]
    assert r1.exact and r2.exact
    assert r1.escalations > 0 and r2.escalations > 0
    cb, hb = eng.overflow_free_cand, eng.overflow_free_hits
    for key in db.executor._fns:
        for budget in key[2:]:
            assert budget in (cb, hb) or budget == bucket_pow2(budget), key
    n_buckets = (math.ceil(math.log2(cb)) + math.ceil(math.log2(hb)) + 4)
    assert db.executor.cache_size(eng) <= n_buckets
    assert db.executor.cache_size(eng) == \
        pair.ref.executor.cache_size(pair.ref.engines["xla"])
    assert sorted(k[1:] for k in db.executor._fns) == \
        sorted(k[1:] for k in pair.ref.executor._fns)
    # warm traffic: pure cache hits, zero new compiles
    before = db.executor.cache.snapshot()
    pair.query(lambda a: a.Count(Ls, Us))
    pair.query(lambda a: a.Range(Ls, Us))
    after = db.executor.cache
    assert after.misses == before.misses
    assert after.compiles == before.compiles
    assert after.hits > before.hits


def test_shape_bucketing_saves_recompiles_across_batch_sizes(roomy):
    """Batch sizes 17, 25, 29 pad to raw q_chunk multiples {24, 32, 32} (2
    distinct shapes without bucketing) but to buckets {32, 32, 32} — one
    new shape serves them all."""
    pair, data, _ = roomy
    db = pair.port
    K = db.index.K
    sizes = (17, 25, 29)
    raw = {-(-q // 8) * 8 for q in sizes}
    bucketed = {bucket_pow2(q, 8) for q in sizes}
    assert len(bucketed) < len(raw)
    wl = make_workload(data, 9, seed=5, K=K)
    pair.query(lambda a: a.Count(*wl))                      # warm: bucket 16
    before = db.executor.cache.snapshot()
    for i, q in enumerate(sizes):
        wl = make_workload(data, q, seed=10 + i, K=K)
        pair.query(lambda a: a.Count(*wl))
    compiled = db.executor.cache.compiles - before.compiles
    assert compiled == len(bucketed)                        # == 1
    assert db.executor.cache.misses == before.misses        # same fn


def test_engine_reattach_and_rebuild_evict_cache_entries():
    pair, data, (Ls, Us) = _pair(n=1500, n_q=8, q_chunk=8)
    db = pair.port
    pair.query(lambda a: a.Count(Ls, Us))
    assert db.executor.cache_size() > 0
    pair.engine("xla", q_chunk=8)                           # re-attach
    assert db.executor.cache.evictions > 0
    pair.query(lambda a: a.Count(Ls, Us))
    old = db.engines["torch"]
    pair.both("rebuild")
    assert db.executor.cache_size(old) == 0                 # invalidated
    assert db.executor.cache.evictions == pair.ref.executor.cache.evictions


# ---------------------------------------------------------------------------
# device POINT batching: (Q, d) probes = one device call
# ---------------------------------------------------------------------------


def test_point_batch_is_one_device_call(roomy):
    pair, data, _ = roomy
    xs = np.concatenate([data[::300], np.asarray([[1, 2]], np.uint64)])
    res = pair.query(lambda a: a.Point(xs))
    assert res.engine == "torch"
    assert res.plan.accounting.device_calls == 1
    np.testing.assert_array_equal(
        res.found, pair.query(lambda a: a.Point(xs), engine="cpu").found)


# ---------------------------------------------------------------------------
# counter coverage: CacheStats / ExecAccounting tell the truth
# ---------------------------------------------------------------------------


def test_cache_stats_snapshot_is_isolated(roomy):
    """`CacheStats.snapshot()` is a frozen copy: later traffic must not
    mutate it."""
    pair, data, (Ls, Us) = roomy
    db = pair.port
    pair.query(lambda a: a.Count(Ls, Us))
    snap = db.executor.cache.snapshot()
    before = (snap.hits, snap.misses, snap.compiles, snap.calls,
              snap.evictions)
    pair.query(lambda a: a.Count(Ls, Us))         # warm traffic mutates live
    assert db.executor.cache.hits > snap.hits     # ... the live counters
    assert (snap.hits, snap.misses, snap.compiles, snap.calls,
            snap.evictions) == before             # ... never the snapshot


def test_eviction_counter_on_invalidate_reattach_and_cap_growth():
    """Every eviction path increments `CacheStats.evictions` by exactly the
    number of dropped fns: engine re-attach, rebuild invalidation, and the
    delta-capacity-growth repack (which must drop fns launched at the old
    static cap)."""
    pair, data, (Ls, Us) = _pair(n=1500, n_q=8, page_bytes=2048,
                                 q_chunk=8, max_cand=64)
    db = pair.port
    pair.query(lambda a: a.Count(Ls, Us))
    live = db.executor.cache_size(db.engines["torch"])
    assert live > 0 and db.executor.cache.evictions == 0
    # re-attach: exactly the old engine's fns are evicted
    pair.engine("xla", q_chunk=8, max_cand=64)
    assert db.executor.cache.evictions == live
    pair.query(lambda a: a.Count(Ls, Us))
    # rebuild invalidation: same bookkeeping through Engine.invalidate
    ev0 = db.executor.cache.evictions
    live = db.executor.cache_size(db.engines["torch"])
    pair.both("rebuild")
    assert db.executor.cache.evictions == ev0 + live
    # cap growth: enough near-duplicate inserts into one page overflow the
    # packed point capacity; the repack grows the (static) cap and must
    # evict the fns launched at the old one
    pair.engine("xla", q_chunk=8, max_cand=db.num_pages)
    pair.query(lambda a: a.Count(Ls, Us))
    cap0 = db.engines["torch"]._host.points.shape[2]
    base = data[100].astype(np.int64)
    K = db.index.K
    new = np.unique(np.stack([
        np.clip(base + [dx, 0], 0, 2 ** K - 1).astype(np.uint64)
        for dx in range(1, cap0 + 16)]), axis=0)
    new = new[~rows_in_set(new, data)]
    pair.both("insert", new)
    ev0 = db.executor.cache.evictions
    live = db.executor.cache_size(db.engines["torch"])
    assert live > 0
    res = pair.query(lambda a: a.Count(Ls, Us), engine="xla")  # grows cap
    assert db.engines["torch"]._host.points.shape[2] > cap0
    assert res.exact
    assert db.executor.cache.evictions >= ev0 + live


def test_accounting_reflects_actual_escalation_path(ladder):
    """`ExecAccounting` on the executed plan mirrors what really happened:
    a budget that forces the whole ladder books one device call per rung
    taken plus the first pass, and escalations match the result's."""
    pair, data, (Ls, Us), cold = ladder
    res = cold["count"]
    acct = res.plan.accounting
    assert res.exact and res.escalations > 0
    assert acct.escalations == res.escalations
    assert acct.device_calls == 1 + acct.escalations  # first pass + rungs
    assert acct.cpu_fallbacks == res.cpu_fallbacks
    # an overflow-free budget takes zero rungs: exactly one device call
    roomy_pair, _, wl = _pair(q_chunk=8, max_cand=pair.port.num_pages)
    res2 = roomy_pair.query(lambda a: a.Count(*wl))
    acct2 = res2.plan.accounting
    assert res2.escalations == 0 and acct2.escalations == 0
    assert acct2.device_calls == 1


def test_exec_accounting_merge():
    """Accountings are additive (`merge` / ``+=``), and `merged` keeps the
    unsummed breakdown — as the reference's."""
    from repro.api.exec.plan import ExecAccounting as RAcct
    a = ExecAccounting(device_calls=2, escalations=1, pages_scanned=10)
    b = ExecAccounting(device_calls=3, cache_hits=4, pages_scanned=5)
    a += b
    assert (a.device_calls, a.escalations, a.cache_hits,
            a.pages_scanned) == (5, 1, 4, 15)
    m = ExecAccounting.merged([ExecAccounting(device_calls=2),
                               ExecAccounting(device_calls=3)])
    assert m.device_calls == 5 and len(m.per_shard) == 2
    assert ExecAccounting._COUNTERS == RAcct._COUNTERS
    for f in ExecAccounting._COUNTERS:
        assert getattr(m, f) == sum(getattr(s, f) for s in m.per_shard), f


def test_fence_synchronizes_cuda_outputs_and_propagates_faults(monkeypatch):
    """`_fence` waits for every CUDA device among the outputs and lets a
    device fault surface; CPU outputs need no fence."""
    import torch

    from repro_torch.api.exec import executor
    calls = []

    def sync(dev):
        calls.append(dev)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    executor._fence((torch.zeros(2), torch.zeros(3)))
    assert calls == []

    class _On:
        device = torch.device("cuda", 0)

    with pytest.raises(RuntimeError, match="illegal memory access"):
        executor._fence((_On(), torch.zeros(1)))
    assert calls == [torch.device("cuda", 0)]
