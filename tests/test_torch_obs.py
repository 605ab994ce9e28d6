"""The port's observability layer (`repro_torch.obs`) against the
reference's (`repro.obs`): metrics, spans, exporters, and the contract
that instrumentation never changes results.

Twins of `tests/test_obs.py` less its router case (the router comes with
the multi-device slice).  Where a twin drives both packages, the same
calls under the same fake clock must give equal snapshots, traces and
Prometheus text; instrumented queries run the reference's `xla` engine
and the port's `torch` engine on the CPU (``device="cpu"``) on the same
seeded data, and every served array must be equal (integers and exact
distances: tolerance 0).  New here: obs on and obs off give identical
`learn_sfc` and served results; the port's stage spans along Count's and
Range's path (each nested where it runs, once a chunk or once a call);
with obs off, no span and no profiler range; with obs on, every span
mirrored as a `record_function` range and each collector pause a
``python.gc`` span.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import logging
import sys
import threading

import numpy as np
import pytest

from repro import api as rapi
from repro import obs as robs
from repro.core.index import IndexConfig as RConfig
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch import api as tapi
from repro_torch import obs
from repro_torch.core.index import IndexConfig as TConfig
from repro_torch.core.serve import bucket_pow2
from repro_torch.core.smbo import learn_sfc
from repro_torch.obs.metrics import Histogram, Registry
from repro_torch.obs.trace import NULL_SPAN, Tracer

FIELDS = ("counts", "rows", "offsets", "found", "neighbors", "dists")

# the port's spans along Count's and Range's path, inside one call, with
# the span each opens under; the reference has none of them
STAGE_PARENTS = {
    "database.query": (None,),
    "planner.plan": ("database.query",),
    "executor.execute": ("database.query",),
    "executor.escalate": ("executor.execute",),
    "executor.device_call": ("executor.execute", "executor.escalate"),
    "serve.upload": ("executor.execute", "executor.escalate"),
    "serve.readback": ("executor.execute", "executor.escalate"),
    "serve.resolve_rows": ("executor.execute", "executor.escalate"),
    "serve.split": ("executor.device_call",),
    "serve.prune": ("executor.device_call",),
    "serve.kernel": ("executor.device_call",),
    "executor.device_wait": ("executor.device_call",),
    "executor.order_rows": ("executor.execute",),
}
PORT_ONLY = {"database.query", "executor.escalate", "serve.upload",
             "serve.readback", "serve.resolve_rows", "serve.split",
             "serve.prune", "serve.kernel", "executor.device_wait",
             "executor.order_rows", "executor.knn_seed",
             "executor.knn_refine"}


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with both obs layers off + empty."""
    for o in (obs, robs):
        o.disable()
        o.reset()
    yield
    for o in (obs, robs):
        o.disable()
        o.reset()


def fake_clock(step=1000):
    t = [0]

    def clk():
        t[0] += step
        return t[0]
    return clk


def _names(snapshot_metrics) -> set:
    return {k.split("{")[0] for k in snapshot_metrics}


@contextlib.contextmanager
def no_automatic_gc():
    """No automatic collection inside (each would be a `python.gc` span
    on the obs clock); explicit `gc.collect()` still runs the hooks."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------


def test_counter_and_gauge_basics():
    r = Registry()
    c = r.counter("q", kind="count")
    c.inc()
    c.inc(4)
    assert c.snapshot() == 5
    with pytest.raises(ValueError, match="monotonic"):
        c.inc(-1)
    g = r.gauge("depth")
    g.set(3.5)
    g.add(-1.0)
    assert g.snapshot() == 2.5
    # same name, different labels = different series
    assert r.counter("q", kind="range") is not c
    assert r.counter("q", kind="count") is c
    with pytest.raises(TypeError, match="already registered"):
        r.gauge("q", kind="count")


def test_histogram_quantiles_exact_nearest_rank():
    h = Histogram("lat")
    ref = robs.Histogram("lat")
    for v in range(1, 101):          # 1..100
        h.observe(v)
        ref.observe(v)
    assert h.exact
    assert h.percentile(50) == 50
    assert h.percentile(95) == 95
    assert h.percentile(99) == 99
    assert h.percentile(100) == 100
    q = h.quantiles()
    assert q["p50"] <= q["p95"] <= q["p99"]
    snap = h.snapshot()
    assert snap["count"] == 100 and snap["sum"] == 5050 and snap["exact"]
    assert snap == ref.snapshot()
    with pytest.raises(ValueError):
        h.percentile(0)


def test_histogram_reservoir_overflow_falls_back_to_buckets():
    h = Histogram("lat", max_samples=10)
    ref = robs.Histogram("lat", max_samples=10)
    for v in [2000] * 15:            # > cap: 5 dropped from the reservoir
        h.observe(v)
        ref.observe(v)
    assert not h.exact
    assert h.samples_dropped == 5
    # bucket fallback: upper bound of the bucket holding the rank (2048)
    assert h.percentile(50) == 2048
    assert h.snapshot()["samples_dropped"] == 5
    assert h.snapshot() == ref.snapshot()
    # monotone even on the bucket path
    q = h.quantiles()
    assert q["p50"] <= q["p95"] <= q["p99"]


def test_empty_histogram_has_no_quantiles():
    h = Histogram("lat")
    assert h.percentile(50) is None
    assert h.snapshot()["count"] == 0
    assert h.snapshot() == robs.Histogram("lat").snapshot()


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_spans_nest_with_deterministic_clock():
    tr = Tracer(clock=fake_clock())
    with tr.span("outer", kind="a"):
        with tr.span("inner"):
            pass
    spans = tr.snapshot()
    assert [s.name for s in spans] == ["inner", "outer"]  # finish order
    inner, outer = spans
    assert inner.depth == 1 and outer.depth == 0
    assert outer.t0_ns < inner.t0_ns
    assert inner.t1_ns <= outer.t1_ns
    assert outer.labels == {"kind": "a"}
    ref = robs.Tracer(clock=fake_clock())
    with ref.span("outer", kind="a"):
        with ref.span("inner"):
            pass
    assert [dataclasses.astuple(s)[:4] for s in spans] == \
        [dataclasses.astuple(s)[:4] for s in ref.snapshot()]


def test_span_label_after_open_and_histogram_feed():
    reg = Registry()
    tr = Tracer(clock=fake_clock(), registry=reg)
    with tr.span("planner.plan", kind="count") as sp:
        sp.label(engine="torch")
    s, = tr.snapshot()
    assert s.labels == {"kind": "count", "engine": "torch"}
    h = reg.histogram("planner.plan_ns", kind="count", engine="torch")
    assert h.count == 1 and h.sum == 1000


def test_span_buffer_bounded_with_drop_accounting():
    tr = Tracer(clock=fake_clock(), max_spans=3)
    for _ in range(5):
        with tr.span("s"):
            pass
    assert len(tr) == 3
    assert tr.spans_dropped == 2


def test_null_span_is_inert_and_shared():
    assert obs.span("anything", x=1) is NULL_SPAN
    with obs.span("nope") as sp:
        assert sp is NULL_SPAN
        assert sp.label(a=1) is NULL_SPAN
    assert len(obs.tracer) == 0


def test_disabled_hooks_record_nothing():
    obs.inc("c", 5)
    obs.observe("h", 1.0)
    obs.set_gauge("g", 2.0)
    assert obs.registry.snapshot() == {}
    for o in (obs, robs):
        o.enable(clock=fake_clock())
        o.inc("c", 5)
        o.observe("h", 1.0)
        o.set_gauge("g", 2.0)
    snap = obs.registry.snapshot()
    assert snap["c"] == 5 and snap["g"] == 2.0 and snap["h"]["count"] == 1
    assert snap == robs.registry.snapshot()


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def test_trace_export_balanced_and_nested(tmp_path):
    for o in (obs, robs):
        with no_automatic_gc():
            o.enable(clock=fake_clock())
            with o.span("outer", kind="count"):
                with o.span("inner"):
                    pass
            with o.span("solo"):
                pass
    path = tmp_path / "trace.json"
    n = obs.export_trace(str(path))
    assert n == 3
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    assert sum(1 for e in ev if e["ph"] == "B") == 3
    assert sum(1 for e in ev if e["ph"] == "E") == 3
    # nesting: outer opens before inner; inner closes before outer
    names = [(e["name"], e["ph"]) for e in ev]
    assert names.index(("outer", "B")) < names.index(("inner", "B"))
    assert names.index(("inner", "E")) < names.index(("outer", "E"))
    assert ev[0]["args"] == {"kind": "count"}
    assert doc["otherData"]["spans_dropped"] == 0
    assert doc["otherData"]["exporter"] == "repro_torch.obs"
    tss = [e["ts"] for e in ev]
    assert tss == sorted(tss)
    # the same events as the reference's, but for the category
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("cat",
                                                                  "tid")}
                         for e in evs]
    assert strip(ev) == strip(robs.trace_events())


def test_prometheus_text_format():
    for o in (obs, robs):
        o.enable(clock=fake_clock())
        o.inc("executor.queries", 7, kind="count")
        o.observe("lat", 2000)
    text = obs.prometheus_text()
    assert '# TYPE repro_executor_queries counter' in text
    assert 'repro_executor_queries{kind="count"} 7' in text
    assert '# TYPE repro_lat histogram' in text
    assert 'repro_lat_bucket{le="2048"} 1' in text
    assert 'repro_lat_bucket{le="+Inf"} 1' in text
    assert 'repro_lat_sum 2000.0' in text and 'repro_lat_count 1' in text
    assert text == robs.prometheus_text()


def test_thread_safety_of_registry_and_tracer():
    obs.enable()                        # real clock: concurrent increments
    errs = []

    def work():
        try:
            for _ in range(300):
                obs.inc("t.c")
                obs.observe("t.h", 5)
                with obs.span("t.s"):
                    pass
        except Exception as e:          # pragma: no cover
            errs.append(e)
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    snap = obs.registry.snapshot()
    assert snap["t.c"] == 1200
    assert snap["t.h"]["count"] == 1200
    # the collector's pauses are spans of their own (`python.gc`)
    assert sum(1 for s in obs.tracer.snapshot() if s.name == "t.s") + \
        obs.tracer.spans_dropped == 1200


# ---------------------------------------------------------------------------
# instrumentation is inert: results bit-identical with obs on
# ---------------------------------------------------------------------------


def _small_dbs(n=1200, seed=0, **eng):
    """The same index in both packages: the reference on `xla`, the port
    on `torch` (CPU), with the same knobs."""
    data = make_dataset("osm", n, seed=seed)
    K = default_K(2)
    Ls, Us = make_workload(data, 8, seed=seed + 1, K=K)
    kw = dict(q_chunk=8, max_cand=16, max_hits=128)
    kw.update(eng)
    ref = rapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                            cfg=RConfig(paging="heuristic", page_bytes=1024))
    ref.engine("xla", rapi.EngineConfig(**kw))
    port = tapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                             cfg=TConfig(paging="heuristic", page_bytes=1024),
                             device="cpu")
    port.engine("torch", tapi.EngineConfig(**kw))
    return ref, port, data, (Ls, Us)


def _assert_same(got, want, ctx=""):
    for f in FIELDS:
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{ctx} {f}")


def test_instrumented_queries_bit_identical_and_metrics_flow():
    ref, db, data, (Ls, Us) = _small_dbs()
    mk = lambda a: [a.Count(Ls, Us), a.Range(Ls, Us), a.Point(data[:5]),
                    a.Knn(data[:3], k=3)]
    want = [db.query(q) for q in mk(tapi)]             # obs off
    rwant = [ref.query(q) for q in mk(rapi)]
    obs.enable()
    got = [db.query(q) for q in mk(tapi)]              # obs on
    with db.session(engine="torch", tick=3) as s:      # coalesced, obs on
        tickets = [s.submit(q) for q in mk(tapi) for _ in range(2)]
    obs.disable()
    robs.enable()                                      # the reference, on
    rgot = [ref.query(q) for q in mk(rapi)]
    with ref.session(engine="xla", tick=3) as s:
        rtickets = [s.submit(q) for q in mk(rapi) for _ in range(2)]
    robs.disable()
    for w, g, rw, r in zip(want, got, rwant, rgot):
        _assert_same(g, w, "obs on")
        _assert_same(w, rw, "reference, obs off")
        _assert_same(g, r, "reference, obs on")
    for i, (t, rt) in enumerate(zip(tickets, rtickets)):
        _assert_same(t.result(timeout=60), want[i // 2], f"ticket {i}")
        _assert_same(t.result(timeout=60), rt.result(timeout=60),
                     f"reference ticket {i}")
    snap = db.stats()
    names = _names(snap["metrics"])
    for expected in ("planner.plan_ns", "executor.device_call_ns",
                     "executor.execute_ns", "executor.queries",
                     "session.service_ns", "session.queue_wait_ns",
                     "session.coalesce_size", "session.tick_fill"):
        assert expected in names, expected
    # the port's stage spans feed histograms the reference has not, and
    # kNN's box rows a counter
    stage = {n + "_ns" for n in PORT_ONLY} | {"executor.knn_box_rows"}
    assert stage - {"executor.escalate_ns"} <= names
    assert names - stage == _names(ref.stats()["metrics"])
    assert snap["executor_cache"]["calls"] > 0
    assert snap["executor_cache"] == ref.stats()["executor_cache"]
    # per-ticket service latency: one sample per coalesced submission
    svc = [v for k, v in snap["metrics"].items()
           if k.startswith("session.service_ns")]
    assert sum(h["count"] for h in svc) == len(tickets)
    for h in svc:
        assert h["p50"] <= h["p95"] <= h["p99"]
    assert db.stats(format="prometheus").startswith("# TYPE")
    with pytest.raises(ValueError, match="format"):
        db.stats(format="xml")


def _stages(o) -> dict:
    return {dict(m.labels)["stage"]: m.count for m in o.registry.metrics()
            if m.name == "executor.device_call_ns"}


def test_device_call_stages_are_disjoint_and_labeled():
    ref, db, data, (Ls, Us) = _small_dbs(n=2500, max_cand=1)  # the ladder
    obs.enable()
    res = db.query(tapi.Count(Ls, Us))   # cold: every rung's first launch
    res2 = db.query(tapi.Count(Ls, Us))  # warm: rungs book as escalate
    obs.disable()
    robs.enable()
    rres = ref.query(rapi.Count(Ls, Us))
    rres2 = ref.query(rapi.Count(Ls, Us))
    robs.disable()
    assert res.exact and res.escalations > 0
    stages = _stages(obs)
    # first launch of each (fn, shape) books as compile — even a ladder
    # rung; only warm rungs book as escalate (disjoint stages)
    assert stages.get("compile", 0) >= 1 + res.escalations
    assert stages.get("escalate", 0) == res2.escalations
    assert stages.get("first", 0) >= 1   # the warm first pass
    total = sum(stages.values())
    assert total == (res.plan.accounting.device_calls
                     + res2.plan.accounting.device_calls)
    assert stages == _stages(robs)
    for a, b in ((res, rres), (res2, rres2)):
        _assert_same(a, b)
        assert (a.escalations, a.cpu_fallbacks) == (b.escalations,
                                                    b.cpu_fallbacks)
        np.testing.assert_array_equal(a.overflowed, b.overflowed)


def test_fit_and_smbo_spans_recorded():
    data = make_dataset("osm", 400, seed=2)
    K = default_K(2)
    Ls, Us = make_workload(data, 4, seed=3, K=K)
    kw = dict(K=K, learn=True, sample=200,
              smbo={"max_iters": 1, "n_init": 2, "evals_per_iter": 1})
    obs.enable()
    db = tapi.Database.fit(data, (Ls, Us), device="cpu", **kw)
    obs.disable()
    robs.enable()
    ref = rapi.Database.fit(data, (Ls, Us), **kw)
    robs.disable()
    names = _names(obs.registry.snapshot())
    assert {"database.fit_ns", "database.fit.learn_ns",
            "database.fit.build_ns", "smbo.iteration_ns",
            "smbo.init_design_ns", "smbo.pool_eval_ns",
            "smbo.evaluations", "smbo.best_cost",
            "smbo.iteration"} <= names
    assert names == _names(robs.registry.snapshot())
    snap, rsnap = obs.registry.snapshot(), robs.registry.snapshot()
    for k in rsnap:
        if k.startswith(("smbo.evaluations", "smbo.best_cost",
                         "smbo.iteration{")):
            assert snap[k] == rsnap[k], k
    assert db.curve.to_json() == ref.curve.to_json()
    assert [(c.to_json(), y) for c, y in db.fit_result.evaluated] == \
        [(c.to_json(), y) for c, y in ref.fit_result.evaluated]


def test_pool_eval_dispatch_counters_match_reference():
    """A round big enough for the pooled program (4 candidates, 100 x 5,000
    >= 500,000 row-queries) books one dispatch and its candidates, as the
    reference's does."""
    data = make_dataset("osm", 5000, seed=4)
    K = default_K(2)
    Ls, Us = make_workload(data, 100, seed=5, K=K)
    kw = dict(K=K, learn=True, sample=5000,
              smbo={"max_iters": 1, "n_init": 4, "evals_per_iter": 4})
    obs.enable()
    db = tapi.Database.fit(data, (Ls, Us), device="cpu", **kw)
    obs.disable()
    robs.enable()
    ref = rapi.Database.fit(data, (Ls, Us), **kw)
    robs.disable()
    snap, rsnap = obs.registry.snapshot(), robs.registry.snapshot()
    assert snap["smbo.pool_eval.dispatches"] == 2    # init design + round 1
    assert snap["smbo.pool_eval.candidates"] == 8
    for k in ("smbo.pool_eval.dispatches", "smbo.pool_eval.candidates"):
        assert snap[k] == rsnap[k], k
    assert db.fit_result.history == ref.fit_result.history
    assert [(c.to_json(), y) for c, y in db.fit_result.evaluated] == \
        [(c.to_json(), y) for c, y in ref.fit_result.evaluated]
    assert db.curve.to_json() == ref.curve.to_json()


def test_obs_on_and_off_give_identical_learning_and_serving():
    """Instrumentation never changes what is learned or served: the same
    fit and the same queries with obs off and on (served under a recording
    profiler, so every span opens its `record_function` range) are
    identical, Count and Range through the escalation ladder included."""
    from torch.profiler import ProfilerActivity, profile
    data = make_dataset("osm", 5000, seed=6)
    K = default_K(2)
    Ls, Us = make_workload(data, 100, seed=7, K=K)
    runs = []
    for on in (False, True):
        if on:
            obs.enable()
        # 4 candidates x 100 queries x 5,000 rows: the pooled program
        res = learn_sfc(data, Ls, Us, K=K, max_iters=1, n_init=4,
                        evals_per_iter=4, seed=3, device="cpu")
        db = tapi.Database.fit(data, (Ls, Us), K=K, curve=res.curve_best,
                               cfg=TConfig(page_bytes=1024), device="cpu")
        db.engine("torch", tapi.EngineConfig(q_chunk=8, max_cand=1,
                                             max_hits=64))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            served = [db.query(q) for q in (
                tapi.Count(Ls, Us), tapi.Range(Ls, Us),
                tapi.Point(data[::97]),
                tapi.Knn(data[:4], k=5, metric="linf"))]
        obs.disable()
        ranges = collections.Counter(e.name for e in prof.events())
        runs.append((res, served, ranges))
    (r0, s0, g0), (r1, s1, g1) = runs
    assert r0.curve_best.to_json() == r1.curve_best.to_json()
    assert r0.history == r1.history
    assert [(c.to_json(), y) for c, y in r0.evaluated] == \
        [(c.to_json(), y) for c, y in r1.evaluated]
    for a, b in zip(s0, s1):
        _assert_same(b, a)
        assert (a.escalations, a.cpu_fallbacks) == (b.escalations,
                                                    b.cpu_fallbacks)
        for f in ("overflowed", "residual_overflow"):
            if hasattr(a, f):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    # the ladder ran for Count and Range, both times
    assert s0[0].escalations > 0 and s0[1].escalations > 0
    assert g0["executor.escalate"] == 0
    assert g1["executor.escalate"] >= s1[0].escalations + s1[1].escalations
    assert "smbo.iteration_ns" in _names(obs.registry.snapshot())


# ---------------------------------------------------------------------------
# the port's stage spans, their profiler ranges and the collector's pauses
# ---------------------------------------------------------------------------


def _port_db(n=2500, **eng):
    """A port-only database on the CPU `torch` engine whose budgets force
    the escalation ladder (max_cand 1, max_hits 16)."""
    data = make_dataset("osm", n, seed=0)
    K = default_K(2)
    Ls, Us = make_workload(data, 24, seed=1, K=K)
    kw = dict(q_chunk=8, max_cand=1, max_hits=16)
    kw.update(eng)
    db = tapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                           cfg=TConfig(paging="heuristic", page_bytes=1024),
                           device="cpu")
    db.engine("torch", tapi.EngineConfig(**kw))
    return db, Ls, Us


def _parent(span, spans):
    """The span `span` opened under: the enclosing one a level up."""
    up = [p for p in spans if p.depth == span.depth - 1
          and p.t0_ns <= span.t0_ns and span.t1_ns <= p.t1_ns]
    assert len(up) <= 1, (span, up)
    return up[0].name if up else None


@pytest.mark.parametrize("kind", ["count", "range"])
def test_stage_spans_nest_once_a_chunk_or_a_call(kind, monkeypatch):
    """Every stage span of one call under forced escalation: opened under
    the span the table names, `serve.split`, `executor.device_wait`,
    `serve.upload` and `serve.readback` once a device call (and
    `serve.resolve_rows` once a Range device call), `serve.prune` and
    `serve.kernel` once a q_chunk piece of its padded batch,
    `executor.escalate` once a rung, the rest once a call."""
    db, Ls, Us = _port_db()
    q = (tapi.Count if kind == "count" else tapi.Range)(Ls, Us)
    db.query(q)                                  # every shape launched
    eng = db._engines["torch"]
    run = "run" if kind == "count" else "run_range"
    sizes = []
    real = getattr(eng, run)

    def counted(Ls, Us, **kw):
        sizes.append(len(Ls))
        return real(Ls, Us, **kw)
    monkeypatch.setattr(eng, run, counted)
    with no_automatic_gc():
        obs.enable(clock=fake_clock())
        res = db.query(q)
        obs.disable()
    spans = obs.tracer.snapshot()
    assert res.escalations > 0
    n = collections.Counter(s.name for s in spans)
    calls = 1 + res.escalations
    chunks = sum(bucket_pow2(m, 8) // 8 for m in sizes)
    assert len(sizes) == calls == res.plan.accounting.device_calls
    want = {"database.query": 1, "planner.plan": 1, "executor.execute": 1,
            "executor.escalate": res.escalations,
            "executor.device_call": calls, "executor.device_wait": calls,
            "serve.upload": calls, "serve.split": calls,
            "serve.readback": calls, "serve.prune": chunks,
            "serve.kernel": chunks}
    if kind == "range":
        want.update({"serve.resolve_rows": calls, "executor.order_rows": 1})
    assert dict(n) == want
    for sp in spans:
        assert _parent(sp, spans) in STAGE_PARENTS[sp.name], sp.name
    assert {s.labels["kind"] for s in spans
            if s.name in ("serve.prune", "executor.escalate")} == {kind}
    q0 = next(s for s in spans if s.name == "database.query")
    assert q0.labels == {"kind": kind, "engine": "torch"}


def test_obs_off_records_no_span_and_opens_no_range(monkeypatch):
    """With obs off the path makes no span object, records nothing, opens
    no `record_function` range under a recording profiler and imports no
    module."""
    from torch.profiler import ProfilerActivity, profile
    db, Ls, Us = _port_db()
    queries = [tapi.Count(Ls, Us), tapi.Range(Ls, Us)]
    for q in queries:                            # warm: lazy imports done
        db.query(q)
    opened = []

    def no_span(*a, **kw):
        raise AssertionError(f"span object made with obs off: {a}")
    monkeypatch.setattr(obs.tracer, "span", no_span)
    monkeypatch.setattr("torch.profiler.record_function",
                        lambda *a, **kw: opened.append(a))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = set(sys.modules)
        for q in queries:
            db.query(q)
        added = set(sys.modules) - before
    assert not opened and not added
    assert len(obs.tracer) == 0 and obs.registry.snapshot() == {}
    assert not {e.name for e in prof.events()} & set(STAGE_PARENTS)


def test_profiler_sees_every_span_as_a_range_of_its_name():
    """With obs on under a recording CPU profiler, each span opens a
    `record_function` range of its name: as many ranges as spans."""
    from torch.profiler import ProfilerActivity, profile
    db, Ls, Us = _port_db()
    queries = [tapi.Count(Ls, Us), tapi.Range(Ls, Us)]
    for q in queries:
        db.query(q)
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for q in queries:
            db.query(q)
    obs.disable()
    spans = collections.Counter(s.name for s in obs.tracer.snapshot()
                                if s.name != "python.gc")
    ranges = collections.Counter(e.name for e in prof.events()
                                 if e.name in spans)
    assert set(STAGE_PARENTS) <= set(spans)
    assert ranges == spans
    # outside a profiler no range opens, the spans still record
    obs.reset()
    obs.enable()
    with obs.span("solo") as sp:
        assert sp._range is None
    obs.disable()
    assert [s.name for s in obs.tracer.snapshot()] == ["solo"]


def test_collector_pauses_are_spans_while_obs_is_on():
    """`enable` hooks the collector, `disable` unhooks it: each
    collection in between is a `python.gc` span, labelled by generation,
    one level under the span it paused, feeding no histogram.  The hook
    takes no lock, so a collection that starts while the tracer's lock is
    held still files its span later."""
    obs.enable()
    obs.enable()
    assert gc.callbacks.count(obs.tracer.gc_callback) == 1
    with no_automatic_gc():
        with obs.span("outer"):
            gc.collect()
        with obs.tracer._lock:                   # as inside `_finish`
            obs.tracer.gc_callback("start", {"generation": 0})
            obs.tracer.gc_callback("stop", {"generation": 0})
        spans = obs.tracer.snapshot()
    outer, = [s for s in spans if s.name == "outer"]
    pause = [s for s in spans if s.name == "python.gc"]
    assert [s.labels for s in pause] == [{"generation": 2},
                                         {"generation": 0}]
    assert pause[0].depth == outer.depth + 1
    assert outer.t0_ns <= pause[0].t0_ns and pause[0].t1_ns <= outer.t1_ns
    assert "python.gc_ns" not in _names(obs.registry.snapshot())
    obs.disable()
    assert obs.tracer.gc_callback not in gc.callbacks
    n = len(obs.tracer)
    gc.collect()
    assert len(obs.tracer) == n


# ---------------------------------------------------------------------------
# structured logging (repro_torch.obs.log)
# ---------------------------------------------------------------------------


def test_logging_silent_by_default_and_byte_compatible_when_configured():
    from repro_torch.obs import log as obs_log

    logger = obs_log.get_logger("launch.train")
    assert logger.name == "repro_torch.launch.train"
    assert obs_log.get_logger("repro_torch.core").name == "repro_torch.core"
    root = logging.getLogger("repro_torch")
    assert any(isinstance(h, logging.NullHandler) for h in root.handlers)
    buf = io.StringIO()
    obs_log.configure(stream=buf)
    step, loss, gnorm, dt = 3, 0.1234, 1.5, 0.0421
    logger.info("step %d: loss=%.4f gnorm=%.3f %.0fms",
                step, loss, gnorm, dt * 1e3)
    printed = f"step {step}: loss={loss:.4f} gnorm={gnorm:.3f} {dt*1e3:.0f}ms"
    assert buf.getvalue() == printed + "\n"
    # idempotent: re-configure replaces, never stacks handlers
    n = len(root.handlers)
    obs_log.configure(stream=buf)
    assert len(root.handlers) == n
    root.handlers[:] = [logging.NullHandler()]


def test_enable_disable_reset_roundtrip():
    assert not obs.enabled()
    with no_automatic_gc():
        obs.enable(clock=fake_clock())
        assert obs.enabled()
        assert obs.tracer.gc_callback in gc.callbacks
        assert obs.clock_ns() == 1000
        with obs.span("s"):
            pass
        assert len(obs.tracer) == 1
    obs.reset()
    assert len(obs.tracer) == 0 and obs.registry.snapshot() == {}
    assert obs.enabled()                # reset clears data, not the switch
    obs.disable()
    assert not obs.enabled()
    assert obs.tracer.gc_callback not in gc.callbacks
    import time
    assert abs(obs.clock_ns() - time.perf_counter_ns()) < 10 ** 9
