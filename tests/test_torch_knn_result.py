"""kNN's box accounting on the port's `KnnResult`: `overflowed`,
`residual_overflow` and `box_rows`, and kNN's stage spans.

A device engine answers a kNN batch in three stages (`_exec_knn`): the
seed (page rings around each center's curve address give a covering box,
`executor.knn_seed`), the box retrieval through the Range path, and the
refine (exact integer distances and the (distance, lexicographic row)
tie-break, `executor.knn_refine`).  The result carries the box
retrieval's first-pass and residual overflow flags, as `RangeResult`
does, and the rows each box returned (`executor.knn_box_rows` counts
them); the `cpu` engine retrieves no box and reads zeros.

Each case holds the answers to the reference's (`repro.api`, through
`Pair` from `tests/test_torch_api.py`, or its `Router`), to its
`query_knn` walk and to `brute_force_knn`: the new fields change no
answer.  The engines: `cpu`, `torch` (the reference's `xla`) with
budgets that force both overflow dimensions, and `distributed`, which
routes kNN to `cpu`; then `Router` over three shards and `Session`.
"""
import collections

import numpy as np
import pytest

from repro import api as rapi
from repro.core.index import IndexConfig as RConfig
from repro.core.query import brute_force_count, brute_force_knn
from repro.core.query import query_knn as r_query_knn
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch import api as tapi
from repro_torch import obs
from repro_torch.core.index import IndexConfig
from repro_torch.core.query import knn_box
from test_torch_api import Pair

K = default_K(2)
FORCED = dict(q_chunk=8, max_cand=1, max_hits=16)   # both overflow kinds
CFG = dict(paging="heuristic", page_bytes=1024)


def _centers(data):
    """Centers on rows, off rows, at both corners of the domain and far
    from every row."""
    top = 2**K - 1
    off = data[10:13] + np.uint64(3)
    return np.concatenate([
        data[5:9], off,
        np.asarray([[0, 0], [top, top], [0, top], [7, 9]], dtype=np.uint64),
    ]).astype(np.uint64)


@pytest.fixture(scope="module")
def scene():
    data = make_dataset("osm", 2500, seed=0)
    Ls, Us = make_workload(data, 8, seed=1, K=K)
    pair = Pair(data, (Ls, Us), K=K, page_bytes=CFG["page_bytes"])
    pair.engine("xla", **FORCED)
    port = tapi.Database.fit(data, (Ls, Us), K=K, learn=False,
                             cfg=IndexConfig(**CFG), device="cpu")
    port.engine("torch", tapi.EngineConfig(**FORCED))
    return pair, port, data


def _same_answers(res, data, centers, k, ctx=""):
    for i, c in enumerate(centers):
        want, wd = brute_force_knn(data, c, k, "l2")
        np.testing.assert_array_equal(res.neighbors_for(i), want,
                                      err_msg=f"{ctx} c{i}")
        np.testing.assert_array_equal(res.dists_for(i),
                                      np.asarray(wd, dtype=np.float64))


def _assert_fields(res, q):
    assert res.overflowed.shape == res.residual_overflow.shape == (q,)
    assert res.box_rows.shape == (q,)
    assert res.overflowed.dtype == res.residual_overflow.dtype == np.int32
    assert res.box_rows.dtype == np.int64
    assert not res.residual_overflow.any() and res.exact


@pytest.mark.parametrize("name", ["cpu", "xla", "distributed"])
def test_knn_box_accounting_on_each_engine(scene, name):
    pair, port, data = scene
    if name == "distributed":
        pair.engine("distributed", q_chunk=8,
                    max_cand=pair.port.num_pages)
    centers = _centers(data)
    k = 6
    res = pair.query(lambda a: a.Knn(centers, k=k), engine=name)
    _same_answers(res, data, centers, k, name)
    for i, c in enumerate(centers):
        rows, dd, _ = r_query_knn(pair.ref.index, c, k, "l2")
        np.testing.assert_array_equal(res.neighbors_for(i), rows)
        np.testing.assert_array_equal(res.dists_for(i),
                                      np.asarray(dd, dtype=np.float64))
    _assert_fields(res, len(centers))
    if name != "xla":                    # the cpu walk, or routed to it
        assert res.engine == "cpu"
        assert not res.overflowed.any() and not res.box_rows.any()
        return
    # the torch engine: each box is the seed's, its rows those inside it,
    # its flags the Range path's on the same boxes
    eng = port._get_engine("torch")[1]
    radius = eng.knn_radius(centers, k, "l2")
    boxes = [knn_box(c, r, K) for c, r in zip(centers, radius)]
    Ls = np.stack([b[0] for b in boxes])
    Us = np.stack([b[1] for b in boxes])
    want_rows = [brute_force_count(data, lo, hi) for lo, hi in boxes]
    np.testing.assert_array_equal(res.box_rows, want_rows)
    assert (res.box_rows >= k).all()
    rng = port.query(tapi.Range(Ls, Us))
    np.testing.assert_array_equal(res.overflowed, rng.overflowed)
    np.testing.assert_array_equal(res.box_rows, rng.counts)
    assert res.overflowed.any() and res.escalations > 0


def test_knn_box_accounting_through_the_router(scene):
    """Merged over three shards: a center's box flags are the OR of the
    shards' and its box rows their sum; the answers the reference
    Router's and the unsharded oracle's."""
    _, _, data = scene
    ref = rapi.Router.build(data, 3, K=K, learn=False, cfg=RConfig(**CFG))
    router = tapi.Router.build(data, 3, K=K, learn=False,
                               cfg=IndexConfig(**CFG), device="cpu")
    ref.engine("xla", rapi.EngineConfig(**FORCED))
    router.engine("torch", tapi.EngineConfig(**FORCED))
    centers = _centers(data)
    got = router.query(tapi.Knn(centers, k=6))
    want = ref.query(rapi.Knn(centers, k=6))
    for f in ("neighbors", "dists", "offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    _same_answers(got, data, centers, 6, "router")
    _assert_fields(got, len(centers))
    parts = [s.query(tapi.Knn(centers, k=6)) for s in router.shards]
    np.testing.assert_array_equal(
        got.overflowed, np.any([p.overflowed for p in parts], axis=0))
    np.testing.assert_array_equal(
        got.box_rows, np.sum([p.box_rows for p in parts], axis=0))
    assert got.overflowed.any() and (got.box_rows > 0).all()


def test_knn_box_accounting_through_a_session(scene):
    """Each ticket of a coalesced kNN batch gets its own centers' slice
    of the fields, equal to a serial query of those centers."""
    _, port, data = scene
    centers = _centers(data)
    cuts = [(0, 3), (3, 4), (4, len(centers))]
    with port.session(engine="torch", tick=len(cuts)) as s:
        tickets = [s.submit(tapi.Knn(centers[a:b], k=6)) for a, b in cuts]
    for t, (a, b) in zip(tickets, cuts):
        got = t.result(timeout=60)
        want = port.query(tapi.Knn(centers[a:b], k=6))
        _assert_fields(got, b - a)
        for f in ("neighbors", "dists", "offsets", "overflowed",
                  "residual_overflow", "box_rows"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        _same_answers(got, data, centers[a:b], 6, "session")


def test_knn_spans_and_counter_with_obs_on_and_off(scene):
    _, port, data = scene
    q = tapi.Knn(_centers(data), k=6)
    off = port.query(q)
    obs.disable()
    obs.reset()
    assert len(obs.tracer) == 0
    obs.enable()
    try:
        on = port.query(q)
        spans = obs.tracer.snapshot()
        counters = {m.name: m.value for m in obs.registry.metrics()
                    if m.kind == "counter"}
    finally:
        obs.disable()
        obs.reset()
    for f in ("neighbors", "dists", "offsets", "overflowed",
              "residual_overflow", "box_rows"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f))
    n = collections.Counter(s.name for s in spans)
    assert n["executor.knn_seed"] == n["executor.knn_refine"] == 1
    execute, = [s for s in spans if s.name == "executor.execute"]
    for s in spans:
        if s.name.startswith("executor.knn_"):
            assert s.labels == {"kind": "knn", "engine": "torch"}
            assert s.depth == execute.depth + 1
            assert execute.t0_ns <= s.t0_ns and s.t1_ns <= execute.t1_ns
    seed, = [s for s in spans if s.name == "executor.knn_seed"]
    refine, = [s for s in spans if s.name == "executor.knn_refine"]
    assert seed.t1_ns <= refine.t0_ns
    assert counters["executor.knn_box_rows"] == int(on.box_rows.sum()) > 0
    # obs off: the same call records nothing
    port.query(q)
    assert len(obs.tracer) == 0 and obs.registry.snapshot() == {}
