"""The port's `Database` facade (`repro_torch.api`) against the reference's
(`repro.api`): cross-engine parity with overflow escalation, the
update→serve path (DeltaStore epochs, dirty-page refresh, tombstones,
capacity growth), rebuild policies, and the legacy update shims.

Twins of `tests/test_api_database.py` (those of `tests/test_updates.py`
are in `tests/test_torch_updates.py`, which imports `Pair` from here).
Each builds the same seeded numpy data and queries for the reference's
`Database` (engines `cpu`, `xla`, and `pallas` in interpret mode) and the
port's (`cpu`, `torch` on the CPU with ``device="cpu"``; `torch`, on the
kernels' plain twins, also stands in for `pallas`), runs the same steps on
both, and holds every output equal, exactly: counts, rows, offsets, found
flags, kNN rows and distances, overflow flags, escalations, CPU
fallbacks, epochs, `QueryPlan.describe()` (engine names mapped), the plan's
accounting and `CacheStats`.  The reference test's own checks (brute
force, capacity growth, epochs) run on the port's side.  The `cuda`
engine refuses a CPU device and is driven on a card by
`tests/test_torch_cuda.py`; the `distributed` engine's twins are in
`tests/test_torch_dist.py` (the store and the serving front have files of
their own: `tests/test_torch_store.py`, `tests/test_torch_serving.py`).
"""
import dataclasses

import numpy as np
import pytest

from repro import api as rapi
from repro.core import index as rindex_mod
from repro.core.index import IndexConfig as RConfig
from repro.core.index import LMSFCIndex as RIndex
from repro.core.query import brute_force_count
from repro.core.serve import pack_serving_arrays as r_pack
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch import api as tapi
from repro_torch.api.deltas import get_delta_store, rows_in_set
from repro_torch.core import index as index_mod
from repro_torch.core.index import IndexConfig, LMSFCIndex
from repro_torch.core.serve import ServingArrays, pack_serving_arrays

PORT_ENGINE = {"xla": "torch", "pallas": "torch", "cpu": "cpu",
               "distributed": "distributed", None: None}
ARRAYS = ("counts", "rows", "offsets", "found", "neighbors", "dists",
          "overflowed", "residual_overflow")
SCALARS = ("escalations", "cpu_fallbacks", "epoch", "k", "metric")


def assert_same(got, want, ctx=""):
    """The port's result `got` equals the reference's `want` on every
    output and on its executed plan."""
    for f in ARRAYS:
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{ctx} {f}")
    for f in SCALARS:
        if hasattr(want, f):
            assert getattr(got, f) == getattr(want, f), (ctx, f)
    assert got.engine == PORT_ENGINE[want.engine], ctx
    if want.stats is not None:
        assert dataclasses.asdict(got.stats) == \
            dataclasses.asdict(want.stats), ctx
    assert got.plan.describe() == want.plan.describe().replace(
        f"'{want.engine}'", f"'{got.engine}'"), ctx
    ga = dataclasses.asdict(got.plan.accounting)
    wa = dataclasses.asdict(want.plan.accounting)
    assert ga == wa, (ctx, ga, wa)


class Pair:
    """One scenario in both packages: the reference's `Database` and the
    port's, built from the same data; every call goes to both and every
    result is compared (`assert_same`), with both executors' `CacheStats`."""

    def __init__(self, data, workload=None, *, K, policy=None, curve=None,
                 **cfg):
        cfg = dict(paging="heuristic", **cfg)
        kw = dict(K=K, learn=False)
        if curve is not None:
            kw["curve"] = curve
        self.ref = rapi.Database.fit(
            data, workload, cfg=RConfig(**cfg),
            policy=policy and getattr(rapi, type(policy).__name__)(
                **dataclasses.asdict(policy)), **kw)
        self.port = tapi.Database.fit(data, workload, cfg=IndexConfig(**cfg),
                                      policy=policy, device="cpu", **kw)

    def engine(self, name, **cfg):
        port_cfg = dict(cfg)
        if name == "pallas":      # its kernels on the host: interpret mode
            cfg["interpret"] = True
        self.ref.engine(name, rapi.EngineConfig(**cfg))
        self.port.engine(PORT_ENGINE[name], tapi.EngineConfig(**port_cfg))
        return self

    def query(self, make, engine=None, ctx=""):
        """`make(api)` builds the query (or legacy bounds tuple) in one
        package's algebra."""
        args = make(rapi)
        want = self.ref.query(*args if isinstance(args, list) else (args,),
                              engine=engine)
        args = make(tapi)
        got = self.port.query(*args if isinstance(args, list) else (args,),
                              engine=PORT_ENGINE[engine])
        assert_same(got, want, ctx)
        assert dataclasses.asdict(self.port.executor.cache) == \
            dataclasses.asdict(self.ref.executor.cache), ctx
        return got

    def both(self, method, *args, **kw):
        """Call a mutating method on both; their returns must agree."""
        a = getattr(self.ref, method)(*args, **kw)
        b = getattr(self.port, method)(*args, **kw)
        if isinstance(a, (int, np.integer)):
            assert a == b, method
        return b


def _data(n=4000, n_q=16, seed=0):
    data = make_dataset("osm", n, seed=seed)
    K = default_K(2)
    Ls, Us = make_workload(data, n_q, seed=seed + 1, K=K)
    want = np.asarray([brute_force_count(data, l, u) for l, u in zip(Ls, Us)])
    return data, (Ls, Us), K, want


def _db(n=4000, n_q=16, seed=0, page_bytes=1024, **fit_kw):
    data, wl, K, want = _data(n, n_q, seed)
    return Pair(data, wl, K=K, page_bytes=page_bytes, **fit_kw), data, wl, want


def _count(wl):
    return lambda a: a.Count(*wl)


# ---------------------------------------------------------------------------
# acceptance: identical counts on cpu / torch, incl. overflow
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def overflowing():
    """The cross-engine fixture: 4,000 rows in many pages, 16 queries."""
    pair, data, wl, want = _db()
    assert pair.port.num_pages > 8  # must be able to overflow max_cand=1
    return pair, data, wl, want


def test_cross_engine_parity_with_overflow_escalation(overflowing):
    """The same workload through cpu and torch returns identical counts —
    including queries that overflow max_cand=1, which escalation (doubled
    max_cand, CPU fallback) makes exact — and the same accounting as the
    reference's cpu and xla engines."""
    pair, data, wl, want = overflowing
    results = {"cpu": pair.query(lambda a: wl, engine="cpu")}
    pair.engine("xla", max_cand=1, q_chunk=8)
    results["torch"] = pair.query(lambda a: wl)
    for name, res in results.items():
        assert res.exact, name
        np.testing.assert_array_equal(res.counts, want, err_msg=name)
    # the device engine really did overflow on the first pass + escalated
    assert np.any(results["torch"].overflowed > 0)
    assert results["torch"].escalations > 0
    # CPU never overflows and carries the full mechanical stats
    assert not results["cpu"].overflowed.any()
    assert results["cpu"].stats.pages_accessed > 0


def test_escalation_disabled_flags_residual_overflow(overflowing):
    pair, data, wl, want = overflowing
    pair.engine("xla", max_cand=1, q_chunk=8, escalate=False,
                cpu_fallback=False)
    res = pair.query(lambda a: wl)
    assert not res.exact and res.residual_overflow.any()
    ok = res.residual_overflow == 0
    np.testing.assert_array_equal(res.counts[ok], want[ok])
    assert np.all(res.counts[~ok] <= want[~ok])  # undercounts only


def test_kernel_backend_parity_with_pallas_interpret_mode():
    """The reference's Pallas kernels (interpret mode) against the port's
    `torch` engine, whose plain twins are what the CUDA kernels are held
    to; the `cuda` engine itself refuses a CPU device (it is driven on a
    card by `tests/test_torch_cuda.py`)."""
    pair, data, wl, want = _db(n=2000, n_q=8, page_bytes=2048)
    pair.engine("pallas", q_chunk=8, max_cand=pair.port.num_pages)
    assert pair.port.engines["torch"].backend == "torch"
    res = pair.query(_count(wl))
    assert res.exact
    np.testing.assert_array_equal(res.counts, want)
    with pytest.raises(ValueError, match="CUDA device"):
        pair.port.engine("cuda", tapi.EngineConfig(q_chunk=8))
    with pytest.raises(ValueError, match="CUDA device"):
        pair.port.query(tapi.Count(*wl), engine="cuda")


def test_cuda_engine_needs_a_card_and_the_kernels(monkeypatch):
    """Without a card a `cuda` engine cannot attach (device None means
    CUDA); it takes no backend but the kernels, and `torch` none but the
    twins; the `torch` engine on a card-less host without ``device="cpu"``
    raises too, and so does a query with no engine attached, whose default
    is `cuda` unless the Database was asked for the CPU — nothing quietly
    serves from the host."""
    import torch
    data, wl, K, _ = _data(n=1500, n_q=4)
    db = tapi.Database.fit(data, wl, K=K, learn=False)   # no device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            db.engine(name)
    with pytest.raises(ValueError, match="backend"):
        db.engine("cuda", tapi.EngineConfig(backend="torch"))
    for backend in ("xla", "cuda"):
        with pytest.raises(ValueError, match="backend"):
            db.engine("torch", tapi.EngineConfig(backend=backend,
                                                 device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        db.query(tapi.Count(*wl))
    with pytest.raises(RuntimeError, match="CUDA"):
        db.explain(tapi.Count(*wl))
    assert db.active_engine is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert db.default_engine == "cuda"
    on_host = tapi.Database(db.index, device="cpu")
    assert on_host.default_engine == "cpu"
    assert on_host.query(tapi.Count(*wl)).engine == "cpu"


def test_engines_and_paths_that_wait_raise_naming_roadmap(tmp_path):
    """No engine or path of the reference waits any more.  The
    distributed engine attaches (`make_engine`, `engine`, a per-call
    `engine=`) and counts like the reference's, and `EngineConfig.mesh`
    is a knob the other engines ignore, as in the reference.  The store
    and the serving front: the `store` engine refuses a Database with no
    segment, `group_pages`/`cache_bytes` are store knobs the other engines
    ignore, a missing segment raises `StoreCorruptionError`, and `serve`
    returns a server."""
    from repro.store import StoreCorruptionError as RCorrupt
    from repro_torch import serving
    from repro_torch.store import StoreCorruptionError
    data, wl, K, want = _data(n=1500, n_q=4)
    db = tapi.Database.fit(data, wl, K=K, learn=False, device="cpu")
    ref = rapi.Database.fit(data, wl, K=K, learn=False)
    assert isinstance(tapi.make_engine("distributed", db),
                      tapi.engines.BaseEngine)
    got = db.query(tapi.Count(*wl), engine="distributed")
    rgot = ref.query(rapi.Count(*wl), engine="distributed")
    assert got.engine == rgot.engine == "distributed" and got.exact
    np.testing.assert_array_equal(got.counts, rgot.counts)
    np.testing.assert_array_equal(got.counts, want)
    assert db.engine("distributed") is db and \
        db.active_engine == "distributed"
    for api, d in ((rapi, ref), (tapi, db)):
        with pytest.raises(ValueError, match="on-disk segment"):
            d.engine("store")
        assert d.segment is None
        with pytest.raises(StoreCorruptionError if api is tapi
                           else RCorrupt, match="MANIFEST"):
            api.Database.from_segment(str(tmp_path / "segment-dir"))
    for name, port_name in (("xla", "torch"), ("pallas", "cuda")):
        with pytest.raises(KeyError, match=port_name):
            db.engine(name)
    for name in ("cpu", "torch"):
        db.engine(name, tapi.EngineConfig(mesh=["cpu"] * 2, group_pages=64,
                                          cache_bytes=1 << 28))
        res = db.query(tapi.Count(*wl))
        assert res.engine == name and res.exact
        np.testing.assert_array_equal(res.counts, want)
    with db.serve(engine="cpu") as srv:
        assert isinstance(srv, serving.AsyncServer)
        np.testing.assert_array_equal(
            srv.submit(tapi.Count(*wl)).result(timeout=30).counts,
            db.query(tapi.Count(*wl), engine="cpu").counts)
    assert tapi.engine_names() == ["cpu", "cuda", "distributed", "store",
                                   "torch"]


# ---------------------------------------------------------------------------
# update → serve path
# ---------------------------------------------------------------------------


def _mutate(pair, data, seed=7, n_new=80):
    """Insert fresh rows + tombstone a base and an inserted row in both;
    returns the live logical row set."""
    K = pair.port.index.K
    rng = np.random.default_rng(seed)
    new = np.unique(rng.integers(0, 2**K, size=(n_new, pair.port.d),
                                 dtype=np.uint64), axis=0)
    new = new[~rows_in_set(new, data)]
    pair.both("insert", new)
    dead = [data[5], new[0]]
    pair.both("delete", dead)
    logical = np.concatenate([data, new])
    tomb = {tuple(map(int, r)) for r in dead}
    keep = np.asarray([tuple(map(int, r)) not in tomb for r in logical])
    return np.unique(logical[keep], axis=0)


def _want(logical, wl):
    return np.asarray([brute_force_count(logical, l, u) for l, u in zip(*wl)])


def test_inserts_visible_through_torch_engine_after_refresh():
    pair, data, wl, _ = _db(n=2500, n_q=12, page_bytes=2048)
    pair.engine("xla", q_chunk=8, max_cand=pair.port.num_pages)
    pair.query(lambda a: wl)                        # arrays packed at epoch 0
    eng = pair.port.engines["torch"]
    epoch0 = eng.built_epoch
    logical = _mutate(pair, data)
    store = pair.port.store
    assert store.epoch > epoch0                     # mutations bumped epoch
    assert store.dirty_since(epoch0)                # ...and stamped pages
    assert store.dirty_since(epoch0) == \
        pair.ref.store.dirty_since(epoch0)
    pair.both("refresh")
    assert eng.built_epoch == store.epoch           # arrays current again
    res = pair.query(lambda a: wl, engine="xla")
    assert res.exact
    np.testing.assert_array_equal(res.counts, _want(logical, wl))
    # tombstoned rows are point-query invisible (count 0 on their cell)
    dead = data[5]
    res = pair.query(lambda a: (dead, dead), engine="xla")
    assert int(res.counts[0]) == 0
    # and the CPU engine agrees on the full workload
    np.testing.assert_array_equal(
        pair.query(lambda a: wl, engine="cpu").counts, _want(logical, wl))


def test_on_stale_error_and_serve_stale_policies():
    pair, data, wl, want = _db(n=2000, n_q=8, page_bytes=2048)
    pair.engine("xla", q_chunk=8, max_cand=pair.port.num_pages,
                on_stale="error")
    np.testing.assert_array_equal(pair.query(lambda a: wl).counts, want)
    pair.both("insert", np.asarray([[1, 2]], dtype=np.uint64))
    with pytest.raises(rapi.StaleServingError):
        pair.ref.query(wl)
    with pytest.raises(tapi.StaleServingError):
        pair.port.query(wl)
    pair.ref.refresh("xla")
    pair.port.refresh("torch")                      # explicit refresh
    assert pair.query(lambda a: wl).exact
    # serve_stale: answers from the pre-insert snapshot, no error
    pair.engine("xla", q_chunk=8, max_cand=pair.port.num_pages,
                on_stale="serve_stale")
    pair.both("insert", np.asarray([[3, 4]], dtype=np.uint64))
    np.testing.assert_array_equal(pair.query(lambda a: wl).counts, want)


def _burst(data, base_row, cap0, K, exclude):
    """Near-duplicates of one base row: enough inserts into one page's
    z-neighbourhood to overflow the packed point capacity."""
    base = data[base_row].astype(np.int64)
    new = np.unique(np.stack(
        [np.clip(base + [dx, 0], 0, 2**K - 1).astype(np.uint64)
         for dx in range(1, cap0 + 16)]), axis=0)
    return new[~rows_in_set(new, exclude)]


def test_delta_page_capacity_growth_repack():
    """Enough inserts into one page overflow the packed point capacity; the
    refresh must grow cap (full repack) and stay exact."""
    pair, data, wl, _ = _db(n=1500, n_q=8, page_bytes=2048)
    pair.engine("xla", q_chunk=8, max_cand=pair.port.num_pages)
    pair.query(lambda a: wl)
    cap0 = pair.port.engines["torch"]._host.points.shape[2]
    new = _burst(data, 100, cap0, pair.port.index.K, data)
    pair.both("insert", new)
    logical = np.unique(np.concatenate([data, new]), axis=0)
    res = pair.query(lambda a: wl, engine="xla")    # auto-refresh grows cap
    assert pair.port.engines["torch"]._host.points.shape[2] > cap0
    assert pair.port.engines["torch"]._host.points.shape == \
        pair.ref.engines["xla"]._host.points.shape
    assert res.exact
    np.testing.assert_array_equal(res.counts, _want(logical, wl))


def test_cap_growth_repack_preserves_earlier_refreshed_deltas():
    """A full repack forced by capacity overflow must re-apply EVERY page
    ever mutated, not just the ones dirty since the last refresh —
    otherwise deltas/tombstones folded in by earlier refreshes revert."""
    pair, data, wl, _ = _db(n=1500, n_q=8, page_bytes=2048)
    pair.engine("xla", q_chunk=8, max_cand=pair.port.num_pages)
    pair.query(lambda a: wl)
    K = pair.port.index.K
    # cycle 1: a small insert + a tombstone, folded in by a refresh
    early = np.clip(data[200].astype(np.int64) + [1, 0], 0,
                    2**K - 1).astype(np.uint64)[None]
    early = early[~rows_in_set(early, data)]
    pair.both("insert", early)
    pair.both("delete", data[300])
    pair.ref.refresh("xla")
    pair.port.refresh("torch")
    # cycle 2: overflow one page's capacity so the refresh repacks fully
    cap0 = pair.port.engines["torch"]._host.points.shape[2]
    burst = _burst(data, 100, cap0, K, np.concatenate([data, early]))
    pair.both("insert", burst)
    res = pair.query(lambda a: wl, engine="xla")    # auto-refresh, cap grows
    assert pair.port.engines["torch"]._host.points.shape[2] > cap0
    logical = np.concatenate([data, early, burst])
    keep = ~rows_in_set(logical, data[300][None])
    logical = np.unique(logical[keep], axis=0)
    assert res.exact
    np.testing.assert_array_equal(res.counts, _want(logical, wl))
    # the cycle-1 delta row and tombstone specifically survived the repack
    e, dead = early[0], data[300]
    assert int(pair.query(lambda a: (e, e), engine="xla").counts[0]) == 1
    assert int(pair.query(lambda a: (dead, dead),
                          engine="xla").counts[0]) == 0
    h, rh = pair.port.engines["torch"]._host, pair.ref.engines["xla"]._host
    for f in ("points", "page_zmin", "page_zmax", "page_mbr", "page_size"):
        np.testing.assert_array_equal(getattr(h, f), np.asarray(getattr(rh, f)),
                                      err_msg=f)


def test_insert_below_global_zmin_stays_visible():
    """A delta row whose z-address falls below the index's global minimum
    is clipped onto page 0; page_zmin must grow so candidate tests (CPU
    z-overlap and device prune) don't skip it."""
    rng = np.random.default_rng(0)
    K = default_K(2)
    data = np.unique(rng.integers(2**10, 2**K, size=(2000, 2),
                                  dtype=np.uint64), axis=0)
    Ls, Us = make_workload(data, 8, seed=1, K=K)
    pair = Pair(data, (Ls, Us), K=K, page_bytes=2048)
    pair.engine("xla", q_chunk=8, max_cand=pair.port.num_pages)
    pair.query(lambda a: (Ls, Us))
    low = np.zeros(2, dtype=np.uint64)              # z = 0 < every base z
    pair.both("insert", low)
    for name in ("cpu", "xla"):
        res = pair.query(lambda a: (low, low), engine=name)
        assert int(res.counts[0]) == 1, name
    np.testing.assert_array_equal(pair.port.index.page_zmin,
                                  pair.ref.index.page_zmin)


def test_delete_accounting_unknown_and_duplicate_rows():
    pair, data, wl, _ = _db(n=1500, n_q=6, page_bytes=2048)
    db = pair.port
    n0, epoch0 = db.n, db.store.epoch
    assert pair.both("delete", np.asarray([999999, 999999],
                                          dtype=np.uint64)) == 0
    assert db.n == n0 and db.store.epoch == epoch0            # true no-op
    assert pair.both("delete", data[9]) == 1
    assert pair.both("delete", data[9]) == 0                   # idempotent
    assert db.n == n0 - 1 and db.store.n_deleted == 1
    assert (db.n, db.store.epoch) == (pair.ref.n, pair.ref.store.epoch)


def test_rebuild_policy_triggers_at_configured_fraction():
    pair, data, wl, _ = _db(n=2000, n_q=8, page_bytes=2048,
                            policy=tapi.FractionRebuildPolicy(frac=0.02,
                                                              auto=True))
    pair.engine("xla", q_chunk=8, max_cand=pair.port.num_pages)
    pair.query(lambda a: wl)
    n_trigger = int(0.02 * pair.port.index.n) + 1
    logical = _mutate(pair, data, n_new=n_trigger + 40)
    db = pair.port
    # auto policy fired: deltas folded into a fresh index, store reset
    # (the two tombstones land after the rebuild and stay as deltas)
    assert db.store.n_inserted == 0 and not db.store.deltas
    assert not db.rebuild_pending
    assert db.n == len(logical) == pair.ref.n
    np.testing.assert_array_equal(db.index.xs, pair.ref.index.xs)
    for name in ("cpu", "xla"):
        res = pair.query(lambda a: wl, engine=name)
        assert res.exact
        np.testing.assert_array_equal(res.counts, _want(logical, wl),
                                      err_msg=name)


def test_rebuild_pending_flag_without_auto():
    pair, data, wl, _ = _db(n=2000, n_q=8,
                            policy=tapi.FractionRebuildPolicy(frac=0.01,
                                                              auto=False))
    _mutate(pair, data, n_new=60)
    db = pair.port
    assert db.rebuild_pending and pair.ref.rebuild_pending
    n_before = db.index.n
    pair.both("rebuild")
    assert not db.rebuild_pending and db.index.n > n_before
    assert db.index.n == pair.ref.index.n


# ---------------------------------------------------------------------------
# serving-array packing (vectorized scatter == per-page loop)
# ---------------------------------------------------------------------------


def _pack_loop_reference(index, pad_pages_to=1, cap=None):
    """The per-page packing loop, kept as the oracle."""
    from repro_torch.core.zorder64 import u64_to_z64
    Pn, d = index.num_pages, index.d
    cap = cap or int(np.diff(index.starts).max())
    P_pad = -(-Pn // pad_pages_to) * pad_pages_to
    pts = np.zeros((P_pad, d, cap), dtype=np.uint32)
    size = np.zeros(P_pad, dtype=np.int32)
    for p in range(Pn):
        s, e = index.starts[p], index.starts[p + 1]
        pts[p, :, :e - s] = index.xs[s:e].astype(np.uint32).T
        size[p] = e - s
    mbr = np.zeros((P_pad, d, 2), dtype=np.uint32)
    mbr[:Pn] = index.mbrs.astype(np.uint32)
    mbr[Pn:, :, 0] = np.uint32(0xFFFFFFFF)
    zmin = np.full((P_pad, 2), np.int32(-1))
    zmax = np.zeros((P_pad, 2), dtype=np.int32)
    zmin[:Pn] = u64_to_z64(index.page_zmin)
    zmax[:Pn] = u64_to_z64(index.page_zmax)
    return ServingArrays(points=pts.view(np.int32), page_zmin=zmin,
                         page_zmax=zmax, page_mbr=mbr.view(np.int32),
                         page_size=size)


@pytest.mark.parametrize("pad", [1, 8])
def test_pack_serving_arrays_matches_loop_reference(pad):
    data, *_ = _data(n=3000)
    idx = LMSFCIndex.build(data, cfg=IndexConfig(page_bytes=1024))
    ref = RIndex.build(data, cfg=RConfig(page_bytes=1024))
    got = pack_serving_arrays(idx, pad_pages_to=pad)
    loop = _pack_loop_reference(idx, pad_pages_to=pad)
    theirs = r_pack(ref, pad_pages_to=pad)
    for f in ("points", "page_zmin", "page_zmax", "page_mbr", "page_size"):
        np.testing.assert_array_equal(getattr(got, f), getattr(loop, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(theirs, f),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# legacy shim surface stays importable and store-backed
# ---------------------------------------------------------------------------


def test_legacy_free_functions_are_store_backed():
    pair, data, wl, _ = _db(n=1500, n_q=6, page_bytes=2048)
    idx = pair.port.index
    row = np.asarray([123, 456], dtype=np.uint64)
    p = index_mod.insert(idx, row)
    assert p == rindex_mod.insert(pair.ref.index, row)
    store = get_delta_store(idx)
    assert store.n_inserted == 1 and p in store.deltas
    assert idx._deltas is store.deltas            # aliased, not copied
    index_mod.delete(idx, row)
    assert tuple(map(int, row)) in store.tombstones
    assert index_mod.delta_count(idx, p, row, row) == 0
    assert not index_mod.needs_rebuild(idx, frac=0.5)
    idx2 = index_mod.rebuild(idx)
    assert idx2.n == idx.n                        # insert+delete cancel out
