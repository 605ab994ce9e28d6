"""The port's out-of-core store (`repro_torch.store`) against the
reference's (`repro.store`).

Twins of `tests/test_store.py` (its `data.pipeline` case is in
`tests/test_torch_pipeline.py`).  Every scenario runs through both
packages on the same seeded rows: segment builds (every array byte for
byte, the manifest equal apart from its build record), checksum and
truncation failures, the writer's order and dedup checks, page-group
cache accounting, eviction, bypass and dead padding, staleness, the
rebuild's detach, overflow escalation, and Count/Range/Point/kNN through
the `store` engine — the port's on its plain-torch backend with
``device="cpu"``, the reference's on `xla`.  Integer outputs and float
kNN distances alike must be equal (tolerance 0), and so must the
executed plans, their accounting and the caches' counters.  A segment
written by either package opens in the other and serves the same
answers.  The `store` engine on the CUDA kernels is driven on a card by
`tests/test_torch_cuda.py`.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro import obs as robs
from repro import store as rstore
from repro.core.curve import default_curve as r_default_curve
from repro.core.index import IndexConfig as RConfig
from repro.data import synth as rsynth
from repro.store.cache import PageGroupCache as RCache
from repro.store.segment import SegmentWriter as RWriter
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch import store as tstore
from repro_torch.core.curve import default_curve as t_default_curve
from repro_torch.core.index import IndexConfig
from repro_torch.core.theta import default_K
from repro_torch.data import synth as tsynth
from repro_torch.data.workload import make_workload
from repro_torch.store.cache import PageGroupCache as TCache
from repro_torch.store.segment import SegmentWriter as TWriter

N, D, CHUNK = 20_000, 3, 3_000
ARRAYS = ("counts", "rows", "offsets", "found", "neighbors", "dists",
          "overflowed", "residual_overflow")
SCALARS = ("escalations", "cpu_fallbacks", "epoch", "k", "metric", "engine")
SEG_FILES = ("xs.bin", "starts.bin", "mbrs.bin", "sort_dims.bin",
             "page_zmin.bin", "page_zmax.bin")


def _rows(n=N, chunk=CHUNK, seed=3):
    return np.concatenate(list(tsynth.iter_chunks(n, chunk, seed=seed, d=D)))


def _workload(rows, n_q=12, seed=11):
    return make_workload(rows, n_q, seed=seed, K=default_K(D))


def assert_same(got, want, ctx=""):
    """The port's result equals the reference's on every output, scalar,
    plan and accounting (both name their engines alike here)."""
    for f in ARRAYS:
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{ctx} {f}")
    for f in SCALARS:
        if hasattr(want, f):
            assert getattr(got, f) == getattr(want, f), (ctx, f)
    assert got.plan.describe() == want.plan.describe(), ctx
    assert dataclasses.asdict(got.plan.accounting) == \
        dataclasses.asdict(want.plan.accounting), ctx


def assert_same_files(a, b):
    """Two segment directories hold the same arrays byte for byte and the
    same manifest apart from its build record."""
    for f in SEG_FILES:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    ma = json.load(open(os.path.join(a, "MANIFEST.json")))
    mb = json.load(open(os.path.join(b, "MANIFEST.json")))
    ma.pop("build"), mb.pop("build")
    assert ma == mb


@pytest.fixture(scope="module")
def seg_paths(tmp_path_factory):
    """One segment built chunk by chunk by each package from the same rows
    (the reference's generator for the reference's build, the port's for
    the port's)."""
    root = tmp_path_factory.mktemp("store")
    r, t = str(root / "ref"), str(root / "port")
    rstore.build_segment(rsynth.iter_chunks(N, CHUNK, seed=3, d=D), r,
                         page_rows=128)
    tstore.build_segment(tsynth.iter_chunks(N, CHUNK, seed=3, d=D), t,
                         page_rows=128)
    return r, t


@pytest.fixture(scope="module")
def oracle():
    """In-memory Databases over the same rows, *different* paging —
    parity must hold despite disagreeing page boundaries."""
    rows = _rows()
    kw = dict(K=default_K(D), learn=False)
    ref = rapi.Database.fit(rows, cfg=RConfig(paging="heuristic",
                                              page_bytes=4096), **kw)
    port = tapi.Database.fit(rows, cfg=IndexConfig(paging="heuristic",
                                                   page_bytes=4096),
                             device="cpu", **kw)
    return ref, port, rows


@pytest.fixture(scope="module")
def store_dbs(seg_paths):
    r, t = seg_paths
    ref = rapi.Database.from_segment(r, verify="full")
    ref.engine("store", rapi.EngineConfig(q_chunk=8, group_pages=16,
                                          cache_bytes=1 << 22))
    port = tapi.Database.from_segment(t, verify="full", device="cpu")
    port.engine("store", tapi.EngineConfig(q_chunk=8, group_pages=16,
                                           cache_bytes=1 << 22))
    return ref, port


# ---------------------------------------------------------------------------
# chunked generator: determinism, chunk-invariance, duplicate-freedom
# ---------------------------------------------------------------------------


def test_iter_chunks_chunk_invariant_and_duplicate_free():
    a = _rows()
    b = _rows(chunk=777)
    np.testing.assert_array_equal(a, b)  # chunking never changes the stream
    assert len(np.unique(a, axis=0)) == len(a)
    c = _rows(seed=4)
    assert not np.array_equal(a, c)      # the seed actually matters
    assert a.dtype == np.uint64 and a.shape == (N, D)
    assert int(a.max()) < 2 ** default_K(D)
    np.testing.assert_array_equal(
        a, np.concatenate(list(rsynth.iter_chunks(N, CHUNK, seed=3, d=D))))


def test_iter_chunks_rejects_degenerate_args():
    for mod in (rsynth, tsynth):
        with pytest.raises(ValueError):
            next(mod.iter_chunks(0, 10))
        with pytest.raises(ValueError):
            next(mod.iter_chunks(10, 0))
        with pytest.raises(ValueError):
            next(mod.iter_chunks(1 << 30, 1024, d=2, K=8))


# ---------------------------------------------------------------------------
# durability: manifest round-trip, corruption detection
# ---------------------------------------------------------------------------


def test_manifest_round_trip_bit_identical(seg_paths):
    r, t = seg_paths
    assert_same_files(r, t)
    seg = tstore.open_segment(t, verify="full")
    ref = rstore.open_segment(r, verify="full")
    assert seg.n == N and seg.d == D
    man = seg.manifest
    assert man["format"] == "repro.store.segment" and man["version"] == 1
    assert set(man["arrays"]) >= {"xs", "starts", "mbrs",
                                  "page_zmin", "page_zmax"}
    assert man["build"] == ref.manifest["build"]
    assert seg.curve.to_json() == ref.curve.to_json()
    again = tstore.open_segment(t, verify="meta")
    np.testing.assert_array_equal(np.asarray(seg.xs), np.asarray(again.xs))
    for attr in ("starts", "mbrs", "sort_dims", "page_zmin", "page_zmax"):
        np.testing.assert_array_equal(getattr(seg, attr),
                                      getattr(again, attr))
        np.testing.assert_array_equal(getattr(seg, attr), getattr(ref, attr))


@pytest.mark.parametrize("victim", ["xs.bin", "page_zmin.bin"])
def test_corrupted_checksum_raises(seg_paths, tmp_path, victim):
    for pkg, path in zip((rstore, tstore), seg_paths):
        bad = str(tmp_path / pkg.__name__)
        shutil.copytree(path, bad)
        p = os.path.join(bad, victim)
        with open(p, "r+b") as f:
            f.seek(100)
            byte = f.read(1)
            f.seek(100)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(pkg.StoreCorruptionError, match="checksum"):
            pkg.open_segment(bad, verify="full")
        if victim != "xs.bin":
            with pytest.raises(pkg.StoreCorruptionError):
                pkg.open_segment(bad, verify="meta")
        else:
            pkg.open_segment(bad, verify="meta")   # rows only size-checked


def test_truncated_array_raises(seg_paths, tmp_path):
    for pkg, path in zip((rstore, tstore), seg_paths):
        bad = str(tmp_path / pkg.__name__)
        shutil.copytree(path, bad)
        p = os.path.join(bad, "starts.bin")
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) - 8)
        with pytest.raises(pkg.StoreCorruptionError, match="bytes"):
            pkg.open_segment(bad, verify="none")


def test_writer_rejects_out_of_order_and_dedups(tmp_path):
    rows = np.concatenate(list(tsynth.iter_chunks(1000, 1000, seed=5, d=D)))
    out = {}
    for name, writer, curve_of, pkg in (
            ("ref", RWriter, r_default_curve, rstore),
            ("port", TWriter, t_default_curve, tstore)):
        curve = curve_of(D, default_K(D))
        z = curve.encode_np(rows)
        order = np.argsort(z, kind="stable")
        w = writer(str(tmp_path / f"{name}w"), curve=curve, page_rows=64)
        w.append_sorted(rows[order], keys=z[order])
        with pytest.raises(ValueError, match="below"):
            w.append_sorted(rows[order][:4], keys=z[order][:4])
        with pytest.raises(ValueError, match="ascending"):
            w.append_sorted(rows[order][::-1][:4], keys=z[order][::-1][:4])
        w2 = writer(str(tmp_path / f"{name}w2"), curve=curve, page_rows=64)
        w2.append_sorted(np.repeat(rows[order], 2, axis=0),
                         keys=np.repeat(z[order], 2))
        w2.finalize()
        seg = pkg.open_segment(str(tmp_path / f"{name}w2"))
        assert seg.n == len(rows)
        out[name] = str(tmp_path / f"{name}w2")
    assert_same_files(out["ref"], out["port"])


def test_write_segment_from_index_identical_paging(oracle, tmp_path):
    ref, port, rows = oracle
    rp = rstore.write_segment_from_index(ref.index, str(tmp_path / "r"))
    tp = tstore.write_segment_from_index(port.index, str(tmp_path / "t"))
    assert_same_files(rp, tp)
    idx = tstore.open_segment(tp).as_index()
    np.testing.assert_array_equal(idx.page_zmin, port.index.page_zmin)
    np.testing.assert_array_equal(idx.page_zmax, port.index.page_zmax)
    np.testing.assert_array_equal(np.asarray(idx.xs),
                                  np.asarray(port.index.xs))


# ---------------------------------------------------------------------------
# oracle parity: every query kind bit-identical to the in-memory Database
# and to the reference's store engine
# ---------------------------------------------------------------------------


def _both(store_dbs, make, engine):
    ref, port = store_dbs
    want = ref.query(make(rapi), engine=engine)
    got = port.query(make(tapi), engine=engine)
    assert_same(got, want, engine)
    assert dataclasses.asdict(port.executor.cache) == \
        dataclasses.asdict(ref.executor.cache)
    if engine == "store":
        assert port.engines["store"].backend == "torch"
        assert dataclasses.asdict(port.engines["store"].cache.stats) == \
            dataclasses.asdict(ref.engines["store"].cache.stats)
    return got


@pytest.mark.parametrize("engine", ["cpu", "store"])
def test_count_parity(store_dbs, oracle, engine):
    _, odb, rows = oracle
    Ls, Us = _workload(rows)
    got = _both(store_dbs, lambda a: a.Count(Ls, Us), engine)
    want = odb.query(tapi.Count(Ls, Us), engine="cpu")
    assert got.exact and got.engine == engine
    np.testing.assert_array_equal(got.counts, want.counts)


@pytest.mark.parametrize("engine", ["cpu", "store"])
def test_range_parity(store_dbs, oracle, engine):
    _, odb, rows = oracle
    Ls, Us = _workload(rows, seed=12)
    got = _both(store_dbs, lambda a: a.Range(Ls, Us), engine)
    want = odb.query(tapi.Range(Ls, Us), engine="cpu")
    assert got.exact
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.rows, want.rows)


@pytest.mark.parametrize("engine", ["cpu", "store"])
def test_point_parity(store_dbs, oracle, engine):
    _, odb, rows = oracle
    present = rows[::911]
    absent = (present ^ np.uint64(1)) + np.uint64(2)  # very likely absent
    xs = np.concatenate([present, absent])
    got = _both(store_dbs, lambda a: a.Point(xs), engine)
    want = odb.query(tapi.Point(xs), engine="cpu")
    np.testing.assert_array_equal(got.found, want.found)
    assert got.found[:len(present)].all()


@pytest.mark.parametrize("engine", ["cpu", "store"])
@pytest.mark.parametrize("metric", ["l2", "linf"])
def test_knn_parity(store_dbs, oracle, engine, metric):
    _, odb, rows = oracle
    centers = rows[::2500]
    got = _both(store_dbs, lambda a: a.Knn(centers, k=7, metric=metric),
                engine)
    want = odb.query(tapi.Knn(centers, k=7, metric=metric), engine="cpu")
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.neighbors, want.neighbors)
    np.testing.assert_array_equal(got.dists, want.dists)


def test_overflow_escalation_stays_exact_on_store(seg_paths, oracle):
    """max_cand=1 forces first-pass overflow; the store engine's
    escalation (and CPU net over the memmap) must still be bit-exact, and
    escalate exactly as the reference's."""
    _, odb, rows = oracle
    Ls, Us = _workload(rows, seed=13)
    r, t = seg_paths
    ref = rapi.Database.from_segment(r, verify="none")
    ref.engine("store", rapi.EngineConfig(q_chunk=8, max_cand=1,
                                          group_pages=16))
    port = tapi.Database.from_segment(t, verify="none", device="cpu")
    port.engine("store", tapi.EngineConfig(q_chunk=8, max_cand=1,
                                           group_pages=16))
    got = _both((ref, port), lambda a: a.Count(Ls, Us), None)
    assert got.exact and got.escalations > 0
    np.testing.assert_array_equal(
        got.counts, odb.query(tapi.Count(Ls, Us), engine="cpu").counts)


# ---------------------------------------------------------------------------
# cache accounting: hits+misses==lookups, resident bytes never over budget
# ---------------------------------------------------------------------------


def _caches(seg_paths, G, budget):
    r, t = seg_paths
    rseg = rstore.open_segment(r, verify="none")
    tseg = tstore.open_segment(t, verify="none")
    return (RCache(rseg, group_pages=G, budget_bytes=budget),
            TCache(tseg, group_pages=G, budget_bytes=budget, device="cpu"),
            tseg)


def _same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("points", "page_zmin", "page_zmax", "page_mbr",
                  "page_size"):
            a, b = getattr(g, f), getattr(w, f)
            assert isinstance(a, torch.Tensor) and a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cache_eviction_accounting(seg_paths):
    G = 8
    seg = tstore.open_segment(seg_paths[1], verify="none")
    budget = 3 * seg.group_nbytes(G)  # room for exactly 3 groups
    rc, tc, seg = _caches(seg_paths, G, budget)
    ngroups = seg.num_groups(G)
    assert ngroups > 6
    rng = np.random.default_rng(0)
    for _ in range(40):
        k = int(rng.integers(1, 3))
        gs = sorted(rng.choice(ngroups, size=k, replace=False).tolist())
        blocks = tc.get(gs)
        _same_blocks(blocks, rc.get(gs))
        assert len(blocks) == len(gs)
        assert tc.resident_bytes <= budget          # hard bound, always
        assert tc.resident_groups * seg.group_nbytes(G) == tc.resident_bytes
        assert list(tc._lru) == list(rc._lru)
    st = tc.stats
    assert dataclasses.asdict(st) == dataclasses.asdict(rc.stats)
    assert st.hits + st.misses == st.lookups
    assert st.misses >= tc.resident_groups
    assert st.evictions > 0
    tc.clear()
    assert tc.resident_bytes == 0 and tc.resident_groups == 0


def test_cache_over_budget_request_bypasses(seg_paths):
    G = 8
    seg = tstore.open_segment(seg_paths[1], verify="none")
    rc, tc, seg = _caches(seg_paths, G, seg.group_nbytes(G))
    gs = list(range(min(4, seg.num_groups(G))))
    blocks = tc.get(gs)
    _same_blocks(blocks, rc.get(gs))
    assert len(blocks) >= 2
    assert tc.resident_bytes <= seg.group_nbytes(G)
    assert tc.stats.bypass > 0
    assert dataclasses.asdict(tc.stats) == dataclasses.asdict(rc.stats)


def test_cache_rejects_sub_block_budget(seg_paths):
    seg = tstore.open_segment(seg_paths[1], verify="none")
    with pytest.raises(ValueError, match="smaller than one page-group"):
        TCache(seg, group_pages=8, budget_bytes=seg.group_nbytes(8) - 1,
               device="cpu")
    with pytest.raises(ValueError):
        RCache(rstore.open_segment(seg_paths[0], verify="none"),
               group_pages=8, budget_bytes=seg.group_nbytes(8) - 1)


def test_cache_blocks_are_dead_padded(seg_paths):
    G = 16
    rc, tc, seg = _caches(seg_paths, G, 1 << 24)
    last = seg.num_groups(G) - 1
    blk = tc.get([last])[0]
    _same_blocks([blk], rc.get([last]))
    live = seg.num_pages - last * G
    size = blk.page_size.numpy()
    assert (size[live:] == 0).all()
    assert (size[:live] > 0).all()
    _same_blocks([tc.dead_block()], [rc.dead_block()])


def test_cache_obs_counters_and_spans_match_reference(seg_paths):
    """The store.cache.* counters, the resident-bytes gauge and the
    store.cache.upload span count what the reference's count."""
    G = 8
    seg = tstore.open_segment(seg_paths[1], verify="none")
    rc, tc, seg = _caches(seg_paths, G, 2 * seg.group_nbytes(G))
    snaps = []
    for obs, cache in ((robs, rc), (tobs, tc)):
        obs.enable()
        try:
            for gs in ([0, 1], [1, 2], [0, 3, 4], [4]):
                cache.get(gs)
            snap = obs.snapshot()["metrics"]
        finally:
            obs.disable()
            obs.reset()
        snaps.append({k: (v["count"] if isinstance(v, dict) else v)
                      for k, v in snap.items()
                      if k.startswith("store.cache")})
    assert snaps[1] == snaps[0]
    assert snaps[1]["store.cache.bypass"] > 0
    assert snaps[1]["store.cache.resident_bytes"] <= 2 * seg.group_nbytes(G)
    assert any(k.startswith("store.cache.upload_ns") for k in snaps[1])


# ---------------------------------------------------------------------------
# staleness: the store engine serves an immutable snapshot
# ---------------------------------------------------------------------------


def test_store_engine_raises_on_stale(seg_paths):
    rows = np.concatenate(list(tsynth.iter_chunks(64, 64, seed=3, d=D)))
    for api, path, kw in ((rapi, seg_paths[0], {}),
                          (tapi, seg_paths[1], {"device": "cpu"})):
        db = api.Database.from_segment(path, verify="none", **kw)
        db.engine("store", api.EngineConfig(group_pages=16))
        q = api.Count(rows[:2], rows[:2])
        db.query(q)
        db.insert((rows[:1] + np.uint64(1)) | np.uint64(1))
        with pytest.raises(api.StaleServingError, match="epoch"):
            db.query(q, engine="store")
        res = db.query(q, engine="cpu")
        assert res.exact
        db.engine("store", api.EngineConfig(group_pages=16,
                                            on_stale="serve_stale"))
        res2 = db.query(q, engine="store")
        np.testing.assert_array_equal(res2.counts, res.counts)


def test_rebuild_detaches_segment(seg_paths):
    out = []
    for api, path, kw in ((rapi, seg_paths[0], {}),
                          (tapi, seg_paths[1], {"device": "cpu"})):
        db = api.Database.from_segment(path, verify="none", **kw)
        db.engine("store", api.EngineConfig(group_pages=16))
        db.insert(np.asarray([[1, 2, 3]], dtype=np.uint64))
        db.rebuild()
        assert db.segment is None
        assert "store" not in db.engines and db.active_engine is None
        res = db.query(api.Point(np.asarray([[1, 2, 3]], dtype=np.uint64)))
        assert res.found.all() and res.engine == "cpu"
        out.append(res)
    assert_same(out[1], out[0])


# ---------------------------------------------------------------------------
# npy shard ingestion
# ---------------------------------------------------------------------------


def test_iter_npy_shards_build_matches_generator_build(seg_paths, tmp_path):
    paths = []
    for i, c in enumerate(tsynth.iter_chunks(N, CHUNK, seed=3, d=D)):
        p = str(tmp_path / f"shard{i}.npy")
        np.save(p, c)
        paths.append(p)
    path2 = str(tmp_path / "seg2")
    tstore.build_segment(tstore.iter_npy_shards(paths), path2, page_rows=128)
    assert_same_files(seg_paths[1], path2)
    a, b = tstore.open_segment(seg_paths[1]), tstore.open_segment(path2)
    np.testing.assert_array_equal(np.asarray(a.xs), np.asarray(b.xs))
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.page_zmin, b.page_zmin)


# ---------------------------------------------------------------------------
# beyond the reference's file: cross-package segments, the engine's
# backend and device rules, a built segment under a learned curve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segment_written_by_either_package_opens_in_the_other(
        seg_paths, oracle, writer):
    """The reference opens the port's segment and the port the
    reference's; both serve the same answers through their store
    engines."""
    path = seg_paths[1] if writer == "port" else seg_paths[0]
    ref = rapi.Database.from_segment(path, verify="full")
    port = tapi.Database.from_segment(path, verify="full", device="cpu")
    ref.engine("store", rapi.EngineConfig(q_chunk=8, group_pages=16))
    port.engine("store", tapi.EngineConfig(q_chunk=8, group_pages=16))
    _, odb, rows = oracle
    Ls, Us = _workload(rows, n_q=8, seed=14)
    for make in (lambda a: a.Count(Ls, Us), lambda a: a.Range(Ls, Us),
                 lambda a: a.Point(rows[::1999])):
        got = _both((ref, port), make, "store")
        want = odb.query(make(tapi), engine="cpu")
        for f in ("counts", "rows", "found"):
            if hasattr(want, f):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))


def test_learned_curve_segment_round_trips_between_packages(tmp_path):
    """A segment under a non-default (piecewise) curve: the curve JSON the
    port writes is the reference's, and each package reads the other's."""
    from repro.core.curve import curve_from_json as r_from_json
    from repro_torch.core.curve import random_curve
    curve = random_curve(np.random.default_rng(7), D, default_K(D),
                         family="piecewise", depth=2)
    rcurve = r_from_json(curve.to_json())
    assert rcurve.to_json() == curve.to_json()
    t, r = str(tmp_path / "t"), str(tmp_path / "r")
    rows = _rows(n=6000, chunk=1000)
    tstore.build_segment([rows[:2500], rows[2500:]], t, curve=curve,
                         page_rows=64)
    rstore.build_segment([rows[:2500], rows[2500:]], r, curve=rcurve,
                         page_rows=64)
    assert_same_files(r, t)
    assert rstore.open_segment(t).curve.to_json() == curve.to_json()
    assert tstore.open_segment(r).curve == curve


def test_store_engine_backends_and_device(seg_paths, monkeypatch):
    """`torch` is the default backend only under ``device="cpu"``; the
    kernels' backend refuses a CPU device; without a card and without
    ``device="cpu"`` the engine cannot attach; an in-memory Database has
    no segment to serve."""
    db = tapi.Database.from_segment(seg_paths[1], verify="none",
                                    device="cpu")
    db.engine("store")
    eng = db.engines["store"]
    assert eng.backend == "torch" and eng.device.type == "cpu"
    assert eng.cache.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA device"):
        db.engine("store", tapi.EngineConfig(backend="cuda"))
    with pytest.raises(ValueError, match="backend"):
        db.engine("store", tapi.EngineConfig(backend="xla"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodev = tapi.Database.from_segment(seg_paths[1], verify="none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nodev.engine("store")
    mem = tapi.Database.fit(_rows(n=500, chunk=500), learn=False,
                            device="cpu")
    assert mem.segment is None
    with pytest.raises(ValueError, match="segment"):
        mem.engine("store")
