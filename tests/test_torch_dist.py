"""The port's multi-shard index path against the reference's: the sharding
rules (`repro_torch.dist`), the page-sharded query fn
(`core.serve.make_distributed_query_fn`, `shard_serving_arrays`) and the
`distributed` engine behind the `Database` facade.

Twins of `tests/test_dist_sharding.py`, of the distributed cases of
`tests/test_serve_engine.py` and of the `distributed` cases of
`tests/test_api_database.py` and `tests/test_exec.py` (the planner case of
`tests/test_query_surface.py` is in `tests/test_torch_queries.py`).  A
port mesh is a sequence of devices, one page shard each; here every shard
is the CPU (``["cpu"] * n``), which stands in for the reference's fake
host devices.  Every output is held equal exactly (tolerance 0): counts,
overflow counts (the number of shards that overflowed), escalations,
plans and their accounting, partition specs by their entries.  The
reference's 8-device run needs `--xla_force_host_platform_device_count`
before JAX starts, so it runs in one subprocess; the port's 8 shards run
in this process.  On the CUDA kernels the engine is driven on a card by
`tests/test_torch_cuda.py`.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro import api as rapi
from repro.core.index import IndexConfig as RConfig
from repro.core.index import LMSFCIndex as RIndex
from repro.core.serve import build_serving_arrays as r_build
from repro.core.serve import make_distributed_query_fn as r_make_dist
from repro.core.serve import shard_serving_arrays as r_shard
from repro.core.theta import random_theta as r_random_theta
from repro.dist.sharding import ShardingRules as RRules
from repro_torch import api as tapi
from repro_torch.api.deltas import rows_in_set
from repro_torch.core.index import IndexConfig, LMSFCIndex
from repro_torch.core.query import brute_force_count
from repro_torch.core.serve import (PageShards, make_distributed_query_fn,
                                    mesh_devices, pack_serving_arrays,
                                    shard_serving_arrays)
from repro_torch.core.theta import default_K, random_theta
from repro_torch.data.synth import make_dataset
from repro_torch.data.workload import make_workload
from repro_torch.dist.sharding import P, ShardingRules
from test_torch_api import Pair

ROOT = Path(__file__).resolve().parents[1]
MESH_AXES = {"data", "model", "pod", None}


# ---------------------------------------------------------------------------
# sharding rules (twins of tests/test_dist_sharding.py)
# ---------------------------------------------------------------------------


def _all_specs(rules, B=128):
    return {
        "vector": rules.vector(),
        "embed": rules.embed(4096, 1024),
        "dense_in": rules.dense_in(1024, 4096),
        "dense_in_heads": rules.dense_in_heads(1024, 8, 1024),
        "dense_out": rules.dense_out(4096, 1024),
        "expert_in": rules.expert_in(8, 1024, 2048),
        "expert_out": rules.expert_out(8, 2048, 1024),
        "kv_cache": rules.kv_cache(B, 8),
        "act_hidden": rules.act_hidden(B),
        "act_logits": rules.act_logits(B, 4096),
        "tokens": rules.tokens(B),
    }


@pytest.mark.parametrize("fsdp", [False, True])
def test_every_rule_returns_partition_spec_on_mesh_axes(fsdp):
    rules = ShardingRules(model_size=2, data_size=4, fsdp=fsdp)
    ref = _all_specs(RRules(model_size=2, data_size=4, fsdp=fsdp))
    for name, spec in _all_specs(rules).items():
        assert isinstance(spec, P), name
        assert tuple(spec) == tuple(ref[name]), name
        for entry in spec:
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert set(axes) <= MESH_AXES, (name, spec)
    rref = RRules(model_size=2, data_size=4, fsdp=fsdp)
    for tup, want in ((rules.ssm_state(128, 8), rref.ssm_state(128, 8)),
                      (rules.mlstm_state(128, 8, 64),
                       rref.mlstm_state(128, 8, 64))):
        assert tup == want
        spec = P(None, *tup)
        assert isinstance(spec, P)
        assert set(spec) <= MESH_AXES


def test_fsdp_shards_embed_and_dense_weights_on_data():
    rules = ShardingRules(model_size=2, data_size=4, fsdp=True)
    assert rules.embed(4096, 1024) == P("model", "data")
    assert rules.dense_in(1024, 4096) == P("data", "model")
    assert rules.dense_out(4096, 1024) == P("model", "data")
    assert rules.expert_in(8, 1024, 2048) == P(None, "data", "model")
    assert rules.expert_out(8, 2048, 1024) == P(None, "model", "data")
    plain = ShardingRules(model_size=2, data_size=4, fsdp=False)
    assert plain.embed(4096, 1024) == P("model", None)
    assert plain.dense_in(1024, 4096) == P(None, "model")
    assert plain.fsdp_ax is None and rules.fsdp_ax == "data"
    # a port spec equals the reference's with the same entries
    assert rules.embed(4096, 1024) == RP("model", "data")
    assert RP(None, "model") == plain.dense_in(1024, 4096)


def test_head_and_batch_divisibility():
    rules = ShardingRules(model_size=4, data_size=2, fsdp=True)
    rref = RRules(model_size=4, data_size=2, fsdp=True)
    assert rules.dense_in_heads(1024, 2, 256) == P("data", None)
    assert rules.kv_cache(128, 2) == P("data", None, None, None)
    for port, ref in ((rules.dense_in_heads, rref.dense_in_heads),):
        with pytest.raises(ValueError):
            port(1024, 6, 768)
        with pytest.raises(ValueError):
            ref(1024, 6, 768)
    with pytest.raises(ValueError):
        rules.kv_cache(128, 6)
    assert rules.dense_in(1021, 4095) == P(None, None)
    assert rules.batch_ax(3) is None and rref.batch_ax(3) is None
    assert rules.tokens(3) == P(None, None) == tuple(rref.tokens(3))


def test_multi_pod_batch_axes():
    rules = ShardingRules(model_size=16, data_size=16, fsdp=True,
                          multi_pod=True)
    rref = RRules(model_size=16, data_size=16, fsdp=True, multi_pod=True)
    assert rules.batch_ax(256) == ("pod", "data") == rref.batch_ax(256)
    assert rules.tokens(256) == P(("pod", "data"), None)
    assert tuple(rules.tokens(256)) == tuple(rref.tokens(256))
    assert rules.batch_ax(16) == "data"
    assert rules.act_hidden(256) == P(("pod", "data"), None, None)


def test_invalid_mesh_sizes_raise():
    for cls in (ShardingRules, RRules):
        with pytest.raises(ValueError):
            cls(model_size=0, data_size=1, fsdp=False)


def test_partition_spec_is_a_tuple_of_its_entries():
    assert P() == () and P(None) == (None,) and P("data", None) == \
        ("data", None)
    assert repr(P("data", None)) == "P('data', None)"
    assert hash(P("data")) == hash(("data",))
    assert isinstance(P("pages"), tuple)


# ---------------------------------------------------------------------------
# the page-sharded query fn (twins of tests/test_serve_engine.py)
# ---------------------------------------------------------------------------


def _setup(name, n, n_q, seed, page_bytes=2048):
    """The reference test's `_setup`: a random global θ, heuristic pages
    (2 KiB unless told), the workload's queries, in both packages."""
    data = make_dataset(name, n, seed=seed)
    d = data.shape[1]
    K = default_K(d)
    theta = random_theta(np.random.default_rng(seed), d, K)
    Ls, Us = make_workload(data, n_q, seed=seed, K=K)
    rtheta = r_random_theta(np.random.default_rng(seed), d, K)
    assert np.array_equal(rtheta.pos_of_bit, theta.pos_of_bit)
    kw = dict(paging="heuristic", page_bytes=page_bytes)
    idx = LMSFCIndex.build(data, theta=theta, cfg=IndexConfig(**kw),
                           workload=(Ls, Us), K=K)
    ridx = RIndex.build(data, theta=rtheta, cfg=RConfig(**kw),
                        workload=(Ls, Us), K=K)
    q = np.stack([Ls, Us], axis=-1).astype(np.uint32).view(np.int32)
    want = np.asarray([brute_force_count(data, l, u) for l, u in zip(Ls, Us)])
    return data, idx, ridx, theta, rtheta, q, want


def test_distributed_fn_single_shard_matches_reference():
    """A one-shard mesh in process: the reference's (1, 1) mesh and the
    port's ``["cpu"]`` give the same counts and overflow, equal to brute
    force; the shard layout is ``P("pages")`` on every field, as the
    reference's on a ``("pages",)`` mesh."""
    data, idx, ridx, theta, rtheta, q, want = _setup("nyc", 3000, 32, 0)
    mc = max(64, idx.num_pages)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rfn, _ = r_make_dist(rtheta, mesh, max_cand=mc, q_chunk=8)
    rc, ro = rfn(r_shard(r_build(ridx, pad_pages_to=1), mesh), q)
    fn, layout = make_distributed_query_fn(theta, ["cpu"], max_cand=mc,
                                           q_chunk=8, backend="torch")
    c, o = fn(shard_serving_arrays(pack_serving_arrays(idx), ["cpu"]), q)
    assert c.dtype == o.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(o.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(c.numpy(), want)
    _, rlayout = r_make_dist(rtheta, jax.make_mesh((1,), ("pages",)),
                             max_cand=mc, q_chunk=8)
    for f in ("points", "page_zmin", "page_zmax", "page_mbr", "page_size"):
        assert getattr(layout, f) == P("pages")
        assert tuple(getattr(layout, f)) == tuple(getattr(rlayout, f))


def test_distributed_fn_8_shards_against_brute_force():
    data, idx, _, theta, _, q, want = _setup("osm", 4000, 24, 1)
    mesh = ["cpu"] * 8
    host = pack_serving_arrays(idx, pad_pages_to=8)
    arrays = shard_serving_arrays(host, mesh)
    per = host.page_size.shape[0] // 8
    assert isinstance(arrays.points, PageShards)
    assert arrays.points.shape == host.points.shape
    for i, part in enumerate(arrays.page_size.parts):
        np.testing.assert_array_equal(part.numpy(),
                                      host.page_size[i * per:(i + 1) * per])
    fn, _ = make_distributed_query_fn(theta, mesh, max_cand=idx.num_pages,
                                      q_chunk=8, backend="torch")
    counts, over = fn(arrays, q)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert not over.numpy().any()


def test_distributed_fn_refusals():
    data, idx, _, theta, _, q, _ = _setup("osm", 1500, 8, 2)
    with pytest.raises(ValueError, match="at least one device"):
        mesh_devices([])
    n = idx.num_pages + 1                 # never divides the page count
    with pytest.raises(ValueError, match=f"pad_pages_to={n}"):
        shard_serving_arrays(pack_serving_arrays(idx), ["cpu"] * n)
    with pytest.raises(ValueError, match="backend='torch'"):
        make_distributed_query_fn(theta, ["cpu", "cpu"], backend="cuda")


_R8 = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.core.index import IndexConfig, LMSFCIndex
    from repro.core.serve import (build_serving_arrays,
                                  make_distributed_query_fn,
                                  shard_serving_arrays)
    from repro.core.theta import default_K, random_theta
    from repro.data.synth import make_dataset
    from repro.data.workload import make_workload

    assert jax.device_count() == 8
    data = make_dataset("osm", 4000, seed=1)
    K = default_K(2)
    theta = random_theta(np.random.default_rng(1), 2, K)
    Ls, Us = make_workload(data, 24, seed=1, K=K)
    idx = LMSFCIndex.build(data, theta=theta,
                           cfg=IndexConfig(paging="heuristic",
                                           page_bytes=512),
                           workload=(Ls, Us), K=K)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    arrays = shard_serving_arrays(build_serving_arrays(idx, pad_pages_to=8),
                                  mesh)
    q = np.stack([Ls, Us], -1).astype(np.uint32).view(np.int32)
    out = {}
    for mc in (1, 2, idx.num_pages):
        fn, _ = make_distributed_query_fn(theta, mesh, max_cand=mc,
                                          q_chunk=8)
        c, o = fn(arrays, q)
        out[mc] = [np.asarray(c).tolist(), np.asarray(o).tolist()]
    print("R8 " + json.dumps({"pages": idx.num_pages, "out": out}))
""")


def test_overflow_counts_equal_reference_8_device_run():
    """Forced `max_cand` on 8 shards: the port's counts and per-query
    overflow counts (how many shards overflowed) equal the reference's on
    an 8-device (4 x 2) mesh, run in a subprocess (pages of 512 B, so a
    query's candidates span several shards); with an overflow-free budget
    both equal brute force."""
    r = subprocess.run(
        [sys.executable, "-c", _R8], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
             "HOME": os.environ.get("HOME", str(ROOT)),
             "JAX_PLATFORMS": "cpu"},
        cwd=ROOT, timeout=600)
    line = [x for x in r.stdout.splitlines() if x.startswith("R8 ")]
    assert line, r.stderr[-3000:]
    ref = json.loads(line[0][3:])
    data, idx, _, theta, _, q, want = _setup("osm", 4000, 24, 1, 512)
    assert idx.num_pages == ref["pages"]
    arrays = shard_serving_arrays(pack_serving_arrays(idx, pad_pages_to=8),
                                  ["cpu"] * 8)
    over_seen = 0
    for mc, (rc, ro) in ref["out"].items():
        fn, _ = make_distributed_query_fn(theta, ["cpu"] * 8,
                                          max_cand=int(mc), q_chunk=8,
                                          backend="torch")
        c, o = fn(arrays, q)
        np.testing.assert_array_equal(c.numpy(), rc, err_msg=mc)
        np.testing.assert_array_equal(o.numpy(), ro, err_msg=mc)
        over_seen = max(over_seen, int(o.max()))
        if int(mc) == idx.num_pages:
            np.testing.assert_array_equal(c.numpy(), want)
    assert over_seen > 1          # several shards overflowed one query


# ---------------------------------------------------------------------------
# the `distributed` engine behind the facade
# ---------------------------------------------------------------------------


def _data(n=4000, n_q=16, seed=0):
    data = make_dataset("osm", n, seed=seed)
    K = default_K(2)
    Ls, Us = make_workload(data, n_q, seed=seed + 1, K=K)
    want = np.asarray([brute_force_count(data, l, u) for l, u in zip(Ls, Us)])
    return data, (Ls, Us), K, want


def test_cross_engine_parity_with_overflow_escalation():
    """Twin of the reference's cpu / xla / distributed acceptance test for
    `distributed`: max_cand=1 overflows on the first pass and escalation
    makes it exact; results, plans, accounting and `CacheStats` equal the
    reference's one-device engine; an 8-shard mesh gives the same counts
    and counts how many of its shards overflowed."""
    data, wl, K, want = _data()
    pair = Pair(data, wl, K=K, page_bytes=1024)
    assert pair.port.num_pages > 8
    pair.engine("distributed", max_cand=1, q_chunk=8)
    eng = pair.port.engines["distributed"]
    assert eng.mesh == (mesh_devices(["cpu"])[0],)
    assert eng.backend == "torch"
    res = pair.query(lambda a: wl)
    assert res.engine == "distributed" and res.exact
    np.testing.assert_array_equal(res.counts, want)
    assert np.any(res.overflowed > 0) and res.escalations > 0
    pair.port.engine("distributed", tapi.EngineConfig(
        mesh=["cpu"] * 8, max_cand=1, q_chunk=8))
    r8 = pair.port.query(tapi.Count(*wl))
    assert r8.exact and r8.engine == "distributed"
    np.testing.assert_array_equal(r8.counts, want)
    assert pair.port.engines["distributed"]._host.points.shape[0] % 8 == 0
    assert r8.escalations > 0 and r8.overflowed.max() > 1   # shard sums


def test_explain_and_plan_shim_route_unsupported_kinds_to_cpu():
    """Twins of `test_explain_routes_unsupported_kinds_to_cpu` and the
    `distributed` line of `test_plan_string_shim_deprecated`."""
    data, wl, K, _ = _data(n=1500, n_q=8)
    pair = Pair(data, wl, K=K, page_bytes=1024)
    pair.engine("distributed", q_chunk=8, max_cand=64)
    for api, db in ((rapi, pair.ref), (tapi, pair.port)):
        plan = db.explain(api.Range(*wl))
        assert plan.engine == "cpu" and plan.requested == "distributed"
        assert plan.routed
        assert db.explain(api.Count(*wl)).engine == "distributed"
        with pytest.warns(DeprecationWarning):
            assert db.plan("range", engine="distributed") == "cpu"
    for mk in (lambda a: a.Count(*wl), lambda a: a.Point(data[:9])):
        assert pair.ref.explain(mk(rapi)).describe() == \
            pair.port.explain(mk(tapi)).describe()


def test_refresh_after_updates_copies_dirty_pages_into_their_shards():
    """Inserts and deletes are served after a refresh that copies only the
    dirty pages into the shards holding them (equal to the reference's
    engine and to brute force); a page overflowing the capacity re-packs
    and re-shards everything at the grown capacity, still exact."""
    data, wl, K, _ = _data(n=2500, n_q=12)
    pair = Pair(data, wl, K=K, page_bytes=2048)
    pair.engine("distributed", q_chunk=8, max_cand=pair.port.num_pages)
    cap = int(np.diff(pair.port.index.starts).max()) + 32   # headroom
    pair.port.engine("distributed", tapi.EngineConfig(
        mesh=["cpu"] * 4, q_chunk=8, max_cand=pair.port.num_pages, cap=cap))

    def both(make):
        """The port's 4-shard engine against the reference's one-device
        engine: every answer equal (the plans differ by the padding)."""
        got, want = pair.port.query(make(tapi)), pair.ref.query(make(rapi))
        assert got.engine == want.engine == "distributed" and got.exact
        for f in ("counts", "found"):
            if hasattr(want, f):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
        return got

    both(lambda a: a.Count(*wl))                     # packed at epoch 0
    eng = pair.port.engines["distributed"]
    parts0 = eng._arrays.points.parts
    before = [p.clone() for p in parts0]
    rng = np.random.default_rng(7)
    new = np.unique(rng.integers(0, 2**K, size=(80, 2), dtype=np.uint64),
                    axis=0)
    new = new[~rows_in_set(new, data)]
    pair.both("insert", new)
    pair.both("delete", [data[5], new[0]])
    dirty = set(pair.port.store.dirty_since(eng.built_epoch))
    res = both(lambda a: a.Count(*wl))
    assert eng.built_epoch == pair.port.store.epoch
    assert eng._host.points.shape[2] == cap        # refreshed page by page
    assert all(a is b for a, b in zip(eng._arrays.points.parts, parts0))
    live = pair.port.store.merged_data()
    np.testing.assert_array_equal(
        res.counts, [brute_force_count(live, l, u) for l, u in zip(*wl)])
    per = eng._host.points.shape[0] // 4
    for i, (old, part) in enumerate(zip(before, eng._arrays.points.parts)):
        changed = {i * per + int(p) for p in np.nonzero(
            (old != part).reshape(per, -1).any(1).numpy())[0]}
        assert changed <= dirty
        np.testing.assert_array_equal(
            part.numpy(), eng._host.points[i * per:(i + 1) * per])
    pt = both(lambda a: a.Point(np.concatenate([new[:3], data[5:6]])))
    assert pt.found.tolist() == [False, True, True, False]
    # capacity growth: near-duplicates of one row overflow its page
    cap0 = eng._host.points.shape[2]
    base = data[100].astype(np.int64)
    burst = np.unique(np.stack([
        np.clip(base + [dx, 0], 0, 2 ** K - 1).astype(np.uint64)
        for dx in range(1, cap0 + 16)]), axis=0)
    burst = burst[~rows_in_set(burst, pair.port.store.merged_data())]
    pair.both("insert", burst)
    res = both(lambda a: a.Count(*wl))
    assert eng._host.points.shape[2] > cap0 and res.exact
    for i, part in enumerate(eng._arrays.points.parts):
        np.testing.assert_array_equal(
            part.numpy(), eng._host.points[i * per:(i + 1) * per])
    live = pair.port.store.merged_data()
    np.testing.assert_array_equal(
        res.counts, [brute_force_count(live, l, u) for l, u in zip(*wl)])


def test_engine_mesh_backend_and_refusals(monkeypatch):
    """The mesh defaults to the engine's device under ``device="cpu"``
    and pads pages to the shard count; 'torch' is the default backend on
    a CPU mesh only, and backend 'cuda' (named, or the default on a mesh
    that mixes a card and the CPU) on a mesh holding a CPU device raises
    at attach — no fallback to the twins; without a card and without
    ``device="cpu"`` the default mesh (every CUDA device) cannot resolve;
    range and kNN are not sharded and route to the CPU engine."""
    data, wl, K, want = _data(n=1500, n_q=8)
    db = tapi.Database.fit(data, wl, K=K, learn=False, device="cpu")
    db.engine("distributed", tapi.EngineConfig(mesh=["cpu"] * 3, q_chunk=8))
    eng = db.engines["distributed"]
    assert eng.pad_pages_to == 3 and eng.backend == "torch"
    res = db.query(tapi.Count(*wl))
    np.testing.assert_array_equal(res.counts, want)
    assert eng._host.points.shape[0] % 3 == 0
    for mesh in (["cpu"], ["cpu", "cpu"]):
        with pytest.raises(ValueError, match="CUDA kernels"):
            db.engine("distributed", tapi.EngineConfig(mesh=mesh,
                                                       backend="cuda"))
    # a mesh with a card and the CPU takes 'cuda' by default, so it raises
    # at attach too: no shard on a card is served by the twins
    for mesh in (["cuda:0", "cpu"], ["cpu", "cuda:1"]):
        with pytest.raises(ValueError, match="CUDA kernels"):
            db.engine("distributed", tapi.EngineConfig(mesh=mesh))
    with pytest.raises(ValueError, match="backend"):
        db.engine("distributed", tapi.EngineConfig(backend="xla"))
    with pytest.raises(NotImplementedError, match="CPU engine"):
        eng._build_rfn(8, 8)
    assert db.query(tapi.Range(*wl), engine="distributed").engine == "cpu"
    assert db.query(tapi.Knn(data[:2], k=3),
                    engine="distributed").engine == "cpu"
    assert tapi.engine_capabilities()["distributed"] == \
        rapi.engine_capabilities()["distributed"] == {"count", "point"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_device = tapi.Database(db.index)
    with pytest.raises(RuntimeError, match="CUDA"):
        no_device.engine("distributed")
