"""Port vs reference: the device window-query path (Count and Range).

The same index (built by both packages from the same data, or built by
the reference and carried across with `core.convert`) is packed, and the
same query rectangles run through the reference's `make_query_fn` /
`make_range_fn` (backend "xla", and one batch through "pallas" in
interpret mode) and the port's (default "cuda" backend on CPU tensors,
which takes the plain twins, and "torch").  Every output is an integer:
tolerance 0, arrays must be equal, including forced overflow."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import curve as rc
from repro.core import index as ri
from repro.core import pgm as rpgm
from repro.core import query as rq
from repro.core import serve as rsv
from repro.core.theta import default_K
from repro.data.synth import make_dataset
from repro.data.workload import make_workload
from repro_torch.core import convert
from repro_torch.core import curve as tc
from repro_torch.core import index as ti
from repro_torch.core import query as tq
from repro_torch.core import serve as tsv
from repro_torch.core import split as tsplit

SERVE_FIELDS = ("points", "page_zmin", "page_zmax", "page_mbr", "page_size")


def _indexes(family="global", n=6000, name="osm", depth=1, seed=0):
    data = make_dataset(name, n, seed=seed)
    d = data.shape[1]
    K = 32 if d == 2 else default_K(d)
    ref_curve = rc.random_curve(np.random.default_rng(seed + 11), d, K,
                                family=family, depth=depth)
    wl = make_workload(data, 16, seed=seed, K=K, width_scale=0.1)
    cfg = dict(paging="heuristic", page_bytes=2048)
    a = ri.LMSFCIndex.build(data, curve=ref_curve, cfg=ri.IndexConfig(**cfg),
                            workload=wl)
    b = ti.LMSFCIndex.build(data, curve=tc.curve_from_json(ref_curve.to_json()),
                            cfg=ti.IndexConfig(**cfg), workload=wl)
    return data, wl, a, b


def _run_both(a, b, rects, *, max_cand, max_hits, backends=("cuda", "torch"),
              ref_backend="xla", interpret=False, arr_t=None, q_chunk=8,
              k_maxsplit=4):
    """Count and Range through both packages (the port on `arr_t`, by
    default `b` packed by the port); asserts equality."""
    arr_r = rsv.build_serving_arrays(a)
    if arr_t is None:
        arr_t = tsv.build_serving_arrays(b, device="cpu")
    kw = dict(max_cand=max_cand, q_chunk=q_chunk, k_maxsplit=k_maxsplit)
    want_c = rsv.make_query_fn(a.curve, backend=ref_backend,
                               interpret=interpret, **kw)(
        arr_r, jnp.asarray(rects))
    want_r = rsv.make_range_fn(a.curve, max_hits=max_hits,
                               backend=ref_backend, interpret=interpret,
                               **kw)(arr_r, jnp.asarray(rects))
    for backend in backends:
        got_c = tsv.make_query_fn(b.curve, backend=backend, **kw)(arr_t,
                                                                  rects)
        got_r = tsv.make_range_fn(b.curve, max_hits=max_hits,
                                  backend=backend, **kw)(arr_t, rects)
        for g, w, name in zip(got_c + got_r, want_c + want_r,
                              ("counts", "overflow", "ids", "n_hits",
                               "cand_over", "hit_over")):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{backend}: {name}")
    return [np.asarray(w) for w in want_c + want_r]


@pytest.mark.parametrize("page_bytes,pad,cap", [(2048, 1, None),
                                                (8192, 8, 1100)])
def test_pack_serving_arrays_identical(page_bytes, pad, cap):
    data = make_dataset("osm", 5000, seed=2)
    a = ri.LMSFCIndex.build(data, cfg=ri.IndexConfig(page_bytes=page_bytes))
    b = ti.LMSFCIndex.build(data, cfg=ti.IndexConfig(page_bytes=page_bytes))
    ha = rsv.pack_serving_arrays(a, pad_pages_to=pad, cap=cap)
    hb = tsv.pack_serving_arrays(b, pad_pages_to=pad, cap=cap)
    for f in SERVE_FIELDS:
        np.testing.assert_array_equal(getattr(hb, f), getattr(ha, f),
                                      err_msg=f)
    on_cpu = tsv.build_serving_arrays(b, pad_pages_to=pad, cap=cap,
                                      device="cpu")
    for f in SERVE_FIELDS:
        np.testing.assert_array_equal(getattr(on_cpu, f).numpy(),
                                      getattr(ha, f), err_msg=f)
    with pytest.raises(ValueError):
        tsv.pack_serving_arrays(b, cap=1)
    with pytest.raises(ValueError):
        tsv.pack_serving_arrays(b, pad_pages_to=0)


@pytest.mark.parametrize("family,depth", [("global", 1), ("piecewise", 1)])
def test_count_and_range_match_reference(family, depth):
    data, (Ls, Us), a, b = _indexes(family, depth=depth)
    rects = tsv.pack_query_rects(Ls, Us)
    counts, over, ids, n_hits, cand_over, hit_over = _run_both(
        a, b, rects, max_cand=max(64, a.num_pages), max_hits=4096)
    assert not over.any() and not cand_over.any() and not hit_over.any()
    want = [rq.brute_force_count(data, lo, hi) for lo, hi in zip(Ls, Us)]
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(n_hits, want)


@pytest.mark.parametrize("name,family", [("nyc", "global"),
                                         ("nyc", "piecewise"),
                                         ("stock", "global"),
                                         ("stock", "piecewise")])
def test_count_and_range_match_reference_in_three_and_four_dims(name,
                                                                family):
    """d 3 (NYC-like, K 21) and d 4 (stock-like, K 16), depth 1: Count and
    Range equal the reference's `xla` path bit for bit, upper bounds at
    2^K - 1 included, with max_cand=2 / max_hits=8 forcing both overflows;
    the queries that fit are held against brute force.  The global curves
    also run with budgets no query overflows.  (The reference's XLA
    compile of a piecewise path takes 25-75 s a function here at d 4, so
    the piecewise cases compile one budget pair.)"""
    data, (Ls, Us), a, b = _indexes(family, n=4000, name=name, seed=9)
    d, K = data.shape[1], a.K
    assert d == (3 if name == "nyc" else 4) and K == default_K(d)
    Us = Us.copy()
    Us[:3] = 2**K - 1                    # the top of the key domain
    rects = tsv.pack_query_rects(Ls, Us)
    want = np.asarray([rq.brute_force_count(data, lo, hi)
                       for lo, hi in zip(Ls, Us)])
    counts, over, ids, n_hits, cand_over, hit_over = _run_both(
        a, b, rects, max_cand=2, max_hits=8)
    assert over.any() and cand_over.any() and hit_over.any()
    fit = (over == 0) & (cand_over == 0)
    assert fit.any()
    np.testing.assert_array_equal(counts[fit], want[fit])
    np.testing.assert_array_equal(n_hits[fit], want[fit])
    if family == "global":
        counts, over, _, n_hits, cand_over, hit_over = _run_both(
            a, b, rects, max_cand=max(64, a.num_pages), max_hits=4096)
        assert not over.any() and not cand_over.any() and not hit_over.any()
        np.testing.assert_array_equal(counts, want)
        np.testing.assert_array_equal(n_hits, want)


def test_forced_overflow_matches_reference():
    """max_cand=1 overflows Count and Range candidates; max_hits=4
    truncates the id buffers.  Flags and truncated outputs must agree."""
    _, (Ls, Us), a, b = _indexes("global", seed=3)
    rects = tsv.pack_query_rects(Ls, Us)
    _, over, _, _, cand_over, _ = _run_both(a, b, rects, max_cand=1,
                                            max_hits=4096)
    assert over.any() and cand_over.any()
    *_, hit_over = _run_both(a, b, rects, max_cand=64, max_hits=4)
    assert hit_over.any()


@pytest.mark.parametrize("k_maxsplit,q_chunk,max_cand,max_hits", [
    (4, 8, 64, 4096), (4, 16, 1, 4096), (2, 4, 64, 4), (3, 16, 64, 4096)])
def test_split_and_zranges_run_once_a_batch(monkeypatch, k_maxsplit, q_chunk,
                                            max_cand, max_hits):
    """Count and Range split the whole batch at once: on CPU tensors (the
    split kernel's twin) k_maxsplit + 1 encode calls a batch (each split
    level encodes both corner sets in one call, the z-ranges both corners
    in one), whatever Q / q_chunk, with outputs equal to the reference's,
    forced overflow included."""
    calls = []
    real = tsplit.sfc_encode

    def counting(x, curve, **kw):
        calls.append(x.shape[0])
        return real(x, curve, **kw)

    monkeypatch.setattr(tsplit, "sfc_encode", counting)
    _, (Ls, Us), a, b = _indexes("global", seed=8)
    rects = tsv.pack_query_rects(Ls, Us)
    Q, d = rects.shape[:2]
    over = _run_both(a, b, rects, max_cand=max_cand, max_hits=max_hits,
                     q_chunk=q_chunk, k_maxsplit=k_maxsplit)
    # points a call: both corner sets of (Q, 2^level, d) candidate
    # corners, then both corners of the (Q, 2^k) sub-queries
    batch = [2 * Q * 2**lv * d for lv in range(k_maxsplit)]
    batch.append(2 * Q * 2**k_maxsplit)
    assert calls == batch * 4           # 2 backends x (Count, Range)
    if max_cand == 1:
        assert over[1].any() and over[4].any()
    if max_hits == 4:
        assert over[5].any()


def test_count_matches_reference_pallas_interpret():
    """One small batch against the reference's Pallas kernels (interpret)."""
    _, (Ls, Us), a, b = _indexes("global", n=3000, seed=4)
    rects = tsv.pack_query_rects(Ls[:8], Us[:8])
    _run_both(a, b, rects, max_cand=16, max_hits=256, backends=("cuda",),
              ref_backend="pallas", interpret=True)


def test_reference_built_index_carried_across():
    """An index built by the reference (piecewise curve) reaches the port
    as numpy arrays plus curve JSON, and its packed serving arrays as
    numpy; the port serves it bit-identically.  A port-built index carried
    back serves identically in the reference too."""
    data, (Ls, Us), a, _ = _indexes("piecewise", seed=5)
    cfg = {"paging": a.cfg.paging, "page_bytes": a.cfg.page_bytes,
           "pgm_eps": a.cfg.pgm_eps}
    b = convert.index_from_numpy(a.curve.to_json(), cfg, a.xs, a.starts,
                                 a.mbrs, a.sort_dims, a.page_zmin,
                                 a.page_zmax)
    np.testing.assert_array_equal(b.pgm.seg_x0, a.pgm.seg_x0)
    for lo, hi in zip(Ls[:4], Us[:4]):
        assert tq.query_count(b, lo, hi).result == \
            rq.query_count(a, lo, hi).result
    host = rsv.pack_serving_arrays(a)
    arrays = convert.serving_arrays_from_numpy(
        host.points, host.page_zmin, host.page_zmax, host.page_mbr,
        host.page_size, device="cpu")
    rects = tsv.pack_query_rects(Ls, Us)
    _run_both(a, b, rects, max_cand=32, max_hits=512, backends=("cuda",),
              arr_t=arrays)
    # the reverse: a port-built index served by the reference
    _, (Ls, Us), _, p = _indexes("global", seed=6)
    back = ri.LMSFCIndex(
        curve=rc.curve_from_json(p.curve.to_json()), cfg=ri.IndexConfig(),
        K=p.K, xs=p.xs, starts=p.starts, mbrs=p.mbrs, sort_dims=p.sort_dims,
        page_zmin=p.page_zmin, page_zmax=p.page_zmax,
        pgm=rpgm.build_pgm(p.page_zmin))
    _run_both(back, p, tsv.pack_query_rects(Ls, Us), max_cand=32,
              max_hits=512, backends=("cuda",))


def test_device_default_is_cuda(monkeypatch):
    """Without a GPU and without device="cpu", device entry points raise;
    they never quietly serve from the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_dataset("osm", 1000, seed=0)
    idx = ti.LMSFCIndex.build(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsv.build_serving_arrays(idx)
    host = tsv.pack_serving_arrays(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.serving_arrays_from_numpy(host.points, host.page_zmin,
                                          host.page_zmax, host.page_mbr,
                                          host.page_size)
    assert tsv.build_serving_arrays(idx, device="cpu").points.device.type \
        == "cpu"


def test_range_guard_and_batch_shape_checks():
    """pages*cap must stay below 2^31 (int32 row ids); batches must be
    q_chunk multiples of (Q, d, 2) int32 rects."""
    curve = tc.default_curve(2, 32)
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    huge = tsv.ServingArrays(points=meta(2**21, 2, 1024),
                             page_zmin=meta(2**21, 2),
                             page_zmax=meta(2**21, 2),
                             page_mbr=meta(2**21, 2, 2),
                             page_size=meta(2**21))
    rfn = tsv.make_range_fn(curve, q_chunk=8)
    with pytest.raises(ValueError, match="2\\^31"):
        rfn(huge, np.zeros((8, 2, 2), np.int32))
    data = make_dataset("osm", 1000, seed=0)
    arrays = tsv.build_serving_arrays(ti.LMSFCIndex.build(data),
                                      device="cpu")
    qfn = tsv.make_query_fn(curve, q_chunk=8)
    with pytest.raises(ValueError, match="q_chunk"):
        qfn(arrays, np.zeros((5, 2, 2), np.int32))
    with pytest.raises(ValueError, match="int32"):
        qfn(arrays, np.zeros((8, 2, 2), np.int64))
    empty = np.zeros((0, 2, 2), np.int32)
    assert [tuple(t.shape) for t in qfn(arrays, empty)] == [(0,), (0,)]
    rfn = tsv.make_range_fn(curve, q_chunk=8, max_hits=16)
    assert [tuple(t.shape) for t in rfn(arrays, empty)] == \
        [(0, 16), (0,), (0,), (0,)]


def test_buckets_rects_and_knn_seeds_match_reference():
    for n, m in [(0, 1), (1, 1), (5, 1), (17, 8), (64, 16), (65, 16)]:
        assert tsv.bucket_pow2(n, m) == rsv.bucket_pow2(n, m)
    with pytest.raises(ValueError):
        tsv.bucket_pow2(3, 0)
    data, (Ls, Us), a, b = _indexes("global", n=4000, seed=7)
    np.testing.assert_array_equal(tsv.pack_query_rects(Ls, Us, 24),
                                  rsv.pack_query_rects(Ls, Us, 24))
    with pytest.raises(ValueError):
        tsv.pack_query_rects(Ls, Us, 3)
    with pytest.raises(ValueError):
        tsv.pack_query_rects(Ls[:0], Us[:0], 8)
    host_r, host_t = rsv.pack_serving_arrays(a), tsv.pack_serving_arrays(b)
    for metric in ("l2", "linf"):
        assert tsv.knn_seed_radius(host_t, b.curve, data[:6], 5, metric) == \
            rsv.knn_seed_radius(host_r, a.curve, data[:6], 5, metric)
    assert tsv.knn_seed_radius(host_t, b.curve, data[:2], 0) == [0, 0]
