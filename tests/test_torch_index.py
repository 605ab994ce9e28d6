"""Port vs reference: index build (paging, sort dims, PGM), the CPU
engine and its brute-force oracles, and the data generators.  The port's
copies are numpy code like the reference's, so integer and float outputs
alike must be equal (tolerance 0)."""
import numpy as np
import pytest
import torch

from repro.core import curve as rc
from repro.core import index as ri
from repro.core import paging as rp
from repro.core import pgm as rpgm
from repro.core import query as rq
from repro.core import sortdim as rsd
from repro.core.theta import default_K
from repro.data import synth as rsyn
from repro.data import workload as rwl
from repro_torch.core import curve as tc
from repro_torch.core import index as ti
from repro_torch.core import paging as tp
from repro_torch.core import pgm as tpgm
from repro_torch.core import query as tq
from repro_torch.core import sortdim as tsd
from repro_torch.data import synth as tsyn
from repro_torch.data import workload as twl

INDEX_FIELDS = ("xs", "starts", "mbrs", "sort_dims", "page_zmin", "page_zmax")


def _build_both(data, family, paging, workload, page_bytes=2048, seed=0):
    d = data.shape[1]
    K = default_K(d)
    ref_curve = rc.random_curve(np.random.default_rng(seed), d, K,
                                family=family)
    curve = tc.curve_from_json(ref_curve.to_json())
    kw = dict(paging=paging, page_bytes=page_bytes)
    a = ri.LMSFCIndex.build(data, curve=ref_curve, cfg=ri.IndexConfig(**kw),
                            workload=workload)
    b = ti.LMSFCIndex.build(data, curve=curve, cfg=ti.IndexConfig(**kw),
                            workload=workload)
    return a, b


@pytest.mark.parametrize("paging,family", [
    ("fixed", "global"), ("heuristic", "global"), ("heuristic", "piecewise"),
    ("dp", "global"), ("dp", "piecewise")])
def test_index_build_matches_reference(paging, family):
    n = 3000 if paging == "dp" else 12000
    data = rsyn.make_dataset("osm", n, seed=3)
    wl = rwl.make_workload(data, 32, seed=1)
    a, b = _build_both(data, family, paging, wl)
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)
    assert (b.K, b.n, b.d, b.num_pages) == (a.K, a.n, a.d, a.num_pages)
    np.testing.assert_array_equal(b.pgm.seg_x0, a.pgm.seg_x0)
    np.testing.assert_array_equal(b.pgm.seg_slope, a.pgm.seg_slope)
    assert b.pgm.eps_actual == a.pgm.eps_actual
    assert b.index_size_bytes() == a.index_size_bytes()
    np.testing.assert_array_equal(b.page_of(a.page_zmax), a.page_of(a.page_zmax))


def test_index_build_defaults_and_errors_match_reference():
    data = rsyn.make_dataset("stock", 2000, seed=2)
    a = ri.LMSFCIndex.build(data)
    b = ti.LMSFCIndex.build(data)
    assert b.curve.to_json() == a.curve.to_json()
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert b.theta.seq == a.theta.seq
    with pytest.raises(ValueError):
        ti.LMSFCIndex.build(data, curve=b.curve, theta=b.theta)
    with pytest.raises(ValueError):
        ti.LMSFCIndex.build(data, K=7, curve=b.curve)


def test_paging_pgm_sortdim_helpers_match_reference():
    rng = np.random.default_rng(5)
    xs = np.sort(rng.integers(0, 2**16, size=(4000, 2)), axis=0)
    smin, smax = rp.page_capacity(2, 2048)
    assert tp.page_capacity(2, 2048) == (smin, smax)
    for fn in ("heuristic_paging", "dp_paging_np"):
        want = getattr(rp, fn)(xs, smin, smax, 16)
        np.testing.assert_array_equal(getattr(tp, fn)(xs, smin, smax, 16),
                                      want, err_msg=fn)
    starts = rp.fixed_paging(len(xs), smax)
    np.testing.assert_array_equal(tp.fixed_paging(len(xs), smax), starts)
    mbrs = rp.compute_mbrs(xs, starts)
    np.testing.assert_array_equal(tp.compute_mbrs(xs, starts), mbrs)
    assert tp.total_score(xs, starts, 16) == rp.total_score(xs, starts, 16)
    keys = np.unique(rng.integers(0, 2**63, size=3000, dtype=np.uint64))
    pa, pb = rpgm.build_pgm(keys, eps=16), tpgm.build_pgm(keys, eps=16)
    np.testing.assert_array_equal(pb.seg_y0, pa.seg_y0)
    np.testing.assert_array_equal(pb.predict(keys), pa.predict(keys))
    np.testing.assert_array_equal(tpgm.lookup_le(pb, keys, keys[::7] + 1),
                                  rpgm.lookup_le(pa, keys, keys[::7] + 1))
    Ls = rng.integers(0, 2**15, size=(20, 2))
    Us = Ls + rng.integers(0, 2**14, size=(20, 2))
    np.testing.assert_array_equal(
        tsd.choose_sort_dims(mbrs, Ls, Us, 2**16),
        rsd.choose_sort_dims(mbrs, Ls, Us, 2**16))
    sd = rsd.choose_sort_dims(mbrs, Ls, Us, 2**16)
    np.testing.assert_array_equal(tsd.apply_sort_dims(xs, starts, sd),
                                  rsd.apply_sort_dims(xs, starts, sd))
    assert tsd.default_sort_dim(Ls, Us, 2**16) == \
        rsd.default_sort_dim(Ls, Us, 2**16)


def test_dp_paging_above_200k_rows_is_not_ported_yet(monkeypatch):
    """Above 200k rows dp paging runs on a device (`dp_paging_torch`, held
    against `dp_paging_np` in tests/test_torch_paging.py): without a card
    and without ``device="cpu"`` it raises instead of falling back."""
    xs = np.zeros((200_001, 2), dtype=np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.make_paging(xs, "dp", 16)
    threads = torch.get_num_threads()   # few threads: see test_torch_paging
    torch.set_num_threads(2)
    try:
        pg = tp.make_paging(xs, "dp", 16, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert pg.starts[0] == 0 and pg.starts[-1] == len(xs)


@pytest.mark.parametrize("family", ["global", "piecewise"])
def test_cpu_engine_matches_reference(family):
    data = rsyn.make_dataset("nyc", 8000, seed=4)
    Ls, Us = rwl.make_workload(data, 12, seed=2)
    a, b = _build_both(data, family, "heuristic", (Ls, Us), seed=1)
    cr, sr = rq.run_workload(a, Ls, Us)
    ct, st = tq.run_workload(b, Ls, Us)
    np.testing.assert_array_equal(ct, cr)
    assert vars(st) == vars(sr)
    for lo, hi in zip(Ls[:6], Us[:6]):
        rows_r, stats_r = rq.query_range(a, lo, hi)
        rows_t, stats_t = tq.query_range(b, lo, hi)
        np.testing.assert_array_equal(rows_t, rows_r)
        assert vars(stats_t) == vars(stats_r)
        assert tq.brute_force_count(data, lo, hi) == \
            rq.brute_force_count(data, lo, hi) == len(rows_t)
        np.testing.assert_array_equal(tq.lex_sorted_rows(rows_t),
                                      tq.brute_force_range(data, lo, hi))
    probe = np.concatenate([data[:10], data[:5] + 1])
    np.testing.assert_array_equal(tq.query_point(b, probe),
                                  rq.query_point(a, probe))
    for metric in ("l2", "linf"):
        for center in (data[7], Ls[0]):
            rr, dr, _ = rq.query_knn(a, center, 9, metric)
            rt, dt, _ = tq.query_knn(b, center, 9, metric)
            np.testing.assert_array_equal(rt, rr)
            assert dt == dr
            brute_rows, brute_d = tq.brute_force_knn(data, center, 9, metric)
            np.testing.assert_array_equal(rt, brute_rows)
            assert dt == brute_d


def test_fnz_skipping_is_not_ported_yet():
    """FNZ skipping is ported (`repro_torch.baselines.fnz`): an index
    built with ``skipping="fnz"`` counts exactly, with the reference's
    `QueryStats`."""
    import dataclasses
    data = rsyn.make_dataset("osm", 500, seed=0)
    idx = ti.LMSFCIndex.build(data, cfg=ti.IndexConfig(skipping="fnz"))
    ridx = ri.LMSFCIndex.build(data, cfg=ri.IndexConfig(skipping="fnz"))
    Ls, Us = rwl.make_workload(data, 12, seed=2, width_scale=0.1)
    for lo, hi in [(data[0], data[0])] + list(zip(Ls, Us)):
        st = tq.query_count(idx, lo, hi)
        assert st.result == tq.brute_force_count(data, lo, hi)
        assert dataclasses.asdict(st) == \
            dataclasses.asdict(rq.query_count(ridx, lo, hi))


@pytest.mark.parametrize("name", ["osm", "nyc", "stock"])
def test_data_generators_match_reference(name):
    a = rsyn.make_dataset(name, 3000, seed=5)
    b = tsyn.make_dataset(name, 3000, seed=5)
    np.testing.assert_array_equal(b, a)
    wa = rwl.make_workload(a, 40, seed=3, width_scale=0.02)
    wb = twl.make_workload(b, 40, seed=3, width_scale=0.02)
    for x, y in zip(wb, wa):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(twl.scale_to_selectivity(b, *wb, 0.01, iters=4),
                    rwl.scale_to_selectivity(a, *wa, 0.01, iters=4)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(twl.with_aspect_ratio(*wb, 4.0),
                    rwl.with_aspect_ratio(*wa, 4.0)):
        np.testing.assert_array_equal(x, y)


def test_iter_chunks_matches_reference_for_any_chunking():
    want = np.concatenate(list(rsyn.iter_chunks(5000, 5000, seed=3)))
    for chunk in (700, 5000):
        got = np.concatenate(list(tsyn.iter_chunks(5000, chunk, seed=3)))
        np.testing.assert_array_equal(got, want)
