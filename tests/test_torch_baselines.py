"""The port's baseline indexes (`repro_torch.baselines`) against the
reference's (`repro.baselines`).

Twins of `tests/test_baselines.py` (ZM, Flood and R-tree counts against
brute force), with each baseline built from the same seeded data in both
packages and its structure held equal: ZM's pages (boundaries, z ranges,
MBRs), Flood's layout (sort and grid dimensions, columns, bin edges, cell
ranges, the laid-out rows) and the R-tree's leaf ranges, leaf MBRs and
levels.  FindNextZaddress skipping (`fnz`): `next_jump_in` equals the
reference's on seeded z values, `query_count(..., skipping="fnz")` gives
`QueryStats` equal to the reference's field for field (twin of the fnz
cases of `tests/test_index_query.py::test_query_exact_counts`), and a
piecewise curve refuses FNZ (twin of
`tests/test_curve.py::test_fnz_requires_global_curve`).  Everything here
is host numpy: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest

from repro.baselines import flood as rflood
from repro.baselines import fnz as rfnz
from repro.baselines import rstar as rrstar
from repro.baselines import zm as rzm
from repro.core import query as rq
from repro.core.index import IndexConfig as RConfig
from repro.core.index import LMSFCIndex as RIndex
from repro.core.theta import random_theta as r_random_theta
from repro_torch.baselines import flood, fnz, rstar, zm
from repro_torch.core import query as tq
from repro_torch.core.curve import PiecewiseCurve
from repro_torch.core.index import IndexConfig, LMSFCIndex
from repro_torch.core.query import brute_force_count, query_count
from repro_torch.core.sfc import encode_np
from repro_torch.core.theta import default_K, random_theta
from repro_torch.data.synth import make_dataset
from repro_torch.data.workload import make_workload


def _same_index(a, b):
    """Two `LMSFCIndex` builds with the same pages."""
    for f in ("xs", "starts", "page_zmin", "page_zmax", "mbrs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.curve.to_json() == b.curve.to_json()


@pytest.mark.parametrize("name", ["osm", "nyc", "stock"])
def test_zm_index_exact(name):
    data = make_dataset(name, 3000, seed=7)
    K = default_K(data.shape[1])
    Ls, Us = make_workload(data, 25, seed=7, K=K)
    idx = zm.build_zm_index(data, K=K, page_bytes=2048)
    ridx = rzm.build_zm_index(data, K=K, page_bytes=2048)
    _same_index(idx, ridx)
    for l, u in zip(Ls, Us):
        st = query_count(idx, l, u)
        assert st.result == brute_force_count(data, l, u)
        assert dataclasses.asdict(st) == \
            dataclasses.asdict(rq.query_count(ridx, l, u))


@pytest.mark.parametrize("name", ["osm", "nyc"])
def test_flood_exact(name):
    data = make_dataset(name, 4000, seed=8)
    K = default_K(data.shape[1])
    Ls, Us = make_workload(data, 30, seed=8, K=K)
    fi = flood.build_flood(data, (Ls, Us), K=K, page_bytes=2048)
    rfi = rflood.build_flood(data, (Ls, Us), K=K, page_bytes=2048)
    assert (fi.sort_dim, fi.grid_dims, fi.cols, fi.page_size, fi.K) == \
        (rfi.sort_dim, rfi.grid_dims, rfi.cols, rfi.page_size, rfi.K)
    np.testing.assert_array_equal(fi.xs, rfi.xs)
    np.testing.assert_array_equal(fi.cell_starts, rfi.cell_starts)
    assert len(fi.edges) == len(rfi.edges)
    for e, re in zip(fi.edges, rfi.edges):
        np.testing.assert_array_equal(e, re)
    assert fi.index_size_bytes() == rfi.index_size_bytes()
    for l, u in zip(Ls, Us):
        st = fi.query(l, u)
        assert st.result == brute_force_count(data, l, u)
        assert [list(r) for r in fi._cell_ranges(l, u)] == \
            [list(r) for r in rfi._cell_ranges(l, u)]
        assert dataclasses.asdict(st) == dataclasses.asdict(rfi.query(l, u))


@pytest.mark.parametrize("name", ["osm", "stock"])
def test_rtree_exact(name):
    data = make_dataset(name, 5000, seed=9)
    Ls, Us = make_workload(data, 30, seed=9)
    rt = rstar.build_rtree(data, page_bytes=2048, fanout=16)
    rrt = rrstar.build_rtree(data, page_bytes=2048, fanout=16)
    for l, u in zip(Ls, Us):
        st = rt.query(l, u)
        assert st.result == brute_force_count(data, l, u)
        assert dataclasses.asdict(st) == dataclasses.asdict(rrt.query(l, u))
    assert rt.index_size_bytes() == rrt.index_size_bytes()


def test_rtree_structure():
    data = make_dataset("osm", 4000, seed=10)
    rt = rstar.build_rtree(data, page_bytes=1024, fanout=8)
    rrt = rrstar.build_rtree(data, page_bytes=1024, fanout=8)
    np.testing.assert_array_equal(rt.xs, rrt.xs)
    np.testing.assert_array_equal(rt.leaf_starts, rrt.leaf_starts)
    np.testing.assert_array_equal(rt.leaf_mbrs, rrt.leaf_mbrs)
    assert len(rt.levels) == len(rrt.levels)
    for (m, cs), (rm, rcs) in zip(rt.levels, rrt.levels):
        np.testing.assert_array_equal(m, rm)
        np.testing.assert_array_equal(cs, rcs)
    assert rt.leaf_starts[-1] == len(data)
    assert len(rt.levels[-1][0]) <= 8
    mbrs0, cs = rt.levels[0]
    for nd in range(len(mbrs0)):
        ch = rt.leaf_mbrs[cs[nd]:cs[nd + 1]]
        assert np.all(ch[:, :, 0] >= mbrs0[nd, :, 0])
        assert np.all(ch[:, :, 1] <= mbrs0[nd, :, 1])


@pytest.mark.parametrize("d,K", [(2, 4), (2, 16), (3, 10)])
def test_next_jump_in_equals_reference(d, K):
    """BIGMIN on seeded z values and windows, against the reference and
    (at the smallest grid) against brute force over every cell."""
    rng = np.random.default_rng(d * 100 + K)
    for _ in range(12):
        seed = int(rng.integers(0, 2**31))
        theta = random_theta(np.random.default_rng(seed), d, K)
        rtheta = r_random_theta(np.random.default_rng(seed), d, K)
        lo = rng.integers(0, 2**K - 1, size=d)
        hi = np.minimum(lo + rng.integers(0, 2**K, size=d), 2**K - 1)
        qL, qU = lo.astype(np.uint64), hi.astype(np.uint64)
        zs = None
        if d * K <= 8:
            cells = np.stack(np.meshgrid(
                *[np.arange(qL[i], qU[i] + 1) for i in range(d)],
                indexing="ij"), axis=-1).reshape(-1, d).astype(np.uint64)
            zs = np.sort(encode_np(cells, theta))
        for z in rng.integers(0, 2**(K * d), size=16):
            got = fnz.next_jump_in(int(z), qL, qU, theta)
            assert got == rfnz.next_jump_in(int(z), qL, qU, rtheta)
            if zs is not None:
                later = zs[zs >= z]
                assert got == (int(later[0]) if len(later) else None)


@pytest.mark.parametrize("paging", ["fixed", "heuristic", "dp"])
def test_fnz_query_stats_equal_reference(paging):
    """`skipping="fnz"` through `query_count`: exact, and every field of
    `QueryStats` (pages, false positives, index accesses, subqueries)
    equal to the reference's."""
    rng = np.random.default_rng(42)
    d, K = 2, 8
    theta = random_theta(rng, d, K)
    rtheta = r_random_theta(np.random.default_rng(42), d, K)
    data = np.unique(rng.integers(0, 2**K, size=(4000, d), dtype=np.uint64),
                     axis=0)
    Ls, Us = make_workload(data, 40, seed=1, width_scale=0.3, K=K)
    kw = dict(paging=paging, page_bytes=512, fill_factor=0.25,
              skipping="fnz", use_query_split=False)
    idx = LMSFCIndex.build(data, theta=theta, cfg=IndexConfig(**kw),
                           workload=(Ls, Us), K=K)
    ridx = RIndex.build(data, theta=rtheta, cfg=RConfig(**kw),
                        workload=(Ls, Us), K=K)
    np.testing.assert_array_equal(idx.starts, ridx.starts)
    for qL, qU in zip(Ls, Us):
        st = query_count(idx, qL, qU)
        assert st.result == brute_force_count(data, qL, qU)
        assert st.subqueries == 1
        assert dataclasses.asdict(st) == \
            dataclasses.asdict(rq.query_count(ridx, qL, qU))
        assert dataclasses.asdict(fnz.fnz_query(idx, qL, qU)) == \
            dataclasses.asdict(st)


def test_fnz_requires_global_curve():
    rng = np.random.default_rng(10)
    data = make_dataset("osm", 1200, seed=4)
    K = default_K(2)
    idx = LMSFCIndex.build(data, curve=PiecewiseCurve.random(rng, 2, K),
                           cfg=IndexConfig(skipping="fnz"))
    with pytest.raises(TypeError, match="GlobalTheta"):
        tq.query_count(idx, np.zeros(2, np.uint64), np.full(2, 10, np.uint64))
