"""DP paging above 200k rows (`dp_paging_torch`) against the reference.

The port's `dp_paging_torch` runs `dp_paging_np`'s recurrence on a device
in blocks of `smin` positions.  It is held to `dp_paging_np`'s
boundaries exactly (tolerance 0, the reference's live numpy DP and the
port's copy of it), at d 2 and 3, K 10/21/32, several (smin, smax) and
n on both sides of a multiple of `smin`; `make_paging("dp")` takes it
above 200k rows.  Against the reference's float32 `dp_paging_jax` the
score is held within the reference's own ``rel=1e-5``
(`tests/test_paging_split.py::test_dp_jax_matches_np`)."""
import numpy as np
import pytest
import torch

from repro.core import paging as rp
from repro.core.curve import default_curve as r_default_curve
from repro.data.synth import make_dataset
from repro_torch.core import index as ti
from repro_torch.core import paging as tp


@pytest.fixture(autouse=True)
def _two_threads():
    """The device DP on the CPU is thousands of small torch ops; with one
    torch thread per core in each of the suite's parallel workers, every
    op waits on the other workers' threads.  Two threads a test keep the
    file's time what it is alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sorted_points(seed, n, d, K):
    """`n` distinct points (before dedup) sorted by the z-order key, as
    `tests/test_paging_split.py` makes them."""
    rng = np.random.default_rng(seed)
    xs = np.unique(rng.integers(0, 2**K, size=(n, d), dtype=np.uint64),
                   axis=0)
    z = r_default_curve(d, K).encode_np(xs)
    return xs[np.argsort(z, kind="stable")].astype(np.int64)


def _dataset_sorted(name, n, d, K):
    data = make_dataset(name, n, seed=1)
    z = r_default_curve(d, K).encode_np(data)
    return data[np.argsort(z, kind="stable")].astype(np.int64)


@pytest.mark.parametrize("d,K", [(2, 10), (2, 32), (3, 10), (3, 21)])
@pytest.mark.parametrize("smin,smax", [(8, 32), (5, 17), (16, 64)])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_dp_paging_torch_equals_dp_paging_np(d, K, smin, smax, offset):
    xs = _sorted_points(d * 1000 + K + smin, 3000, d, K)
    xs = xs[:smin * (len(xs) // smin - 2) + offset]   # n = m*smin + offset
    want = rp.dp_paging_np(xs, smin, smax, K)
    np.testing.assert_array_equal(tp.dp_paging_np(xs, smin, smax, K), want)
    got = tp.dp_paging_torch(xs, smin, smax, K, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,d,K,n", [("osm", 2, 32, 12_001),
                                        ("nyc", 3, 21, 9_999)])
def test_dp_paging_torch_at_page_capacity(name, d, K, n):
    """The paper's page capacity (smin, smax) = (256, 1024) at d 2 and
    (170, 682) at d 3, on the generators' clustered data."""
    xs = _dataset_sorted(name, n, d, K)
    smin, smax = rp.page_capacity(d)
    want = rp.dp_paging_np(xs, smin, smax, K)
    got = tp.dp_paging_torch(xs, smin, smax, K, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_dp_paging_torch_small_inputs_and_prefix():
    xs = _sorted_points(5, 40, 2, 10)
    # n <= smax: one page, as the reference
    np.testing.assert_array_equal(
        tp.dp_paging_torch(xs, 8, 64, 10, device="cpu"),
        rp.dp_paging_np(xs, 8, 64, 10))
    # n just above smax: the undersized first page may be chosen
    for smin, smax in ((8, 16), (12, 24), (1, 4)):
        np.testing.assert_array_equal(
            tp.dp_paging_torch(xs, smin, smax, 10, device="cpu"),
            rp.dp_paging_np(xs, smin, smax, 10))


@pytest.fixture(scope="module")
def nyc_210k():
    return _dataset_sorted("nyc", 210_000, 3, 21)


def test_make_paging_dp_above_200k_rows_equals_dp_paging_np(nyc_210k):
    """Above the 200k switch `make_paging("dp")` (and so
    `LMSFCIndex.build(paging="dp")`) takes the device DP; its boundaries
    equal the reference's `dp_paging_np` on the same rows."""
    xs = nyc_210k
    smin, smax = rp.page_capacity(3)
    pg = tp.make_paging(xs, "dp", 21, device="cpu")
    want = rp.dp_paging_np(xs, smin, smax, 21)
    np.testing.assert_array_equal(pg.starts, want)
    np.testing.assert_array_equal(pg.mbrs, rp.compute_mbrs(xs, want))
    s_dp = tp.total_score(xs, pg.starts, 21)
    s_h = tp.total_score(xs, tp.heuristic_paging(xs, smin, smax, 21), 21)
    s_f = tp.total_score(xs, tp.fixed_paging(len(xs), smax), 21)
    # the reference's ordering (tests/test_paging_split.py): the exact DP
    # scores no worse than either; heuristic against fixed is not ordered
    # (the sum over pages favours fewer, fuller pages)
    assert s_dp <= s_h and s_dp <= s_f


def test_index_build_passes_its_device_to_dp_paging(monkeypatch):
    """`LMSFCIndex.build(paging="dp")` above 200k rows resolves its device
    for the DP only: without a card it raises unless ``device="cpu"``,
    while the heuristic build needs no device."""
    data = make_dataset("osm", 200_500, seed=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    heur = ti.LMSFCIndex.build(data, cfg=ti.IndexConfig(paging="heuristic"))
    assert heur.num_pages > 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ti.LMSFCIndex.build(data, cfg=ti.IndexConfig(paging="dp"))
    seen = []
    real = tp.dp_paging_torch

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(tp, "dp_paging_torch", spy)
    idx = ti.LMSFCIndex.build(data, cfg=ti.IndexConfig(paging="dp"),
                              device="cpu")
    assert seen == ["cpu"] and idx.n == len(data)


@pytest.mark.parametrize("seed,n,d,K,smin,smax", [
    (3, 600, 2, 10, 8, 32),        # tests/test_paging_split.py's case
    (0, 3000, 2, 12, 16, 64),
    (1, 2000, 3, 21, 8, 32),
    (2, 2000, 2, 32, 8, 32)])
def test_score_within_reference_tolerance_of_dp_paging_jax(seed, n, d, K,
                                                           smin, smax):
    rng = np.random.default_rng(seed)
    xs = np.unique(rng.integers(0, 2**K, size=(n, d), dtype=np.uint64),
                   axis=0)
    z = r_default_curve(d, K).encode_np(xs)
    xs = xs[np.argsort(z, kind="stable")].astype(np.int64)
    got = tp.dp_paging_torch(xs, smin, smax, K, device="cpu")
    jx = rp.dp_paging_jax(xs, smin, smax, K)
    assert rp.total_score(xs, got, K) == pytest.approx(
        rp.total_score(xs, jx, K), rel=1e-5)
