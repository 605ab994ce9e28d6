"""The frozen generators repeat per seed, draw what the program's own
generators draw, and give every seed the same amount of work."""
import numpy as np
import pytest
import torch

from portbench.gen import synth, workload

N = 200_000
QS = (0.05, 0.25, 0.5, 0.75, 0.95)


def quantiles(rows):
    """Column quantiles less the median, over the interquartile range: the
    grid's offset and scale (set by each sample's extremes) drop out."""
    q = np.quantile(rows.astype(np.float64), QS, axis=0)
    return (q - q[2]) / (q[3] - q[1])


@pytest.mark.parametrize("name", sorted(synth.DATASETS))
def test_dataset_repeats_per_seed(name):
    a = synth.make_dataset(name, 5_000, 2**31 + 11)
    b = synth.make_dataset(name, 5_000, 2**31 + 11)
    c = synth.make_dataset(name, 5_000, 2**31 + 12)
    assert a.dtype == np.uint64
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(a, np.unique(a, axis=0))


@pytest.mark.parametrize("name,seed", [("osm", 5), ("nyc", 1),
                                       ("stock", 2)])
def test_dataset_has_the_originals_distribution(name, seed):
    from repro_torch.data import synth as original
    got = synth.make_dataset(name, N, 77, layout_seed=seed)
    want = original.make_dataset(name, N, seed)
    assert abs(len(got) - len(want)) < 0.001 * N
    assert np.allclose(quantiles(got), quantiles(want), atol=0.05)


def test_osm_layout_is_the_originals_and_seeds_share_it():
    rng = np.random.default_rng(5)         # the original's first draws
    centers = rng.uniform(0, 1, size=(64, 2))
    weights = rng.pareto(1.2, 64) + 0.05
    sizes = rng.multinomial(int(N * 0.9), weights / weights.sum())
    got_c, got_s, sigmas = synth.osm_layout(N, 5)
    assert np.array_equal(got_c, centers) and np.array_equal(got_s, sizes)
    assert ((0.002 <= sigmas) & (sigmas <= 0.03)).all()
    a = synth.make_dataset("osm", N, 1, layout_seed=5)
    b = synth.make_dataset("osm", N, 2, layout_seed=5)
    assert abs(len(a) - len(b)) < 0.0005 * N
    assert np.allclose(quantiles(a), quantiles(b), atol=0.01)


@pytest.mark.parametrize("d,K", [(2, 32), (3, 21), (4, 16), (3, 32)])
def test_unique_rows_is_numpys_unique(d, K):
    g = torch.Generator().manual_seed(d)
    x = torch.randint(0, 8, (500, d), generator=g) << (K - 3)
    got = synth.unique_rows(x, K).numpy().astype(np.uint64)
    assert np.array_equal(got, np.unique(x.numpy().astype(np.uint64),
                                         axis=0))


@pytest.mark.parametrize("name", sorted(synth.DATASETS))
def test_grid_is_the_deployments_not_the_seeds(name):
    """Rows of two seeds sit on the grid of the layout seed's rows: their
    column quantiles, in grid units and not normalised, agree; the
    reference rows are the layout seed's own."""
    dep = synth.Deployment(name, N, layout_seed=3)
    a, b = dep.rows_of(1), dep.rows_of(2)
    top = 2.0**dep.K - 1
    qa = np.quantile(a.astype(np.float64), QS, axis=0) / top
    qb = np.quantile(b.astype(np.float64), QS, axis=0) / top
    assert np.abs(qa - qb).max() < 2e-3
    assert np.array_equal(dep.rows.numpy().astype(np.uint64),
                          dep.rows_of(3))
    assert a.max() <= top


def test_windows_repeat_per_seed_and_match_the_original():
    from repro_torch.data import workload as original
    data = synth.make_dataset("osm", 5_000, 7)
    a = workload.make_workload(data, 256, 2**31 + 5, K=32)
    b = workload.make_workload(data, 256, 2**31 + 5, K=32)
    want = original.make_workload(data, 256, seed=2**31 + 5, K=32)
    for x, y, z in zip(a, b, want):
        assert np.array_equal(x, y) and np.array_equal(x, z)
    got = workload.scale_to_selectivity(data, *a, 1e-3, K=32)
    ref = original.scale_to_selectivity(data, *a, 1e-3, K=32)
    for x, y in zip(got, ref):
        assert np.array_equal(x, y)


def test_more_probes_hit_the_target_selectivity():
    data = synth.make_dataset("osm", 20_000, 3)
    Ls, Us = workload.make_workload(data, 512, 4, K=32)
    Ls, Us = workload.scale_to_selectivity(data, Ls, Us, 1e-2, K=32,
                                           probes=512)
    inside = [np.all((data >= lo) & (data <= hi), axis=1).mean()
              for lo, hi in zip(Ls, Us)]
    assert 0.5e-2 < np.mean(inside) < 2e-2
