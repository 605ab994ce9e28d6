"""The plain reference against a brute NumPy count and row set, and its
lossy control against hand-made windows whose answers it must get wrong."""
import numpy as np
import pytest
import torch

from portbench.gen import synth, workload
from portbench.ref.window import WindowReference, lossy_dtype


def brute(data, lo, hi):
    inside = np.all((data >= lo) & (data <= hi), axis=1)
    rows = data[inside]
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


@pytest.mark.parametrize("name,K", [("osm", 32), ("nyc", 21)])
def test_reference_matches_brute_numpy(name, K):
    data = synth.make_dataset(name, 3_000, 5)
    Ls, Us = workload.make_workload(data, 64, 6, K=K)
    Ls, Us = workload.scale_to_selectivity(data, Ls, Us, 2e-2, K=K)
    # windows whose corners sit on rows: the closed bounds count them
    Ls[:8], Us[:8] = data[:8], data[:8] + np.uint64(3)
    ref = WindowReference(data)
    want = [brute(data, lo, hi) for lo, hi in zip(Ls, Us)]
    assert np.array_equal(ref.count(Ls, Us), [len(w) for w in want])
    assert sum(len(w) for w in want) > 64
    for got, w in zip(ref.rows(Ls, Us), want):
        assert got.dtype == np.uint64 and np.array_equal(got, w)


@pytest.mark.parametrize("K", [32, 21])
def test_lossy_control_breaks_exactness(K):
    base = np.uint64((1 << K) - 4096)
    data = np.array([[base, base], [base + np.uint64(1), base],
                     [base + np.uint64(2), base]], dtype=np.uint64)
    Ls = np.array([[base + np.uint64(1), base]], dtype=np.uint64)
    Us = np.array([[base + np.uint64(1), base]], dtype=np.uint64)
    assert WindowReference(data).count(Ls, Us).tolist() == [1]
    lossy = WindowReference(data, lossy_K=K)
    assert lossy.count(Ls, Us).tolist() != [1]
    assert lossy_dtype(K) == (torch.float32 if K > 24 else torch.bfloat16)
