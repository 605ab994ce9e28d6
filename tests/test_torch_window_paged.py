"""Port vs reference: the paged window filter and the Count path on it.

`window_filter_paged` reads each query's candidate pages by id from the
index's page array and sums their hits per query.  Its plain twin
(`window_filter_paged_ref`) and the wrapper on CPU tensors (which takes
the twin) are held against the reference's Pallas kernel in interpret
mode, run on the same pages gathered with numpy and summed per query.
Every output is an integer: tolerance 0, arrays must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serve as rsv
from repro.kernels.window_filter.kernel import window_filter_pallas
from repro_torch.core import serve as tsv
from repro_torch.kernels.window_filter.ops import (filter_work_paged,
                                                   window_filter_paged)
from repro_torch.kernels.window_filter.ref import window_filter_paged_ref
from test_torch_serve import _indexes


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.astype(np.uint32).view(np.int32))


def _paged_inputs(seed: int, d: int, cap: int, P: int = 9, Qc: int = 6,
                  C: int = 5):
    """Seeded pages and queries: coordinates over the full uint32 range
    (the sign bit set on about half), sizes from -1 to cap + 2, n_cand 0,
    below C, C and above C, page ids with duplicates in a query and across
    queries, and points on the rectangles' bounds (inclusive)."""
    rng = np.random.default_rng(seed)
    points = rng.integers(0, 2**32, size=(P, d, cap), dtype=np.uint64)
    size = rng.integers(-1, cap + 3, size=P)
    size[:3] = (cap, cap + 2, -1)
    width = 0.5 ** (1.0 / d)       # about half the points inside a rect
    span = np.uint64(int(width * 2**32))
    lo = rng.integers(0, 2**32 - int(span), size=(Qc, d), dtype=np.uint64)
    hi = lo + span
    queries = np.stack([lo, hi], axis=-1)                   # (Qc, d, 2)
    cand = rng.integers(0, P, size=(Qc, C))
    cand[0, 1] = cand[0, 0]                                 # repeated page
    cand[1, :] = cand[0, :]                                 # shared pages
    n_cand = np.array([C, 0, C - 2, C + 3, 1, C][:Qc])
    p = cand[0, 0]
    points[p, :, 0] = lo[0]                                 # on the bounds
    points[p, :, min(1, cap - 1)] = hi[0]
    return (_i32(points), size.astype(np.int32), _i32(queries),
            cand.astype(np.int32), n_cand.astype(np.int64))


def _reference(points, size, queries, cand, n_cand) -> np.ndarray:
    """The reference's Pallas filter (interpret mode) on the gathered
    pages, padded to its block of 8, summed per query."""
    Qc, C = cand.shape
    _, d, cap = points.shape
    live = np.arange(C)[None, :] < np.minimum(n_cand, C)[:, None]
    pts = points[cand].reshape(-1, d, cap)
    sz = np.where(live, size[cand], 0).reshape(-1).astype(np.int32)
    rect = np.repeat(queries[:, None], C, axis=1).reshape(-1, d, 2)
    G = pts.shape[0]
    pad = -G % 8
    pts = np.concatenate([pts, np.zeros((pad, d, cap), np.int32)])
    rect = np.concatenate([rect, np.zeros((pad, d, 2), np.int32)])
    sz = np.concatenate([sz, np.zeros(pad, np.int32)])
    cnt = np.asarray(window_filter_pallas(jnp.asarray(pts), jnp.asarray(rect),
                                          jnp.asarray(sz), interpret=True))
    return cnt[:G].reshape(Qc, C).sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("cap", [1, 682, 1024])
@pytest.mark.parametrize("d", [2, 3, 4, 32])
def test_paged_filter_matches_reference_pallas(d, cap):
    args = _paged_inputs(100 * d + cap, d, cap)
    want = _reference(*args)
    t = tuple(map(torch.from_numpy, args))
    for got in (window_filter_paged_ref(*t),
                window_filter_paged(*t),
                window_filter_paged(*t, backend="torch"),
                window_filter_paged(*t[:4], t[4].to(torch.int32))):
        assert got.dtype == torch.int32 and got.shape == (len(want),)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[1] == 0                # n_cand 0
    assert want.sum() > 0 or cap == 1


def test_paged_filter_edges():
    """No candidates (C 0), no queries, and a query whose candidates are
    all past its n_cand give zeros of the right shape."""
    points, size, queries, cand, n_cand = map(
        torch.from_numpy, _paged_inputs(5, 2, 8))
    assert window_filter_paged(points, size, queries, cand[:, :0],
                               n_cand).tolist() == [0] * len(n_cand)
    assert window_filter_paged(points, size, queries[:0], cand[:0],
                               n_cand[:0]).shape == (0,)
    got = window_filter_paged(points, size, queries, cand,
                              torch.zeros_like(n_cand))
    assert got.tolist() == [0] * len(n_cand)
    with pytest.raises(ValueError):
        window_filter_paged(points, size, queries, cand, n_cand,
                            backend="triton")


def test_filter_work_paged_counts_distinct_pages_at_most():
    """From shapes alone: min(Qc * C, P) whole pages with their sizes, the
    rects, ids, live counts and counts."""
    assert filter_work_paged(100, 2, 3, 2, 16) == (
        6 * (2 * 16 * 4 + 4) + 2 * 2 * 2 * 4 + 6 * 4 + 2 * 8 + 2 * 4)
    assert filter_work_paged(4, 2, 3, 2, 16, 4) == (
        4 * (2 * 16 * 4 + 4) + 2 * 2 * 2 * 4 + 6 * 4 + 2 * 4 + 2 * 4)


@pytest.mark.parametrize("max_cand", [2, 64])
def test_count_path_matches_reference(max_cand):
    """The Count path on the paged filter (torch and cuda backends on CPU
    tensors) equals the reference's Count on the same index, counts and
    overflow flags; max_cand 2 forces overflow."""
    _, (Ls, Us), a, b = _indexes("global", seed=12)
    rects = tsv.pack_query_rects(Ls, Us)
    kw = dict(max_cand=max_cand, q_chunk=8, k_maxsplit=4)
    want = rsv.make_query_fn(a.curve, backend="xla", **kw)(
        rsv.build_serving_arrays(a), jnp.asarray(rects))
    arrays = tsv.build_serving_arrays(b, device="cpu")
    for backend in ("torch", "cuda"):
        got = tsv.make_query_fn(b.curve, backend=backend, **kw)(arrays,
                                                                rects)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[1]).any() == (max_cand == 2)


def test_count_reads_pages_by_id_and_range_still_gathers(monkeypatch):
    """Neither Count nor Range gathers the candidate pages any more (the
    name predates Range's paged match): on the kernel route, run on meta
    tensors (shapes alone, nothing launched), no op indexes the (P, d,
    cap) page array, the twins' `gather_pages` is never called, and each
    chunk is one `window_filter` call (Count) or one `window_match` call
    (Range), the page array read by id."""
    from repro_torch.dist.hlo_analysis import StepCounter
    from repro_torch.kernels.window_filter import ref as wf_ref
    _, (Ls, Us), _, b = _indexes("global", n=3000, seed=13)
    rects = tsv.pack_query_rects(Ls, Us)
    arrays = tsv.build_serving_arrays(b, device="cpu").map(
        lambda t: torch.empty_like(t, device="meta"))
    queries = torch.from_numpy(rects).to("meta")
    calls = []
    gather = wf_ref.gather_pages

    def counted(*args):
        calls.append(args[3].shape)
        return gather(*args)

    monkeypatch.setattr(wf_ref, "gather_pages", counted)
    kw = dict(max_cand=64, q_chunk=8, backend="cuda")
    page_array = list(arrays.points.shape)
    chunks = len(rects) // 8
    for fn, key in ((tsv.make_query_fn(b.curve, **kw), "window_filter"),
                    (tsv.make_range_fn(b.curve, max_hits=4096, **kw),
                     "window_match")):
        with StepCounter(op_log=True) as c:
            fn(arrays, queries)
        assert calls == []
        assert c.kernel_calls[key] == chunks
        reads = [r for r in c.op_log() if page_array in r["shapes"]]
        assert {r["op"] for r in reads} == {f"repro_torch.{key}"}, reads
