"""Port vs reference: the paged window match and the Range path on it.

`window_match_paged` reads each query's candidate pages by id from the
index's page array and writes the ids of its matching rows (page * cap +
slot, in candidate then slot order) into a -1 padded (Qc, max_hits)
buffer, with the (Qc,) count of every match.  Its plain twin
(`window_match_paged_ref`) and the wrapper on CPU tensors (which takes the
twin) are held against the reference's Pallas match kernel in interpret
mode, run on the same pages gathered with numpy, followed by the reference
Range path's own compaction (`repro.core.serve.make_range_fn`: a cumsum
over the (Qc, C * cap) mask and a dropping scatter).  Every output is an
integer: tolerance 0, arrays must be equal."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serve as rsv
from repro.kernels.window_filter.kernel import window_match_pallas
from repro_torch.core import serve as tsv
from repro_torch.dist.hlo_analysis import StepCounter
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.window_filter.ops import (match_work_paged,
                                                   window_match_paged)
from repro_torch.kernels.window_filter.ref import window_match_paged_ref
from test_torch_serve import _indexes
from test_torch_window_paged import _paged_inputs


def _compact_like_reference(mask, gid, max_hits: int):
    """The reference Range chunk's compaction (src/repro/core/serve.py,
    `make_range_fn._chunk`), on its own arrays."""
    Qc = mask.shape[0]
    hpos = jnp.cumsum(mask, axis=1) - 1
    n_hits = hpos[:, -1] + 1
    out = jnp.full((Qc, max_hits), -1, jnp.int32)
    hq = jnp.broadcast_to(jnp.arange(Qc)[:, None], mask.shape)
    okh = mask & (hpos < max_hits)
    out = out.at[jnp.where(okh, hq, Qc), jnp.where(okh, hpos, 0)
                 ].set(gid, mode="drop")
    return np.asarray(out), np.asarray(n_hits)


@functools.lru_cache(maxsize=None)
def _reference_mask(d: int, cap: int) -> np.ndarray:
    """The reference's Pallas match (interpret mode) on the gathered pages
    of `_paged_inputs`, padded to its block of 8: (Qc, C * cap) bool."""
    points, size, queries, cand, n_cand = _paged_inputs(100 * d + cap, d,
                                                        cap)
    Qc, C = cand.shape
    live = np.arange(C)[None, :] < np.minimum(n_cand, C)[:, None]
    pts = points[cand].reshape(-1, d, cap)
    sz = np.where(live, size[cand], 0).reshape(-1).astype(np.int32)
    rect = np.repeat(queries[:, None], C, axis=1).reshape(-1, d, 2)
    G = pts.shape[0]
    pad = -G % 8
    pts = np.concatenate([pts, np.zeros((pad, d, cap), np.int32)])
    rect = np.concatenate([rect, np.zeros((pad, d, 2), np.int32)])
    sz = np.concatenate([sz, np.zeros(pad, np.int32)])
    m = np.asarray(window_match_pallas(jnp.asarray(pts), jnp.asarray(rect),
                                       jnp.asarray(sz), interpret=True))
    return m[:G].reshape(Qc, C * cap).astype(bool)


@pytest.mark.parametrize("max_hits", [1, 4, 4096])
@pytest.mark.parametrize("cap", [1, 682, 1024])
@pytest.mark.parametrize("d", [2, 3, 4, 32])
def test_paged_match_matches_reference_pallas(d, cap, max_hits):
    """n_cand 0, below, at and above C; a page repeated in a query and the
    same pages in two queries; max_hits 1 and 4 truncate."""
    args = _paged_inputs(100 * d + cap, d, cap)
    cand = args[3]
    mask = _reference_mask(d, cap)
    gid = (cand[:, :, None] * cap
           + np.arange(cap, dtype=np.int32)).reshape(len(cand), -1)
    want_ids, want_n = _compact_like_reference(jnp.asarray(mask),
                                               jnp.asarray(gid), max_hits)
    t = tuple(map(torch.from_numpy, args))
    for ids, n_hits in (window_match_paged_ref(*t, max_hits),
                        window_match_paged(*t, max_hits),
                        window_match_paged(*t, max_hits, backend="torch"),
                        window_match_paged(*t[:4], t[4].to(torch.int32),
                                           max_hits)):
        assert ids.dtype == torch.int32 and n_hits.dtype == torch.int64
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_array_equal(n_hits.numpy(), want_n)
    assert want_n[1] == 0                       # n_cand 0
    # queries 0 and 1 share their pages, but query 1 has no live one
    assert (want_ids[1] == -1).all()
    if cap > 1:
        assert want_n.max() > 4                 # max_hits 1, 4 truncate


def test_paged_match_edges():
    """No candidates (C 0), no queries, max_hits 0, every candidate past
    n_cand; an unknown backend and ids past int32 raise."""
    points, size, queries, cand, n_cand = map(
        torch.from_numpy, _paged_inputs(5, 2, 8))
    Qc = len(n_cand)
    ids, n = window_match_paged(points, size, queries, cand[:, :0], n_cand,
                                3)
    assert ids.tolist() == [[-1] * 3] * Qc and n.tolist() == [0] * Qc
    ids, n = window_match_paged(points, size, queries[:0], cand[:0],
                                n_cand[:0], 3)
    assert ids.shape == (0, 3) and n.shape == (0,)
    ids, n = window_match_paged(points, size, queries, cand, n_cand, 0)
    assert ids.shape == (Qc, 0)
    np.testing.assert_array_equal(
        n.numpy(), window_match_paged_ref(points, size, queries, cand,
                                          n_cand, 4)[1].numpy())
    ids, n = window_match_paged(points, size, queries, cand,
                                torch.zeros_like(n_cand), 2)
    assert ids.tolist() == [[-1, -1]] * Qc and n.tolist() == [0] * Qc
    with pytest.raises(ValueError, match="backend"):
        window_match_paged(points, size, queries, cand, n_cand, 2,
                           backend="triton")
    big = torch.empty((2**21, 2, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        window_match_paged(big, size, queries, cand, n_cand, 2)


def test_paged_match_on_meta_allocates_and_counts_one_op():
    """The kernel route on meta tensors: outputs of the right shapes, no
    launch, one op of `match_work_paged`'s bytes; 12 candidate ids name at
    most the 10 pages.  A tensor on another device is refused."""
    import types
    P, d, cap, Qc, C, H = 10, 2, 16, 3, 4, 7
    meta = lambda *shape, dtype=torch.int32: torch.empty(
        shape, dtype=dtype, device="meta")
    before = dict(cuda_lib.LAUNCHES)
    with StepCounter() as c:
        ids, n_hits = window_match_paged(
            meta(P, d, cap), meta(P), meta(Qc, d, 2), meta(Qc, C),
            meta(Qc, dtype=torch.int64), H)
    assert cuda_lib.LAUNCHES == before
    assert (ids.shape, ids.dtype) == ((Qc, H), torch.int32)
    assert (n_hits.shape, n_hits.dtype) == ((Qc,), torch.int64)
    assert dict(c.kernel_calls) == {"window_match": 1}
    want = match_work_paged(P, Qc, C, d, cap, H)
    assert want == (P * (d * cap * 4 + 4) + Qc * d * 2 * 4 + Qc * C * 4
                    + Qc * 8 + Qc * H * 4 + Qc * 8)
    assert c.analyze()["bytes"] == float(want)
    assert match_work_paged(100, 2, 3, 2, 16, 5, 4) == (
        6 * (2 * 16 * 4 + 4) + 2 * 2 * 2 * 4 + 6 * 4 + 2 * 4 + 2 * 5 * 4
        + 2 * 8)
    other = types.SimpleNamespace(device=torch.device("xpu"),
                                  dtype=torch.int32, shape=(P, d, cap),
                                  dim=lambda: 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        window_match_paged(other, meta(P), meta(Qc, d, 2), meta(Qc, C),
                           meta(Qc, dtype=torch.int64), H)


@pytest.mark.parametrize("family,max_cand,max_hits", [
    ("global", 1, 4096), ("global", 2, 4), ("global", 64, 4096),
    ("piecewise", 1, 64), ("piecewise", 2, 4096), ("piecewise", 64, 16)])
def test_range_path_matches_reference(family, max_cand, max_hits):
    """Range through the paged match (torch and cuda backends on CPU
    tensors) equals the reference's Range (`backend="xla"`) on the same
    index: ids, n_hits, cand_over and hit_over bit for bit; max_cand 1
    and 2 force candidate overflow, small max_hits hit overflow."""
    _, (Ls, Us), a, b = _indexes(family, n=3000, seed=21)
    rects = tsv.pack_query_rects(Ls, Us)
    kw = dict(max_cand=max_cand, q_chunk=8, k_maxsplit=4)
    want = rsv.make_range_fn(a.curve, max_hits=max_hits, backend="xla",
                             **kw)(rsv.build_serving_arrays(a),
                                   jnp.asarray(rects))
    arrays = tsv.build_serving_arrays(b, device="cpu")
    for backend in ("torch", "cuda"):
        got = tsv.make_range_fn(b.curve, max_hits=max_hits, backend=backend,
                                **kw)(arrays, rects)
        for g, w, name in zip(got, want, ("ids", "n_hits", "cand_over",
                                          "hit_over")):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{backend}: {name}")
    if max_cand < 64:
        assert np.asarray(want[2]).any()
    if max_hits <= 16:
        assert np.asarray(want[3]).any()
