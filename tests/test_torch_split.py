"""Port vs reference: recursive query splitting and z-ranges.

The port's torch batch (`recursive_split_torch`, `zranges_torch`) and the
split kernel's wrapper (`split_zranges`, whose CPU route is that batch)
are held against the reference's JAX batch (`recursive_split_jax`,
`zranges_jax`) on the same query rectangles, and the numpy
recursion/batch against their reference twins.  Integer outputs:
tolerance 0.  The wrapper's kernel route is held here on ``meta`` tensors
(shapes, refusals, its counted bytes) and against the twin on the card in
`test_torch_split_kernel.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import curve as rc
from repro.core import split as rs
from repro.core.theta import default_K
from repro_torch.core import curve as tc
from repro_torch.core import split as ts
from repro_torch.dist.hlo_analysis import StepCounter
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.sfc_encode import ops as enc_ops
from split_cases import queries as _queries


def _i32(a):
    return np.ascontiguousarray(a.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("d,family,depth,K", [
    (2, "global", 1, 32), (3, "global", 1, None), (4, "global", 1, None),
    (2, "piecewise", 1, 32), (2, "piecewise", 2, None)])
def test_torch_split_matches_reference(d, family, depth, K):
    K = K or default_K(d)
    ref_curve = rc.random_curve(np.random.default_rng(d * 7 + depth), d, K,
                                family=family, depth=depth)
    curve = tc.curve_from_json(ref_curve.to_json())
    q = _i32(_queries(d + depth, 12, d, K))

    def reference(qj):
        rects, valid = rs.recursive_split_jax(qj, ref_curve, 4)
        return (rects, valid) + rs.zranges_jax(rects, ref_curve)

    if family == "global":        # compiling the piecewise chains is slower
        reference = jax.jit(reference)
    rects_r, valid_r, zlo_r, zhi_r = reference(jnp.asarray(q))
    for backend in ("cuda", "torch"):          # both take the twin on CPU
        rects, valid = ts.recursive_split_torch(torch.from_numpy(q), curve,
                                                4, backend=backend)
        np.testing.assert_array_equal(
            rects.numpy(), np.asarray(rects_r).astype(np.int64))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
        zlo, zhi = ts.zranges_torch(rects, curve, backend=backend)
        np.testing.assert_array_equal(zlo.numpy(), np.asarray(zlo_r))
        np.testing.assert_array_equal(zhi.numpy(), np.asarray(zhi_r))
        _assert_leaves(enc_ops.split_zranges(torch.from_numpy(q), curve, 4,
                                             backend=backend),
                       (valid_r, zlo_r, zhi_r))


def _assert_leaves(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [0, 1, 5])
@pytest.mark.parametrize("d,family,depth,K", [
    (2, "global", 1, 32), (3, "piecewise", 2, 21), (4, "global", 1, None)])
def test_split_zranges_matches_reference(d, family, depth, K, k):
    """`split_zranges` on CPU tensors, both backends, equals the
    reference's split and z-ranges at k_maxsplit 0, 1 and 5."""
    K = K or default_K(d)
    ref_curve = rc.random_curve(np.random.default_rng(d * 5 + k), d, K,
                                family=family, depth=depth)
    curve = tc.curve_from_json(ref_curve.to_json())
    q = _i32(_queries(d + k, 6, d, K))

    def reference(qj):
        rects, valid = rs.recursive_split_jax(qj, ref_curve, k)
        return (valid, *rs.zranges_jax(rects, ref_curve))

    if family == "global":        # compiling the piecewise chains is slower
        reference = jax.jit(reference)
    want = reference(jnp.asarray(q))
    for backend in ("cuda", "torch"):          # both take the twin on CPU
        _assert_leaves(enc_ops.split_zranges(torch.from_numpy(q), curve, k,
                                             backend=backend), want)


def _meta_queries(Q, d):
    return torch.zeros((Q, d, 2), dtype=torch.int32, device="meta")


@pytest.mark.parametrize("k", [0, 4, 8])
def test_split_zranges_on_meta_allocates_and_counts(k):
    """On ``meta`` tensors the kernel route allocates the outputs, launches
    nothing, and reports one op with `split_work`'s bytes."""
    curve = tc.default_curve(3, 21, "piecewise", depth=2)
    R, M = 64, 6                               # 4^3 regions, 2 bits a dim
    q = _meta_queries(5, 3)
    before = dict(cuda_lib.LAUNCHES)
    with StepCounter() as c:
        valid, zlo, zhi = enc_ops.split_zranges(q, curve, k)
    assert cuda_lib.LAUNCHES == before
    assert (valid.device.type, tuple(valid.shape), valid.dtype) == \
        ("meta", (5, 2**k), torch.bool)
    for z in (zlo, zhi):
        assert (z.device.type, tuple(z.shape), z.dtype) == \
            ("meta", (5, 2**k, 2), torch.int32)
    assert dict(c.kernel_calls) == {"split_zranges": 1}
    assert c.analyze()["bytes"] == enc_ops.split_work(5, 3, 21, R, M, k)


@pytest.mark.parametrize("case", ["dtype", "rank", "dims", "curve_dims",
                                  "k_above", "k_below", "backend"])
def test_split_zranges_refuses(case):
    """The kernel route raises on what the kernel does not take: a wrong
    dtype or rank, dims other than the curve's, a k_maxsplit outside
    [0, MAX_SPLIT_K], more dims than the kernel holds; and any backend
    but 'cuda' and 'torch'."""
    curve = tc.default_curve(2, 32)
    q = _meta_queries(4, 2)
    call, err = {
        "dtype": (lambda: enc_ops.split_zranges(q.to(torch.int64), curve,
                                                4), TypeError),
        "rank": (lambda: enc_ops.split_zranges(q[:, :, 0], curve, 4),
                 ValueError),
        "dims": (lambda: enc_ops.split_zranges(_meta_queries(4, 3), curve,
                                               4), ValueError),
        "curve_dims": (lambda: enc_ops.split_zranges(
            _meta_queries(4, enc_ops.MAX_SPLIT_D + 1),
            tc.default_curve(enc_ops.MAX_SPLIT_D + 1, 3), 4), ValueError),
        "k_above": (lambda: enc_ops.split_zranges(
            q, curve, enc_ops.MAX_SPLIT_K + 1), ValueError),
        "k_below": (lambda: enc_ops.split_zranges(q, curve, -1),
                    ValueError),
        "backend": (lambda: enc_ops.split_zranges(q, curve, 4,
                                                  backend="xla"),
                    ValueError),
    }[case]
    before = dict(cuda_lib.LAUNCHES)
    with pytest.raises(err):
        call()
    assert cuda_lib.LAUNCHES == before


def test_split_work_and_plan():
    """`split_work`: windows in (Q*d*2 int32), `valid` (1 byte a leaf) and
    both z-ranges (16 bytes a leaf) out, the curve's positions and live
    region bits once; `plan_split`: one leaf a thread, the table staged
    in shared memory up to 227 KB less the static arrays."""
    # osm's global curve (d 2, K 32), 1,024 windows of 16 leaves
    assert enc_ops.split_work(1024, 2, 32, 1, 0, 4) == \
        16_384 + 278_528 + 256
    # nyc's piecewise curve at depth 2 (64 regions, 6 live region bits)
    assert enc_ops.split_work(1024, 3, 21, 64, 6, 4) == \
        24_576 + 278_528 + 16_152
    assert enc_ops.split_work(7, 4, 16, 1, 0, 0) == 224 + 119 + 256
    glob = enc_ops.plan_split(1024, 4, 1, 2, 32, 132)
    assert (glob.placement, glob.blocks, glob.table_bytes) == \
        ("smem", 64, 2048)
    pw = enc_ops.plan_split(4096, 4, 64, 3, 21, 132)
    assert (pw.placement, pw.blocks, pw.table_bytes) == \
        ("smem", 132, 147_456)          # one 147 KB block an SM
    deep = enc_ops.plan_split(4096, 8, 512, 3, 21, 132)
    assert (deep.placement, deep.blocks) == ("l1", 132 * 8)


@pytest.mark.parametrize("family", ["global", "piecewise"])
def test_numpy_splits_match_reference(family):
    d, K = 3, default_K(3)
    ref_curve = rc.random_curve(np.random.default_rng(4), d, K, family=family)
    curve = tc.curve_from_json(ref_curve.to_json())
    rq = _queries(9, 10, d, K)
    Ls, Us = rq[..., 0], rq[..., 1]
    r_rects, r_valid = rs.recursive_split_np_batch(Ls, Us, ref_curve, 3)
    t_rects, t_valid = ts.recursive_split_np_batch(Ls, Us, curve, 3)
    np.testing.assert_array_equal(t_rects, r_rects)
    np.testing.assert_array_equal(t_valid, r_valid)
    for lo, hi in zip(Ls, Us):
        want = rs.recursive_split(lo, hi, ref_curve, 3)
        got = ts.recursive_split(lo, hi, curve, 3)
        assert len(got) == len(want)
        for (a, b), (c, e) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, e)
        assert ts.optimal_1split(lo, hi, curve) == \
            rs.optimal_1split(lo, hi, ref_curve)


def test_msb_is_exact_over_32_bits():
    rng = np.random.default_rng(0)
    v = rng.integers(1, 2**32, size=5000, dtype=np.int64)
    v[:34] = [1, 2, 3, 2**31 - 1, 2**31, 2**32 - 1] + \
        [2**k for k in range(4, 32)]
    got = ts._msb_u32(torch.from_numpy(v)).numpy()
    want = np.array([int(x).bit_length() - 1 for x in v])
    np.testing.assert_array_equal(got, want)
