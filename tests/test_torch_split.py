"""Port vs reference: recursive query splitting and z-ranges.

The port's torch batch (`recursive_split_torch`, `zranges_torch`) is held
against the reference's JAX batch (`recursive_split_jax`, `zranges_jax`)
on the same query rectangles, and the numpy recursion/batch against their
reference twins.  Integer outputs: tolerance 0."""
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


def _queries(seed, Q, d, K):
    """(Q, d, 2) uint64 rects, including dims with qL == qU, dims pinned
    at 0, and (at K = 32) bounds with bit 31 set."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**K, size=(Q, d), dtype=np.uint64)
    b = rng.integers(0, 2**K, size=(Q, d), dtype=np.uint64)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[0, 0] = hi[0, 0]                        # qL == qU
    lo[1, :], hi[1, :] = 0, 0                  # qU == 0 in every dim
    lo[2, -1], hi[2, -1] = 0, 0
    lo[3], hi[3] = 0, 2**K - 1                 # the whole domain
    return np.stack([lo, hi], axis=-1)


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
