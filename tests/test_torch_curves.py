"""Port (`repro_torch`) vs reference (`repro`): θ, Z64 words, encodes and
curves.  Every output compared here is an integer (or a float computed by
identical numpy code), so the tolerance is 0: arrays must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import curve as rc
from repro.core import sfc as rsfc
from repro.core import theta as rth
from repro.core import zorder64 as rz
from repro_torch.core import curve as tc
from repro_torch.core import sfc as tsfc
from repro_torch.core import theta as tth
from repro_torch.core import zorder64 as tz

# (d, family, depth): global and piecewise (depth 1 and 2) at d = 2, 3, 4
CURVE_CASES = [(d, fam, dep) for d in (2, 3, 4)
               for fam, dep in (("global", 1), ("piecewise", 1),
                                ("piecewise", 2))]


def _i32(x_u64: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x_u64.astype(np.uint32).view(np.int32))


def _both_curves(d, family, depth, seed, K=None):
    """The reference's random curve and the port's twin from its JSON."""
    K = K or rth.default_K(d)
    ref = rc.random_curve(np.random.default_rng(seed), d, K, family=family,
                          depth=depth)
    return ref, tc.curve_from_json(ref.to_json())


@pytest.mark.parametrize("d", [2, 3, 4])
def test_theta_matches_reference(d):
    K = rth.default_K(d)
    assert tth.default_K(d) == K
    pairs = [(rth.zorder(d, K), tth.zorder(d, K)),
             (rth.major_order(d, K), tth.major_order(d, K)),
             (rth.major_order(d, K, list(reversed(range(d)))),
              tth.major_order(d, K, list(reversed(range(d))))),
             (rth.random_theta(np.random.default_rng(d), d, K),
              tth.random_theta(np.random.default_rng(d), d, K))]
    for a, b in pairs:
        assert a.seq == b.seq
        np.testing.assert_array_equal(a.pos_of_bit, b.pos_of_bit)
        np.testing.assert_array_equal(a.bit_of_pos, b.bit_of_pos)
        np.testing.assert_array_equal(a.features(), b.features())
        assert a.to_json() == b.to_json()
        assert tth.Theta.from_json(a.to_json()) == b
        na = rth.neighbors(a, np.random.default_rng(3), n=4)
        nb = tth.neighbors(b, np.random.default_rng(3), n=4)
        assert [t.seq for t in na] == [t.seq for t in nb]
    with pytest.raises(ValueError):
        tth.Theta(2, 2, (0, 0, 0, 1))


def test_zorder64_twins_match_reference():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(4096, 2), dtype=np.uint64)
    words[:16] = [[0, 0], [0, 2**32 - 1], [2**31, 0], [2**31 - 1, 2**31]] * 4
    a = _i32(words)
    b = _i32(rng.permutation(words))
    b[::7] = a[::7]                          # equal pairs too
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("z64_lt", "z64_le", "z64_eq", "z64_sub", "z64_add"):
        want = np.asarray(getattr(rz, name)(ja, jb))
        got = getattr(tz, name)(ta, tb).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("u32_lt", "u32_le"):
        want = np.asarray(getattr(rz, name)(ja[:, 0], jb[:, 1]))
        got = getattr(tz, name)(ta[:, 0], tb[:, 1]).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tz.u64_to_z64(words), rz.u64_to_z64(words))
    np.testing.assert_array_equal(tz.z64_to_u64(a), rz.z64_to_u64(a))
    np.testing.assert_array_equal(tz.i32_of(tz.u32_of(ta)).numpy(), a)


@pytest.mark.parametrize("d,family,depth", CURVE_CASES)
def test_curve_encodes_match_reference(d, family, depth):
    ref, port = _both_curves(d, family, depth, seed=10 * d + depth)
    assert port.to_json() == ref.to_json()
    K = ref.K
    # the port's own factories draw the same curve from the same seed
    again = tc.random_curve(np.random.default_rng(10 * d + depth), d, K,
                            family=family, depth=depth)
    assert again == port
    rng = np.random.default_rng(d)
    xs = rng.integers(0, 2**K, size=(300, d), dtype=np.uint64)
    z = ref.encode_np(xs)
    np.testing.assert_array_equal(port.encode_np(xs), z)
    np.testing.assert_array_equal(port.decode_np(z), ref.decode_np(z))
    for x in xs[:8]:
        assert port.encode_scalar(x) == ref.encode_scalar(x)
    want = np.asarray(ref.encode_jax(jnp.asarray(_i32(xs))))
    got = port.encode_torch(torch.from_numpy(_i32(xs))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tz.z64_to_u64(got), z)
    np.testing.assert_array_equal(port.features(), ref.features())
    nr = ref.neighbors(np.random.default_rng(1), n=3)
    nt = port.neighbors(np.random.default_rng(1), n=3)
    assert [c.to_json() for c in nt] == [c.to_json() for c in nr]
    assert port.optimal_1split(xs[0] // 2, xs[0]) == \
        ref.optimal_1split(xs[0] // 2, xs[0])


@pytest.mark.parametrize("family,depth", [("global", 1), ("piecewise", 1),
                                          ("piecewise", 2)])
def test_encode_k32_sign_bit(family, depth):
    """d=2, K=32: coordinates reach 2^32-1, so bit 31 of the int32 words
    and bit 63 of the address are live."""
    ref, port = _both_curves(2, family, depth, seed=5, K=32)
    rng = np.random.default_rng(1)
    xs = rng.integers(2**31, 2**32, size=(512, 2), dtype=np.uint64)
    xs[:4] = [[2**32 - 1, 2**32 - 1], [2**31, 0], [0, 2**32 - 1], [0, 0]]
    want = np.asarray(ref.encode_jax(jnp.asarray(_i32(xs))))
    got = port.encode_torch(torch.from_numpy(_i32(xs))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tz.z64_to_u64(got), ref.encode_np(xs))


def test_sfc_module_matches_reference():
    rng = np.random.default_rng(2)
    theta_r = rth.random_theta(rng, 3, 21)
    theta_t = tth.Theta(3, 21, theta_r.seq)
    xs = rng.integers(0, 2**21, size=(200, 3), dtype=np.uint64)
    np.testing.assert_array_equal(tsfc.encode_np_ref(xs, theta_t),
                                  rsfc.encode_np_ref(xs, theta_r))
    np.testing.assert_array_equal(tsfc.encode_np(xs, theta_t),
                                  rsfc.encode_np(xs, theta_r))
    z = rsfc.encode_np(xs, theta_r)
    np.testing.assert_array_equal(tsfc.decode_np(z, theta_t),
                                  rsfc.decode_np(z, theta_r))
    assert tsfc.encode_scalar(xs[0], theta_t) == \
        rsfc.encode_scalar(xs[0], theta_r)
    assert tsfc.is_monotonic_pair(theta_t, xs[0], xs[0] + 1)
    want = np.asarray(rsfc.encode_jax(jnp.asarray(_i32(xs)), theta_r))
    got = tsfc.encode_torch(torch.from_numpy(_i32(xs)), theta_t).numpy()
    np.testing.assert_array_equal(got, want)


def test_pack_curve_pool_and_factories_match_reference():
    curves_r = [rc.random_curve(np.random.default_rng(i), 2, 16)
                for i in range(2)]
    curves_r += [rc.random_curve(np.random.default_rng(9 + i), 2, 16,
                                 family="piecewise", depth=1 + i)
                 for i in range(2)]
    curves_t = [tc.curve_from_json(c.to_json()) for c in curves_r]
    pr, pt = rc.pack_curve_pool(curves_r), tc.pack_curve_pool(curves_t)
    np.testing.assert_array_equal(pt.pos, pr.pos)
    np.testing.assert_array_equal(pt.reg, pr.reg)
    assert (pt.d, pt.K, len(pt)) == (pr.d, pr.K, len(pr))
    for c in curves_t:
        pos, reg = tc.curve_tables(c, "cpu")
        one = rc.pack_curve_pool([rc.curve_from_json(c.to_json())])
        np.testing.assert_array_equal(pos.numpy(), one.pos[0])
        np.testing.assert_array_equal(reg.numpy(), one.reg[0])
    for fam in ("global", "piecewise"):
        assert tc.default_curve(3, 12, fam).to_json() == \
            rc.default_curve(3, 12, fam).to_json()
        assert [c.to_json() for c in tc.init_curves(3, 12, fam)] == \
            [c.to_json() for c in rc.init_curves(3, 12, fam)]
    theta = tth.zorder(2, 8)
    assert tc.as_curve(theta) == tc.GlobalTheta(theta)
    assert tc.as_curve(theta.to_json().replace('{"d"', '{"kind": "global", "d"')) \
        == tc.GlobalTheta(theta)
    with pytest.raises(ValueError):
        tc.curve_from_json('{"kind": "hilbert"}')
    with pytest.raises(TypeError):
        tc.as_curve(3)
