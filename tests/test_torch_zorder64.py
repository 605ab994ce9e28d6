"""The port's Z64 helpers `z64_max`, `z64_min` and `z64_to_f32` against the
reference's on seeded Z64 pairs: bit for bit (the float32 magnitude too),
with ties and pairs whose words differ in the sign bit only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zorder64 as rz
from repro_torch.core import zorder64 as tz


def _pairs(seed: int, n: int = 4096):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    b = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    b[: n // 8] = a[: n // 8]                                  # ties
    flip = np.uint64(1 << 63)
    b[n // 8: n // 4] = a[n // 8: n // 4] ^ flip               # hi sign bit
    b[n // 4: 3 * n // 8] = a[n // 4: 3 * n // 8] ^ np.uint64(1 << 31)
    b[3 * n // 8: n // 2] = (a[3 * n // 8: n // 2]
                             & np.uint64(0xFFFFFFFF00000000))  # equal hi
    a[-4:] = [0, 2**64 - 1, 2**63, 2**31]
    return tz.u64_to_z64(a), tz.u64_to_z64(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_z64_max_min_equal_reference(seed):
    a, b = _pairs(seed)
    for t_fn, r_fn in ((tz.z64_max, rz.z64_max), (tz.z64_min, rz.z64_min)):
        got = t_fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(r_fn(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    ua, ub = tz.z64_to_u64(a), tz.z64_to_u64(b)
    np.testing.assert_array_equal(
        tz.z64_to_u64(tz.z64_max(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()),
        np.maximum(ua, ub))


@pytest.mark.parametrize("seed", [0, 1])
def test_z64_to_f32_equals_reference(seed):
    a, b = _pairs(seed)
    z = np.concatenate([a, b])
    got = tz.z64_to_f32(torch.from_numpy(z))
    want = np.asarray(rz.z64_to_f32(jnp.asarray(z)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
