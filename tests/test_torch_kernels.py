"""The port's kernel packages vs the reference's Pallas kernels.

On the CPU the port's wrappers take their plain-torch twins (the tensors
lie on the CPU); those are held against the reference's kernels in
interpret mode and its jnp oracles.  The CUDA kernels themselves run only
on a GPU: tests/test_torch_cuda.py holds them against the twins there.
All outputs are integers: tolerance 0, arrays must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import curve as rc
from repro.core import sfc as rsfc
from repro.core.theta import default_K
from repro.kernels.sfc_encode.ops import sfc_encode as r_sfc_encode
from repro.kernels.sfc_encode.ops import sfc_encode_pool as r_sfc_encode_pool
from repro.kernels.window_filter.ops import window_filter as r_window_filter
from repro.kernels.window_filter.ops import window_match as r_window_match
from repro_torch.core import curve as tc
from repro_torch.core.convert import curve_pool_from_numpy
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.sfc_encode import ops as sfc_ops
from repro_torch.kernels.sfc_encode.ops import sfc_encode, sfc_encode_pool
from repro_torch.kernels.sfc_encode.ref import (encode_lut_torch, lut_tables,
                                                pool_tables,
                                                sfc_encode_pool_ref,
                                                sfc_encode_ref)
from repro_torch.kernels.window_filter.ops import window_filter, window_match
from repro_torch.kernels.window_filter.ref import (window_filter_ref,
                                                   window_match_ref)


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.astype(np.uint32).view(np.int32))


def _filter_inputs(seed, G, d, cap):
    """Unsigned coordinates over the full 32-bit range (sign bit live),
    random rects, and sizes from 0 to past cap."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 2**32, size=(G, d, cap), dtype=np.uint64)
    lo = rng.integers(0, 2**32, size=(G, d), dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 2**31, size=(G, d),
                                      dtype=np.uint64), 2**32 - 1)
    rect = np.stack([lo, hi], axis=-1)
    rect[0] = [0, 2**32 - 1]                     # a rect that holds all
    size = rng.integers(0, cap + 2, size=G).astype(np.int32)
    return _i32(pts), _i32(rect), size


@pytest.mark.parametrize("G,d,cap", [(16, 2, 128), (13, 3, 64), (8, 4, 256)])
def test_window_filter_twins_match_reference(G, d, cap):
    pts, rect, size = _filter_inputs(G + d + cap, G, d, cap)
    jp, jr, js = jnp.asarray(pts), jnp.asarray(rect), jnp.asarray(size)
    want = np.asarray(r_window_filter(jp, jr, js, backend="xla"))
    pallas = np.asarray(r_window_filter(jp, jr, js, backend="pallas",
                                        interpret=True))
    np.testing.assert_array_equal(pallas, want)
    tp, tr, ts = map(torch.from_numpy, (pts, rect, size))
    for got in (window_filter_ref(tp, tr, ts), window_filter(tp, tr, ts),
                window_filter(tp, tr, ts, backend="torch")):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("G,d,cap", [(16, 2, 128), (13, 3, 64)])
def test_window_match_twins_match_reference(G, d, cap):
    pts, rect, size = _filter_inputs(7 * G + d, G, d, cap)
    jp, jr, js = jnp.asarray(pts), jnp.asarray(rect), jnp.asarray(size)
    want = np.asarray(r_window_match(jp, jr, js, backend="xla"))
    pallas = np.asarray(r_window_match(jp, jr, js, backend="pallas",
                                       interpret=True))
    np.testing.assert_array_equal(pallas, want)
    tp, tr, ts = map(torch.from_numpy, (pts, rect, size))
    for got in (window_match_ref(tp, tr, ts), window_match(tp, tr, ts)):
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,family,depth", [(2, "global", 1), (3, "global", 1),
                                            (4, "global", 1),
                                            (2, "piecewise", 1),
                                            (2, "piecewise", 2)])
def test_sfc_encode_twin_matches_reference(d, family, depth):
    K = default_K(d)
    ref_curve = rc.random_curve(np.random.default_rng(d + depth), d, K,
                                family=family, depth=depth)
    curve = tc.curve_from_json(ref_curve.to_json())
    rng = np.random.default_rng(d)
    xs = _i32(rng.integers(0, 2**K, size=(700, d), dtype=np.uint64))
    want = np.asarray(r_sfc_encode(jnp.asarray(xs), ref_curve, backend="xla"))
    pallas = np.asarray(r_sfc_encode(jnp.asarray(xs), ref_curve,
                                     backend="pallas", block_n=256,
                                     interpret=True))
    np.testing.assert_array_equal(pallas, want)
    xt = torch.from_numpy(xs)
    for got in (sfc_encode_ref(xt, curve), sfc_encode(xt, curve),
                sfc_encode(xt, curve, backend="torch")):
        assert got.dtype == torch.int32 and tuple(got.shape) == (700, 2)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,K,family,depth", [
    (2, 32, "global", 1), (2, 32, "piecewise", 1), (2, 32, "piecewise", 2),
    (2, 21, "global", 1), (2, 21, "piecewise", 2), (3, 21, "global", 1),
    (3, 21, "piecewise", 1), (3, 21, "piecewise", 2)])
def test_lut_twin_matches_reference(d, K, family, depth):
    """The CUDA kernel's arithmetic (`lut_tables`, then `encode_lut_torch`)
    against the plain twin and the reference's live encodes (the curve's
    `encode_jax` and the data-driven `encode_z64_dyn` on its packed
    layout), bit for bit.  Coordinates reach 2^K - 1; at K 32 bit 31 of the
    int32 words and bit 63 of the address are live."""
    ref_curve = rc.random_curve(np.random.default_rng(10 * d + K + depth), d,
                                K, family=family, depth=depth)
    curve = tc.curve_from_json(ref_curve.to_json())
    rng = np.random.default_rng(K)
    xs = rng.integers(0, 2**K, size=(600, d), dtype=np.uint64)
    xs[:3] = 2**K - 1
    xs[3] = 0
    xs[4:20, 0] = 2**K - 1 - rng.integers(0, 16, size=16, dtype=np.uint64)
    x = _i32(xs)
    pos, reg = tc.curve_tables(curve, "cpu")
    lut = lut_tables(pos, d, K)
    assert lut.dtype == torch.int64
    assert tuple(lut.shape) == (pos.shape[0], d, -(-K // 4), 16)
    got = encode_lut_torch(torch.from_numpy(x), lut, reg, K).numpy()
    assert got.dtype == np.int32 and got.shape == (600, 2)
    np.testing.assert_array_equal(
        got, sfc_encode_ref(torch.from_numpy(x), curve).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(ref_curve.encode_jax(jnp.asarray(x))))
    rpool = rc.pack_curve_pool([ref_curve])
    np.testing.assert_array_equal(got, np.asarray(rsfc.encode_z64_dyn(
        jnp.asarray(x), jnp.asarray(rpool.pos[0]), jnp.asarray(rpool.reg[0]))))
    np.testing.assert_array_equal(tc.curve_lut(curve, "cpu").numpy(),
                                  lut.numpy())


def _mixed_pool(d, K):
    """The reference's mixed SMBO pool shape (tests/test_kernels.py): three
    global curves and three piecewise curves of depth 1 and 2."""
    curves = [rc.random_curve(np.random.default_rng(i), d, K)
              for i in range(3)]
    curves += [rc.random_curve(np.random.default_rng(40 + i), d, K,
                               family="piecewise", depth=1 + i % 2)
               for i in range(3)]
    return curves


@pytest.mark.parametrize("d,K", [(2, 16), (3, 12), (2, 32)])
def test_sfc_encode_pool_twin_matches_reference(d, K):
    """The pooled twin equals the reference's pooled encode (jnp oracle and
    Pallas in interpret mode) on shared points, fed either the reference's
    packed pool carried across or the port's own curves; with one point
    set per curve, row p equals curve p's single encode."""
    ref_curves = _mixed_pool(d, K)
    curves = [tc.curve_from_json(c.to_json()) for c in ref_curves]
    rng = np.random.default_rng(d * 100 + K)
    xs = _i32(rng.integers(0, 2**K, size=(900, d), dtype=np.uint64))
    xs[:4] = _i32(np.full((4, d), 2**K - 1, dtype=np.uint64))
    want = np.asarray(r_sfc_encode_pool(jnp.asarray(xs), ref_curves,
                                        backend="xla"))
    pallas = np.asarray(r_sfc_encode_pool(jnp.asarray(xs), ref_curves,
                                          backend="pallas", block_n=256,
                                          interpret=True))
    np.testing.assert_array_equal(pallas, want)
    rpool = rc.pack_curve_pool(ref_curves)
    carried = curve_pool_from_numpy(rpool.pos, rpool.reg, d, K)
    xt = torch.from_numpy(xs)
    for got in (sfc_encode_pool(xt, carried), sfc_encode_pool(xt, curves),
                sfc_encode_pool_ref(xt, carried),
                sfc_encode_pool(xt, carried, backend="torch")):
        assert got.dtype == torch.int32 and tuple(got.shape) == (6, 900, 2)
        np.testing.assert_array_equal(got.numpy(), want)
    own = _i32(rng.integers(0, 2**K, size=(6, 333, d), dtype=np.uint64))
    got = sfc_encode_pool(torch.from_numpy(own), carried).numpy()
    for p, c in enumerate(ref_curves):
        np.testing.assert_array_equal(
            got[p], np.asarray(r_sfc_encode(jnp.asarray(own[p]), c,
                                            backend="xla")))
    with pytest.raises(ValueError, match="point sets"):
        sfc_encode_pool(torch.from_numpy(own[:5]), carried)


@pytest.mark.parametrize("d,K", [(2, 16), (3, 12), (2, 32)])
def test_lut_twin_of_a_pool_matches_reference(d, K):
    """A pool's tables in one `lut_tables` call (what the pooled evaluator
    builds once a round) equal each curve's own, and row p's LUT encode
    equals the reference's pooled encode; `pool_tables` uses a pool's own
    tables when it carries them."""
    ref_curves = _mixed_pool(d, K)
    rpool = rc.pack_curve_pool(ref_curves)
    pool = curve_pool_from_numpy(rpool.pos, rpool.reg, d, K)
    rng = np.random.default_rng(d + K)
    xs = _i32(rng.integers(0, 2**K, size=(500, d), dtype=np.uint64))
    xs[:4] = _i32(np.full((4, d), 2**K - 1, dtype=np.uint64))
    want = np.asarray(r_sfc_encode_pool(jnp.asarray(xs), ref_curves,
                                        backend="xla"))
    reg, lut = pool_tables(pool, "cpu")
    assert tuple(lut.shape) == (6, rpool.pos.shape[1], d, -(-K // 4), 16)
    for p, c in enumerate(ref_curves):
        own = tc.curve_lut(tc.curve_from_json(c.to_json()), "cpu")
        np.testing.assert_array_equal(lut[p, :own.shape[0]].numpy(),
                                      own.numpy())
        np.testing.assert_array_equal(encode_lut_torch(
            torch.from_numpy(xs), lut[p], reg[p], K).numpy(), want[p])
    carried = tc.CurvePool(pos=pool.pos, reg=pool.reg, d=d, K=K, lut=lut)
    assert pool_tables(carried, "cpu")[1] is lut


def test_plan_encode_places_tables_by_size():
    """Staged in shared memory when the table fits, else through L1.  Grids
    cover the points at 1,024 a block, capped at what 132 SMs hold at once
    across the pool: 8 blocks an SM, or as many staged blocks as fit."""
    plan = sfc_ops.plan_encode
    g = plan(256, 1, 1, 2, 32, 132)               # a global curve, d 2
    assert (g.placement, g.blocks, g.table_bytes) == ("smem", 1, 2048)
    assert plan(8192, 1, 1, 2, 32, 132).blocks == 8
    assert plan(2**20, 1, 1, 2, 32, 132).blocks == 1024
    assert plan(2**21, 1, 1, 2, 32, 132).blocks == 132 * 8
    # 64 regions at d 3, K 21: 147,456 bytes, one staged block an SM
    pw = plan(2**20, 1, 64, 3, 21, 132)
    assert (pw.placement, pw.blocks, pw.table_bytes) == ("smem", 132, 147456)
    assert plan(384, 1, 64, 3, 21, 132).blocks == 1
    # pools: the SMBO shared-point encodes and a per-candidate call
    assert plan(499808, 8, 1, 2, 32, 132).blocks == 132
    assert plan(50000, 8, 64, 3, 21, 132).blocks == 16
    assert plan(10, 2000, 1, 2, 32, 132).blocks == 1
    # 256 regions at d 4, K 16: 262,144 bytes do not fit
    big = plan(2**20, 8, 256, 4, 16, 132)
    assert (big.placement, big.blocks) == ("l1", 132)
    assert plan(2**21, 1, 256, 4, 16, 132).blocks == 132 * 8
    assert plan(2**22, 1, 512, 3, 21, 132).table_bytes == 1179648
    # the largest table that is staged, and the smallest that is not
    fit = sfc_ops.MAX_STAGED_BYTES // 2048 * 2048
    assert plan(2**20, 1, fit // 2048, 2, 32, 132).placement == "smem"
    assert plan(2**20, 1, fit // 2048 + 1, 2, 32, 132).placement == "l1"


def test_curve_pool_from_numpy_is_the_ports_packing():
    ref_curves = _mixed_pool(3, 12)
    rpool = rc.pack_curve_pool(ref_curves)
    carried = curve_pool_from_numpy(rpool.pos, rpool.reg, 3, 12)
    own = tc.pack_curve_pool([tc.curve_from_json(c.to_json())
                              for c in ref_curves])
    np.testing.assert_array_equal(carried.pos, own.pos)
    np.testing.assert_array_equal(carried.reg, own.reg)
    assert (carried.d, carried.K, len(carried)) == (3, 12, 6)
    with pytest.raises(ValueError, match="bits per region"):
        curve_pool_from_numpy(rpool.pos, rpool.reg, 2, 12)
    with pytest.raises(ValueError, match="need pos"):
        curve_pool_from_numpy(rpool.pos[0], rpool.reg, 3, 12)


def test_wrappers_refuse_unknown_backends_and_devices(monkeypatch):
    """No fallback: a tensor that is not on the CPU is never handed to the
    plain twin.  A meta tensor (shapes only) takes the kernel route, which
    allocates the kernel's outputs there and launches nothing; a tensor
    on any other device than the CPU, a card or meta is refused."""
    import types
    from repro_torch.kernels.sfc_encode import ops as enc_ops
    from repro_torch.kernels.window_filter import ops as wf_ops

    def twin(*a, **k):
        raise AssertionError("handed to the twin")
    for mod, name in ((wf_ops, "window_filter_ref"),
                      (wf_ops, "window_match_ref"),
                      (enc_ops, "sfc_encode_ref"),
                      (enc_ops, "sfc_encode_pool_ref")):
        monkeypatch.setattr(mod, name, twin)
    pts = torch.zeros((2, 2, 8), dtype=torch.int32, device="meta")
    rect = torch.zeros((2, 2, 2), dtype=torch.int32, device="meta")
    size = torch.zeros(2, dtype=torch.int32, device="meta")
    x = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    curve = tc.default_curve(2, 32)
    before = dict(cuda_lib.LAUNCHES)
    for call, shape, dtype in (
            (lambda: window_filter(pts, rect, size), (2,), torch.int32),
            (lambda: window_match(pts, rect, size), (2, 8), torch.bool),
            (lambda: sfc_encode(x, curve), (4, 2), torch.int32),
            (lambda: sfc_encode_pool(x, [curve, curve]), (2, 4, 2),
             torch.int32)):
        out = call()
        assert (out.device.type, tuple(out.shape), out.dtype) == \
            ("meta", shape, dtype)
    assert cuda_lib.LAUNCHES == before
    other = types.SimpleNamespace(device=torch.device("xpu"), dtype=torch.int32,
                                  shape=(2, 2, 8), dim=lambda: 3)
    for call in (lambda: window_filter(other, rect, size),
                 lambda: window_match(other, rect, size),
                 lambda: sfc_encode(other, curve),
                 lambda: sfc_encode_pool(other, [curve, curve])):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    cpu = torch.zeros((2, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="backend"):
        window_filter(cpu, cpu[:, :, :2], cpu[:, 0, 0], backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        sfc_encode(cpu[0], curve, backend="xla")
    with pytest.raises(ValueError, match="backend"):
        sfc_encode_pool(cpu[0], [curve], backend="pallas")


def test_library_path_is_keyed_on_the_sources():
    path = cuda_lib.library_path()
    assert path.parent == cuda_lib.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "repro_torch")
    assert path == cuda_lib.library_path()
    names = {p.name for p in cuda_lib.CSRC.glob("*.cu")}
    assert names == {"window_filter.cu", "sfc_encode.cu",
                     "flash_attention.cu", "flash_attention_tc.cu"}
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
