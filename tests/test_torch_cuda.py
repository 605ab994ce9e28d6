"""The port's CUDA kernels on the card, held against their plain-torch
twins (the twins are held against the reference in the other
tests/test_torch_*.py files).  Every test here needs an NVIDIA GPU and
`nvcc`; without them each one skips.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The index kernels' outputs are integers: tolerance 0, tensors must be
equal.  Flash attention is held at the reference's bars for its kernel
against its oracle: atol = rtol = 2e-5 in float32, 2e-2 in bfloat16.  The
bf16 tensor-core kernel is also held against `flash_tc_ref`, which rounds
where it rounds (P as two bf16 parts, scale after the product), at
atol = rtol = 1e-2: what is left is float32 summation order and exp2's
last bits, which can flip one bf16 rounding of an output (at most 2^-7
of it) or of a probability.  The float32 kernel is also held against
`flash_tf32x3_ref`, which takes the same three TF32 products, at
atol = rtol = 1e-5: what is left is the order in which the tensor cores
and the twin sum them."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch, reduced_config
from repro_torch.core import curve as tc
from repro_torch.core import serve as tsv
from repro_torch.core.cost import evaluate_pool
from repro_torch.core.index import IndexConfig, LMSFCIndex
from repro_torch.core.theta import default_K
from repro_torch.data.synth import make_dataset
from repro_torch.data.workload import make_workload
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ops import KERNELS, flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_tc_ref,
                                                     flash_tf32x3_ref,
                                                     mha_ref)
from repro_torch.kernels.sfc_encode import ops as sfc_ops
from repro_torch.kernels.sfc_encode.ops import sfc_encode, sfc_encode_pool
from repro_torch.kernels.sfc_encode.ref import (lut_tables,
                                                sfc_encode_pool_ref,
                                                sfc_encode_ref)
from repro_torch.kernels.window_filter.ops import (window_filter,
                                                   window_filter_paged,
                                                   window_match,
                                                   window_match_paged)
from repro_torch.kernels.window_filter.ref import (window_filter_paged_ref,
                                                   window_filter_ref,
                                                   window_match_paged_ref,
                                                   window_match_ref)
from repro_torch.models.transformer import init_decode_state, init_model
from repro_torch.train.steps import make_decode_step, make_prefill_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("G,d,cap", [(1024, 2, 1024), (37, 3, 682),
                                     (5, 4, 1)])
def test_window_kernels_match_twins(cuda_device, G, d, cap):
    rng = np.random.default_rng(G + d)
    pts = _i32(rng.integers(0, 2**32, size=(G, d, cap), dtype=np.uint64))
    lo = rng.integers(0, 2**32, size=(G, d), dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 2**31, size=(G, d),
                                      dtype=np.uint64), 2**32 - 1)
    rect = _i32(np.stack([lo, hi], axis=-1))
    size = rng.integers(-1, cap + 2, size=G).astype(np.int32)
    cpu = tuple(map(torch.from_numpy, (pts, rect, size)))
    dev = tuple(t.to(cuda_device) for t in cpu)
    before = dict(cuda_lib.LAUNCHES)
    got_c = window_filter(*dev)
    got_m = window_match(*dev)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["window_filter"] == before["window_filter"] + 1
    assert cuda_lib.LAUNCHES["window_match"] == before["window_match"] + 1
    assert torch.equal(got_c.cpu(), window_filter_ref(*cpu))
    assert torch.equal(got_m.cpu(), window_match_ref(*cpu))


@pytest.mark.parametrize("Qc,C,d,cap,P,shift", [
    (16, 256, 2, 1024, 2048, 0),    # the Count path's chunk
    (37, 64, 3, 682, 300, 1),       # rows 4 bytes off 16: aligned-down copies
    (5, 6, 4, 1, 9, 0),             # cap 1
    (8, 16, 32, 1024, 64, 0),       # d 32: the general body, 69 KB a block
    (9, 7, 5, 100, 20, 1),          # d 5: the general body
])
def test_paged_window_filter_matches_twin(cuda_device, Qc, C, d, cap, P,
                                          shift):
    """The paged kernel against its twin: sizes -1..cap + 2, n_cand 0,
    below, at and above C, repeated ids, sign bits; `shift` starts the
    points one word into their buffer, so no row is 16-byte aligned."""
    rng = np.random.default_rng(Qc * C + d)
    flat = _i32(rng.integers(0, 2**32, size=P * d * cap + shift,
                             dtype=np.uint64))
    points = torch.from_numpy(flat)[shift:].view(P, d, cap)
    size = torch.from_numpy(rng.integers(-1, cap + 3, size=P)
                            .astype(np.int32))
    span = int(0.5 ** (1 / d) * 2**32)
    lo = rng.integers(0, 2**32 - span, size=(Qc, d), dtype=np.uint64)
    queries = torch.from_numpy(_i32(np.stack([lo, lo + span], axis=-1)))
    cand = rng.integers(0, P, size=(Qc, C))
    cand[0, 1:] = cand[0, 0]
    cand = torch.from_numpy(cand.astype(np.int32))
    n_cand = torch.from_numpy(rng.integers(0, C + 4, size=Qc))
    n_cand[:3] = torch.tensor([0, C, C + 5])
    cpu = (points, size, queries, cand, n_cand)
    dev = tuple(t.to(cuda_device) for t in cpu)
    if shift:
        flat_dev = torch.from_numpy(flat).to(cuda_device)
        dev = (flat_dev[shift:].view(P, d, cap),) + dev[1:]
        assert dev[0].data_ptr() % 16 == 4
    want = window_filter_paged_ref(*cpu)
    before = cuda_lib.LAUNCHES["window_filter"]
    got = window_filter_paged(*dev)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["window_filter"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert want[0] == 0 and (want.sum() > 0 or cap == 1)
    got = window_filter_paged(*dev[:4], dev[4].to(torch.int32))
    assert torch.equal(got.cpu(), want)
    assert cuda_lib.LAUNCHES["window_filter"] == before + 2


def test_paged_window_filter_stops_on_a_live_id_outside_the_pages(
        cuda_device):
    """An id past n_cand is never read, whatever it holds; a live id
    outside [0, P) (P itself, or -1) stops the kernel, and the error
    reaches the caller at the next sync, as torch's index assert does.  The
    fault leaves the CUDA context unusable, so it runs in a child
    process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = r'''
import sys
import torch
from repro_torch.kernels.window_filter.ops import window_filter_paged
from repro_torch.kernels.window_filter.ref import window_filter_paged_ref
g = torch.Generator().manual_seed(5)
P, d, cap, Qc, C = 40, 2, 1024, 4, 8
points = torch.randint(-2**31, 2**31, (P, d, cap), generator=g,
                       dtype=torch.int64).to(torch.int32)
size = torch.randint(0, cap + 1, (P,), generator=g, dtype=torch.int32)
queries = torch.tensor([[[0, -1]] * d] * Qc, dtype=torch.int32)
cand = torch.randint(0, P, (Qc, C), generator=g, dtype=torch.int32)
n_cand = torch.tensor([C, 3, 0, C + 2])
want = window_filter_paged_ref(points, size, queries, cand, n_cand)
dead = cand.clone()
dead[1, 3:] = P
dead[2, :] = -1
dev = lambda *ts: [t.cuda() for t in ts]
got = window_filter_paged(*dev(points, size, queries, dead, n_cand))
assert torch.equal(got.cpu(), want), (got, want)
assert int(want[0]) == int(size[cand[0].long()].sum())
bad = cand.clone()
bad[int(sys.argv[1]), 1] = int(sys.argv[2])
try:
    window_filter_paged(*dev(points, size, queries, bad, n_cand))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", str(e).splitlines()[0])
'''
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    for q, page in ((0, 40), (3, -1)):
        proc = subprocess.run([sys.executable, "-c", code, str(q),
                               str(page)], cwd=root, capture_output=True,
                              text=True, timeout=600, env=env)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert "RAISED" in proc.stdout, proc.stdout


def _paged_card_inputs(rng, Qc, C, d, cap, P, shift, dev):
    """Seeded paged inputs on the host and on the card: sizes -1..cap + 2,
    n_cand 0, at and above C and random, query 0's ids all one page and
    query 1's the same as query 0's; `shift` starts the points one word
    into their buffer, so no row is 16-byte aligned."""
    flat = _i32(rng.integers(0, 2**32, size=P * d * cap + shift,
                             dtype=np.uint64))
    points = torch.from_numpy(flat)[shift:].view(P, d, cap)
    size = torch.from_numpy(rng.integers(-1, cap + 3, size=P)
                            .astype(np.int32))
    span = int(0.5 ** (1 / d) * 2**32)
    lo = rng.integers(0, 2**32 - span, size=(Qc, d), dtype=np.uint64)
    queries = torch.from_numpy(_i32(np.stack([lo, lo + span], axis=-1)))
    cand = rng.integers(0, P, size=(Qc, C))
    cand[0, 1:] = cand[0, 0]
    cand[1] = cand[0]
    cand = torch.from_numpy(cand.astype(np.int32))
    n_cand = torch.from_numpy(rng.integers(0, C + 4, size=Qc))
    n_cand[:3] = torch.tensor([C, 0, C + 5])
    cpu = (points, size, queries, cand, n_cand)
    on_card = tuple(t.to(dev) for t in cpu)
    if shift:
        flat_dev = torch.from_numpy(flat).to(dev)
        on_card = (flat_dev[shift:].view(P, d, cap),) + on_card[1:]
        assert on_card[0].data_ptr() % 16 == 4
    return cpu, on_card


@pytest.mark.parametrize("Qc,C,d,cap,P,shift,max_hits", [
    (16, 256, 2, 1024, 2048, 0, 65536),  # the Range path's chunk
    (16, 256, 2, 1024, 2048, 0, 4),      # truncated at max_hits
    (37, 64, 3, 682, 300, 1, 1000),      # rows 4 bytes off 16
    (5, 6, 4, 1, 9, 0, 1),               # cap 1, max_hits 1
    (8, 16, 32, 1024, 64, 0, 4097),      # d 32: tiles of 128 slots
    (9, 7, 5, 100, 20, 1, 3),            # d 5: the general body
    (3, 300, 2, 64, 50, 0, 99),          # C above 256: two scan rounds
])
def test_paged_window_match_matches_twin(cuda_device, Qc, C, d, cap, P,
                                         shift, max_hits):
    """`window_match_paged` against its twin, ids and n_hits bit for bit,
    two launches a call; an int32 n_cand gives the same."""
    rng = np.random.default_rng(Qc * C + d + max_hits)
    cpu, dev = _paged_card_inputs(rng, Qc, C, d, cap, P, shift, cuda_device)
    want = window_match_paged_ref(*cpu, max_hits)
    before = cuda_lib.LAUNCHES["window_match"]
    got = window_match_paged(*dev, max_hits)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["window_match"] == before + 2
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    assert want[1][1] == 0 and (want[1].sum() > 0 or cap == 1)
    got = window_match_paged(*dev[:4], dev[4].to(torch.int32), max_hits)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    # no candidates: the id pass alone
    got = window_match_paged(*dev[:3], dev[3][:, :0], dev[4], max_hits)
    assert cuda_lib.LAUNCHES["window_match"] == before + 5
    assert (got[0] == -1).all() and (got[1] == 0).all()


def test_paged_window_match_stops_on_a_live_id_outside_the_pages(
        cuda_device):
    """As the paged filter: an id past n_cand is never read; a live id of
    P or -1 stops the kernel, and the error reaches the caller at the next
    sync.  The fault leaves the CUDA context unusable, so it runs in a
    child process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = r'''
import sys
import torch
from repro_torch.kernels.window_filter.ops import window_match_paged
from repro_torch.kernels.window_filter.ref import window_match_paged_ref
g = torch.Generator().manual_seed(5)
P, d, cap, Qc, C = 40, 2, 1024, 4, 8
points = torch.randint(-2**31, 2**31, (P, d, cap), generator=g,
                       dtype=torch.int64).to(torch.int32)
size = torch.randint(0, cap + 1, (P,), generator=g, dtype=torch.int32)
queries = torch.tensor([[[0, -1]] * d] * Qc, dtype=torch.int32)
cand = torch.randint(0, P, (Qc, C), generator=g, dtype=torch.int32)
n_cand = torch.tensor([C, 3, 0, C + 2])
want = window_match_paged_ref(points, size, queries, cand, n_cand, 9000)
dead = cand.clone()
dead[1, 3:] = P
dead[2, :] = -1
dev = lambda *ts: [t.cuda() for t in ts]
got = window_match_paged(*dev(points, size, queries, dead, n_cand), 9000)
assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
assert int(want[1][0]) == int(size[cand[0].long()].sum())
bad = cand.clone()
bad[int(sys.argv[1]), 1] = int(sys.argv[2])
try:
    window_match_paged(*dev(points, size, queries, bad, n_cand), 9000)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", str(e).splitlines()[0])
'''
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    for q, page in ((0, 40), (3, -1)):
        proc = subprocess.run([sys.executable, "-c", code, str(q),
                               str(page)], cwd=root, capture_output=True,
                              text=True, timeout=600, env=env)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert "RAISED" in proc.stdout, proc.stdout


def test_range_on_the_cuda_engine_launches_window_match_twice_a_chunk(
        cuda_device, monkeypatch):
    """Range through `Database`'s `cuda` engine: each chunk calls
    `window_match_paged` once, which launches twice (hit words, ids), and
    the rows equal the `torch` engine's."""
    from repro_torch import api

    data = make_dataset("osm", 20000, seed=3)
    Ls, Us = make_workload(data, 40, seed=4, width_scale=0.05)
    db = api.Database.fit(data, K=32, learn=False,
                          cfg=IndexConfig(page_bytes=2048))
    knobs = dict(q_chunk=8, max_cand=64, max_hits=4096)
    db.engine("torch", api.EngineConfig(**knobs))
    db.engine("cuda", api.EngineConfig(**knobs))
    calls = []
    paged = tsv.window_match_paged

    def counted(*a, **kw):
        calls.append(a[3].shape)
        return paged(*a, **kw)

    monkeypatch.setattr(tsv, "window_match_paged", counted)
    cuda_lib.reset_launches()
    got = db.query(api.Range(Ls, Us), engine="cuda")
    launches = dict(cuda_lib.LAUNCHES)
    assert calls and all(c[0] == 8 for c in calls)
    assert launches["window_match"] == 2 * len(calls)
    want = db.query(api.Range(Ls, Us), engine="torch")
    for f in ("rows", "offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.exact and got.engine == "cuda" and got.cpu_fallbacks == 0


@pytest.mark.parametrize("d,family,depth", [(2, "global", 1),
                                            (2, "piecewise", 2),
                                            (3, "piecewise", 2),
                                            (4, "piecewise", 2)])
def test_sfc_encode_kernel_matches_twin(cuda_device, d, family, depth):
    """(4, piecewise, 2) has 256 regions: its 524,288-byte lookup table is
    read through L1 instead of shared memory."""
    K = 32 if d == 2 else default_K(d)
    curve = tc.random_curve(np.random.default_rng(3), d, K, family=family,
                            depth=depth)
    xs = _i32(np.random.default_rng(4).integers(0, 2**K, size=(5000, d),
                                                dtype=np.uint64))
    before = cuda_lib.LAUNCHES["sfc_encode"]
    got = sfc_encode(torch.from_numpy(xs).to(cuda_device), curve)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["sfc_encode"] == before + 1
    assert torch.equal(got.cpu(), sfc_encode_ref(torch.from_numpy(xs), curve))


@pytest.mark.parametrize("d,K,family,depth,n,placement", [
    (2, 32, "global", 1, 300, "smem"),  # sign bit; one 8-byte load a point
    (2, 32, "piecewise", 2, 70001, "smem"),
    (3, 21, "piecewise", 2, 5000, "smem"),    # 64 regions: 147,456 bytes
    (4, 16, "piecewise", 1, 4097, "smem"),
    (5, 12, "global", 1, 1000, "smem"),   # any d: coordinates one by one
    (2, 32, "piecewise", 4, 70001, "l1"),     # 256 regions: 524,288 bytes
    (3, 21, "piecewise", 3, 5000, "l1"),      # 512 regions: 1,179,648
    (4, 16, "piecewise", 2, 4097, "l1"),      # 256 regions: 524,288
    (5, 12, "piecewise", 2, 1000, "l1"),      # 1,024 regions: 1,966,080
])
def test_sfc_encode_kernel_matches_twin_in_both_placements(
        cuda_device, d, K, family, depth, n, placement):
    """The lookup tables staged in shared memory (up to 227 KB) and read
    through L1 (larger ones) give the twin's words bit for bit, in every
    compiled (d, C) and the general one; at d 2 a point set that starts 4
    bytes off an 8-byte boundary takes the kernel's one-by-one loads."""
    curve = tc.random_curve(np.random.default_rng(d + depth), d, K,
                            family=family, depth=depth)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    R = curve.num_regions if family == "piecewise" else 1
    assert sfc_ops.plan_encode(n, 1, R, d, K, sms).placement == placement
    xs = np.random.default_rng(n).integers(0, 2**K, size=(n, d),
                                           dtype=np.uint64)
    xs[:5] = 2**K - 1
    x = torch.from_numpy(_i32(xs))
    before = cuda_lib.LAUNCHES["sfc_encode"]
    got = sfc_encode(x.to(cuda_device), curve)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["sfc_encode"] == before + 1
    assert torch.equal(got.cpu(), sfc_encode_ref(x, curve))
    if d == 2:
        flat = x.reshape(-1).to(cuda_device)
        off = flat[1:1 + 2 * (n - 1)].view(n - 1, 2)
        assert off.data_ptr() % 8 == 4
        want = sfc_encode_ref(x.reshape(-1)[1:1 + 2 * (n - 1)].view(n - 1, 2),
                              curve)
        assert torch.equal(sfc_encode(off, curve).cpu(), want)


@pytest.mark.parametrize("depth,placement", [(2, "smem"), (3, "l1")])
def test_sfc_encode_pool_kernel_matches_twin_in_both_placements(
        cuda_device, depth, placement):
    """A d 3 pool of piecewise curves and global ones, points shared and
    per candidate, its tables carried: at depth 2 its 147,456-byte tables
    are staged, at depth 3 its 1,179,648-byte ones read through L1."""
    d, K = 3, 21
    curves = [tc.random_curve(np.random.default_rng(20 + i), d, K,
                              family="piecewise" if i % 3 else "global",
                              depth=depth) for i in range(5)]
    pool = tc.pack_curve_pool(curves)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert sfc_ops.plan_encode(20000, 5, pool.pos.shape[1], d, K,
                               sms).placement == placement
    pos = torch.from_numpy(pool.pos).to(cuda_device)
    carried = tc.CurvePool(pos=pos, reg=torch.from_numpy(pool.reg).to(
        cuda_device), d=d, K=K, lut=lut_tables(pos, d, K))
    rng = np.random.default_rng(5)
    for shape in ((20000, d), (5, 3001, d)):
        x = torch.from_numpy(_i32(rng.integers(0, 2**K, size=shape,
                                               dtype=np.uint64)))
        want = sfc_encode_pool_ref(x, pool)
        for p in (pool, carried):
            got = sfc_encode_pool(x.to(cuda_device), p)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)


def test_sfc_encode_pool_of_more_curves_than_resident_blocks(cuda_device):
    """More curves than SMs x 8: every curve still gets one block."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    P = sms * 8 + 37
    curves = [tc.random_curve(np.random.default_rng(i), 2, 32)
              for i in range(P)]
    pool = tc.pack_curve_pool(curves)
    rng = np.random.default_rng(6)
    for shape in ((300, 2), (P, 70, 2)):
        x = torch.from_numpy(_i32(rng.integers(0, 2**32, size=shape,
                                               dtype=np.uint64)))
        got = sfc_encode_pool(x.to(cuda_device), pool)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), sfc_encode_pool_ref(x, pool))


def test_sfc_encode_wrappers_reject_tables_the_kernel_does_not_take(
        cuda_device):
    d, K = 2, 32
    curves = [tc.random_curve(np.random.default_rng(i), d, K,
                              family="piecewise") for i in range(3)]
    pool = tc.pack_curve_pool(curves)
    pos = torch.from_numpy(pool.pos).to(cuda_device)
    reg = torch.from_numpy(pool.reg).to(cuda_device)
    lut = lut_tables(pos, d, K)
    x = torch.zeros((64, d), dtype=torch.int32, device=cuda_device)
    flat = torch.zeros(lut.numel() + 1, dtype=torch.int64, device=cuda_device)
    for bad, err in ((lut[..., :-1, :], ValueError),        # wrong C
                     (lut[1:], ValueError),                  # wrong P
                     (lut.int(), TypeError),
                     (lut.transpose(3, 4), ValueError),      # not contiguous
                     (flat[1:].view(lut.shape), ValueError)):  # 8 B off
        with pytest.raises(err):
            sfc_encode_pool(x, tc.CurvePool(pos=pos, reg=reg, d=d, K=K,
                                            lut=bad))
    wide = torch.zeros((3, 31), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="reg"):
        sfc_encode_pool(x, tc.CurvePool(pos=pos, reg=wide, d=d, K=K,
                                        lut=lut))
    with pytest.raises(ValueError, match="dims"):
        sfc_encode(torch.zeros((8, 3), dtype=torch.int32,
                               device=cuda_device), curves[0])


@pytest.mark.parametrize("family", ["global", "piecewise"])
def test_served_batches_match_host_twins(cuda_device, family):
    """Count and Range through the kernels on the card equal the plain
    twins on the host, including forced overflow."""
    data = make_dataset("osm", 20000, seed=1)
    curve = tc.random_curve(np.random.default_rng(2), 2, 32, family=family)
    idx = LMSFCIndex.build(data, curve=curve,
                           cfg=IndexConfig(page_bytes=2048))
    Ls, Us = make_workload(data, 32, seed=0, width_scale=0.1)
    rects = tsv.pack_query_rects(Ls, Us)
    on_card = tsv.build_serving_arrays(idx)
    on_host = tsv.build_serving_arrays(idx, device="cpu")
    for max_cand, max_hits in ((64, 4096), (1, 4)):
        kw = dict(max_cand=max_cand, q_chunk=8)
        for fn in (tsv.make_query_fn(curve, **kw),
                   tsv.make_range_fn(curve, max_hits=max_hits, **kw)):
            got = fn(on_card, rects)
            want = fn(on_host, rects)
            for g, w in zip(got, want):
                assert g.device.type == "cuda"
                assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("d,depths", [(2, (0, 0, 1, 2)), (3, (2, 0, 1)),
                                      (4, (2, 1, 0))])
def test_sfc_encode_pool_kernel_matches_twin(cuda_device, d, depths):
    """A pool mixing global curves (depth 0) with piecewise ones of other
    depths, points shared (stride 0) and per candidate.  At d = 4 a
    depth-2 curve has 256 regions: the 64 KB table is read from global
    memory instead of shared memory."""
    K = 32 if d == 2 else default_K(d)
    curves = [tc.random_curve(np.random.default_rng(10 + i), d, K,
                              family="piecewise" if dp else "global",
                              depth=max(dp, 1))
              for i, dp in enumerate(depths)]
    pool = tc.pack_curve_pool(curves)
    rng = np.random.default_rng(d)
    shared = _i32(rng.integers(0, 2**K, size=(3001, d), dtype=np.uint64))
    own = _i32(rng.integers(0, 2**K, size=(len(curves), 777, d),
                            dtype=np.uint64))
    for xs in (shared, own):
        x = torch.from_numpy(xs)
        before = cuda_lib.LAUNCHES["sfc_encode_pool"]
        got = sfc_encode_pool(x.to(cuda_device), pool)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["sfc_encode_pool"] == before + 1
        want = sfc_encode_pool_ref(x, pool)
        assert torch.equal(got.cpu(), want)
        for p, c in enumerate(curves):
            assert torch.equal(want[p], sfc_encode_ref(
                x if x.dim() == 2 else x[p], c))


@pytest.mark.parametrize("family,depth", [("global", 1), ("piecewise", 2)])
def test_evaluate_pool_on_card_matches_host(cuda_device, family, depth):
    """The pooled program on the card (kernel and twin) equals the same
    program on the host, and the numpy loop."""
    data = make_dataset("osm", 4000, seed=3)
    Ls, Us = make_workload(data, 24, seed=1, width_scale=0.05)
    cfg = IndexConfig(paging="heuristic", page_bytes=1024)
    curves = [tc.random_curve(np.random.default_rng(i), 2, 32, family=family,
                              depth=depth) for i in range(5)]
    before = cuda_lib.LAUNCHES["sfc_encode_pool"]
    got = evaluate_pool(curves, data, Ls, Us, cfg, engine="torch")
    # the keys, one a split level (k = 4), one for the z-ranges
    assert cuda_lib.LAUNCHES["sfc_encode_pool"] == before + 6
    twin = evaluate_pool(curves, data, Ls, Us, cfg, engine="torch",
                         backend="torch")
    host = evaluate_pool(curves, data, Ls, Us, cfg, engine="torch",
                         device="cpu")
    loop = evaluate_pool(curves, data, Ls, Us, cfg, engine="np",
                         device="cpu")
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(twin, host)
    np.testing.assert_array_equal(loop, host)


@pytest.mark.parametrize("B,H,KH,S,dh,dtype,causal,window", [
    (1, 4, 1, 256, 128, torch.float32, True, 0),
    (1, 4, 1, 256, 128, torch.float32, False, 0),
    (1, 4, 1, 256, 128, torch.bfloat16, True, 0),
    (1, 4, 1, 256, 128, torch.bfloat16, False, 0),
    (1, 2, 2, 512, 64, torch.float32, True, 64),
    (1, 2, 2, 512, 64, torch.float32, True, 192),
    (2, 4, 4, 128, 32, torch.float32, True, 0),
    (2, 8, 2, 200, 32, torch.bfloat16, True, 48),
    (1, 4, 2, 1, 64, torch.float32, True, 0),
    (3, 6, 3, 129, 64, torch.bfloat16, False, 0),
    (1, 8, 2, 2048, 128, torch.float32, True, 0),
    (1, 8, 2, 1000, 128, torch.float32, True, 0),
    (1, 2, 2, 512, 64, torch.float32, True, 100),
])
def test_flash_attention_kernel_matches_twin(cuda_device, B, H, KH, S, dh,
                                             dtype, causal, window):
    """MHA, GQA and MQA; causal, full and windowed; S = 1, 129, 200 and
    1,000 take the ragged last tile, window 100 starts inside a kv tile.
    float32 is also held against `flash_tf32x3_ref` at 1e-5: the kernel's
    three TF32 products summed in the tensor cores' order against the
    twin's."""
    g = torch.Generator(device=cuda_device).manual_seed(B * 100 + S)
    q, k, v = (torch.randn(B, h, S, dh, generator=g, device=cuda_device)
               .to(dtype) for h in (H, KH, KH))
    before = cuda_lib.LAUNCHES[KERNELS[dtype]]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[KERNELS[dtype]] == before + 1
    want = mha_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.float32:
        torch.testing.assert_close(
            got, flash_tf32x3_ref(q, k, v, causal=causal, window=window),
            atol=1e-5, rtol=1e-5)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    q = torch.zeros(1, 4, 64, 128, device=cuda_device)
    k = torch.zeros(1, 3, 64, 128, device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)                       # H % KH != 0
    with pytest.raises(ValueError):
        odd = torch.zeros(1, 4, 64, 96, device=cuda_device)
        flash_attention(odd, odd, odd)                 # dh = 96
    with pytest.raises(TypeError):
        h = q.half()
        flash_attention(h, h, h)
    with pytest.raises(ValueError):
        wide = torch.zeros(1, 4, 64, 256, device=cuda_device,
                           dtype=torch.bfloat16)
        t = wide[..., ::2]
        flash_attention(t, t, t)                       # strided last dim
    with pytest.raises(ValueError):
        flat = torch.zeros(1 + 4 * 64 * 128, device=cuda_device,
                           dtype=torch.bfloat16)
        t = flat[1:].view(1, 4, 64, 128)
        flash_attention(t, t, t)                       # base not aligned


def _bf16_inputs(dev, B, H, KH, S, dh, seed, strided=False):
    """Seeded bf16 q, k, v as (B, H, S, dh); `strided`: views of
    (B, S, heads, dh) tensors, as the model passes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        return tuple(torch.randn(B, S, h, dh, generator=g, device=dev)
                     .bfloat16().transpose(1, 2) for h in (H, KH, KH))
    return tuple(torch.randn(B, h, S, dh, generator=g, device=dev)
                 .bfloat16() for h in (H, KH, KH))


@pytest.mark.parametrize("B,H,KH,S,dh,causal,window,strided", [
    (1, 2, 2, 512, 64, True, 64, False),     # windows
    (1, 2, 2, 512, 64, True, 192, False),
    (2, 4, 4, 256, 32, True, 0, False),      # dh 32, 64, 128
    (1, 4, 2, 256, 64, False, 0, False),
    (1, 4, 1, 256, 128, True, 0, False),     # MQA
    (1, 4, 2, 1, 128, True, 0, False),       # S = 1, 129, 200, 1000
    (3, 6, 3, 129, 64, False, 0, False),
    (2, 8, 2, 200, 32, True, 48, False),
    (1, 8, 2, 1000, 128, True, 0, False),    # GQA
    (2, 32, 8, 384, 128, True, 0, True),     # the model's strided views
    (1, 4, 2, 200, 64, True, 0, True),
])
def test_flash_tc_kernel_matches_twins(cuda_device, B, H, KH, S, dh, causal,
                                       window, strided):
    """The bf16 tensor-core kernel against `mha_ref` at the reference's
    bar and against `flash_tc_ref` at 1e-2; one launch of its own counter,
    none of the float32 kernel's; o keeps q's strides."""
    q, k, v = _bf16_inputs(cuda_device, B, H, KH, S, dh, B * 1000 + S,
                           strided)
    before = dict(cuda_lib.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention_tc"] == (
        before["flash_attention_tc"] + 1)
    assert cuda_lib.LAUNCHES["flash_attention"] == before["flash_attention"]
    assert got.dtype == torch.bfloat16 and got.stride() == q.stride()
    kw = dict(causal=causal, window=window)
    torch.testing.assert_close(got.float(), mha_ref(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(),
                               flash_tc_ref(q, k, v, **kw).float(),
                               atol=1e-2, rtol=1e-2)


def test_reduced_qwen3_serves_through_kernel_like_torch_backend(cuda_device):
    """A reduced qwen3-4b prefill plus 4 greedy decode steps, the flash
    kernel against the torch backend on the card: logits at the
    reference's bf16 bar (atol 0.15, rtol 0.1), and one kernel launch per
    layer per prefill.  Both runs decode the kernel run's greedy tokens."""
    cfg = reduced_config(get_arch("qwen3-4b"))
    params = init_model(cfg, seed=0)
    B, S, steps = 2, 96, 4
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    out, greedy = {}, []
    for backend in ("cuda", "torch"):
        prefill = make_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"),
                                    backend=backend)
        decode = make_decode_step(cfg, ShapeConfig("d", S + steps, B,
                                                   "decode"))
        before = cuda_lib.LAUNCHES["flash_attention_tc"]
        last, caches = prefill(params, {"tokens": toks})
        launched = cuda_lib.LAUNCHES["flash_attention_tc"] - before
        assert launched == (cfg.n_layers if backend == "cuda" else 0)
        state = init_decode_state(cfg, S + steps, B)
        for kv in ("k", "v"):
            state[kv][:, :, :, :S] = caches[kv]
        logits = [last[:, 0]]
        for i in range(steps):
            if backend == "cuda":
                greedy.append(logits[-1].argmax(-1))
            lg, state = decode(params, {"tokens": greedy[i][:, None],
                                        "cur_len": S + i}, state)
            logits.append(lg[:, 0])
        out[backend] = torch.stack(logits, 1).float().cpu()
    torch.testing.assert_close(out["cuda"], out["torch"], atol=0.15,
                               rtol=0.1)
    assert torch.isfinite(out["cuda"]).all()


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "seamless-m4t-medium"])
def test_reduced_family_prefill_through_kernel_like_torch_backend(
        cuda_device, name):
    """A reduced MoE and a reduced enc-dec prefill on the card: one bf16
    flash launch a self-attention (enc-dec: the encoder's, non-causal,
    and the decoder's; cross-attention runs the plain walk) and nothing
    else, none on the torch backend; last logits at the reference's bf16
    bar (atol 0.15, rtol 0.1), and the enc-dec caches at 0.1."""
    cfg = reduced_config(get_arch(name))
    params = init_model(cfg, seed=0)
    B, S = 2, 96
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    want = cfg.n_layers
    if cfg.family == "encdec":
        batch["enc_embeds"] = (torch.randn(B, S // cfg.enc_seq_div,
                                           cfg.d_model, generator=g)
                               * 0.02).bfloat16()
        want += cfg.enc_layers
    out = {}
    for backend in ("cuda", "torch"):
        prefill = make_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"),
                                    backend=backend)
        before = dict(cuda_lib.LAUNCHES)
        last, caches = prefill(params, batch)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()}
        n = want if backend == "cuda" else 0
        assert launched["flash_attention_tc"] == n
        assert sum(launched.values()) == n
        assert last.device.type == "cuda"
        assert torch.isfinite(last.float()).all()
        out[backend] = (last.float().cpu(), caches)
    torch.testing.assert_close(out["cuda"][0], out["torch"][0], atol=0.15,
                               rtol=0.1)
    if cfg.family == "encdec":
        assert set(out["cuda"][1]) == {"k", "v", "cross_k", "cross_v"}
        assert out["cuda"][1]["cross_k"].shape[3] == S // cfg.enc_seq_div
        for k, t in out["cuda"][1].items():
            torch.testing.assert_close(t.float(), out["torch"][1][k].float(),
                                       atol=0.1, rtol=0.1)


def test_database_serves_through_the_cuda_engine(cuda_device):
    """`Database` on the card: `fit` learns on the device program (the
    pooled encode launched), the `cuda` engine serves Count, Range, Point
    and kNN through the window and encode kernels, and every output equals
    the `torch` engine's on the same card and the `cpu` engine's, forced
    escalation and an update included; no query of the `cuda` engine
    falls back to the CPU, and a Database with no engine attached and no
    ``device=`` serves on `cuda`."""
    from repro_torch import api

    data = make_dataset("osm", 20000, seed=3)
    Ls, Us = make_workload(data, 100, seed=4, width_scale=0.05)
    cuda_lib.reset_launches()
    db = api.Database.fit(data, (Ls, Us), K=32, sample=5000,
                          smbo={"max_iters": 1, "evals_per_iter": 4},
                          cfg=IndexConfig(page_bytes=2048))
    assert cuda_lib.LAUNCHES["sfc_encode_pool"] > 0
    knobs = dict(q_chunk=8, max_cand=4, max_hits=64)
    db.engine("torch", api.EngineConfig(**knobs))
    db.engine("cuda", api.EngineConfig(**knobs))
    assert db.engines["cuda"].device.type == "cuda"
    queries = [api.Count(Ls, Us), api.Range(Ls, Us),
               api.Point(np.concatenate([data[::1000],
                                         [[1, 2], [3, 4]]]).astype(np.uint64)),
               api.Knn(data[:5], k=7), api.Knn(data[5:9], k=3,
                                                metric="linf")]
    db.insert(np.asarray([[5, 6], [7, 8]], dtype=np.uint64))
    db.delete(data[17])
    cuda_lib.reset_launches()
    got = [db.query(q, engine="cuda") for q in queries]
    for name in ("window_filter", "window_match", "split_zranges"):
        assert cuda_lib.LAUNCHES[name] > 0, name
    assert got[0].escalations > 0
    for engine in ("torch", "cpu"):
        for g, w in zip(got, [db.query(q, engine=engine) for q in queries]):
            for f in ("counts", "rows", "offsets", "found", "neighbors",
                      "dists"):
                if hasattr(w, f):
                    np.testing.assert_array_equal(getattr(g, f),
                                                  getattr(w, f))
    for g in got:
        assert g.exact and g.engine == "cuda" and g.cpu_fallbacks == 0
    fresh = api.Database(db.index)          # no engine attached, no device
    assert fresh.default_engine == "cuda"
    res = fresh.query(queries[0])
    assert res.engine == "cuda"
    np.testing.assert_array_equal(res.counts, got[0].counts)


def _same_fields(got, want):
    for f in ("counts", "rows", "offsets", "found", "neighbors", "dists",
              "overflowed", "residual_overflow"):
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


def test_store_engine_serves_through_the_cuda_kernels(cuda_device,
                                                      tmp_path):
    """`Database.from_segment(...).engine("store")` on the card: the
    default backend is the kernels, every kind launches them, and every
    output equals the `store` engine on the plain twins on the same card
    and the memmap-backed `cpu` engine — cold, warm, and at a budget
    small enough to force evictions and bypass, with resident bytes never
    above the budget."""
    from repro_torch import api
    from repro_torch.data.synth import iter_chunks
    from repro_torch.store import build_segment

    path = str(tmp_path / "seg")
    build_segment(iter_chunks(60_000, 7_000, seed=5, d=2), path,
                  page_rows=128)
    db = api.Database.from_segment(path)
    rows = np.asarray(db.segment.xs[::997])
    Ls, Us = make_workload(np.asarray(db.segment.xs), 64, seed=6,
                           width_scale=0.02, K=db.index.K)
    queries = [api.Count(Ls, Us), api.Range(Ls, Us),
               api.Point(np.concatenate([rows, rows ^ np.uint64(1)])),
               api.Knn(rows[:6], k=5), api.Knn(rows[6:9], k=4,
                                                metric="linf")]
    seg = db.segment
    block = seg.group_nbytes(16)
    want = {e: [db.query(q, engine=e) for q in queries]
            for e in ("cpu",)}
    db.engine("store", api.EngineConfig(q_chunk=8, group_pages=16,
                                        backend="torch"))
    before = dict(cuda_lib.LAUNCHES)
    want["torch"] = [db.query(q) for q in queries]
    assert cuda_lib.LAUNCHES == before      # the twins launch nothing
    for budget in (256 << 20, 3 * block):
        db.engine("store", api.EngineConfig(q_chunk=8, group_pages=16,
                                            cache_bytes=budget))
        eng = db.engines["store"]
        assert eng.backend == "cuda" and eng.device.type == "cuda"
        for _ in ("cold", "warm"):
            cuda_lib.reset_launches()
            got = [db.query(q) for q in queries]
            for name in ("window_filter", "window_match", "split_zranges"):
                assert cuda_lib.LAUNCHES[name] > 0, name
            for g in got:
                assert g.engine == "store" and g.cpu_fallbacks == 0
            for ref in want.values():
                for g, w in zip(got, ref):
                    _same_fields(g, w)
            assert eng.cache.resident_bytes <= budget
        st = eng.cache.stats
        assert st.hits > 0 and st.hits + st.misses == st.lookups
        if budget < 256 << 20:
            assert st.evictions > 0 and st.bypass > 0


def test_server_on_the_card_equals_serial_replay(cuda_device):
    """`Database.serve(engine="cuda")`: the drain thread launches the
    kernels, and every served result equals serial replay on the `cuda`
    engine and on the `torch` engine of the same card."""
    from repro_torch import api, serving

    data = make_dataset("osm", 30_000, seed=7)
    db = api.Database.fit(data, K=32, learn=False,
                          cfg=IndexConfig(page_bytes=2048))
    db.engine("torch", api.EngineConfig(q_chunk=8))
    db.engine("cuda", api.EngineConfig(q_chunk=8))
    spec = serving.LoadSpec(rate_qps=400.0, duration_s=0.5, n_clients=20,
                            knn_k=4, seed=8)
    log = serving.make_query_log(data, spec, K=32)
    cuda_lib.reset_launches()
    srv = db.serve(slo=serving.SLOConfig(window_init_ms=2.0), engine="cuda")
    try:
        point = serving.run_open_loop(srv, log)
    finally:
        srv.close(timeout=60)
    assert not srv._thread.is_alive()
    for name in ("window_filter", "window_match", "split_zranges"):
        assert cuda_lib.LAUNCHES[name] > 0, name
    assert point["completed"] == point["admitted"] and point["failed"] == 0
    for engine in ("cuda", "torch"):
        oracle = serving.replay_serial(db, srv.query_log(), engine=engine)
        for seq, res in point["results"].items():
            serving.assert_bit_identical(res, oracle[seq], f"seq{seq}")


def test_kernel_library_binds_once_when_two_threads_launch_first(
        cuda_device):
    """In a process that has not loaded the kernel library yet, two
    servers' drain threads launch at once: the library is loaded and
    bound once, and both serve results equal to the `torch` engine's."""
    import subprocess
    import sys
    from pathlib import Path

    code = r'''
import ctypes, threading
import numpy as np
from repro_torch import api, serving
from repro_torch.core.index import IndexConfig
from repro_torch.data.synth import make_dataset
from repro_torch.data.workload import make_workload
from repro_torch.kernels import cuda_lib

cuda_lib.build()                       # the build itself is not the race
loads = []
real = ctypes.CDLL
def counting(name, *a, **kw):
    if "librepro_torch" in str(name):
        loads.append(threading.current_thread().name)
    return real(name, *a, **kw)
cuda_lib.ctypes.CDLL = counting
data = make_dataset("osm", 20_000, seed=9)
Ls, Us = make_workload(data, 32, seed=10, width_scale=0.03, K=32)
dbs = [api.Database.fit(data, K=32, learn=False,
                        cfg=IndexConfig(page_bytes=2048)) for _ in range(2)]
for db in dbs:
    db.engine("cuda", api.EngineConfig(q_chunk=8))
    db.engines["cuda"].sync()          # pack and upload before the race
    db.engine("torch", api.EngineConfig(q_chunk=8))
assert cuda_lib._lib is None
srvs = [db.serve(engine="cuda") for db in dbs]
tickets = [[s.submit(api.Count(Ls[i:i + 1], Us[i:i + 1])) for i in range(32)]
           for s in srvs]
for s in srvs:
    s.close(timeout=120)
assert len(loads) == 1, loads
for db, ts in zip(dbs, tickets):
    want = db.query(api.Count(Ls, Us), engine="torch").counts
    got = np.concatenate([t.result(timeout=60).counts for t in ts])
    assert np.array_equal(got, want)
print("OK", loads)
'''
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout


def test_distributed_engine_serves_through_the_kernels_on_every_shard(
        cuda_device):
    """The `distributed` engine on the card — the default mesh (every
    visible card) and four shards on one card — launches the window and
    encode kernels on every shard, and its counts, found flags and
    overflow flags equal the `cuda` engine's, forced escalation and an
    update included; backend 'cuda', named or by default, on a mesh
    holding the CPU raises."""
    from repro_torch import api

    data = make_dataset("osm", 30_000, seed=11)
    Ls, Us = make_workload(data, 64, seed=12, width_scale=0.03, K=32)
    db = api.Database.fit(data, K=32, learn=False,
                          cfg=IndexConfig(page_bytes=2048))
    db.engine("cuda", api.EngineConfig(q_chunk=8, max_cand=4))
    probes = np.concatenate([data[::3000], [[1, 2], [3, 4]]]).astype(
        np.uint64)
    for step, mesh in enumerate((None, ["cuda:0"] * 4)):
        if step:
            db.insert(np.asarray([[5, 6], [7, 8]], dtype=np.uint64))
            db.delete(data[17])
        db.engine("distributed", api.EngineConfig(mesh=mesh, q_chunk=8,
                                                  max_cand=4))
        eng = db.engines["distributed"]
        assert eng.backend == "cuda" and len(eng.mesh) == (
            torch.cuda.device_count() if mesh is None else 4)
        cuda_lib.reset_launches()
        got = [db.query(api.Count(Ls, Us)), db.query(api.Point(probes))]
        for name in ("window_filter", "split_zranges"):
            assert cuda_lib.LAUNCHES[name] > 0, name
        want = [db.query(api.Count(Ls, Us), engine="cuda"),
                db.query(api.Point(probes), engine="cuda")]
        for g, w in zip(got, want):
            assert g.engine == "distributed" and g.exact
            assert g.cpu_fallbacks == 0
            for f in ("counts", "found"):
                if hasattr(w, f):
                    np.testing.assert_array_equal(getattr(g, f),
                                                  getattr(w, f))
        assert got[0].escalations > 0
        if len(eng.mesh) == 1:
            np.testing.assert_array_equal(got[0].overflowed,
                                          want[0].overflowed)
    for backend in ("cuda", None):
        with pytest.raises(ValueError, match="CUDA kernels"):
            db.engine("distributed", api.EngineConfig(
                mesh=["cuda:0", "cpu"], backend=backend))


def test_router_shards_serve_through_the_cuda_engine(cuda_device):
    """A Router whose shards serve on the `cuda` engine: every kind
    launches the kernels and equals an unsharded Database on the host
    (kNN tie-breaks included), and its server equals serial replay; a
    shard on the CPU refuses the `cuda` engine."""
    from repro_torch import api, serving

    data = make_dataset("osm", 30_000, seed=13)
    Ls, Us = make_workload(data, 32, seed=14, width_scale=0.03, K=32)
    cfg = IndexConfig(page_bytes=2048)
    router = api.Router.build(data, 3, K=32, learn=False, cfg=cfg)
    router.engine("cuda", api.EngineConfig(q_chunk=8))
    oracle = api.Database.fit(data, K=32, learn=False, cfg=cfg,
                              device="cpu")
    queries = [api.Count(Ls, Us), api.Range(Ls, Us),
               api.Point(np.concatenate([data[::997], [[1, 2]]]).astype(
                   np.uint64)),
               api.Knn(data[:5], k=7), api.Knn(data[5:9], k=3,
                                                metric="linf")]
    cuda_lib.reset_launches()
    got = [router.query(q) for q in queries]
    for name in ("window_filter", "window_match", "split_zranges"):
        assert cuda_lib.LAUNCHES[name] > 0, name
    for g, q in zip(got, queries):
        assert g.engine == "router[3xcuda]" and g.cpu_fallbacks == 0
        serving.assert_bit_identical(g, oracle.query(q), q.kind)
    log = serving.make_query_log(data, serving.LoadSpec(
        rate_qps=400.0, duration_s=0.25, n_clients=10, knn_k=4, seed=15),
        K=32)
    with router.serve(engine="cuda") as srv:
        point = serving.run_open_loop(srv, log)
    assert point["completed"] == point["admitted"] and point["failed"] == 0
    replay = serving.replay_serial(router, srv.query_log(), engine="cuda")
    for seq, res in point["results"].items():
        serving.assert_bit_identical(res, replay[seq], f"seq{seq}")
    host = api.Router.build(data[:3000], 2, K=32, learn=False, cfg=cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        host.engine("cuda")


def test_indexed_dataset_selects_through_window_match(cuda_device):
    """`IndexedDataset` without ``device=``: a select is a Range on the
    `cuda` engine (the `window_match` kernel launched), verified against
    the full metadata mask and equal to the host dataset's."""
    from repro_torch.data.pipeline import IndexedDataset, synth_corpus

    docs, meta = synth_corpus(3000, vocab=64, max_len=64, seed=16)
    ds = IndexedDataset(docs, meta, seed=0, verify_selects=True)
    host = IndexedDataset(docs, meta, seed=0, device="cpu")
    assert ds.db.default_engine == "cuda"
    cuda_lib.reset_launches()
    rng = np.random.default_rng(17)
    for _ in range(8):
        lo, hi = np.sort(rng.uniform(0, 1, (2, 4)), axis=0)
        np.testing.assert_array_equal(ds.select(lo, hi),
                                      host.select(lo, hi))
    assert cuda_lib.LAUNCHES["window_match"] > 0


def test_flash_wrapper_refuses_autograd_and_serves_under_no_grad(
        cuda_device):
    """The kernels have no backward: on the CUDA route, inputs that
    autograd would record raise (the output would silently carry no
    gradient); under `torch.no_grad()` the same inputs are served by one
    launch, held against the twin at the bf16 bar."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn((1, 4, 128, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, causal=True)
    before = cuda_lib.LAUNCHES["flash_attention_tc"]
    with torch.no_grad():
        got = flash_attention(q, k, v, causal=True)
    assert cuda_lib.LAUNCHES["flash_attention_tc"] == before + 1
    torch.testing.assert_close(
        got.float(), mha_ref(q.detach(), k, v, causal=True).float(),
        atol=2e-2, rtol=2e-2)
    # the twin's route stays differentiable
    flash_attention(q, k, v, causal=True, backend="torch").sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad.float()).all())


def test_reduced_train_step_on_card_like_cpu(cuda_device):
    """A reduced qwen3-4b train step (2 microbatches, remat "full") on the
    card against the same step on the CPU from the same weights: the loss
    within a relative 1e-3 and the gradient norm within 0.08 (the CPU
    tests' bars for two bf16 computations), no flash launch, and
    ``backend="cuda"`` refused."""
    import dataclasses
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(reduced_config(get_arch("qwen3-4b")),
                              microbatch=2, remat="full")
    shape = ShapeConfig("t", 64, 4, "train")
    toks = torch.randint(0, cfg.vocab, (4, 64),
                         generator=torch.Generator().manual_seed(3))
    host = init_model(cfg, seed=0, device="cpu")
    card = _to(init_model(cfg, seed=0, device="cpu"), cuda_device)
    out = {}
    for dev, params in (("cpu", host), ("cuda", card)):
        step = make_train_step(cfg, shape, AdamWConfig(lr=1e-3,
                                                       warmup_steps=1),
                               device=dev)
        cuda_lib.reset_launches()
        _, _, m = step(params, init_opt_state(params), {"tokens": toks})
        assert sum(cuda_lib.LAUNCHES.values()) == 0
        out[dev] = {k: v.item() for k, v in m.items()}
    assert out["cuda"]["loss"] == pytest.approx(out["cpu"]["loss"], rel=1e-3)
    assert out["cuda"]["grad_norm"] == pytest.approx(out["cpu"]["grad_norm"],
                                                     rel=0.08)
    assert out["cuda"]["lr"] == out["cpu"]["lr"]
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, shape, backend="cuda")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
