"""The split kernel (`split_zranges`, `csrc/sfc_encode.cu`) on the card,
held bit for bit against its twin, `core.split.recursive_split_torch`
then `zranges_torch` on the same card (their encodes on the `sfc_encode`
kernel) and on the CPU: `valid`, `zlo` and `zhi`, invalid leaves
included.  The twin is held against the reference in
`test_torch_split.py`.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_split_kernel.py

Curves: the template instances (d 2 with K 32, d 3 piecewise at depth 2
with K 21, d 4 global with K 16), the general instance (d 2 with K 20,
d 5 with K 12) and a table read through L1 (d 3 piecewise at depth 3,
1.2 MB)."""
import numpy as np
import pytest
import torch

from repro_torch.core import curve as tc
from repro_torch.core import serve as tsv
from repro_torch.core.index import IndexConfig
from repro_torch.core.split import recursive_split_torch, zranges_torch
from repro_torch.data.synth import make_dataset
from repro_torch.data.workload import make_workload
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.sfc_encode import ops as enc_ops
from split_cases import queries

pytestmark = pytest.mark.cuda

# name: d, K, family, depth
CURVES = {"global2": (2, 32, "global", 1),
          "piecewise3": (3, 21, "piecewise", 2),
          "global4": (4, 16, "global", 1),
          "general2": (2, 20, "global", 1),
          "general5": (5, 12, "global", 1),
          "piecewise3_l1": (3, 21, "piecewise", 3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _windows(name, Q):
    """(Q, d, 2) int32 windows: `split_cases.queries`' edge rectangles
    (qL == qU, zeros, the whole domain, bit 31 set at K 32) and random
    ones; a single window is the whole domain."""
    d, K, _, _ = CURVES[name]
    q = queries(Q + d, max(Q, 4), d, K)
    q = q[3:4] if Q == 1 else q[:Q]
    return torch.from_numpy(np.ascontiguousarray(
        q.astype(np.uint32).view(np.int32)))


def _curve(name):
    d, K, family, depth = CURVES[name]
    return tc.random_curve(np.random.default_rng(d * 11 + depth), d, K,
                           family=family, depth=depth)


@pytest.mark.parametrize("Q", [1, 37, 1024])
@pytest.mark.parametrize("k", [0, 1, 4, 6, 8])
@pytest.mark.parametrize("name", list(CURVES))
def test_split_kernel_matches_twin(cuda_device, name, k, Q):
    d, K, _, _ = CURVES[name]
    curve = _curve(name)
    q = _windows(name, Q)
    R = tc.curve_lut(curve, "cpu").shape[0]
    placement = enc_ops.plan_split(Q, k, R, d, K, 132).placement
    assert placement == ("l1" if name.endswith("_l1") else "smem")
    dev = q.to(cuda_device)
    before = dict(cuda_lib.LAUNCHES)
    got = enc_ops.split_zranges(dev, curve, k)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["split_zranges"] == before["split_zranges"] + 1
    assert cuda_lib.LAUNCHES["sfc_encode"] == before["sfc_encode"]
    rects, valid = recursive_split_torch(dev, curve, k)
    on_card = (valid, *zranges_torch(rects, curve))
    on_cpu = enc_ops.split_zranges(q, curve, k)
    for g, a, b in zip(got, on_card, on_cpu, strict=True):
        assert g.device.type == "cuda" and g.dtype == b.dtype
        assert torch.equal(g.cpu(), a.cpu())
        assert torch.equal(g.cpu(), b)


@pytest.mark.parametrize("kind", ["count", "range"])
def test_engine_splits_once_a_device_call(cuda_device, monkeypatch, kind):
    """One `Database.query` on the `cuda` engine, forced to escalate:
    every device call (each `core.serve._chunks`) launches the split
    kernel once and the encode kernel never, and the answers equal the
    `torch` engine's."""
    from repro_torch import api

    data = make_dataset("osm", 20_000, seed=3)
    Ls, Us = make_workload(data, 100, seed=4, width_scale=0.05)
    db = api.Database.fit(data, K=32, learn=False,
                          cfg=IndexConfig(page_bytes=2048))
    knobs = dict(q_chunk=8, max_cand=4, max_hits=64)
    db.engine("torch", api.EngineConfig(**knobs))
    db.engine("cuda", api.EngineConfig(**knobs))
    q = (api.Count if kind == "count" else api.Range)(Ls, Us)
    want = db.query(q, engine="torch")
    calls = []
    real = tsv._chunks

    def counting(*args, **kw):
        before = dict(cuda_lib.LAUNCHES)
        out = real(*args, **kw)
        calls.append({n: cuda_lib.LAUNCHES[n] - before[n] for n in before})
        return out

    monkeypatch.setattr(tsv, "_chunks", counting)
    before = dict(cuda_lib.LAUNCHES)
    got = db.query(q, engine="cuda")
    assert got.engine == "cuda" and got.escalations > 0
    assert len(calls) > 1
    for c in calls:
        assert c["split_zranges"] == 1 and sum(c.values()) == 1
    assert cuda_lib.LAUNCHES["split_zranges"] - before["split_zranges"] == \
        len(calls)
    assert cuda_lib.LAUNCHES["sfc_encode"] == before["sfc_encode"]
    for f in ("counts", "rows", "offsets"):
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
