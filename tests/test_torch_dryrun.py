"""The port's step counter and dry run (`dist.hlo_analysis.StepCounter`,
`launch.dryrun`, `report`, `attribute`, `reanalyze`), with `input_specs`
and shape-only params.

Held here, on the CPU:
- the counter's flops on reduced prefill and train steps equal
  ``FlopCounterMode``'s exactly (the same registered formulas);
- a step's totals (flops, bytes, wire, collectives, calls of each op) on
  ``meta`` tensors equal its totals on CPU tensors (both on the twins);
- on ``meta``, ``backend="cuda"`` records each kernel's one op with the
  function's work and never runs the twin; nothing is launched;
- a tiny dense train step's flops equal a count written from its shapes;
- a c10d all-reduce and all-gather in a 2-process gloo group carry the
  reference analyzer's ring wire bytes;
- `init_model`, `init_opt_state` and `init_decode_state` on meta give
  every leaf the CPU init's shape and dtype; `input_specs` the
  reference's keys, shapes and dtypes;
- the dry run of every reduced family's cells (train, prefill, decode)
  and of `lmsfc-serve`, then `report`, `attribute --ops` and `reanalyze`
  on its records.
Card counts against meta counts are `chip_smoke.py`'s (phase cost_model).
"""
import dataclasses
import gzip
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.dist import hlo_analysis as rhlo
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig, input_specs, spec_tensors
from repro_torch.dist import roofline as troof
from repro_torch.dist.hlo_analysis import StepCounter, count_step
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.sfc_encode import ops as enc_ops
from repro_torch.kernels.window_filter import ops as wf_ops
from repro_torch.launch import attribute, dryrun, reanalyze, report
from repro_torch.models.transformer import init_decode_state, init_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(treg.ARCHS)
SMALL = {"train_4k": ShapeConfig("train_4k", 32, 2, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 32, 2, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 32, 2, "decode"),
         "long_500k": ShapeConfig("long_500k", 64, 1, "decode")}


@pytest.fixture(autouse=True)
def _one_thread():
    """The CPU steps here are thousands of tiny ops: one intra-op thread
    a test process, so parallel test workers do not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(arch):
    return treg.reduced_config(treg.get_arch(arch))


def _step(cfg, shape, device, backend="torch"):
    """(step, args) of `shape`'s kind on `device` (CPU data seeded)."""
    dev = torch.device(device)
    params = init_model(cfg, device=dev)
    batch = dryrun.step_batch(cfg, shape, dev)
    if shape.kind == "train":
        return (make_train_step(cfg, shape, AdamWConfig(), device=dev),
                (params, init_opt_state(params), batch))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, shape, device=dev, backend=backend),
                (params, batch))
    state = init_decode_state(cfg, shape.seq_len, shape.global_batch,
                              device=dev)
    return make_decode_step(cfg, shape, device=dev), (params, batch, state)


def _shapes_dtypes(tree):
    if isinstance(tree, dict):
        return {k: _shapes_dtypes(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


# ---------------------------------------------------------------------------
# the counter against FlopCounterMode, and meta against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_counter_flops_equal_flop_counter_mode(arch):
    cfg = _reduced(arch)
    for kind in ("prefill_32k", "train_4k"):
        shape = SMALL[kind]
        step, args = _step(cfg, shape, "cpu")
        with FlopCounterMode(display=False) as fc:
            step(*args)
        step, args = _step(cfg, shape, "cpu")
        _, counter = count_step(step, *args)
        assert counter.analyze()["flops"] == fc.get_total_flops() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_totals_equal_cpu_totals(arch):
    cfg = _reduced(arch)
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SMALL[kind]
        counts = []
        for device in ("cpu", "meta"):
            step, args = _step(cfg, shape, device)
            _, counter = count_step(step, *args)
            counts.append((counter.analyze(), dict(counter.op_counts)))
        assert counts[0] == counts[1], kind
        assert counts[0][0]["bytes"] > 0


def test_meta_kernel_route_records_the_kernel_not_the_twin(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the twin ran")
    monkeypatch.setattr(flash_ops, "mha_ref", refuse)
    cfg = _reduced("qwen3-4b")
    shape = SMALL["prefill_32k"]
    before = dict(cuda_lib.LAUNCHES)
    step, args = _step(cfg, shape, "meta", backend="cuda")
    (logits, caches), counter = count_step(step, *args, op_log=True)
    assert cuda_lib.LAUNCHES == before                 # nothing launched
    assert logits.device.type == "meta"
    assert logits.shape == (2, 1, cfg.vocab_padded)
    L, B, S = cfg.n_layers, shape.global_batch, shape.seq_len
    assert dict(counter.kernel_calls) == {"flash_attention_tc": L}
    assert counter.op_counts["repro_torch.flash_attention_tc"] == L
    flops, nbytes = flash_ops.flash_work(B, cfg.n_heads, cfg.n_kv_heads, S,
                                         cfg.head_dim, 2, True, 0)
    assert flops == 4 * B * cfg.n_heads * cfg.head_dim * S * (S + 1) // 2
    rows = [r for r in counter.op_log()
            if r["op"] == "repro_torch.flash_attention_tc"]
    assert len(rows) == 1 and rows[0]["count"] == L
    assert (rows[0]["flops"], rows[0]["bytes"]) == (L * flops, L * nbytes)
    assert rows[0]["source"].startswith("repro_torch/models/attention.py:")
    # the torch backend on meta runs the walk instead, op by op
    step, args = _step(cfg, shape, "meta", backend="torch")
    _, walk = count_step(step, *args)
    assert not walk.kernel_calls
    assert walk.analyze()["flops"] > counter.analyze()["flops"]


def test_meta_index_kernels_allocate_and_count():
    G, d, cap = 6, 2, 16
    pts = torch.empty((G, d, cap), dtype=torch.int32, device="meta")
    rect = torch.empty((G, d, 2), dtype=torch.int32, device="meta")
    size = torch.empty(G, dtype=torch.int32, device="meta")
    from repro_torch.core import curve as tc
    curve = tc.default_curve(2, 32)
    pw = tc.default_curve(3, 21, "piecewise", depth=2)
    x = torch.empty((40, 2), dtype=torch.int32, device="meta")
    x3 = torch.empty((40, 3), dtype=torch.int32, device="meta")
    before = dict(cuda_lib.LAUNCHES)
    with StepCounter() as c:
        cnt = wf_ops.window_filter(pts, rect, size)
        mask = wf_ops.window_match(pts, rect, size)
        z = enc_ops.sfc_encode(x, curve)
        zp = enc_ops.sfc_encode(x3, pw)
        zz = enc_ops.sfc_encode_pool(x, [curve, curve, curve])
    assert cuda_lib.LAUNCHES == before
    assert (cnt.shape, cnt.dtype) == ((G,), torch.int32)
    assert (mask.shape, mask.dtype) == ((G, cap), torch.bool)
    assert z.shape == (40, 2) and zp.shape == (40, 2)
    assert zz.shape == (3, 40, 2)
    assert dict(c.kernel_calls) == {"window_filter": 1, "window_match": 1,
                                    "sfc_encode": 2, "sfc_encode_pool": 1}
    assert set(c.op_counts) == {f"repro_torch.{k}" for k in c.kernel_calls}
    pw_live = int((tc.curve_tables(pw, "cpu")[1] < 63).sum())
    assert pw_live == 6
    want = (wf_ops.filter_work(G, d, cap, G * 4)
            + wf_ops.filter_work(G, d, cap, G * cap)
            + enc_ops.encode_work(40, 2, 32, 1, 0)
            + enc_ops.encode_work(40, 3, 21, pw.num_regions, pw_live)
            + enc_ops.encode_work(40, 2, 32, 1, 0, 3))
    assert c.analyze() == {"flops": 0, "bytes": float(want),
                           "bytes_unfused": float(want), "wire_bytes": 0.0,
                           "collectives": {}}
    # the paged form: one op; 12 candidate ids name at most the 10 pages
    P, Qc, C = 10, 3, 4
    meta = lambda *shape, dtype=torch.int32: torch.empty(
        shape, dtype=dtype, device="meta")
    with StepCounter() as cp:
        cnt_p = wf_ops.window_filter_paged(
            meta(P, d, cap), meta(P), meta(Qc, d, 2), meta(Qc, C),
            meta(Qc, dtype=torch.int64))
    assert cuda_lib.LAUNCHES == before
    assert (cnt_p.shape, cnt_p.dtype) == ((Qc,), torch.int32)
    assert dict(cp.kernel_calls) == {"window_filter": 1}
    want_p = wf_ops.filter_work_paged(P, Qc, C, d, cap)
    assert want_p == (P * (d * cap * 4 + 4) + Qc * d * 2 * 4 + Qc * C * 4
                      + Qc * 8 + Qc * 4)
    assert cp.analyze()["bytes"] == float(want_p)
    # without a counter the meta route still only allocates
    assert wf_ops.window_filter(pts, rect, size).device.type == "meta"
    assert cuda_lib.LAUNCHES == before


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5),
                                           (False, 5), (True, 40),
                                           (False, 40)])
def test_visible_pairs_closed_form(causal, window):
    for S in (1, 5, 6, 33):
        rows = np.arange(S)
        hi = rows + 1 if causal else np.full(S, S)
        lo = np.maximum(rows - window + 1, 0) if window > 0 else 0
        assert flash_ops.visible_pairs(S, causal, window) == \
            int(np.sum(hi - lo))


def test_float32_flash_on_meta_counts_its_function():
    q = torch.empty((2, 4, 8, 32), device="meta")
    k = torch.empty((2, 2, 8, 32), device="meta")
    with StepCounter() as c:
        o = flash_ops.flash_attention(q, k, k, causal=False, window=3)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert dict(c.kernel_calls) == {"flash_attention": 1}
    flops, nbytes = flash_ops.flash_work(2, 4, 2, 8, 32, 4, False, 3)
    assert c.analyze()["flops"] == flops
    assert c.analyze()["bytes"] == nbytes == (2 * 8 + 2 * 4) * 8 * 32 * 4


def test_tiny_dense_train_step_flops_from_shapes():
    """Remat none, microbatch 1, one attention block: every matrix product
    of the forward is done again twice in the backward (input and weight
    gradients), and nothing else has a flop formula."""
    cfg = dataclasses.replace(
        _reduced("qwen3-4b"), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=96, vocab=100, attn_chunk=1024,
        microbatch=1, remat="none")
    B, S = 3, 16
    shape = ShapeConfig("tiny", S, B, "train")
    T, D, H, KH, dh, F = B * S, 64, 4, 2, 16, 96
    layer = (2 * T * D * (H + 2 * KH) * dh      # wq, wk, wv
             + 2 * T * H * dh * D               # wo
             + 2 * 2 * B * H * S * S * dh       # scores and PV (masked)
             + 3 * 2 * T * D * F)               # swiglu
    fwd = cfg.n_layers * layer + 2 * T * D * cfg.vocab_padded
    for device in ("cpu", "meta"):
        step, args = _step(cfg, shape, device)
        _, counter = count_step(step, *args)
        assert counter.analyze()["flops"] == 3 * fwd


def test_peak_bytes_track_live_storage():
    with StepCounter() as c:
        a = torch.empty(1000, device="meta") + 1       # 4,000 B, kept
        for _ in range(3):
            b = a * 2                                  # freed each turn
            del b
    assert c.peak_bytes == 8000
    assert c.live == 4000
    del a
    assert c.live == 0


# ---------------------------------------------------------------------------
# collectives over a 2-process gloo group
# ---------------------------------------------------------------------------

GLOO = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from repro_torch.dist.hlo_analysis import StepCounter
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    t = torch.ones(1000)
    out = torch.empty(2000)
    with StepCounter() as c:
        dist.all_reduce(t)
        dist.all_gather_into_tensor(out, t)
    assert float(t[0]) == 2.0
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(c.analyze()))
""")

HLO_COLL = textwrap.dedent("""\
    HloModule colls, num_partitions=2

    ENTRY %main (x: f32[1000]) -> f32[2000] {
      %x = f32[1000]{0} parameter(0)
      %ar = f32[1000]{0} all-reduce(%x), replica_groups={{0,1}}, to_apply=%sum
      ROOT %ag = f32[2000]{0} all-gather(%ar), replica_groups={{0,1}}, dimensions={0}
    }
""")


def test_gloo_collectives_carry_the_reference_wire_bytes():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", GLOO, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT, env=env)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-2000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    want = rhlo.analyze_hlo_text(HLO_COLL)
    assert got["collectives"] == want["collectives"]
    assert got["wire_bytes"] == want["wire_bytes"] == 4000 + 4000
    assert got["flops"] == 0


# ---------------------------------------------------------------------------
# shape-only params and input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_cpu_init(arch):
    cfg = _reduced(arch)
    cpu, meta = init_model(cfg, device="cpu"), init_model(cfg, device="meta")
    assert _shapes_dtypes(meta) == _shapes_dtypes(cpu)
    assert all(t.device.type == "meta"
               for t in _leaves(meta) + _leaves(init_opt_state(meta)))
    assert _shapes_dtypes(init_opt_state(meta)) == \
        _shapes_dtypes(init_opt_state(cpu))
    assert _shapes_dtypes(init_decode_state(cfg, 32, 2, device="meta")) == \
        _shapes_dtypes(init_decode_state(cfg, 32, 2, device="cpu"))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_input_specs_equal_reference():
    for arch in ARCHS:
        for name in tbase.SHAPES:
            got = input_specs(treg.get_arch(arch), tbase.SHAPES[name])
            want = rbase.input_specs(rreg.get_arch(arch), rbase.SHAPES[name])
            assert list(got) == list(want)
            for k, spec in got.items():
                assert spec.shape == tuple(want[k].shape)
                assert str(spec.dtype).removeprefix("torch.") == \
                    str(want[k].dtype)
            made = spec_tensors(got)
            assert all(t.device.type == "meta" for t in made.values())


# ---------------------------------------------------------------------------
# the dry run and its tools
# ---------------------------------------------------------------------------


def _reduced_registry(monkeypatch):
    monkeypatch.setattr(dryrun, "get_arch", _reduced)
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(reanalyze, "get_arch", _reduced)
    monkeypatch.setattr(reanalyze, "SHAPES", SMALL)


def test_dryrun_of_every_reduced_cell_and_its_tools(monkeypatch, tmp_path,
                                                    capsys):
    _reduced_registry(monkeypatch)
    out = str(tmp_path)
    dryrun.main(["--all", "--out", out])
    dryrun.main(["--arch", "lmsfc-serve", "--out", out, "--overrides",
                 json.dumps({"n_pages": 512, "q_batch": 64})])
    recs = report.load(out)
    lm = [r for r in recs if r["arch"] != "lmsfc-serve"]
    assert len(lm) == len(ARCHS) * len(SMALL)
    for r in lm:
        cfg = _reduced(r["arch"])
        if r["status"] == "skipped":
            assert not tbase.shape_applicable(cfg, SMALL[r["shape"]])
            assert r["reason"] == dryrun.SKIP_REASON
            continue
        assert r["status"] == "ok" and r["mesh"] == "1x1"
        assert r["chips"] == 1 and r["compile_s"] == 0
        mf = troof.model_flops(cfg, SMALL[r["shape"]])
        assert r["model_flops_total"] == r["model_flops_per_chip"] == mf
        ro = r["roofline"]
        assert ro["compute_s"] == ro["flops_per_device"] / troof.PEAK_FLOPS
        assert r["useful_flops_ratio"] == mf / ro["flops_per_device"]
        ms = ro["memory_stats"]
        assert ms["argument_size_in_bytes"] > 0
        assert ms["temp_size_in_bytes"] > 0
        flash = r["kernel_calls"].get("flash_attention_tc", 0)
        if SMALL[r["shape"]].kind == "prefill" and cfg.family != "ssm":
            assert flash > 0
        else:
            assert flash == 0
        name = dryrun._cell_name(r["arch"], r["shape"], "1x1")
        assert os.path.exists(os.path.join(out, "ops",
                                           name + ".ops.json.gz"))
    assert sum(r["status"] == "ok" for r in lm) == \
        len(lm) - sum(not treg.get_arch(a).sub_quadratic for a in ARCHS)
    serve = [r for r in recs if r["arch"] == "lmsfc-serve"]
    assert len(serve) == 2 and all(r["status"] == "ok" for r in serve)
    small = next(r for r in serve if r["shape"] == "q64_p512_c64_k4")
    assert small["global_points"] == 512 * 1024
    assert small["kernel_calls"] == {"split_zranges": 1, "window_filter": 4}
    capsys.readouterr()

    report.main(["--dir", out])
    table = capsys.readouterr().out
    assert f"records: {len(recs)} ok=" in table and "failed=0" in table
    assert "### mesh 1x1" in table and "| qwen3-4b | train_4k | ok |" in table

    cell = os.path.join(out, "ops", "qwen3-4b__train_4k__1_1.ops.json.gz")
    rows = attribute.main(["--ops", cell, "--kind", "flops", "--top", "5"])
    printed = capsys.readouterr().out
    assert "total flops:" in printed and "repro_torch/" in printed
    with gzip.open(cell, "rt") as f:
        saved = json.load(f)
    assert sum(r[0] for r in rows) == saved["cost"]["flops"]
    attribute.main(["--ops", cell, "--kind", "traffic"])
    assert "total traffic:" in capsys.readouterr().out

    path = os.path.join(out, "qwen3-4b__train_4k__1_1.json")
    with open(path) as f:
        before = json.load(f)
    before["roofline"]["compute_s"] = -1.0
    before["model_flops_total"] = -1.0
    with open(path, "w") as f:
        json.dump(before, f)
    reanalyze.main(["--dir", out])
    with open(path) as f:
        after = json.load(f)
    assert after["roofline"]["flops_per_device"] == saved["cost"]["flops"]
    assert after["roofline"]["compute_s"] == \
        saved["cost"]["flops"] / troof.PEAK_FLOPS
    assert after["model_flops_total"] == troof.model_flops(
        _reduced("qwen3-4b"), SMALL["train_4k"])
    assert after["roofline"]["memory_stats"] == \
        before["roofline"]["memory_stats"]


def _ring(base, n, g):
    """The analyzer's ring formulas: all-reduce 2n(g-1)/g, else n(g-1)/g."""
    return (2.0 if base == "all-reduce" else 1.0) * n * (g - 1) / g


def test_production_meshes_are_not_ported(monkeypatch, tmp_path):
    """The production meshes are ported: ``--mesh pod`` / ``multipod``
    count rank 0's share of the sharded decode step under the fake group
    (left again afterwards).  Reduced qwen3-4b (4 layers, D 128, 4 heads,
    d_ff 256, vocab 512, no FSDP), batch 64: the 4 heads do not split 16
    ways, so attention runs whole on every chip after an all-gather of
    ``wo`` (its rows are on model); the MLP's d_ff and the vocabulary are
    split, closed by a psum of the (B_local, 1, D) bf16 rows (one a layer
    and one for the embedding).  The wire bytes are the ring formulas of
    those collectives, and 256 (512) times a chip's flops lies between the
    one-card count and 16 times it (the model axis replicates the
    attention: measured 6.87x on both meshes)."""
    import torch.distributed as dist
    shape = ShapeConfig("decode_32k", 32, 64, "decode")
    monkeypatch.setattr(dryrun, "get_arch", _reduced)
    monkeypatch.setattr(dryrun, "SHAPES", {"decode_32k": shape})
    cfg = _reduced("qwen3-4b")
    one = dryrun.dryrun_cell("qwen3-4b", "decode_32k", "host",
                             out_dir=str(tmp_path), verbose=False)
    L, D, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    for mesh, chips, label in (("pod", 256, "16x16"),
                               ("multipod", 512, "2x16x16")):
        dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                     "--mesh", mesh, "--out", str(tmp_path)])
        assert not dist.is_initialized()
        with open(tmp_path / f"qwen3-4b__decode_32k__"
                  f"{label.replace('x', '_')}.json") as f:
            rec = json.load(f)
        assert (rec["status"], rec["chips"], rec["mesh"]) == (
            "ok", chips, label)
        roof = rec["roofline"]
        ratio = roof["flops_per_device"] * chips / \
            one["roofline"]["flops_per_device"]
        assert 1.0 <= ratio <= 16.0, ratio
        b_local = 64 // (chips // 16)
        psum = _ring("all-reduce", b_local * D * 2, 16)
        gather = _ring("all-gather", cfg.n_heads * dh * D * 2, 16)
        assert roof["collectives"] == {
            "all-reduce": {"count": L + 1, "bytes": (L + 1) * psum},
            "all-gather": {"count": L, "bytes": L * gather}}


@pytest.mark.parametrize("ranks", [4, 1])
def test_counter_prices_dtensor_redistribute(ranks):
    """On meta under the fake group (rank 0 of `ranks`): a (64, 8) float32
    DTensor sharded `ranks` ways and gathered whole by its own
    `redistribute`, and the same gather through the shard_map shim's
    `all_gather`, each reach the counter as one all-gather priced by the
    ring formula (2,048 bytes: 1,920 wire bytes over 4 ranks); over one
    rank DTensor issues none and the shim's is priced at 0.  An add of
    two sharded DTensors counts one rank's block."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.dist.compat import all_gather, shard_map
    from repro_torch.dist.sharding import P
    from repro_torch.launch.mesh import init_fake_group
    init_fake_group(ranks)
    try:
        mesh = init_device_mesh("cpu", (ranks,), mesh_dim_names=("model",))
        d = DTensor.from_local(torch.empty(64 // ranks, 8, device="meta"),
                               mesh, [Shard(0)], run_check=False)
        gather = {"count": 1, "bytes": _ring("all-gather", 64 * 8 * 4,
                                             ranks)}
        with StepCounter(op_log=True) as c:
            full = d.redistribute(mesh, [Replicate()])
            d + d
        assert tuple(full.to_local().shape) == (64, 8)
        assert c.analyze()["collectives"] == (
            {"all-gather": gather} if ranks > 1 else {})
        adds = [r for r in c.op_log() if r["op"] == "aten.add.Tensor"]
        assert [r["shapes"] for r in adds] == [[[64 // ranks, 8]] * 2]
        with StepCounter() as c:
            shard_map(lambda x: all_gather(x, "model", 0), mesh=mesh,
                      in_specs=(P("model", None),),
                      out_specs=P(None, None))(d)
        assert c.analyze()["collectives"] == {"all-gather": gather}
    finally:
        dist.destroy_process_group()


def test_op_log_stays_small():
    """One row per distinct (op, shapes, source line): a deeper model adds
    calls to its rows, not rows."""
    shape = SMALL["prefill_32k"]
    sizes = []
    for layers in (2, 4):
        cfg = dataclasses.replace(_reduced("qwen3-4b"), n_layers=layers)
        step, args = _step(cfg, shape, "meta", backend="cuda")
        _, counter = count_step(step, *args, op_log=True)
        sizes.append((len(counter.op_log()),
                      sum(r["count"] for r in counter.op_log())))
    assert sizes[0][0] == sizes[1][0]
    assert sizes[1][1] > sizes[0][1]
