"""The port's cost model against the reference's: `dist.roofline` (MODEL_FLOPS
and the roofline terms at the H100's ceilings) and `dist.hlo_analysis`'s
HLO text analyzer.

- `model_flops` is a copy in the same arithmetic order: equal to the
  reference's exactly (``==``), on every (arch × shape) cell of the
  registry and on the reduced configs.
- The analyzer is a copy with one change, the trip count: the port reads
  the while op's ``known_trip_count`` first.  On HLO without it (the canned
  module below) both analyzers return equal dicts.  On the reference's own
  6-layer scan-plus-grad, lowered by this tree's JAX on an Auto-axes
  (2, 4) mesh of fake CPU devices, the port counts the program's 589,824
  flops a device and 12 all-gathers; the reference counts each loop once
  (98,304 flops, 2 all-gathers): the known fault the port does not copy.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.dist import hlo_analysis as rhlo
from repro.dist import roofline as rroof
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.dist import hlo_analysis as thlo
from repro_torch.dist import roofline as troof

ROOT = Path(__file__).resolve().parents[1]

CANNED = textwrap.dedent("""\
    HloModule canned, num_partitions=8

    %body.1 (p.2: (s32[], f32[4,128])) -> (s32[], f32[4,128]) {
      %p.2 = (s32[], f32[4,128]) parameter(0)
      %iv.3 = s32[] get-tuple-element(%p.2), index=0
      %h.4 = f32[4,128]{1,0} get-tuple-element(%p.2), index=1
      %w.5 = f32[128,32]{1,0} constant({...})
      %dot.6 = f32[4,32]{1,0} dot(%h.4, %w.5), lhs_contracting_dims={1}, rhs_contracting_dims={0}
      %ag.7 = (f32[4,32]{1,0}, f32[4,128]{1,0}) all-gather-start(%dot.6), replica_groups=[2,4]<=[8], dimensions={1}
      %agd.8 = f32[4,128]{1,0} all-gather-done(%ag.7)
      %one.9 = s32[] constant(1)
      %next.10 = s32[] add(%iv.3, %one.9)
      ROOT %tup.11 = (s32[], f32[4,128]) tuple(%next.10, %agd.8)
    }

    %cond.12 (p.13: (s32[], f32[4,128])) -> pred[] {
      %p.13 = (s32[], f32[4,128]) parameter(0)
      %iv.14 = s32[] get-tuple-element(%p.13), index=0
      %trip.15 = s32[] constant(6)
      ROOT %lt.16 = pred[] compare(%iv.14, %trip.15), direction=LT
    }

    ENTRY %main.17 (x.18: f32[4,128]) -> f32[4,128] {
      %x.18 = f32[4,128]{1,0} parameter(0)
      %zero.19 = s32[] constant(0)
      %init.20 = (s32[], f32[4,128]) tuple(%zero.19, %x.18)
      %loop.21 = (s32[], f32[4,128]) while(%init.20), condition=%cond.12, body=%body.1
      ROOT %out.22 = f32[4,128]{1,0} get-tuple-element(%loop.21), index=1
    }
""")

# the same loop as newer XLA emits it: the bound is a loop-carried value,
# and the count is only in the while op's backend_config
KNOWN_TRIP = (CANNED
              .replace("%trip.15 = s32[] constant(6)",
                       "%trip.15 = s32[] get-tuple-element(%p.13), index=0")
              .replace("body=%body.1",
                       'body=%body.1, backend_config={"known_trip_count":'
                       '{"n":"6"}}'))


def _cells():
    return [(a, s) for a in rreg.ARCHS for s in rbase.SHAPES]


@pytest.mark.parametrize("arch,shape", _cells())
def test_model_flops_equals_reference_on_every_cell(arch, shape):
    got = troof.model_flops(treg.get_arch(arch), tbase.SHAPES[shape])
    want = rroof.model_flops(rreg.get_arch(arch), rbase.SHAPES[shape])
    assert got == want


def test_model_flops_equals_reference_on_reduced_configs():
    for arch in rreg.ARCHS:
        rc = rreg.reduced_config(rreg.get_arch(arch))
        tc = treg.reduced_config(treg.get_arch(arch))
        for name, rs in rbase.SHAPES.items():
            ts = tbase.SHAPES[name]
            assert troof.model_flops(tc, ts) == rroof.model_flops(rc, rs)
            assert (troof._n_attn_layers(tc), troof._param_split(tc)) == \
                (rroof._n_attn_layers(rc), rroof._param_split(rc))


def test_shape_bytes():
    _shape_bytes = thlo._shape_bytes
    assert _shape_bytes("f32[4,128]{1,0}") == 4 * 128 * 4
    assert _shape_bytes("bf16[2,3]") == 12
    assert _shape_bytes("(s32[], f32[6,4,32])") == 4 + 6 * 4 * 32 * 4
    assert _shape_bytes("pred[]") == 1
    # sharding annotations must not match as shapes
    assert _shape_bytes("replica_groups=[2,4]<=[8]") == 0


def test_analyzer_loop_accounting_on_canned_hlo():
    res = thlo.analyze_hlo_text(CANNED)
    assert res["flops"] == 6 * (2 * 4 * 32 * 128)        # 1 dot x trip 6
    ag = res["collectives"]["all-gather"]
    assert ag["count"] == 6
    # async-start payload = largest tuple component (f32[4,128] = 2048 B),
    # not the tuple sum; ring all-gather moves n*(g-1)/g per device
    assert ag["bytes"] == 6 * 2048 * 3 / 4
    assert res["bytes_unfused"] >= res["bytes"] > 0
    assert res == rhlo.analyze_hlo_text(CANNED)
    comps, entry = thlo.parse_computations(CANNED)
    rcomps, rentry = rhlo.parse_computations(CANNED)
    assert entry == rentry == "main.17"
    assert {k: [(o.name, o.opcode, o.operands) for o in v]
            for k, v in comps.items()} == \
        {k: [(o.name, o.opcode, o.operands) for o in v]
         for k, v in rcomps.items()}


def test_analyzer_reads_known_trip_count():
    """The one deliberate difference: a loop whose count only the while
    op's backend_config states.  The reference counts it once."""
    got = thlo.analyze_hlo_text(KNOWN_TRIP)
    ref = rhlo.analyze_hlo_text(KNOWN_TRIP)
    assert got == thlo.analyze_hlo_text(CANNED)
    assert got["flops"] == 6 * (2 * 4 * 32 * 128)
    assert ref["flops"] == 2 * 4 * 32 * 128             # the known fault
    assert ref["collectives"]["all-gather"]["count"] == 1
    an = thlo.HloAnalyzer(KNOWN_TRIP)
    loop = next(o for o in an.comps["main.17"] if o.opcode == "while")
    assert an._trip_count("cond.12", loop) == 6
    assert an._trip_count("cond.12") == 1


def test_model_flops_sane():
    cfg = treg.get_arch("yi-6b")
    SHAPES = tbase.SHAPES
    model_flops = troof.model_flops
    N = cfg.param_count()
    tr = model_flops(cfg, SHAPES["train_4k"])
    pf = model_flops(cfg, SHAPES["prefill_32k"])
    dc = model_flops(cfg, SHAPES["decode_32k"])
    # train: 6·N·D ≈ 6 · 6.06e9 · 1.05e6 tokens ≈ 3.8e16 (+ attention)
    assert 6 * N * 256 * 4096 <= tr < 1.3 * 6 * N * 256 * 4096
    assert 2 * N * 32 * 32768 <= pf < 2.0 * 2 * N * 32 * 32768
    assert 2 * N * 128 <= dc < 3.0 * 2 * N * 128
    enc = treg.get_arch("seamless-m4t-medium")
    full = 2 * enc.param_count() * 128
    attn = 2 * 2 * (2 * enc.n_layers) * enc.n_heads * enc.head_dim * 32768 * 128
    got = model_flops(enc, SHAPES["decode_32k"])
    assert got < full + attn
    assert got > attn / 2  # attention term present


def test_ceilings_are_the_h100s():
    """One NVIDIA H100 SXM (80GB HBM3, 700 W): dense bf16 peak, HBM3
    bandwidth, NVLink each way.  None of the reference's TPU numbers."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    for tpu in (rroof.PEAK_FLOPS, rroof.HBM_BW, rroof.LINK_BW):
        assert tpu not in (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW)
    src = (ROOT / "src/repro_torch/dist/roofline.py").read_text()
    for number in ("459e12", "2.765e12", "9e10"):
        assert number not in src


def test_analyze_terms_from_a_counted_cost():
    cost = {"flops": 989e12, "bytes": 6.7e12, "bytes_unfused": 6.7e12,
            "wire_bytes": 45e9,
            "collectives": {"all-reduce": {"count": 2, "bytes": 45e9}}}
    stats = {"argument_size_in_bytes": 10, "output_size_in_bytes": 2,
             "temp_size_in_bytes": 7}
    roof = troof.analyze(cost, stats)
    assert roof.compute_s == 1.0
    assert roof.memory_s == 2.0
    assert roof.collective_s == 0.1
    assert roof.dominant == "memory"
    assert roof.collectives == cost["collectives"]
    assert roof.memory_stats == {**stats, "bytes_unfused_upper_bound":
                                 6.7e12}
    assert set(roof.to_dict()) == set(
        rroof.Roofline.__dataclass_fields__)
    hlo = troof.analyze(thlo.analyze_hlo_text(CANNED))
    assert hlo.flops_per_device == 6 * (2 * 4 * 32 * 128)
    assert hlo.memory_stats == {"bytes_unfused_upper_bound":
                                hlo.bytes_per_device}


SCAN = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.dist import hlo_analysis as rhlo
    from repro_torch.dist import hlo_analysis as thlo

    def step(params, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, params)
        return h.sum()

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    ps = jax.ShapeDtypeStruct((6, 128, 128), jnp.float32,
                              sharding=NamedSharding(mesh, P(None, None, "model")))
    xs = jax.ShapeDtypeStruct((8, 128), jnp.float32,
                              sharding=NamedSharding(mesh, P("data", None)))
    text = jax.jit(jax.grad(step)).lower(ps, xs).compile().as_text()
    print(json.dumps({"port": thlo.analyze_hlo_text(text),
                      "reference": rhlo.analyze_hlo_text(text),
                      "known_trip_count": "known_trip_count" in text}))
""")


def test_scan_trip_counts_on_this_trees_jax():
    """6-layer scan + grad: 3 dots of 2*4*128*32 flops per layer a device
    and one all-gather of the layer's weight in each of the two loops."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", SCAN], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    port, ref = res["port"], res["reference"]
    assert port["flops"] == 6 * 3 * (2 * 4 * 128 * 32) == 589_824
    assert port["collectives"]["all-gather"]["count"] == 12
    assert port["bytes_unfused"] >= port["bytes"] > 0
    # the reference's fault on this JAX (recorded, not copied): each loop
    # counted once
    assert res["known_trip_count"]
    assert ref["flops"] == 98_304
    assert ref["collectives"]["all-gather"]["count"] == 2
