"""The port's spec trees and DTensor placements against the reference's.

For every config of `configs/registry.py` at published widths, under the
rules of the pod (16, 16), the multipod (2, 16, 16) and a (2, 4) mesh,
each with the config's ``fsdp``: `init_specs_only`, `opt_state_specs`,
`decode_state_specs` (S 2,048, B 8) and `bind_runtime`'s
``moe_token_shards`` equal the reference's, entry for entry (a config
whose heads fit neither way raises in both).  Pure Python: no devices,
no process group.  `placements` maps a spec to one DTensor placement a
mesh dimension, a tuple entry sharding its dim over its axes in the
mesh's order.
"""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RP
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS as RARCHS
from repro.dist.sharding import ShardingRules as RRules
from repro.models.transformer import decode_state_specs as r_decode_specs
from repro.optim.adamw import opt_state_specs as r_opt_specs
from repro.train.steps import bind_runtime as r_bind
from repro.train.steps import init_specs_only as r_init_specs
from repro_torch.configs.registry import ARCHS
from repro_torch.dist.sharding import NamedSharding, P, ShardingRules, placements
from repro_torch.models.transformer import decode_state_specs
from repro_torch.optim.adamw import opt_state_specs
from repro_torch.train.steps import bind_runtime, init_specs_only, make_rules

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


class _Mesh:
    """What the reference's `make_rules` / `bind_runtime` read of a mesh
    (axis names and the devices' shape), with no devices behind it."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)
        self.mesh_dim_names = axes
        self.shape = shape


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)


def _ref_plain(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, RP))


def _both(fn_ref, fn_port):
    """(reference result, port result), or the exception types raised."""
    out = []
    for fn in (fn_ref, fn_port):
        try:
            out.append(fn())
        except ValueError as e:
            out.append(type(e))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_equal_the_reference(arch, mesh):
    shape, axes = MESHES[mesh]
    m = _Mesh(shape, axes)
    rcfg, tcfg = RARCHS[arch], ARCHS[arch]
    rrules = RRules(model_size=shape[-1], data_size=shape[-2],
                    fsdp=rcfg.fsdp, multi_pod=len(shape) == 3,
                    pod_size=shape[0] if len(shape) == 3 else 1)
    trules = make_rules(tcfg, m)
    assert dataclasses.asdict(trules) == dataclasses.asdict(rrules)
    rs, ts = _both(lambda: _ref_plain(r_init_specs(rcfg, rrules)),
                   lambda: _plain(init_specs_only(tcfg, trules)))
    assert rs == ts
    if isinstance(rs, type):            # no clean head split: both raise
        return
    assert _ref_plain(r_opt_specs(r_init_specs(rcfg, rrules))) == \
        _plain(opt_state_specs(init_specs_only(tcfg, trules)))
    rd, td = _both(
        lambda: _ref_plain(r_decode_specs(rcfg, 2048, 8, rrules)[1]),
        lambda: _plain(decode_state_specs(tcfg, 2048, 8, trules)[1]))
    assert rd == td
    for batch in (8, 256, 3):
        assert r_bind(rcfg, m, batch).moe_token_shards == \
            bind_runtime(tcfg, m, batch).moe_token_shards


def test_decode_state_shapes_are_meta():
    shapes, specs = decode_state_specs(ARCHS["qwen3-4b"], 2048, 8,
                                       ShardingRules(16, 16))
    assert shapes["k"].device.type == "meta"
    assert tuple(shapes["k"].shape) == (36, 8, 8, 2048, 128)
    assert specs["k"] == P(None, None, None, None, None)


class _Dims:
    def __init__(self, names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec,names,want", [
    (P(("pod", "data"), "model"), ("pod", "data", "model"),
     (Shard(0), Shard(0), Shard(1))),
    (P("data", "model"), ("data", "model"), (Shard(0), Shard(1))),
    (P("model", "data"), ("data", "model"), (Shard(1), Shard(0))),
    (P(None, "model", None), ("data", "model"), (Replicate(), Shard(1))),
    (P(), ("pod", "data", "model"), (Replicate(),) * 3),
])
def test_placements_follow_the_spec(spec, names, want):
    assert placements(_Dims(names), spec) == want
    assert NamedSharding(_Dims(names), spec).placements == want


@pytest.mark.parametrize("spec,names", [
    (P(("data", "pod")), ("pod", "data", "model")),    # against mesh order
    (P("pod"), ("data", "model")),                      # no such axis
    (P("data", "data"), ("data", "model")),             # an axis twice
])
def test_placements_refuse_specs_the_mesh_cannot_hold(spec, names):
    with pytest.raises(ValueError):
        placements(_Dims(names), spec)
