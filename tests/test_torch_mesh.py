"""The port's sharded train, prefill and decode steps on a (2, 2) gloo mesh
against the unsharded port, and its sharded loss against the reference's.

Weights come from the reference's `init_model` (PRNGKey 0) and cross by
`lm_params_from_numpy`; tokens are drawn with numpy from a seed.  One
spawned world of 4 ranks runs every case; the reference's jitted train
step on a (2, 2) mesh runs meanwhile in one subprocess with
``--xla_force_host_platform_device_count=4`` on a `jax.sharding.Mesh` with
Auto axes.  Tolerances, each beside what was measured on the CPU:

- The whole model in bf16 (reduced configs: dense qwen3-4b; granite-34b,
  whose single KV head is replicated over a model axis of 2; MoE
  granite-moe with the global and the shard-map dispatch; hybrid zamba2):
  last-position prefill logits and 3 decode steps within atol 0.15 / rtol
  0.1 of the unsharded port (measured 0.008-0.012); the MoE every prefill
  position's logits and the decode steps per token, at most 10% of the
  tokens missing (a near tie routes a token another way once the
  tensor-parallel sums round differently: measured 3.9% and 0.8%); the
  train step's loss within a relative 1e-3 (measured up to 7.5e-5) and
  its gradients (the first moments after one step) within the per-leaf
  relative L2 of `tests/test_torch_train.py`, 0.08 and 0.2 for MoE
  (measured up to 0.028, and 0.098 for the shard-map MoE).  The shard-map dispatch
  is held against the unsharded port's local dispatch with the same token
  shards (per-shard capacity is its semantics).  Tensor-parallel sums add
  bf16 partials, so parity holds module by module in float32 only.
- Per module in float32 (attention with split and with replicated KV
  heads, the SwiGLU MLP, the shard-map MoE, the vocab-sharded embedding,
  head and loss): outputs and every parameter's gradient within a relative
  L2 1e-5 of the unsharded module's (measured up to 3.5e-7).
- The sharded train step's loss against the reference's jitted sharded
  step on the same weights and batch: relative 1e-3 (measured 8.4e-5).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.dist.sharding import ShardingRules as RRules
from repro.models import transformer as rt
from repro_torch.core.convert import lm_params_from_numpy
from torch_world import run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 32
CASES = {"dense": ("qwen3-4b", {}),
         "kv_replicated": ("granite-34b", {}),
         "moe_global": ("granite-moe-3b-a800m", {}),
         "moe_shardmap": ("granite-moe-3b-a800m",
                          {"moe_dispatch": "shardmap"}),
         "hybrid": ("zamba2-1.2b", {})}
TRAIN_KW = {"microbatch": 2, "remat": "full", "fsdp": True}
LOSS_RTOL = 1e-3
F32_REL = 1e-5
GRAD_REL_L2 = 0.08          # tests/test_torch_train.py's gradient bars
MOE_GRAD_REL_L2 = 0.2

REF_LOSS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, jax, numpy as np
    from repro.configs import registry
    from repro.configs.base import ShapeConfig
    from repro.dist.sharding import ShardingRules
    from repro.models.transformer import init_model
    from repro.optim.adamw import AdamWConfig, init_opt_state
    from repro.train.steps import make_train_step
    cfg = dataclasses.replace(
        registry.reduced_config(registry.get_arch("qwen3-4b")),
        microbatch=2, remat="full", fsdp=True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    rules = ShardingRules(model_size=2, data_size=2, fsdp=True)
    params, _ = init_model(jax.random.PRNGKey(0), cfg, rules)
    tokens = np.load(sys.argv[1])
    fn = make_train_step(cfg, ShapeConfig("t", tokens.shape[1],
                                          tokens.shape[0], "train"), mesh,
                         AdamWConfig(lr=1e-3, warmup_steps=1),
                         donate=False)[0]
    _, _, m = fn(params, init_opt_state(params), {"tokens": tokens})
    print("LOSS", repr(float(m["loss"])))
""")


def _cfg(pkg, name, **kw):
    cfg = pkg.reduced_config(pkg.get_arch(name))
    return dataclasses.replace(cfg, **kw)


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _miss_frac(got, want, atol=0.15, rtol=0.1):
    """Fraction of tokens (rows) with an element off the bf16 bar."""
    bad = (np.abs(got - want) > atol + rtol * np.abs(want)).reshape(
        -1, got.shape[-1]).any(-1)
    return float(bad.mean())


# ---------------------------------------------------------------------------
# the world (4 ranks, a (2, 2) mesh)
# ---------------------------------------------------------------------------


def _steps(rank, inp):
    """Every model case: prefill, decode and one train step, sharded and
    unsharded on the same weights."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import registry as treg
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                         tree_leaves)
    from repro_torch.train.steps import (make_decode_step,
                                         make_prefill_step, make_train_step,
                                         shard_params)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    tokens = inp["tokens"]
    out = {}
    for case, (name, kw) in CASES.items():
        cfg = _cfg(treg, name, **kw)
        unsharded_cfg = cfg
        if kw.get("moe_dispatch") == "shardmap":   # its per-shard semantics
            unsharded_cfg = dataclasses.replace(cfg, moe_dispatch="local",
                                                moe_token_shards=2)
        params = inp["params"][name]
        shape = ShapeConfig("p", S, B, "prefill")
        batch = {"tokens": tokens}
        ref = make_prefill_step(unsharded_cfg, shape, device="cpu",
                                backend="torch")
        step = make_prefill_step(cfg, shape, backend="torch", mesh=mesh)
        sp = shard_params(params, step.in_shardings[0])
        l0, c0 = ref(params, batch)
        l1, c1 = step(sp, batch)
        res = {"prefill": (l1.full_tensor().float(), l0.float())}
        if name.startswith("granite-moe"):      # every position's logits
            from repro_torch.models.transformer import forward
            f1 = forward(sp, cfg, batch, step.rules, mesh, backend="torch")[0]
            f0 = forward(params, unsharded_cfg, batch, backend="torch")[0]
            res["forward"] = (f1.full_tensor().float(), f0.float())
        # decode from the prefill's caches
        dshape = ShapeConfig("d", S + 4, B, "decode")
        dref = make_decode_step(unsharded_cfg, dshape, device="cpu")
        dstep = make_decode_step(cfg, dshape, mesh=mesh)
        s0 = init_decode_state(cfg, S + 4, B, device="cpu")
        for k in c0:
            s0[k][..., :S, :] = c0[k]
        s1 = shard_params(_clone(s0), dstep.in_shardings[2])
        tok = l0.argmax(-1)
        got, want = [], []
        for i in range(3):
            db = {"tokens": tok, "cur_len": S + i}
            a, _ = dref(params, db, s0)
            b, _ = dstep(sp, db, s1)
            want.append(a.float())
            got.append(b.full_tensor().float())
            tok = a.argmax(-1)
        res["decode"] = (torch.cat(got), torch.cat(want))
        # one train step
        tcfg = dataclasses.replace(cfg, **TRAIN_KW)
        tref_cfg = dataclasses.replace(unsharded_cfg, **TRAIN_KW)
        tshape = ShapeConfig("t", S, B, "train")
        opt = AdamWConfig(lr=1e-3, warmup_steps=1)
        tstep = make_train_step(tcfg, tshape, opt, mesh=mesh)
        p1 = shard_params(params, tstep.in_shardings[0])
        o1 = shard_params(init_opt_state(params), tstep.in_shardings[1])
        p0 = _clone(params)
        o0 = init_opt_state(p0)
        _, _, m1 = tstep(p1, o1, batch)
        _, _, m0 = make_train_step(tref_cfg, tshape, opt,
                                   device="cpu")(p0, o0, batch)
        res["loss"] = (float(m1["loss"]), float(m0["loss"]))
        res["grads_rel"] = max(_rel(a.full_tensor(), b) for a, b in zip(
            tree_leaves(o1["m"]), tree_leaves(o0["m"])))
        out[case] = res
    return out


def _clone(t):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in t.items()}


def _modules(rank):
    """float32 modules, sharded against unsharded: outputs and grads."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import registry as treg
    from repro_torch.dist.compat import shard_map, to_dtensor
    from repro_torch.dist.sharding import P, ShardingRules
    from repro_torch.models import spmd
    from repro_torch.models.attention import (attention_layer,
                                              attention_specs,
                                              init_attention)
    from repro_torch.models.common import generator, softmax_xent
    from repro_torch.models.mlp import init_mlp, mlp, mlp_specs
    from repro_torch.models.moe import (init_moe, moe_ffn_local, moe_specs)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = ShardingRules(model_size=2, data_size=2, fsdp=True)
    act = P("data", None, None)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, S, 128, generator=gen)
    w = torch.randn(B, S, 128, generator=gen)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    out = {}

    def f32(t):
        return {k: f32(v) if isinstance(v, dict) else v.float()
                for k, v in t.items()}

    def check(tag, p, s, sharded, plain):
        """`sharded(p_local, x_local)` in a shard_map against `plain(p,
        x)`: output and the gradients of <out, w> for x and every leaf."""
        pd = {k: to_dtensor(v, mesh, s[k]).detach().requires_grad_()
              for k, v in p.items()}
        xd = to_dtensor(x, mesh, act).detach().requires_grad_()
        y = shard_map(sharded, mesh=mesh, in_specs=(s, act), out_specs=act,
                      varying=("data",))(pd, xd)
        (y.to_local() * to_dtensor(w, mesh, act).to_local()).sum() \
            .backward()
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        y0 = plain(pp, xx)
        (y0 * w).sum().backward()
        rel = {"out": _rel(y.full_tensor(), y0),
               "x": _rel(xd.grad.full_tensor(), xx.grad)}
        for k in p:
            g = pd[k].grad
            g = g.redistribute(mesh, pd[k].placements) if isinstance(
                g, DTensor) else g
            rel[k] = _rel(g.full_tensor(), pp[k].grad)
        out[tag] = rel

    for tag, name in (("attention", "qwen3-4b"),
                      ("attention_kv_replicated", "granite-34b")):
        cfg = _cfg(treg, name)
        p = f32(init_attention(generator(torch.device("cpu"), 1), cfg))
        s = attention_specs(cfg, rules)
        check(tag, p, s,
              lambda pl, xl, s=s, cfg=cfg: spmd.attention_tp(
                  pl, s, cfg, xl, pos[:xl.shape[0]], backend="torch"),
              lambda pp, xx, cfg=cfg: attention_layer(pp, cfg, xx, pos,
                                                      backend="torch"))
    cfg = _cfg(treg, "qwen3-4b")
    p = f32(init_mlp(generator(torch.device("cpu"), 2), cfg))
    s = mlp_specs(cfg, rules)
    check("mlp", p, s, lambda pl, xl: spmd.mlp_tp(pl, s, cfg, xl),
          lambda pp, xx: mlp(pp, cfg, xx))
    mcfg = dataclasses.replace(_cfg(treg, "granite-moe-3b-a800m"),
                               moe_token_shards=2)
    p = f32(init_moe(generator(torch.device("cpu"), 3), mcfg))
    s = moe_specs(mcfg, rules)
    check("moe_shardmap", p, s,
          lambda pl, xl: spmd.moe_tp(pl, s, mcfg, xl, ("data",),
                                     "shardmap")[0],
          lambda pp, xx: moe_ffn_local(pp, mcfg, xx)[0])

    # embedding, head and loss, the vocab on model (V 512, tied)
    V = 512
    table = torch.randn(V, 128, generator=gen) * 0.3
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, V, (B, S))).long()
    mask = torch.ones(B, S)
    mask[:, -1] = 0
    es = rules.embed(V, 128)
    hs = {"final_norm": P(None), "embed": es}
    fn = torch.ones(128)

    def loss_sharded(pl, tk):
        h = spmd.embed_tp(pl["embed"], es, tk).float()
        lg = spmd.logits_tp(pl, hs, cfg, h)
        lab = torch.roll(tk, -1, 1)
        m = mask[:tk.shape[0]]
        return spmd.xent_tp(lg, lab, m, True, ("data",))

    pd = {"final_norm": to_dtensor(fn, mesh, P(None)).requires_grad_(),
          "embed": to_dtensor(table, mesh, es).requires_grad_()}
    share = shard_map(loss_sharded, mesh=mesh, in_specs=(hs, P("data", None)),
                      out_specs=None, varying=("data",))(pd, tok)
    share.backward()
    tt = table.clone().requires_grad_()
    h0 = tt[tok].to(torch.bfloat16).float()
    from repro_torch.models.common import rms_norm
    lg0 = rms_norm(h0, fn) @ tt.T
    l0 = softmax_xent(lg0, torch.roll(tok, -1, 1), mask)
    l0.backward()
    total = share.detach().clone()
    import torch.distributed as dist
    dist.all_reduce(total)
    g = pd["embed"].grad.redistribute(mesh, pd["embed"].placements)
    out["embed_head_loss"] = {"out": _rel(total / 2, l0.detach()),
                              "embed": _rel(g.full_tensor(), tt.grad)}
    return out


def _world(rank, path):
    inp = torch.load(path)
    return {"steps": _steps(rank, inp), "modules": _modules(rank)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    tokens = np.random.default_rng(0).integers(0, 512, (B, S)).astype(
        np.int32)
    np.save(d / "tokens.npy", tokens)
    ref = subprocess.Popen([sys.executable, "-c", REF_LOSS,
                            str(d / "tokens.npy")], cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True,
                           env={**os.environ, "PYTHONPATH": "src",
                                "JAX_PLATFORMS": "cpu"})
    rules = RRules(model_size=1, data_size=1)
    params = {}
    for name in {n for n, _ in CASES.values()}:
        rp, _ = rt.init_model(jax.random.PRNGKey(0),
                              _cfg(rreg, name), rules)
        params[name] = lm_params_from_numpy(jax.tree.map(np.asarray, rp),
                                            device="cpu")
    torch.save({"tokens": torch.from_numpy(tokens), "params": params},
               d / "in.pt")
    outs = run_world(_world, 4, str(d / "in.pt"))
    so, se = ref.communicate(timeout=120)
    line = [ln for ln in so.splitlines() if ln.startswith("LOSS")]
    assert line, se[-3000:]
    return {"outs": outs, "ref_loss": float(line[0][4:])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_prefill_and_decode_match_unsharded(world, case):
    res = world["outs"][0]["steps"][case]
    # MoE: every position of the prefill (its last is the prefill's output,
    # 4 rows) and the decode steps, per token
    for what in ("forward", "decode") if case.startswith("moe") else \
            ("prefill", "decode"):
        got, want = res[what]
        if case.startswith("moe"):
            assert _miss_frac(got, want) <= 0.1, (what, case)
        else:
            np.testing.assert_allclose(got, want, atol=0.15, rtol=0.1)
    for o in world["outs"][1:]:     # every rank holds the same result
        np.testing.assert_array_equal(o["steps"][case]["prefill"][0],
                                      res["prefill"][0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_train_step_matches_unsharded(world, case):
    res = world["outs"][0]["steps"][case]
    got, want = res["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    bar = MOE_GRAD_REL_L2 if case.startswith("moe") else GRAD_REL_L2
    assert res["grads_rel"] <= bar, res["grads_rel"]
    assert len({o["steps"][case]["loss"][0] for o in world["outs"]}) == 1


@pytest.mark.parametrize("module", ["attention", "attention_kv_replicated",
                                    "mlp", "moe_shardmap",
                                    "embed_head_loss"])
def test_float32_modules_match_unsharded(world, module):
    for o in world["outs"]:
        rel = o["modules"][module]
        worst = max(rel, key=rel.get)
        assert rel[worst] <= F32_REL, (module, worst, rel[worst])


def test_sharded_loss_matches_reference_sharded_step(world):
    got = world["outs"][0]["steps"]["dense"]["loss"][0]
    np.testing.assert_allclose(got, world["ref_loss"], rtol=LOSS_RTOL)
