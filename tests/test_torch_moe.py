"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`), on the reduced MoE configs.

Weights come from the reference's `init_moe` (cast to float32) or are
drawn with numpy from a seed, and cross to the port as numpy arrays.

Tolerances:
- outputs of the float32 dispatch (`moe_ffn`, `moe_ffn_local`, through
  `moe_apply`): atol = rtol = 1e-5 (the expert products sum in other
  orders);
- routing: bit for bit.  Top-k expert ids and gate logits, the rank of
  each (token, choice) pair within its expert, `keep`, `dest` and the
  dropped fraction are equal, with ties planted by giving two experts
  identical `w_gate` columns (their logits are then equal in both
  packages), at capacity factors that drop pairs and that drop none.
  The reference returns only the dropped fraction, so its routing is
  recomputed here from its own operations (`moe.py:44-61`: `lax.top_k`,
  stable `argsort`, `searchsorted`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.dist.sharding import ShardingRules
from repro.models import moe as rmoe
from repro_torch.configs import registry as treg
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.models import moe as tmoe

RULES = ShardingRules(model_size=1, data_size=1, fsdp=False)
MOE = ["granite-moe-3b-a800m", "mixtral-8x22b"]
F32_TOL = dict(atol=1e-5, rtol=1e-5)
FACTORS = [1.25, 0.5, 4.0]      # the default, heavy drops, no drops


def _cfgs(name, **kw):
    r = rreg.reduced_config(rreg.get_arch(name))
    t = treg.reduced_config(treg.get_arch(name))
    return dataclasses.replace(r, **kw), dataclasses.replace(t, **kw)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _params(cfg, seed=0, tie=True):
    """The reference's `init_moe` in float32; with `tie`, experts 1 and 2
    get expert 0's gate column, so their logits tie exactly."""
    p, _ = rmoe.init_moe(jax.random.PRNGKey(seed), cfg, RULES)
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    if tie:
        p["w_gate"][:, 1] = p["w_gate"][:, 0]
        p["w_gate"][:, 2] = p["w_gate"][:, 0]
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            lm_params_from_numpy(p, device="cpu"))


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)


def _ref_route(logits, k, C):
    """The reference's routing (`moe_ffn`, moe.py:44-61) on given
    logits."""
    E = logits.shape[-1]
    T = logits.shape[0]
    gate, eidx = jax.lax.top_k(logits, k)
    e_flat = eidx.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = jnp.searchsorted(e_sorted, jnp.arange(E))
    rank_sorted = jnp.arange(T * k) - starts[e_sorted]
    rank = jnp.zeros(T * k, jnp.int32).at[order].set(
        rank_sorted.astype(jnp.int32))
    keep = rank < C
    dest = jnp.where(keep, e_flat * C + rank, E * C)
    return gate, eidx, e_flat, rank, keep, dest


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("cf", FACTORS)
def test_routing_equals_reference_bit_for_bit(name, cf):
    rcfg, tcfg = _cfgs(name)
    p = _params(rcfg)
    x = _x(rcfg, 2, 48)
    T, E, k = 96, rcfg.n_experts, rcfg.moe_top_k
    C = tmoe.capacity(T, k, E, cf)
    assert C == max(1, int(T * k / E * cf))
    # the planted ties hold in both packages' products
    jl = np.asarray((jnp.asarray(x).reshape(T, -1)
                     @ jnp.asarray(p["w_gate"])).astype(jnp.float32))
    tl = (torch.from_numpy(x).reshape(T, -1)
          @ torch.from_numpy(p["w_gate"])).float().numpy()
    for lg in (jl, tl):
        assert np.array_equal(lg[:, 0], lg[:, 1])
        assert np.array_equal(lg[:, 0], lg[:, 2])
    assert np.abs(jl - tl).max() < 1e-5
    # same logits in: every routing output equal
    want = _ref_route(jnp.asarray(jl), k, C)
    got = tmoe.route(torch.from_numpy(jl.copy()), k, C)
    for g, w, what in zip(got, want, ("gate", "eidx", "e_flat", "rank",
                                      "keep", "dest")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    # a tie is chosen among the routed pairs (so the tie rule is exercised)
    eidx = got[1].numpy()
    tied = np.isin(eidx, [0, 1, 2]).sum(axis=1)
    assert (tied >= 2).any() or k == 1
    # drop fraction through the reference's and the port's moe_ffn
    jp, tp = _both(p)
    _, rd = rmoe.moe_ffn(jp, rcfg, jnp.asarray(x), capacity_factor=cf)
    _, td = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x), capacity_factor=cf)
    assert float(td) == float(rd)
    assert (float(td) > 0) == (cf < 4.0)


def test_top_k_orders_ties_by_lower_index():
    lg = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = tmoe.top_k(lg, 3)
    assert idx.tolist() == [[1, 2, 4]]
    rv, ri = jax.lax.top_k(jnp.asarray(lg.numpy()), 3)
    assert np.asarray(ri).tolist() == idx.tolist()
    assert np.asarray(rv).tolist() == vals.tolist()


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ffn_matches_reference_float32(name, cf):
    rcfg, tcfg = _cfgs(name)
    jp, tp = _both(_params(rcfg))
    x = _x(rcfg, 2, 48, seed=3)
    want, rd = rmoe.moe_ffn(jp, rcfg, jnp.asarray(x), capacity_factor=cf)
    got, td = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x), capacity_factor=cf)
    assert got.shape == (2, 48, tcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert float(td) == float(rd)


@pytest.mark.parametrize("name", MOE)
def test_moe_apply_local_dispatch_matches_reference(name):
    """``moe_dispatch="local"`` with 2 token shards: each shard ranked and
    dropped on its own (`moe_ffn_local`), through both `moe_apply`s."""
    rcfg, tcfg = _cfgs(name, moe_dispatch="local", moe_token_shards=2)
    jp, tp = _both(_params(rcfg))
    x = _x(rcfg, 4, 24, seed=4)
    want, rd = rmoe.moe_apply(jp, rcfg, jnp.asarray(x))
    got, td = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert float(td) == float(rd)
    # local differs from the global dispatch when capacity binds per shard
    glob, gd = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x))
    assert float(gd) != float(td) or not torch.equal(glob, got)
    # B not divisible by the shards: one shard, the global dispatch
    x3 = _x(rcfg, 3, 24, seed=5)
    one, od = tmoe.moe_ffn_local(tp, tcfg, torch.from_numpy(x3))
    ref3, rd3 = rmoe.moe_ffn_local(jp, rcfg, jnp.asarray(x3))
    np.testing.assert_allclose(_np(one), _np(ref3), **F32_TOL)
    assert float(od) == float(rd3)


@pytest.mark.parametrize("dispatch", ["global", "shardmap"])
def test_moe_apply_without_mesh_takes_global_dispatch(dispatch):
    """As the reference's `moe_apply` without a mesh: "shardmap" (and
    "local" with one token shard) run `moe_ffn`."""
    rcfg, tcfg = _cfgs("granite-moe-3b-a800m", moe_dispatch=dispatch)
    jp, tp = _both(_params(rcfg))
    x = _x(rcfg, 2, 16, seed=6)
    got, td = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    want, wd = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x))
    assert torch.equal(got, want) and float(td) == float(wd)
    ref, rd = rmoe.moe_apply(jp, rcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(ref), **F32_TOL)


@pytest.mark.parametrize("name", MOE)
def test_decode_sized_dispatch_drops_as_reference(name):
    """At decode T = B: C = max(1, int(B·k/E·1.25)), most pairs drop."""
    rcfg, tcfg = _cfgs(name)
    jp, tp = _both(_params(rcfg, tie=False))
    x = _x(rcfg, 2, 1, seed=7)
    want, rd = rmoe.moe_ffn(jp, rcfg, jnp.asarray(x))
    got, td = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert float(td) == float(rd)


def test_dropped_pairs_never_overwrite_the_last_slot():
    """Every pair goes to one expert with capacity 1: the kept pair fills
    slot 0 of that expert and the dropped ones go to the trash row, so the
    output of the first token is its own expert product and the others
    are zero."""
    _, tcfg = _cfgs("mixtral-8x22b", n_experts=2, moe_top_k=1)
    D, Fd = tcfg.d_model, tcfg.moe_d_ff
    g = torch.Generator().manual_seed(0)
    p = {"w_gate": torch.zeros(D, 2),
         "we_gate": torch.randn(2, D, Fd, generator=g) * 0.1,
         "we_up": torch.randn(2, D, Fd, generator=g) * 0.1,
         "we_down": torch.randn(2, Fd, D, generator=g) * 0.1}
    p["w_gate"][:, 1] = 1.0                   # every token prefers expert 1
    x = torch.rand(1, 3, D, generator=g) + 0.5
    y, drop = tmoe.moe_ffn(p, tcfg, x, capacity_factor=0.5)   # C = 1
    assert abs(float(drop) - 2 / 3) < 1e-7
    one = tmoe._experts(x[0, :1].reshape(1, 1, D).expand(2, 1, D), p)[1]
    torch.testing.assert_close(y[0, 0], one[0], **F32_TOL)
    assert not y[0, 1:].any()


@pytest.mark.parametrize("name", MOE)
def test_bf16_combine_adds_choices_in_order(name):
    """bf16, the reference's own weights and one same input: the outputs
    agree at one bf16 rounding of the largest term, and the drop
    fractions exactly (the routing is the same)."""
    rcfg, tcfg = _cfgs(name)
    params, _ = rmoe.init_moe(jax.random.PRNGKey(2), rcfg, RULES)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    x = jnp.asarray(_x(rcfg, 2, 32, seed=8)).astype(jnp.bfloat16)
    want, rd = rmoe.moe_ffn(params, rcfg, x)
    got, td = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(
        np.array(x.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
    assert float(td) == float(rd)


@pytest.mark.parametrize("name", MOE)
def test_init_moe_shapes_match_reference(name):
    rcfg, tcfg = _cfgs(name)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(0), rcfg, RULES)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in rp.items()}
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    w = tp["we_up"].float()
    assert not torch.equal(w[0], w[1])            # each expert its own draw
    assert abs(w.std().item() - tcfg.d_model ** -0.5) < 0.1 * \
        tcfg.d_model ** -0.5


def _ref_forward_unrolled(params, cfg, tokens):
    """The reference's dense-stack `forward` (transformer.py:153-180,
    239-246) with its `lax.scan` unrolled into a loop over layers, so that
    float32 weights can run: the scan's carry must keep the embedding's
    bf16, and float32 weights promote the residual to float32."""
    from repro.models import common as rcm
    from repro.models import transformer as rt
    B, S = tokens.shape
    h = jnp.asarray(params["embed"][tokens], jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    drops, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda x: x[i], params["blocks"])
        h, a, (k, v) = rt._dense_block(lp, cfg, h, pos, want_kv=True)
        drops.append(a)
        ks.append(k)
        vs.append(v)
    h = rcm.rms_norm(h, params["final_norm"])
    return h @ params["head"], jnp.mean(jnp.stack(drops)), \
        jnp.stack(ks), jnp.stack(vs)


@pytest.mark.parametrize("name", MOE)
def test_whole_model_float32_routes_as_reference(name):
    """The reduced MoE models with the reference's weights in float32:
    activations are float32 from the first residual add, so no gate logit
    sits within rounding of a tie and every token routes as in the
    reference.  The dropped fraction (mean over layers) is equal bit for
    bit, logits and KV caches at atol = rtol = 1e-3 (four layers of
    float32 products summed in other orders).  In bf16 a near-tie can
    route one token another way (tests/test_torch_families.py)."""
    from repro.models import transformer as rt
    from repro_torch.models import transformer as tt
    rcfg, tcfg = _cfgs(name)
    params, _ = rt.init_model(jax.random.PRNGKey(0), rcfg, RULES)
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    toks = np.random.default_rng(5).integers(
        0, rcfg.vocab, size=(2, 64)).astype(np.int32)
    want, rdrop, rk, rv = _ref_forward_unrolled(
        jax.tree.map(jnp.asarray, p32), rcfg, jnp.asarray(toks))
    got, aux, tc = tt.forward(lm_params_from_numpy(p32, device="cpu"), tcfg,
                              {"tokens": torch.from_numpy(toks)},
                              want_cache=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)
    for t, r in ((tc["k"], rk), (tc["v"], rv)):
        np.testing.assert_allclose(_np(t), _np(r), atol=1e-3, rtol=1e-3)
    assert float(aux["moe_drop_frac"]) == float(rdrop) > 0
