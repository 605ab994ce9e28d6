"""The port's LM serving path (dense family) vs the reference's.

Weights come from the reference's `init_model` and cross to the port by
`lm_params_from_numpy`; every other input is drawn with numpy from a seed
and handed to both packages.  On the CPU the port's attention with
``backend="cuda"`` takes the kernel's plain twin `mha_ref` (the tensors
lie on the CPU); tests/test_torch_cuda.py runs the kernel on a GPU.

Tolerances:
- module level, float32 weights and inputs: atol = rtol = 1e-5 (the two
  packages sum in other orders; float32 keeps about 7 digits);
- whole model in bfloat16: atol 0.15, rtol 0.1 on logits, the reference's
  own bar for two bf16 computations of the same logits
  (tests/test_models_smoke.py, prefill against decode), since bf16 keeps
  about 3 digits and every layer rounds its activations;
- KV caches, bf16: atol = rtol = 0.1 (a cache entry is one projection
  plus rotary of an activation that has passed bf16 layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import shape_applicable as r_shape_applicable
from repro.dist.sharding import ShardingRules
from repro.models import attention as ra
from repro.models import common as rcm
from repro.models import mlp as rmlp
from repro.models import transformer as rt
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.models import attention as ta
from repro_torch.models import common as tcm
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as tt
from repro_torch.train.steps import make_decode_step, make_prefill_step

RULES = ShardingRules(model_size=1, data_size=1, fsdp=False)
DENSE = ["qwen3-4b", "yi-6b", "minitron-8b", "granite-34b"]
F32_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=0.15, rtol=0.1)
CACHE_TOL = dict(atol=0.1, rtol=0.1)


def _cfgs(name):
    return (rreg.reduced_config(rreg.get_arch(name)),
            treg.reduced_config(treg.get_arch(name)))


def _f32(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


_MODELS = {}


def _model(name):
    """Reference params (bf16, PRNGKey 0) and the port's copy, per config."""
    if name not in _MODELS:
        rcfg, tcfg = _cfgs(name)
        params, _ = rt.init_model(jax.random.PRNGKey(0), rcfg, RULES)
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
        _MODELS[name] = (rcfg, tcfg, params, tp)
    return _MODELS[name]


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_equal_reference():
    assert list(treg.ARCHS) == list(rreg.ARCHS)
    for name, rcfg in rreg.ARCHS.items():
        tcfg = treg.get_arch(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        assert tcfg.head_dim == rcfg.head_dim
        assert tcfg.vocab_padded == rcfg.vocab_padded
        assert tcfg.param_count() == rcfg.param_count()
        assert tcfg.active_param_count() == rcfg.active_param_count()
        assert (dataclasses.asdict(treg.reduced_config(tcfg))
                == dataclasses.asdict(rreg.reduced_config(rcfg)))
        for shape in R_SHAPES:
            assert (shape_applicable(tcfg, SHAPES[shape])
                    == r_shape_applicable(rcfg, R_SHAPES[shape]))
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in R_SHAPES.items()}


def test_qwen3_4b_size():
    cfg = treg.get_arch("qwen3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_padded) == (
        36, 2560, 32, 8, 128, 9728, 152064)
    assert cfg.param_count() == 4_022_458_880   # raw vocab, as the reference counts


# ---------------------------------------------------------------------------
# module level, float32
# ---------------------------------------------------------------------------


def test_rms_norm_and_qk_norm_match_reference():
    rng = np.random.default_rng(0)
    x, w = _f32(rng, 2, 5, 64), _f32(rng, 64)
    np.testing.assert_allclose(
        _np(tcm.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(rcm.rms_norm(jnp.asarray(x), jnp.asarray(w))), **F32_TOL)
    xh, wh = _f32(rng, 2, 5, 4, 32), _f32(rng, 32)
    np.testing.assert_allclose(
        _np(tcm.head_rms_norm(torch.from_numpy(xh), torch.from_numpy(wh))),
        _np(rcm.head_rms_norm(jnp.asarray(xh), jnp.asarray(wh))), **F32_TOL)


def test_rms_norm_bf16_casts_before_the_weight():
    """bf16: the normalised x is rounded to bf16 before the product with
    w, as in the reference; the results are bit-identical."""
    rng = np.random.default_rng(1)
    x, w = _f32(rng, 3, 128), _f32(rng, 128)
    got = tcm.rms_norm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16())
    want = rcm.rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                        jnp.asarray(w).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("theta", [1e4, 1e6, 5e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(2)
    x = _f32(rng, 2, 64, 4, 32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32)[None], (2, 64))
    np.testing.assert_array_equal(tcm.rope_freqs(32, theta),
                                  rcm.rope_freqs(32, theta))
    np.testing.assert_allclose(
        _np(tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                           theta)),
        _np(rcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        **F32_TOL)


def test_mrope_matches_reference():
    rng = np.random.default_rng(3)
    x = _f32(rng, 2, 16, 4, 32)
    pos = rng.integers(0, 40, size=(2, 16, 3)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tcm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                            (16, 24, 24), 1e6)),
        _np(rcm.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (16, 24, 24),
                            1e6)), **F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_activations_match_reference(act):
    x = _f32(np.random.default_rng(4), 1000) * 4
    np.testing.assert_allclose(_np(tcm.ACTS[act](torch.from_numpy(x))),
                               _np(rcm.ACTS[act](jnp.asarray(x))), **F32_TOL)


def test_silu_bf16_matches_reference_bit_for_bit():
    """bf16: `jax.nn.silu` rounds after each of its steps (negate, exp,
    add, divide, multiply) and so does the port's `silu`; `F.silu`, one
    rounding, differs in most elements."""
    x = _f32(np.random.default_rng(9), 4096) * 4
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    got = tcm.silu(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(jax.nn.silu(jx)))
    assert (_np(torch.nn.functional.silu(tx)) != _np(got)).mean() > 0.1


@pytest.mark.parametrize("name,kind", [("qwen3-4b", "swiglu"),
                                       ("granite-34b", "gelu"),
                                       ("minitron-8b", "relu2")])
def test_mlp_kinds_match_reference(name, kind):
    rcfg, tcfg = _cfgs(name)
    assert tcfg.mlp_kind == kind
    rng = np.random.default_rng(5)
    D, Fd = tcfg.d_model, tcfg.d_ff
    names = (("w_gate", D, Fd), ("w_up", D, Fd), ("w_down", Fd, D)) \
        if kind == "swiglu" else (("w_in", D, Fd), ("w_out", Fd, D))
    p = {k: _f32(rng, a, b) * a ** -0.5 for k, a, b in names}
    x = _f32(rng, 2, 8, D)
    got = tmlp.mlp({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                   torch.from_numpy(x))
    want = rmlp.mlp({k: jnp.asarray(v) for k, v in p.items()}, rcfg,
                    jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    gen = torch.Generator().manual_seed(0)
    shapes = {k: tuple(v.shape) for k, v in tmlp.init_mlp(gen, tcfg).items()}
    assert shapes == {k: (a, b) for k, a, b in names}


@pytest.mark.parametrize("H,KH,window,chunk,causal", [
    (4, 4, 0, 16, True), (4, 2, 0, 16, True), (4, 1, 0, 64, True),
    (4, 4, 0, 16, False), (4, 2, 0, 16, False), (4, 1, 0, 64, False),
    (4, 2, 48, 16, True), (4, 1, 48, 32, True)])
def test_blocked_attention_matches_reference_xla(H, KH, window, chunk,
                                                 causal):
    """The torch walk (chunks of 16 over S = 64: the triangular kv walk
    and the window's lower edge) and the kernel backend (its twin here)
    against the reference's XLA path.  Windows are causal only, as in
    `mha_ref`'s contract."""
    rng = np.random.default_rng(H * 10 + KH + window)
    q, k, v = _f32(rng, 2, 64, H, 32), _f32(rng, 2, 64, KH, 32), \
        _f32(rng, 2, 64, KH, 32)
    want = _np(ra.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=chunk, kv_chunk=chunk, backend="xla"))
    for backend in ("torch", "cuda"):
        got = ta.blocked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, window=window, q_chunk=chunk, kv_chunk=chunk,
            backend=backend)
        assert got.shape == (2, 64, H, 32)
        np.testing.assert_allclose(_np(got), want, **F32_TOL)


@pytest.mark.parametrize("name", ["qwen3-4b", "yi-6b"])
def test_attention_projections_and_layer_match_reference(name):
    """attn_qkv (qk-norm for qwen3-4b, rotary at its theta), the Q-only and
    KV-only projections, and the whole layer with its KV output, float32
    weights from the reference's init."""
    rcfg, tcfg = _cfgs(name)
    rp, _ = ra.init_attention(jax.random.PRNGKey(2), rcfg, RULES)
    rp = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    tp = {k: torch.from_numpy(v) for k, v in rp.items()}
    jp = {k: jnp.asarray(v) for k, v in rp.items()}
    rng = np.random.default_rng(8)
    x = _f32(rng, 2, 32, tcfg.d_model)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32)[None], (2, 32)).copy()
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for got, want in zip(ta.attn_qkv(tp, tcfg, tx, torch.from_numpy(pos)),
                         ra.attn_qkv(jp, rcfg, jx, jnp.asarray(pos))):
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(ta.attn_q_only(tp, tcfg, tx)),
                               _np(ra.attn_q_only(jp, rcfg, jx)), **F32_TOL)
    for got, want in zip(ta.attn_kv_only(tp, tcfg, tx),
                         ra.attn_kv_only(jp, rcfg, jx)):
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    want, (wk, wv) = ra.attention_layer(jp, rcfg, jx, jnp.asarray(pos),
                                        return_kv=True)
    for backend in ("torch", "cuda"):
        got, (gk, gv) = ta.attention_layer(tp, tcfg, tx,
                                           torch.from_numpy(pos),
                                           backend=backend, return_kv=True)
        for g, w in ((got, want), (gk, wk), (gv, wv)):
            np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(6 + window)
    q = _f32(rng, 2, 1, 4, 32)
    kc, vc = _f32(rng, 2, 2, 40, 32), _f32(rng, 2, 2, 40, 32)
    for cur in (1, 17, 40):
        want = ra.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.int32(cur),
                                   window=window)
        for c in (cur, torch.tensor(cur, dtype=torch.int32)):
            got = ta.decode_attention(torch.from_numpy(q),
                                      torch.from_numpy(kc),
                                      torch.from_numpy(vc), c, window=window)
            np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# ---------------------------------------------------------------------------
# whole model, bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_and_caches_match_reference(name):
    """Logits at the reference's bf16 bar (atol 0.15, rtol 0.1), caches at
    atol = rtol = 0.1; both backends."""
    rcfg, tcfg, params, tp = _model(name)
    toks = _tokens(rcfg, 2, 64)
    want, _, rc = rt.forward(params, rcfg, {"tokens": jnp.asarray(toks)},
                             want_cache=True)
    for backend in ("cuda", "torch"):
        got, aux, tc = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                  backend=backend, want_cache=True)
        assert got.shape == (2, 64, tcfg.vocab_padded)
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
        for kv in ("k", "v"):
            assert tc[kv].shape == rc[kv].shape
            np.testing.assert_allclose(_np(tc[kv]), _np(rc[kv]), **CACHE_TOL)
        assert float(aux["moe_drop_frac"]) == 0.0


@pytest.mark.parametrize("name", DENSE)
def test_decode_step_matches_reference(name):
    """One decode step against the reference's, from the same state (the
    reference's prefill caches stitched into a state of S + 16 slots):
    logits at atol 0.15 / rtol 0.1, the written cache slot at 0.1."""
    rcfg, tcfg, params, tp = _model(name)
    B, S = 2, 48
    toks = _tokens(rcfg, B, S + 1, seed=7)
    _, _, rc = rt.forward(params, rcfg, {"tokens": jnp.asarray(toks[:, :S])},
                          want_cache=True)
    state = rt.init_decode_state(rcfg, S + 16, B)
    state = {k: jax.lax.dynamic_update_slice(state[k], rc[k],
                                             (0, 0, 0, 0, 0))
             for k in ("k", "v")}
    tstate = lm_params_from_numpy(jax.tree.map(np.asarray, state),
                                  device="cpu")
    dbatch = {"tokens": jnp.asarray(toks[:, S:]), "cur_len": jnp.int32(S)}
    want, rnew = rt.decode_step(params, rcfg, dbatch, state)
    got, tnew = tt.decode_step(tp, tcfg, {"tokens": torch.from_numpy(
        toks[:, S:]), "cur_len": S}, tstate)
    assert got.shape == (B, 1, tcfg.vocab_padded)
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    assert tnew is tstate                         # updated in place
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tnew[kv]), _np(rnew[kv]), **CACHE_TOL)
        assert not tnew[kv][:, :, :, S + 1:].any()


@pytest.mark.parametrize("name", ["qwen3-4b", "granite-34b", "yi-6b"])
def test_prefill_decode_consistency(name):
    """The port alone: decode at position S must match the full forward at
    position S (the reference's test, tests/test_models_smoke.py), at its
    bar atol 0.15 / rtol 0.1, with the caches stitched at 0 into a state of
    S + 16 slots; through the serving step factories."""
    _, cfg, _, params = _model(name)
    B, S = 2, 64
    toks = torch.from_numpy(_tokens(cfg, B, S + 1))
    full, _, _ = tt.forward(params, cfg, {"tokens": toks})
    prefill = make_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"),
                                device="cpu")
    last, caches = prefill(params, {"tokens": toks[:, :S]})
    np.testing.assert_array_equal(_np(last), _np(full[:, S - 1:S]))
    state = tt.init_decode_state(cfg, S + 16, B, device="cpu")
    for k in ("k", "v"):
        state[k][:, :, :, :S] = caches[k]
    decode = make_decode_step(cfg, ShapeConfig("d", S + 16, B, "decode"),
                              device="cpu")
    dec, _ = decode(params, {"tokens": toks[:, S:S + 1],
                             "cur_len": torch.tensor(S, dtype=torch.int32)},
                    state)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, S]), **LOGIT_TOL)


def test_serving_steps_check_their_shape():
    _, cfg, _, params = _model("qwen3-4b")
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    with pytest.raises(ValueError):
        make_prefill_step(cfg, ShapeConfig("p", 16, 4, "prefill"),
                          device="cpu")(params, {"tokens": toks})
    state = tt.init_decode_state(cfg, 20, 2, device="cpu")
    with pytest.raises(ValueError):
        make_decode_step(cfg, ShapeConfig("d", 32, 2, "decode"),
                         device="cpu")(
            params, {"tokens": toks[:, :1], "cur_len": 3}, state)


def test_lm_params_from_numpy_round_trips_bf16_bit_for_bit():
    rcfg, _, params, tp = _model("qwen3-4b")
    flat_r = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat_r:
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(leaf)
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    f32 = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
           "i": np.arange(3, dtype=np.int32)}
    got = lm_params_from_numpy(f32, device="cpu")
    assert got["w"].dtype == torch.float32 and got["i"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].numpy(), f32["w"])


def test_init_model_shapes_match_reference():
    rcfg, tcfg, params, _ = _model("qwen3-4b")
    tp = tt.init_model(tcfg, seed=3, device="cpu")
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict)
                           else tuple(v.shape) for k, v in tree.items()}
    assert shapes(tp) == shapes(jax.tree.map(np.asarray, params))
    again = tt.init_model(tcfg, seed=3, device="cpu")
    assert torch.equal(tp["blocks"]["mlp"]["w_up"],
                       again["blocks"]["mlp"]["w_up"])
    # every layer has its own draw
    w = tp["blocks"]["attn"]["wq"]
    assert not torch.equal(w[0], w[1])
    std = w.float().std().item()
    assert abs(std - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5
    assert tt.param_bytes(tp) == 2 * sum(
        np.asarray(x).size for x in jax.tree.leaves(params))
