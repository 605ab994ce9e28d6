"""The port's LM serving path for the non-dense families against the
reference's: MoE (granite-moe-3b-a800m, mixtral-8x22b), VLM
(qwen2-vl-72b), enc-dec (seamless-m4t-medium), hybrid (zamba2-1.2b) and
SSM (xlstm-125m), each at its `reduced_config`.

Weights come from the reference's `init_model` and cross to the port by
`lm_params_from_numpy`; every other input (tokens, M-RoPE positions,
image and encoder embeddings) is drawn with numpy from a seed and handed
to both packages.  The reference runs its XLA path; the port runs
``backend="torch"`` and ``backend="cuda"`` (whose wrapper takes the
kernel's plain twin for CPU tensors).

Tolerances, the reference's own for two bf16 computations of the same
logits (tests/test_models_smoke.py): logits atol 0.15 / rtol 0.1, caches
and recurrent states atol = rtol = 0.1; float32 layers at 1e-5.

MoE in bf16: routing is discrete.  A token whose gate logits sit within
one bf16 rounding of a tie routes one way or the other depending on the
last bit of its hidden state, which two implementations (or one on other
hardware) do not share; the token's FFN output then differs by a whole
expert, and attention carries a little of it to later tokens.  So for
the MoE configs in bf16 every token but at most `MOE_FLIP_TOKENS` of them
must hold the bar (observed: granite-moe 1 of 128 tokens' logits, mixtral
2 of 128; no cached position; no decode step), and tests/test_torch_moe.py holds the same models in
float32, where the routing is the reference's: the dropped fraction equal
bit for bit and every logit and cache at 1e-3.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.dist.sharding import ShardingRules
from repro.models import attention as ra
from repro.models import transformer as rt
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.train.steps import make_decode_step, make_prefill_step

RULES = ShardingRules(model_size=1, data_size=1, fsdp=False)
FAMILIES = ["granite-moe-3b-a800m", "mixtral-8x22b", "qwen2-vl-72b",
            "seamless-m4t-medium", "zamba2-1.2b", "xlstm-125m"]
MOE = FAMILIES[:2]
LOGIT_TOL = dict(atol=0.15, rtol=0.1)
CACHE_TOL = dict(atol=0.1, rtol=0.1)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
MOE_FLIP_TOKENS = 0.10          # share of tokens a bf16 routing flip may take
B, S = 2, 64


def test_every_family_is_covered():
    assert sorted(FAMILIES) == sorted(
        n for n, c in rreg.ARCHS.items() if c.family != "dense")
    assert {treg.get_arch(n).family for n in FAMILIES} == {
        "moe", "vlm", "encdec", "hybrid", "ssm"}


def _cfgs(name):
    return (rreg.reduced_config(rreg.get_arch(name)),
            treg.reduced_config(treg.get_arch(name)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


_MODELS = {}


def _model(name):
    """Reference params (PRNGKey 0) and the port's copy, per config."""
    if name not in _MODELS:
        rcfg, tcfg = _cfgs(name)
        params, _ = rt.init_model(jax.random.PRNGKey(0), rcfg, RULES)
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
        _MODELS[name] = (rcfg, tcfg, params, tp)
    return _MODELS[name]


def mrope_positions(B, S, n_img, grid_w):
    """Qwen2-VL positions (B, S, 3): the image tokens on a (t, h, w) grid
    of one frame, `grid_w` wide; the text after it at max + 1 + i in all
    three components."""
    pos = np.zeros((S, 3), np.int32)
    i = np.arange(n_img)
    pos[:n_img, 1], pos[:n_img, 2] = i // grid_w, i % grid_w
    start = pos[:n_img].max() + 1 if n_img else 0
    pos[n_img:] = (start + np.arange(S - n_img))[:, None]
    return np.broadcast_to(pos[None], (B, S, 3)).copy()


def _batch(cfg, B, S, seed=1):
    """numpy inputs: tokens, and the family's positions / image / encoder
    embeddings (bf16-representable float32)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(
        np.int32)}

    def emb(n):
        x = rng.standard_normal((B, n, cfg.d_model)) * 0.02
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)

    if cfg.family == "vlm":
        batch["positions"] = mrope_positions(B, S, cfg.n_image_tokens, 4)
        batch["image_embeds"] = emb(cfg.n_image_tokens)
    if cfg.family == "encdec":
        batch["enc_embeds"] = emb(S // cfg.enc_seq_div)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _close(name, got, want, tol, what):
    """`assert_allclose`, except for the MoE configs in bf16, where at most
    `MOE_FLIP_TOKENS` of the tokens (one row along the last axis: one
    (batch, position) row of logits, or one cached position) may miss the
    bar."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if name not in MOE:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
        return
    bad = ~np.isclose(got, want, atol=tol["atol"], rtol=tol["rtol"])
    share = float(bad.any(axis=-1).mean())
    assert share <= MOE_FLIP_TOKENS, (what, share)


# ---------------------------------------------------------------------------
# init and parameter crossing
# ---------------------------------------------------------------------------


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_init_model_shapes_and_dtypes_match_reference(name):
    rcfg, tcfg, params, _ = _model(name)
    tp = tt.init_model(tcfg, seed=3, device="cpu")
    assert _shapes(tp) == _shapes(params)
    assert tt.param_bytes(tp) == sum(
        np.asarray(x).nbytes for x in jax.tree.leaves(params))
    if tcfg.family == "ssm":
        assert list(tp["layers"]) == tt.ssm_layer_names(tcfg)


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_params_from_numpy_carries_every_family_bit_for_bit(name):
    """Mixed bf16 and float32 leaves (mamba2's A_log / dt_bias / D_skip),
    stacked experts and xLSTM's named layers cross unchanged."""
    _, _, params, tp = _model(name)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16))
        else:
            assert t.dtype == torch.float32 and a.dtype == np.float32
            np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# forward with caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_and_caches_match_reference(name):
    rcfg, tcfg, params, tp = _model(name)
    batch = _batch(rcfg, B, S)
    want, raux, rc = rt.forward(params, rcfg, _jax(batch), want_cache=True)
    for backend in ("cuda", "torch"):
        got, aux, tc = tt.forward(tp, tcfg, _torch(batch), backend=backend,
                                  want_cache=True)
        assert got.shape == (B, S, tcfg.vocab_padded)
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        _close(name, got, want, LOGIT_TOL, f"{backend} logits")
        assert set(tc) == set(rc)
        for k in rc:
            assert tuple(tc[k].shape) == rc[k].shape, k
            # a "token" of a cache is one position's dh row
            _close(name, tc[k], rc[k], CACHE_TOL, f"{backend} {k}")
        if name in MOE:
            assert abs(float(aux["moe_drop_frac"])
                       - float(raux["moe_drop_frac"])) <= 0.02
            assert float(aux["moe_drop_frac"]) > 0
        else:
            assert float(aux["moe_drop_frac"]) == 0.0


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _prefilled_states(name, S0, T):
    """The reference's decode state and the port's copy: KV families with
    the reference's prefill caches of S0 tokens stitched at 0 into T
    slots (enc-dec: its cross caches over the prefill's frames); the
    recurrent families after S0 reference decode steps from zero."""
    rcfg, tcfg, params, _ = _model(name)
    batch = _batch(rcfg, B, S0 + 1, seed=7)
    if tcfg.family in ("hybrid", "ssm"):
        state = rt.init_decode_state(rcfg, T, B)
        for t in range(S0):
            _, state = rt.decode_step(params, rcfg, {
                "tokens": jnp.asarray(batch["tokens"][:, t:t + 1]),
                "cur_len": jnp.int32(t)}, state)
    else:
        pre = dict(batch, tokens=batch["tokens"][:, :S0])
        if "positions" in pre:
            pre["positions"] = batch["positions"][:, :S0]
        if "enc_embeds" in pre:
            pre["enc_embeds"] = batch["enc_embeds"][:, :S0 // 4]
        _, _, caches = rt.forward(params, rcfg, _jax(pre), want_cache=True)
        state = rt.init_decode_state(rcfg, T, B)
        for k in ("k", "v"):
            state[k] = jax.lax.dynamic_update_slice(
                state[k], caches[k], (0, 0, 0, 0, 0))
        for k in ("cross_k", "cross_v"):
            if k in caches:
                state[k] = caches[k]
    tstate = lm_params_from_numpy(jax.tree.map(np.asarray, state),
                                  device="cpu")
    return batch, state, tstate


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_matches_reference(name):
    """Two decode steps against the reference's, from the same state:
    logits at atol 0.15 / rtol 0.1, every state leaf at 0.1; the port's
    state is updated in place."""
    rcfg, tcfg, params, tp = _model(name)
    # the recurrent families reach their state by reference decode steps
    S0 = 8 if tcfg.family in ("hybrid", "ssm") else 32
    batch, state, tstate = _prefilled_states(name, S0, S0 + 16)
    for i in range(2):
        cur = S0 + i
        tok = batch["tokens"][:, S0:S0 + 1] if i == 0 else \
            batch["tokens"][:, :1]
        db = {"tokens": tok, "cur_len": cur}
        if rcfg.family == "vlm":
            db["positions"] = mrope_positions(
                B, cur + 1, rcfg.n_image_tokens, 4)[:, cur:cur + 1]
        want, state = rt.decode_step(params, rcfg, {
            k: jnp.asarray(v) for k, v in db.items()}, state)
        got, tnew = tt.decode_step(tp, tcfg, {
            k: torch.as_tensor(v) for k, v in db.items()}, tstate)
        assert tnew is tstate
        assert got.shape == (B, 1, tcfg.vocab_padded)
        _close(name, got, want, LOGIT_TOL, f"step {i} logits")
        flat_r = jax.tree_util.tree_flatten_with_path(state)[0]
        for path, leaf in flat_r:
            t = tstate
            for key in path:
                t = t[key.key]
            assert t.dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32}[leaf.dtype.name]
            np.testing.assert_allclose(_np(t), _np(leaf), **CACHE_TOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_decode(name):
    """Through the serving step factories.  KV families without MoE: the
    decode at position S matches the full forward at S (the reference's
    consistency test), caches stitched into S + 16 slots.  MoE: decode
    routes T = B tokens against a capacity of max(1, B·k/E·1.25), not the
    prefill's, so it is held against the reference's own prefill-then-
    decode instead.  Hybrid and SSM (no prefill state, as in the
    reference): 16 decode steps from the zero state over the prompt, each
    against the full forward at that position."""
    rcfg, tcfg, params, tp = _model(name)
    batch = _batch(rcfg, B, S + 1)
    full, _, _ = tt.forward(tp, tcfg, _torch(batch))
    if tcfg.family in ("hybrid", "ssm"):
        n = 16
        decode = make_decode_step(tcfg, ShapeConfig("d", n, B, "decode"),
                                  device="cpu")
        state = tt.init_decode_state(tcfg, n, B, device="cpu")
        for t in range(n):
            lg, state = decode(tp, {"tokens": torch.from_numpy(
                batch["tokens"][:, t:t + 1].copy()), "cur_len": t}, state)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]),
                                       err_msg=f"position {t}", **LOGIT_TOL)
        return
    pre = dict(batch, tokens=batch["tokens"][:, :S])
    if "positions" in pre:
        pre["positions"] = batch["positions"][:, :S]
    prefill = make_prefill_step(tcfg, ShapeConfig("p", S, B, "prefill"),
                                device="cpu")
    last, caches = prefill(tp, _torch(pre))
    if name not in MOE:     # MoE: the capacity follows the token count
        np.testing.assert_array_equal(_np(last), _np(full[:, S - 1:S]))
    state = tt.init_decode_state(tcfg, S + 16, B, device="cpu")
    for k in ("k", "v"):
        state[k][:, :, :, :S] = caches[k]
    if tcfg.family == "encdec":
        state["cross_k"], state["cross_v"] = caches["cross_k"], \
            caches["cross_v"]
    db = {"tokens": batch["tokens"][:, S:S + 1], "cur_len": S}
    if tcfg.family == "vlm":
        db["positions"] = batch["positions"][:, S:S + 1]
    decode = make_decode_step(tcfg, ShapeConfig("d", S + 16, B, "decode"),
                              device="cpu")
    dec, _ = decode(tp, {k: torch.as_tensor(v) for k, v in db.items()},
                    state)
    if name not in MOE:
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, S]),
                                   **LOGIT_TOL)
        return
    _, _, rc = rt.forward(params, rcfg, _jax(pre), want_cache=True)
    rstate = rt.init_decode_state(rcfg, S + 16, B)
    for k in ("k", "v"):
        rstate[k] = jax.lax.dynamic_update_slice(rstate[k], rc[k],
                                                 (0, 0, 0, 0, 0))
    want, _ = rt.decode_step(params, rcfg, {
        k: jnp.asarray(v) for k, v in db.items()}, rstate)
    _close(name, dec, want, LOGIT_TOL, "prefill-then-decode logits")


# ---------------------------------------------------------------------------
# cross-attention and the step factories
# ---------------------------------------------------------------------------


def test_cross_attention_layer_matches_reference_float32():
    """`attention_layer` with `kv_override` (Se = S/4 encoder frames):
    Q-only projection, no rotary, non-causal, float32 at 1e-5, on both
    backends."""
    rcfg, tcfg = _cfgs("seamless-m4t-medium")
    rp, _ = ra.init_attention(jax.random.PRNGKey(2), rcfg, RULES)
    rp = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    tp = {k: torch.from_numpy(v) for k, v in rp.items()}
    jp = {k: jnp.asarray(v) for k, v in rp.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32)[None], (2, 32))
    ek, ev = ra.attn_kv_only(jp, rcfg, jnp.asarray(enc))
    want = ra.attention_layer(jp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                              kv_override=(ek, ev))
    tk, tv = ta.attn_kv_only(tp, tcfg, torch.from_numpy(enc))
    for backend in ("cuda", "torch"):
        got = ta.attention_layer(tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()),
                                 kv_override=(tk, tv), backend=backend)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_cross_attention_never_reaches_the_kernel(monkeypatch):
    """On ``backend="cuda"`` the encoder's and the decoder's
    self-attention go to the flash wrapper, cross-attention never does:
    it runs the plain walk by name, so it can neither fail in
    `plan_flash_attention` (Se != S) nor change route quietly."""
    rcfg, tcfg, params, tp = _model("seamless-m4t-medium")
    calls = []
    real = flash_ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        flash_ops.plan_flash_attention(q, k, v, window=kw["window"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(ta, "flash_attention", spy)
    batch = _batch(rcfg, B, S)
    tt.forward(tp, tcfg, _torch(batch), backend="cuda")
    Se = S // tcfg.enc_seq_div
    assert [c[2] for c in calls] == [False] * tcfg.enc_layers + \
        [True] * tcfg.n_layers
    assert all(c[0][2] == c[1][2] for c in calls)          # Sq == Sk
    assert calls[0][0][2] == Se and calls[-1][0][2] == S
    calls.clear()
    tt.forward(tp, tcfg, _torch(batch), backend="torch")
    assert calls == []


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", FAMILIES)
def test_chip_smoke_holds_the_kernel_at_the_prefills_shapes(name,
                                                            monkeypatch):
    """`chip_smoke.py` holds the flash kernel alone at the shapes
    `self_attention_shapes` gives and expects `flash_launches` launches a
    prefill: they must be the (B, H, KH, S, dh, causal, window) of every
    call the prefill makes to the wrapper, and their number."""
    smoke = _chip_smoke()
    rcfg, tcfg, _, tp = _model(name)
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                      q.shape[3], kw["causal"], kw["window"]))
        return flash_ops.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(ta, "flash_attention", spy)
    tt.forward(tp, tcfg, _torch(_batch(rcfg, B, S)), backend="cuda")
    assert len(calls) == smoke.flash_launches(tcfg)
    assert sorted(set(calls)) == sorted(
        tuple(row[1:]) for row in smoke.self_attention_shapes(tcfg, B, S))


def test_decode_step_factory_serves_xlstm_state_and_checks_kv():
    """`make_decode_step` checks the state the family has: an xLSTM state
    (no KV caches) of the shape's batch is served, one of another batch
    refused; a KV cache of the wrong length or batch is refused."""
    _, cfg, _, tp = _model("xlstm-125m")
    step = make_decode_step(cfg, ShapeConfig("d", 8, B, "decode"),
                            device="cpu")
    state = tt.init_decode_state(cfg, 8, B, device="cpu")
    assert "k" not in state
    tok = torch.zeros(B, 1, dtype=torch.int64)
    lg, new = step(tp, {"tokens": tok, "cur_len": 0}, state)
    assert new is state and lg.shape == (B, 1, cfg.vocab_padded)
    with pytest.raises(ValueError, match="requests"):
        step(tp, {"tokens": tok, "cur_len": 1},
             tt.init_decode_state(cfg, 8, B + 1, device="cpu"))
    _, mcfg, _, mp = _model("granite-moe-3b-a800m")
    mstep = make_decode_step(mcfg, ShapeConfig("d", 32, B, "decode"),
                             device="cpu")
    with pytest.raises(ValueError, match="positions"):
        mstep(mp, {"tokens": tok, "cur_len": 0},
              tt.init_decode_state(mcfg, 24, B, device="cpu"))
    with pytest.raises(ValueError, match="requests"):
        mstep(mp, {"tokens": tok, "cur_len": 0},
              tt.init_decode_state(mcfg, 32, B + 1, device="cpu"))


def test_prefill_step_moves_every_batch_tensor_to_its_device():
    _, cfg, _, tp = _model("qwen2-vl-72b")
    batch = _torch(_batch(cfg, B, 16))
    seen = {}
    real = tt.forward

    def spy(params, cfg_, b, **kw):
        seen.update({k: v.device.type for k, v in b.items()})
        return real(params, cfg_, b, **kw)

    import repro_torch.train.steps as steps
    orig = steps.forward
    steps.forward = spy
    try:
        make_prefill_step(cfg, ShapeConfig("p", 16, B, "prefill"),
                          device="cpu")(tp, batch)
    finally:
        steps.forward = orig
    assert seen == {"tokens": "cpu", "positions": "cpu",
                    "image_embeds": "cpu"}


def test_models_refuse_an_unknown_family():
    cfg = dataclasses.replace(treg.reduced_config(treg.get_arch("qwen3-4b")),
                              family="rnn")
    with pytest.raises(ValueError):
        tt.init_model(cfg, device="cpu")
    with pytest.raises(ValueError):
        tt.init_decode_state(cfg, 8, 1, device="cpu")
