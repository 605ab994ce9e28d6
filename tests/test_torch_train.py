"""The port's LM training step against the reference's: AdamW, int8
compression, the loss, remat and the microbatched train step.

Weights come from the reference's `init_model` and cross to the port by
`lm_params_from_numpy`; every other input (tokens, gradients, optimizer
state, logits, image and encoder embeddings) is drawn with numpy from a
seed and handed to both packages.  The reference's `value_and_grad` is
jitted once per config and cached.

Tolerances, each beside what was measured on the CPU:
- AdamW below the clip (``grad_clip`` 1e9, so the scale is exactly 1):
  params, master, m and v equal bit for bit, lr equal, over 3 steps of
  float32 and bf16 gradients (measured: equal).  ``grad_norm`` within a
  relative 2e-6: both are float32 sums of squares, and XLA's reduction
  order carries up to 3.3e-7 relative error a leaf against a float64 sum
  where torch's carries 9e-8 (measured: 1.04e-6 at worst).
- AdamW with the clip active (``grad_clip`` 1, gradients ~150 in norm):
  the clip scale carries that norm difference into every element, so
  per-leaf relative L2: params and master 1e-6 (measured 1.2e-8), m 2e-6
  (9.6e-7: linear in the scale), v 4e-6 (1.9e-6: quadratic).
- `softmax_xent` and `lm_loss` on the same float32 logits: 1e-6 relative.
- `quantize_int8`: bit for bit; `compressed_psum_grads` the int8 round
  trip bit for bit, also with DTensor leaves on a 2-rank gloo mesh with a
  pod axis (the payload gathered over pod and averaged).
- The whole model in bf16 (reduced configs): the loss within a relative
  1e-3 (measured 1e-6 to 6e-5); per-leaf gradients at relative L2 0.08
  (measured 0.021-0.039: dense, VLM, enc-dec, hybrid, SSM) and 0.2 for
  the MoE configs (0.092: routing is discrete, and a near-tie routes a
  token by the last bit of its hidden state).  Both packages round every
  activation to bf16, so float32 parity holds module by module only.  A
  planted fault (attention's output detached) must break the 0.08 bar.
- One `make_train_step` against the reference's jitted step (qwen3-4b,
  microbatch 2, remat "full"): loss 1e-3 relative, ``grad_norm`` 0.08
  (the gradients' bar), lr 1e-6, new params and master per-leaf relative
  L2 0.02 (measured 0.0052), m 0.08 (0.033, linear in the gradients), v
  0.16 (0.054, quadratic).
- ``microbatch`` 2 against 1 in the port: the loss within 1e-5 relative
  (7.6e-8), gradients at relative L2 2^-7 (0.0027): microbatch 1 leaves
  them in bf16, microbatch 2 adds two bf16 halves in float32.
- remat "none", "full" and "dots": losses and gradients equal bit for bit
  (the recomputed forward is the same arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.dist.sharding import ShardingRules
from repro.models import common as rcm
from repro.models import transformer as rt
from repro.optim import adamw as radam
from repro.optim import compress as rcomp
from repro.train.steps import make_train_step as r_make_train_step
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.convert import lm_params_from_numpy
from torch_world import run_world
from repro_torch.models import attention as ta
from repro_torch.models import common as tcm
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw as tadam
from repro_torch.optim import compress as tcomp
from repro_torch.train.steps import make_grad_step, make_train_step

RULES = ShardingRules(model_size=1, data_size=1, fsdp=False)
GRAD_CONFIGS = ["qwen3-4b", "mixtral-8x22b", "zamba2-1.2b", "xlstm-125m",
                "seamless-m4t-medium"]
MOE = {"mixtral-8x22b", "granite-moe-3b-a800m"}
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 0.08
MOE_GRAD_REL_L2 = 0.2
B, S = 2, 64


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _flat(tree, prefix="") -> dict:
    """{"a/b": float32 numpy} in sorted key order, from either package."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = prefix + k
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().float().numpy()
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _rel_l2(got, want) -> dict:
    fg, fw = _flat(got), _flat(want)
    assert list(fg) == list(fw)
    return {k: float(np.linalg.norm(fg[k] - fw[k])
                     / max(np.linalg.norm(fw[k]), 1e-30)) for k in fw}


def _cfgs(name, **kw):
    return (dataclasses.replace(rreg.reduced_config(rreg.get_arch(name)),
                                **kw),
            dataclasses.replace(treg.reduced_config(treg.get_arch(name)),
                                **kw))


def _batch(cfg, b=B, s=S, seed=1) -> dict:
    """numpy inputs: tokens, and the family's positions / image / encoder
    embeddings (bf16-representable float32)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(
        np.int32)}

    def emb(n):
        x = rng.standard_normal((b, n, cfg.d_model)) * 0.02
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)

    if cfg.family == "vlm":
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, :, None], (b, s, 3)).copy()
        batch["image_embeds"] = emb(cfg.n_image_tokens)
    if cfg.family == "encdec":
        batch["enc_embeds"] = emb(s // cfg.enc_seq_div)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


_MODELS = {}


def _model(name):
    """Reference params (bf16, PRNGKey 0), the configs, and the reference's
    jitted value_and_grad of its lm_loss, per config."""
    if name not in _MODELS:
        rcfg, tcfg = _cfgs(name)
        params, _ = rt.init_model(jax.random.PRNGKey(0), rcfg, RULES)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: rt.lm_loss(p, rcfg, b)[0]))
        _MODELS[name] = (rcfg, tcfg, params, vg)
    return _MODELS[name]


def _port_params(params):
    return lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")


def _shape(b=B, s=S):
    return ShapeConfig("train", s, b, "train")


# ---------------------------------------------------------------------------
# optimizer and compression: twins of tests/test_train_substrate.py
# ---------------------------------------------------------------------------


def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([2.0, -3.0, 1.0], dtype=torch.bfloat16)}
    opt = tadam.init_opt_state(params)
    cfg = tadam.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)

    def loss(p):
        return torch.sum(torch.square(p["w"].float()))

    l0 = float(loss(params))
    for _ in range(60):
        w = params["w"].detach().requires_grad_()
        loss({"w": w}).backward()
        params, opt, stats = tadam.adamw_update(cfg, {"w": w.grad}, opt,
                                                params)
    assert float(loss(params)) < 0.05 * l0
    assert int(opt["step"]) == 60
    assert opt["step"].dtype == torch.int32
    assert float(stats["grad_norm"]) >= 0


def test_adamw_grad_clip():
    params = {"w": torch.ones(4, dtype=torch.float32)}
    before = params["w"].clone()
    opt = tadam.init_opt_state(params)
    cfg = tadam.AdamWConfig(lr=1e-3, grad_clip=1.0)
    g = {"w": torch.full((4,), 100.0)}
    p2, opt, stats = tadam.adamw_update(cfg, g, opt, params)
    assert float(stats["grad_norm"]) == pytest.approx(200.0)
    # post-clip effective |update| bounded by lr * O(1)
    assert float(torch.max(torch.abs(p2["w"] - before))) < 5e-3


def test_int8_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    q, scale = tcomp.quantize_int8(g)
    back = tcomp.dequantize_int8(q, scale)
    assert q.dtype == torch.int8
    err = float(torch.max(torch.abs(back - g)))
    assert err <= float(scale) / 2 + 1e-6  # half-ulp rounding bound


def test_quantize_int8_matches_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    for g in (rng.normal(size=(256, 64)).astype(np.float32) * 5,
              np.zeros((7,), np.float32),
              rng.uniform(-1, 1, size=(3, 5, 11)).astype(np.float32)):
        rq, rs = rcomp.quantize_int8(jnp.asarray(g))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(g))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert np.float32(ts.item()) == np.float32(rs)
        np.testing.assert_array_equal(
            tcomp.dequantize_int8(tq, ts).numpy(),
            np.asarray(rcomp.dequantize_int8(rq, rs)))


def test_compressed_grads_are_the_int8_round_trip():
    rng = np.random.default_rng(4)
    g = {"a": torch.from_numpy(rng.normal(size=(32, 8)).astype(
        np.float32)).to(torch.bfloat16),
         "n": {"b": torch.from_numpy(rng.normal(size=(5,)).astype(
             np.float32))}}
    out = tcomp.compressed_psum_grads(g)
    for k, v in (("a", g["a"]), ("b", g["n"]["b"])):
        got = out[k] if k == "a" else out["n"][k]
        q, s = tcomp.quantize_int8(v.float())
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, tcomp.dequantize_int8(q, s),
                                   rtol=0, atol=0)

    # with a pod axis: DTensor leaves on a (2, 1, 1) ("pod", "data",
    # "model") gloo mesh, the int8 payload gathered over pod and averaged
    outs = run_world(_pod_round_trip, 2, g)
    for k, v in (("a", g["a"]), ("b", g["n"]["b"])):
        q, s = tcomp.quantize_int8(v.float())
        want = tcomp.dequantize_int8(q, s).numpy()
        for o in outs:
            assert o[k].dtype == np.float32
            np.testing.assert_array_equal(o[k], want)


def _pod_round_trip(rank, g):
    """`compressed_psum_grads` of `g` placed on a (2, 1, 1) pod mesh, each
    leaf sharded on its first dim over data (size 1) and replicated over
    pod; every rank's whole result."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.compat import to_dtensor
    from repro_torch.dist.sharding import P, ShardingRules
    mesh = init_device_mesh("cpu", (2, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    rules = ShardingRules(model_size=1, data_size=1, multi_pod=True,
                          pod_size=2)
    dg = {"a": to_dtensor(g["a"], mesh, P("data", None)),
          "n": {"b": to_dtensor(g["n"]["b"], mesh, P("data"))}}
    out = tcomp.compressed_psum_grads(dg, rules, mesh)
    return {"a": out["a"].full_tensor(), "b": out["n"]["b"].full_tensor()}


# ---------------------------------------------------------------------------
# optimizer against the reference
# ---------------------------------------------------------------------------

_OPT_SHAPES = {"w": ((64, 32), "bf16"), "b": ((128,), "f32"),
               "n": {"u": ((8, 16), "bf16"), "s": ((3, 5, 7), "f32")}}


def _draw(rng, spec, scale=1.0):
    if isinstance(spec, dict):
        return {k: _draw(rng, v, scale) for k, v in spec.items()}
    shape, dt = spec
    return (rng.standard_normal(shape).astype(np.float32) * scale, dt)


def _as_jax(t):
    if isinstance(t, dict):
        return {k: _as_jax(v) for k, v in t.items()}
    a, dt = t
    return jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32)


def _as_torch(t):
    if isinstance(t, dict):
        return {k: _as_torch(v) for k, v in t.items()}
    a, dt = t
    return torch.from_numpy(a.copy()).to(
        torch.bfloat16 if dt == "bf16" else torch.float32)


def _three_adamw_steps(grad_clip):
    rng = np.random.default_rng(0)
    p0 = _draw(rng, _OPT_SHAPES)
    rp, tp = _as_jax(p0), _as_torch(p0)
    ro, to = radam.init_opt_state(rp), tadam.init_opt_state(tp)
    kw = dict(lr=1e-2, warmup_steps=3, grad_clip=grad_clip)
    rcfg, tcfg = radam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    for _ in range(3):
        g = _draw(rng, _OPT_SHAPES, scale=3.0)
        rp, ro, rs = radam.adamw_update(rcfg, _as_jax(g), ro, rp)
        tp, to, ts = tadam.adamw_update(tcfg, _as_torch(g), to, tp)
        yield rp, ro, rs, tp, to, ts


def test_adamw_update_matches_reference_bit_for_bit_below_the_clip():
    for rp, ro, rs, tp, to, ts in _three_adamw_steps(grad_clip=1e9):
        assert int(to["step"]) == int(ro["step"])
        assert np.float32(ts["lr"].item()) == np.float32(rs["lr"])
        np.testing.assert_allclose(ts["grad_norm"].item(),
                                   float(rs["grad_norm"]), rtol=2e-6)
        for got, want in ((tp, rp), (to["master"], ro["master"]),
                          (to["m"], ro["m"]), (to["v"], ro["v"])):
            fg, fw = _flat(got), _flat(want)
            for k in fw:
                np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
        assert {k: str(v.dtype).split(".")[-1] for k, v in
                _flat_tensors(tp).items()} == {
            k: str(v.dtype) for k, v in _flat_tensors(rp).items()}


def _flat_tensors(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat_tensors(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


def test_adamw_update_matches_reference_with_the_clip_active():
    for rp, ro, rs, tp, to, ts in _three_adamw_steps(grad_clip=1.0):
        assert float(rs["grad_norm"]) > 100       # the clip scales
        np.testing.assert_allclose(ts["grad_norm"].item(),
                                   float(rs["grad_norm"]), rtol=2e-6)
        assert np.float32(ts["lr"].item()) == np.float32(rs["lr"])
        for got, want, bar in ((tp, rp, 1e-6),
                               (to["master"], ro["master"], 1e-6),
                               (to["m"], ro["m"], 2e-6),
                               (to["v"], ro["v"], 4e-6)):
            worst = max(_rel_l2(got, want).values())
            assert worst <= bar, (worst, bar)


def test_lr_at_follows_the_reference():
    for warm in (1, 10, 100):
        rcfg, tcfg = (radam.AdamWConfig(lr=3e-4, warmup_steps=warm),
                      tadam.AdamWConfig(lr=3e-4, warmup_steps=warm))
        for step in (0, 1, 5, 9, 10, 99, 150):
            assert np.float32(tadam.lr_at(tcfg, step).item()) == \
                np.float32(radam.lr_at(rcfg, jnp.int32(step)))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 17, 300)).astype(np.float32) * 4
    labels = rng.integers(0, 300, size=(3, 17)).astype(np.int32)
    mask = (rng.uniform(size=(3, 17)) > 0.3).astype(np.float32)
    for m in (mask, None, np.zeros_like(mask)):
        want = float(rcm.softmax_xent(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = tcm.softmax_xent(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen2-vl-72b"])
def test_lm_loss_on_the_same_logits_matches_reference(name, monkeypatch):
    """Labels, mask (the last position; VLM: the image prefix) and the
    mean, with `forward` replaced in both packages by the same logits."""
    rcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((B, S, tcfg.vocab_padded)).astype(
        np.float32) * 3
    batch = _batch(tcfg)
    monkeypatch.setattr(rt, "forward", lambda *a, **k: (
        jnp.asarray(logits), {"moe_drop_frac": jnp.float32(0)}, None))
    monkeypatch.setattr(tt, "forward", lambda *a, **k: (
        torch.from_numpy(logits), {"moe_drop_frac": torch.zeros(())}, None))
    want = float(rt.lm_loss(None, rcfg, _jax(batch))[0])
    got = tt.lm_loss(None, tcfg, _torch(batch))[0]
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# twins of tests/test_models_smoke.py::test_forward_and_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(treg.ARCHS))
def test_forward_and_loss(name):
    cfg = treg.reduced_config(treg.get_arch(name))
    params = tt.init_model(cfg, seed=0, device="cpu")
    batch = _torch(_batch(cfg))
    logits, aux, _ = tt.forward(params, cfg, batch, backend="torch")
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert bool(torch.isfinite(logits.float()).all())
    loss, aux = tt.lm_loss(params, cfg, batch)
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert loss.dtype == torch.float32


# ---------------------------------------------------------------------------
# loss and gradients against the reference
# ---------------------------------------------------------------------------


def _grads_against_reference(name, tcfg=None):
    rcfg, tcfg0, params, vg = _model(name)
    batch = _batch(rcfg)
    rloss, rgrads = vg(params, _jax(batch))
    gstep = make_grad_step(tcfg or tcfg0, _shape(), device="cpu")
    tloss, _, tgrads = gstep(_port_params(params), _torch(batch))
    return float(rloss), float(tloss), _rel_l2(tgrads, rgrads), tgrads


@pytest.mark.parametrize("name", GRAD_CONFIGS)
def test_loss_and_gradients_match_reference(name):
    rloss, tloss, rel, tgrads = _grads_against_reference(name)
    assert abs(tloss - rloss) <= LOSS_RTOL * abs(rloss), (tloss, rloss)
    bar = MOE_GRAD_REL_L2 if name in MOE else GRAD_REL_L2
    worst = max(rel, key=rel.get)
    assert rel[worst] <= bar, (worst, rel[worst])
    # microbatch 1: gradients in the params' dtypes, as value_and_grad's
    params = _flat_tensors(_port_params(_model(name)[2]))
    assert {k: v.dtype for k, v in _flat_tensors(tgrads).items()} == {
        k: v.dtype for k, v in params.items()}


def test_detached_attention_breaks_the_gradient_bar(monkeypatch):
    """A planted fault: attention's output cut from the graph, as a kernel
    without a backward would leave it.  q, k and v then get no gradient."""
    real = ta.blocked_attention
    monkeypatch.setattr(ta, "blocked_attention",
                        lambda *a, **k: real(*a, **k).detach())
    _, _, rel, _ = _grads_against_reference("qwen3-4b")
    assert max(rel.values()) > GRAD_REL_L2
    for w in ("wq", "wk", "wv"):
        assert rel[f"blocks/attn/{w}"] > GRAD_REL_L2


def test_train_step_matches_reference_jitted_step():
    rcfg, tcfg = _cfgs("qwen3-4b", microbatch=2, remat="full")
    params, _ = rt.init_model(jax.random.PRNGKey(0), rcfg, RULES)
    batch = _batch(rcfg, b=4)
    kw = dict(lr=1e-3, warmup_steps=1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    rfn = r_make_train_step(rcfg, RShapeConfig("train", S, 4, "train"),
                            mesh, radam.AdamWConfig(**kw), donate=False)[0]
    rp, ro, rm = rfn(params, radam.init_opt_state(params), _jax(batch))
    tparams = _port_params(params)
    step = make_train_step(tcfg, _shape(b=4), tadam.AdamWConfig(**kw),
                           device="cpu")
    tp, to, tm = step(tparams, tadam.init_opt_state(tparams),
                      _torch(batch))
    assert set(tm) == {"loss", "grad_norm", "lr", "moe_drop_frac"}
    np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(rm["grad_norm"]), rtol=GRAD_REL_L2)
    np.testing.assert_allclose(tm["lr"].item(), float(rm["lr"]), rtol=1e-6)
    assert tm["moe_drop_frac"].item() == float(rm["moe_drop_frac"]) == 0
    assert int(to["step"]) == int(ro["step"]) == 1
    for got, want, bar in ((tp, rp, 0.02), (to["master"], ro["master"], 0.02),
                           (to["m"], ro["m"], GRAD_REL_L2),
                           (to["v"], ro["v"], 2 * GRAD_REL_L2)):
        rel = _rel_l2(got, want)
        worst = max(rel, key=rel.get)
        assert rel[worst] <= bar, (worst, rel[worst], bar)


# ---------------------------------------------------------------------------
# microbatches and remat (the port alone)
# ---------------------------------------------------------------------------


def _port_grads(name, b=4, **kw):
    _, tcfg = _cfgs(name, **kw)
    params = _port_params(_model(name)[2])
    return make_grad_step(tcfg, _shape(b=b), device="cpu")(
        params, _torch(_batch(tcfg, b=b)))


def test_two_microbatches_equal_one_batch():
    l1, _, g1 = _port_grads("qwen3-4b", microbatch=1)
    l2, aux2, g2 = _port_grads("qwen3-4b", microbatch=2)
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-5)
    assert {v.dtype for v in _flat_tensors(g2).values()} == {torch.float32}
    rel = _rel_l2(g2, g1)
    assert max(rel.values()) <= 2 ** -7, max(rel.items(), key=lambda x: x[1])


def test_microbatch_drop_fraction_is_the_mean():
    _, aux1, _ = _port_grads("mixtral-8x22b", b=2, microbatch=1)
    _, aux2, _ = _port_grads("mixtral-8x22b", b=2, microbatch=2)
    _, tcfg = _cfgs("mixtral-8x22b")
    params = _port_params(_model("mixtral-8x22b")[2])
    batch = _torch(_batch(tcfg, b=2))
    halves = [tt.lm_loss(params, tcfg, {k: v[i:i + 1] for k, v in
                                        batch.items()})[1]["moe_drop_frac"]
              for i in range(2)]
    assert aux1["moe_drop_frac"].item() > 0
    assert aux2["moe_drop_frac"].item() == pytest.approx(
        (halves[0].item() + halves[1].item()) / 2, rel=1e-6)


@pytest.mark.parametrize("name", ["qwen3-4b", "mixtral-8x22b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_remat_modes_give_identical_losses_and_gradients(name, monkeypatch):
    calls = []
    real = tt.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("context_fn"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(tt, "checkpoint", spy)
    l0, _, g0 = _port_grads(name, b=2, remat="none")
    assert not calls
    _, tcfg = _cfgs(name)
    # the reference's wrapped bodies: every stacked layer (enc-dec: both
    # stacks), not xLSTM's or the hybrid's shared attention block
    wrapped = tcfg.n_layers + (tcfg.enc_layers
                               if tcfg.family == "encdec" else 0)
    for remat in ("full", "dots"):
        calls.clear()
        l1, _, g1 = _port_grads(name, b=2, remat=remat)
        assert len(calls) == wrapped
        assert all((c is None) == (remat == "full") for c in calls)
        assert l1.item() == l0.item()
        f1, f0 = _flat(g1), _flat(g0)
        for k in f0:
            np.testing.assert_array_equal(f1[k], f0[k], err_msg=k)


def test_remat_stays_out_of_serving(monkeypatch):
    """A forward that autograd does not record (serving) runs the bodies
    as they are, whatever the config's remat."""
    calls = []
    monkeypatch.setattr(tt, "checkpoint", lambda *a, **k: calls.append(1))
    _, tcfg = _cfgs("qwen3-4b", remat="full")
    params = _port_params(_model("qwen3-4b")[2])
    tt.forward(params, tcfg, _torch(_batch(tcfg)), backend="torch")
    with torch.no_grad():
        tt.lm_loss(params, tcfg, _torch(_batch(tcfg)))
    assert not calls
    with pytest.raises(ValueError, match="remat"):
        tt._wrap_remat(lambda h: h, "everything")


def test_train_step_refuses_the_kernel_backend_and_odd_batches():
    _, tcfg = _cfgs("qwen3-4b")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(tcfg, _shape(), device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(dataclasses.replace(tcfg, microbatch=3),
                        _shape(b=4), device="cpu")
    step = make_train_step(tcfg, _shape(b=4), device="cpu")
    params = tt.init_model(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="batch of 2"):
        step(params, tadam.init_opt_state(params),
             _torch(_batch(tcfg, b=2)))


def test_train_step_updates_in_place_and_learns():
    _, tcfg = _cfgs("qwen3-4b", microbatch=2)
    params = tt.init_model(tcfg, seed=0, device="cpu")
    opt = tadam.init_opt_state(params)
    embed = params["embed"]
    step = make_train_step(tcfg, _shape(b=4), tadam.AdamWConfig(
        lr=1e-3, warmup_steps=1), device="cpu")
    batch = _torch(_batch(tcfg, b=4))
    losses = []
    for i in range(3):
        new_params, opt, m = step(params, opt, batch)
        assert new_params is params and params["embed"] is embed
        assert int(opt["step"]) == i + 1
        losses.append(m["loss"].item())
    assert losses[2] < losses[0]
    assert params["embed"].dtype == torch.bfloat16
    torch.testing.assert_close(params["embed"],
                               opt["master"]["embed"].to(torch.bfloat16),
                               rtol=0, atol=0)
