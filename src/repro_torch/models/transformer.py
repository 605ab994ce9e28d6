"""Model composition for every family of `configs/registry.py`: dense / MoE
/ VLM decoder stacks, xLSTM stacks, zamba2 hybrid (mamba2 + shared
attention), enc-dec.

Homogeneous stacks are stacked on a leading layer axis, as the
reference's `stack_init` makes them, and applied by a Python loop over
that axis (the reference's ``lax.scan``); xLSTM's heterogeneous layers
are named ``l{i}m`` / ``l{i}s`` and run in depth order.  Self-attention
in prefill takes `backend` (``"cuda"``: the flash kernel); cross-attention
and decode attention are plain torch on either backend.

As in the reference, the hybrid and SSM prefills return no recurrent
state (only the shared block's k/v, or nothing): decode starts from
`init_decode_state`.

Training: `lm_loss` (next-token cross-entropy) over `forward`, whose
layer bodies are rematerialised as the reference's are (`_wrap_remat`:
the dense / MoE / VLM block, the hybrid's mamba block, the enc-dec
encoder and decoder blocks; not the xLSTM stack or the hybrid's shared
attention block) whenever autograd records them.  `forward` also takes
each stacked layer tree as a list of per-layer trees (`common.layer_list`),
which is how the train step hands it per-layer autograd leaves.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.device import resolve_device
from ..dist.sharding import P
from .attention import (attention_specs, attn_kv_only, attn_q_only, attn_qkv,
                        attention_layer, decode_attention, init_attention)
from .common import (dense, generator, layer_list, layer_slice, rms_norm,
                     softmax_xent, stack_init, stack_specs)
from .mamba2 import (init_mamba2, mamba2_decode_step, mamba2_forward,
                     mamba2_init_state, mamba2_specs)
from .mlp import init_mlp, mlp, mlp_specs
from .moe import init_moe, moe_apply, moe_specs, xla_mean
from .xlstm import (init_mlstm_block, init_slstm_block, mlstm_block,
                    mlstm_block_decode, mlstm_block_init_state,
                    mlstm_block_specs, slstm_block, slstm_block_decode,
                    slstm_block_specs, slstm_init_state)


def ssm_layer_names(cfg) -> list:
    """xLSTM's layers in depth order: ``l{i}s`` for the sLSTM layers,
    ``l{i}m`` for the mLSTM ones (the reference's param names)."""
    return [f"l{i}{'s' if i in cfg.slstm_layers else 'm'}"
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT = ("none", "full", "dots")
# "dots" keeps the outputs of matrix products without batch dimensions
# (jax's dots_with_no_batch_dims_saveable); batched products (bmm, the
# attention walk's einsums, the experts' products) are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _needs_grad(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, dict):
        return any(_needs_grad(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_needs_grad(v) for v in x)
    return False


def _wrap_remat(fn, remat: str):
    """`fn` rematerialised under `remat`: ``"none"`` saves everything,
    ``"full"`` only the block's inputs (its body is recomputed in the
    backward), ``"dots"`` also the outputs of its unbatched matrix
    products.  A call that autograd does not record (no grad mode, or no
    input that requires grad: serving) runs `fn` as it is."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}; got {remat!r}")
    if remat == "none":
        return fn
    kw = {"context_fn": _dots_context} if remat == "dots" else {}

    def wrapped(*args):
        if not (torch.is_grad_enabled() and _needs_grad(args)):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _ones(gen, cfg):
    return torch.ones(cfg.d_model, dtype=torch.bfloat16, device=gen.device)


def _init_dense_block(gen, cfg, cross: bool = False) -> dict:
    p = {"ln1": _ones(gen, cfg), "attn": init_attention(gen, cfg)}
    if cross:
        p["ln_x"] = _ones(gen, cfg)
        p["xattn"] = init_attention(gen, cfg)
    p["ln2"] = _ones(gen, cfg)
    if cfg.family == "moe" and not cross:
        p["moe"] = init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def init_model(cfg, *, seed: int = 0, device=None) -> dict:
    """Seeded random parameters at the reference's shapes, dtypes and
    scales: one `torch.Generator` on `device` (CUDA unless the caller asks
    for the CPU) draws every tensor in float32, one tensor at a time, each
    cast at once (bf16, or float32 for mamba2's `A_log`, `dt_bias` and
    `D_skip`).  The numbers differ from the reference's `jax.random` ones;
    to compare the two, carry the reference's tree across with
    `core.convert.lm_params_from_numpy`.  On ``device="meta"`` it draws
    nothing: every tensor has its shape and dtype and no data (the
    reference's ``jax.eval_shape(init_model)``)."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    Vp, D = cfg.vocab_padded, cfg.d_model
    p = {"embed": dense(gen, Vp, D, scale=0.02),
         "final_norm": _ones(gen, cfg)}
    if not cfg.tie_embeddings:
        p["head"] = dense(gen, D, Vp, scale=0.02)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        p["blocks"] = stack_init(lambda: _init_dense_block(gen, cfg),
                                 cfg.n_layers)
    elif fam == "ssm":
        layers = {}
        for name in ssm_layer_names(cfg):
            init = init_slstm_block if name.endswith("s") else \
                init_mlstm_block
            layers[name] = {**init(gen, cfg), "ln": _ones(gen, cfg)}
        p["layers"] = layers
    elif fam == "hybrid":
        p["mamba"] = stack_init(
            lambda: {**init_mamba2(gen, cfg), "ln": _ones(gen, cfg)},
            cfg.n_layers)
        # zamba2's shared block is a plain dense attn+mlp block
        p["shared_attn"] = _init_dense_block(
            gen, dataclasses.replace(cfg, family="dense"))
    elif fam == "encdec":
        p["enc_blocks"] = stack_init(lambda: _init_dense_block(gen, cfg),
                                     cfg.enc_layers)
        p["dec_blocks"] = stack_init(
            lambda: _init_dense_block(gen, cfg, cross=True), cfg.n_layers)
        p["enc_norm"] = _ones(gen, cfg)
    else:
        raise ValueError(fam)
    return p


def _dense_block_specs(cfg, rules, cross: bool = False) -> dict:
    s = {"ln1": rules.vector(), "attn": attention_specs(cfg, rules)}
    if cross:
        s["ln_x"] = rules.vector()
        s["xattn"] = attention_specs(cfg, rules)
    s["ln2"] = rules.vector()
    if cfg.family == "moe" and not cross:
        s["moe"] = moe_specs(cfg, rules)
    else:
        s["mlp"] = mlp_specs(cfg, rules)
    return s


def param_specs(cfg, rules) -> dict:
    """The spec tree of `init_model`'s params under `rules`, from the config
    alone: the reference's ``init_model(key, cfg, rules)[1]`` entry for
    entry (stacked layers get a leading None)."""
    Vp, D = cfg.vocab_padded, cfg.d_model
    s = {"embed": rules.embed(Vp, D), "final_norm": rules.vector()}
    if not cfg.tie_embeddings:
        s["head"] = rules.dense_in(D, Vp)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        s["blocks"] = stack_specs(_dense_block_specs(cfg, rules))
    elif fam == "ssm":
        s["layers"] = {
            name: {**(slstm_block_specs if name.endswith("s")
                      else mlstm_block_specs)(cfg, rules),
                   "ln": rules.vector()}
            for name in ssm_layer_names(cfg)}
    elif fam == "hybrid":
        s["mamba"] = stack_specs({**mamba2_specs(cfg, rules),
                                  "ln": rules.vector()})
        s["shared_attn"] = _dense_block_specs(
            dataclasses.replace(cfg, family="dense"), rules)
    elif fam == "encdec":
        s["enc_blocks"] = stack_specs(_dense_block_specs(cfg, rules))
        s["dec_blocks"] = stack_specs(_dense_block_specs(cfg, rules,
                                                         cross=True))
        s["enc_norm"] = rules.vector()
    else:
        raise ValueError(fam)
    return s


def param_bytes(params: dict) -> int:
    """Bytes of a nested dict of tensors (params or decode state)."""
    return sum(param_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in params.values())


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _dense_block(lp, cfg, h, positions, *, causal=True, backend="cuda",
                 enc_kv=None, want_kv=False):
    """Returns (h, moe drop fraction or None, (k, v) or ())."""
    attn_out = attention_layer(lp["attn"], cfg, rms_norm(h, lp["ln1"]),
                               positions, causal=causal, backend=backend,
                               return_kv=want_kv)
    kv = ()
    if want_kv:
        attn_out, kv = attn_out
    h = h + attn_out
    if enc_kv is not None:
        h = h + attention_layer(lp["xattn"], cfg, rms_norm(h, lp["ln_x"]),
                                positions, kv_override=enc_kv,
                                backend=backend)
    hn = rms_norm(h, lp["ln2"])
    if "moe" in lp:
        y, drop = moe_apply(lp["moe"], cfg, hn)
        return h + y, drop, kv
    return h + mlp(lp["mlp"], cfg, hn), None, kv


def _positions_1d(B, S, device):
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ head


def _store_kv(caches: dict, n: int, i: int, kv,
              names=("k", "v")) -> None:
    """Write layer `i`'s (B, KH, S, dh) k and v into (n, B, KH, S, dh)
    caches under `names`, allocated at the first write in k's dtype."""
    for name, t in zip(names, kv):
        if name not in caches:
            caches[name] = t.new_empty((n,) + tuple(t.shape))
        caches[name][i].copy_(t)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def forward(params, cfg, batch, rules=None, mesh=None, *, backend="cuda",
            want_cache=False):
    """With `rules` and a `DeviceMesh` `mesh`, the sharded forward of
    `models.spmd` (params DTensors under `param_specs`).  batch: tokens (B,S) [+ positions (B,S) or (B,S,3) / image_embeds
    (B, n_image_tokens, D) / enc_embeds (B, Se, D)].  Returns (logits
    (B, S, Vp), aux_dict, caches | None); caches k/v are (L, B, KH, S, dh)
    (enc-dec adds cross_k/cross_v (L, B, KH, Se, dh); the hybrid family
    has one k/v a shared-block application; the SSM family none), written
    layer by layer into one tensor each, allocated at the first layer."""
    if rules is not None and mesh is not None:
        from . import spmd
        return spmd.forward(params, cfg, batch, rules, mesh, backend=backend,
                            want_cache=want_cache)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = params["embed"][tokens].to(torch.bfloat16)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_1d(B, S, tokens.device)
    if cfg.family == "vlm":
        img = batch["image_embeds"].to(h.dtype)
        h = torch.cat([img, h[:, cfg.n_image_tokens:]], dim=1)
    aux = {"moe_drop_frac": torch.zeros((), device=h.device)}
    caches = {} if want_cache else None
    fam = cfg.family

    if fam in ("dense", "moe", "vlm"):
        blk = _wrap_remat(lambda hh, lp: _dense_block(
            lp, cfg, hh, positions, backend=backend, want_kv=want_cache),
            cfg.remat)
        drops = []
        for i, lp in enumerate(layer_list(params["blocks"], cfg.n_layers)):
            h, drop, kv = blk(h, lp)
            if drop is not None:
                drops.append(drop)
            if want_cache:
                _store_kv(caches, cfg.n_layers, i, kv)
        if drops:
            aux["moe_drop_frac"] = xla_mean(torch.stack(drops))
    elif fam == "ssm":
        for name in ssm_layer_names(cfg):
            lp = params["layers"][name]
            block = slstm_block if name.endswith("s") else mlstm_block
            h = h + block(lp, cfg, rms_norm(h, lp["ln"]))
    elif fam == "hybrid":
        period, L = cfg.attn_every, cfg.n_layers
        n_groups = L // period
        mamba = layer_list(params["mamba"], L)
        mblk = _wrap_remat(lambda hh, lp: hh + mamba2_forward(
            lp, cfg, rms_norm(hh, lp["ln"])), cfg.remat)

        def mamba_layers(lo, hi, h):
            for i in range(lo, hi):
                h = mblk(h, mamba[i])
            return h

        for gi in range(n_groups):
            h = mamba_layers(gi * period, (gi + 1) * period, h)
            h, _, kv = _dense_block(params["shared_attn"], cfg, h, positions,
                                    backend=backend, want_kv=want_cache)
            if want_cache:
                _store_kv(caches, n_groups, gi, kv)
        h = mamba_layers(n_groups * period, L, h)
    elif fam == "encdec":
        enc_h = batch["enc_embeds"].to(h.dtype)
        enc_pos = _positions_1d(B, enc_h.shape[1], h.device)
        eblk = _wrap_remat(lambda hh, lp: _dense_block(
            lp, cfg, hh, enc_pos, causal=False, backend=backend)[0],
            cfg.remat)
        for lp in layer_list(params["enc_blocks"], cfg.enc_layers):
            enc_h = eblk(enc_h, lp)
        enc_h = rms_norm(enc_h, params["enc_norm"])

        def dblk(hh, lp):
            ek, ev = attn_kv_only(lp["xattn"], cfg, enc_h)
            hh, _, kv = _dense_block(lp, cfg, hh, positions, backend=backend,
                                     enc_kv=(ek, ev), want_kv=want_cache)
            return hh, kv, (ek, ev)
        dblk = _wrap_remat(dblk, cfg.remat)
        for i, lp in enumerate(layer_list(params["dec_blocks"],
                                          cfg.n_layers)):
            h, kv, (ek, ev) = dblk(h, lp)
            if want_cache:
                _store_kv(caches, cfg.n_layers, i, kv)
                _store_kv(caches, cfg.n_layers, i,
                          (ek.transpose(1, 2), ev.transpose(1, 2)),
                          ("cross_k", "cross_v"))
    else:
        raise ValueError(fam)
    return _logits(params, cfg, h), aux, caches


def lm_loss(params, cfg, batch, rules=None, mesh=None, *, backend="torch"):
    """Next-token cross-entropy of `forward`: labels are the tokens rolled
    left by one, the last position masked (and, for VLM, the image
    prefix).  Returns (loss float32 0-d, aux_dict).  The default backend
    is the plain-torch walk: the flash kernel has no backward (nor has the
    reference's), and its wrapper refuses autograd on a card.  On a mesh
    (`rules` and `mesh`): `spmd.lm_loss`, whose loss is a DTensor partial
    over the batch axes."""
    if rules is not None and mesh is not None:
        from . import spmd
        return spmd.lm_loss(params, cfg, batch, rules, mesh, backend=backend)
    logits, aux, _ = forward(params, cfg, batch, backend=backend)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    mask[:, -1].zero_()
    if cfg.family == "vlm":     # image prefix carries no LM loss
        mask[:, :cfg.n_image_tokens].zero_()
    return softmax_xent(logits, labels, mask), aux


# ---------------------------------------------------------------------------
# decode (one token against a pre-sized state)
# ---------------------------------------------------------------------------


def init_decode_state(cfg, seq_len: int, batch: int, device=None) -> dict:
    """Zero decode state on `device` (CUDA unless the caller asks for the
    CPU), as the reference's: KV caches (L, B, KH, seq_len, dh) bf16
    (hybrid: one a shared-block application, with the mamba layers'
    stacked SSM and conv states; enc-dec: also cross caches of seq_len //
    enc_seq_div frames), or xLSTM's per-layer recurrent states."""
    dev = resolve_device(device)
    fam = cfg.family

    def kv(n, S):
        return torch.zeros((n, batch, cfg.n_kv_heads, S, cfg.head_dim),
                           dtype=torch.bfloat16, device=dev)

    if fam in ("dense", "moe", "vlm"):
        return {"k": kv(cfg.n_layers, seq_len), "v": kv(cfg.n_layers, seq_len)}
    if fam == "ssm":
        return {name: (slstm_init_state if name.endswith("s")
                       else mlstm_block_init_state)(cfg, batch, dev)
                for name in ssm_layer_names(cfg)}
    if fam == "hybrid":
        n_apps = cfg.n_layers // cfg.attn_every
        per = mamba2_init_state(cfg, batch, dev)
        return {"mamba": {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
                          for k, v in per.items()},
                "k": kv(n_apps, seq_len), "v": kv(n_apps, seq_len)}
    if fam == "encdec":
        Se = seq_len // cfg.enc_seq_div
        return {"k": kv(cfg.n_layers, seq_len),
                "v": kv(cfg.n_layers, seq_len),
                "cross_k": kv(cfg.n_layers, Se),
                "cross_v": kv(cfg.n_layers, Se)}
    raise ValueError(fam)


def decode_state_specs(cfg, seq_len: int, batch: int, rules):
    """(shape tree, spec tree) of the decode state: `init_decode_state` on
    ``meta`` (shapes and dtypes, no data) and the reference's specs, by
    the same path rules (KV caches, mamba2 SSM and conv states, mLSTM
    matrix memories and convs; any other state batch-sharded)."""
    state = init_decode_state(cfg, seq_len, batch, device="meta")
    kv_l = P(None, *rules.kv_cache(batch, cfg.n_kv_heads))
    mamba_heads = (cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
                   if cfg.ssm_headdim else 0)
    bax = rules.batch_ax(batch)

    def spec_of(names, leaf):
        if any(n in ("k", "v", "cross_k", "cross_v") for n in names):
            return kv_l
        if "ssm" in names:
            return P(None, *rules.ssm_state(batch, mamba_heads))
        if "conv" in names and "mamba" in names:
            return P(None, bax, None, None)
        if "C" in names:
            dk = 2 * cfg.d_model // cfg.n_heads
            return P(*rules.mlstm_state(batch, cfg.n_heads, dk))
        if "conv" in names:
            return P(bax, None, None)
        if leaf.dim() >= 1:
            return P(bax, *([None] * (leaf.dim() - 1)))
        return P()

    def walk(tree, names):
        return {k: walk(v, names + (k,)) if isinstance(v, dict)
                else spec_of(names + (k,), v) for k, v in tree.items()}

    return state, walk(state, ())


def _write(state: dict, new: dict) -> None:
    for k, v in new.items():
        state[k].copy_(v)


def decode_step(params, cfg, batch, state, rules=None, mesh=None):
    """One decode step.  batch: tokens (B,1), cur_len int or int32 scalar
    (number of already-cached positions; the new token is written at index
    cur_len) [+ positions (B,1) or (B,1,3)].  Returns (logits (B,1,Vp),
    new_state).

    Unlike the reference (a new state from a donated one), the state is
    updated in place: `new_state` is `state`, its caches written at
    ``cur_len`` by `index_copy_` and its recurrent states overwritten.
    With `rules` and a `DeviceMesh` `mesh`: `spmd.decode_step` on DTensor
    params and state (under `decode_state_specs`)."""
    if rules is not None and mesh is not None:
        from . import spmd
        return spmd.decode_step(params, cfg, batch, state, rules, mesh)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    cur = torch.as_tensor(batch["cur_len"], dtype=torch.int64,
                          device=tokens.device).reshape(())
    h = params["embed"][tokens].to(torch.bfloat16)
    positions = batch.get("positions")
    if positions is None:
        positions = cur.to(torch.int32).expand(B, 1)
    idx = cur.reshape(1)
    fam = cfg.family

    def attn_decode(lp, h, kc, vc):
        q, k, v = attn_qkv(lp["attn"], cfg, rms_norm(h, lp["ln1"]),
                           positions)
        kc.index_copy_(2, idx, k.transpose(1, 2).to(kc.dtype))
        vc.index_copy_(2, idx, v.transpose(1, 2).to(vc.dtype))
        o = decode_attention(q, kc, vc, cur + 1, window=cfg.window)
        return h + o.reshape(B, 1, -1) @ lp["attn"]["wo"]

    def ffn_decode(lp, h):
        hn = rms_norm(h, lp["ln2"])
        if "moe" in lp:
            return h + moe_apply(lp["moe"], cfg, hn)[0]
        return h + mlp(lp["mlp"], cfg, hn)

    if fam in ("dense", "moe", "vlm"):
        for i in range(cfg.n_layers):
            lp = layer_slice(params["blocks"], i)
            h = ffn_decode(lp, attn_decode(lp, h, state["k"][i],
                                           state["v"][i]))
    elif fam == "ssm":
        for name in ssm_layer_names(cfg):
            lp = params["layers"][name]
            step = slstm_block_decode if name.endswith("s") else \
                mlstm_block_decode
            y, new = step(lp, cfg, rms_norm(h, lp["ln"]), state[name])
            h = h + y
            _write(state[name], new)
    elif fam == "hybrid":
        period, L = cfg.attn_every, cfg.n_layers
        n_groups = L // period

        def mamba_layers(lo, hi, h):
            for i in range(lo, hi):
                lp = layer_slice(params["mamba"], i)
                st = layer_slice(state["mamba"], i)
                y, new = mamba2_decode_step(lp, cfg, rms_norm(h, lp["ln"]),
                                            st)
                _write(st, new)
                h = h + y
            return h

        shared = params["shared_attn"]
        for gi in range(n_groups):
            h = mamba_layers(gi * period, (gi + 1) * period, h)
            h = ffn_decode(shared, attn_decode(shared, h, state["k"][gi],
                                               state["v"][gi]))
        h = mamba_layers(n_groups * period, L, h)
    elif fam == "encdec":
        for i in range(cfg.n_layers):
            lp = layer_slice(params["dec_blocks"], i)
            h = attn_decode(lp, h, state["k"][i], state["v"][i])
            q = attn_q_only(lp["xattn"], cfg, rms_norm(h, lp["ln_x"]))
            xk, xv = state["cross_k"][i], state["cross_v"][i]
            o = decode_attention(q, xk, xv, xk.shape[2])
            h = ffn_decode(lp, h + o.reshape(B, 1, -1) @ lp["xattn"]["wo"])
    else:
        raise ValueError(fam)
    return _logits(params, cfg, h), state
