"""The LM on a `DeviceMesh`: `forward`, `lm_loss` and `decode_step` of
`models/transformer.py` with ``rules`` and ``mesh`` given.

Params, decode state and outputs are DTensors placed by the reference's
spec trees (`transformer.param_specs`, `decode_state_specs`).  The model
runs one `dist.compat.shard_map` a layer (and one each for the embedding,
the head and the loss); between them the residual stream is a DTensor
under ``rules.act_hidden`` (`with_spec`), and inside them each rank works
on its local shards with explicit collectives:

* FSDP: a weight dim sharded on ``data`` is all-gathered before use (its
  gradient reduce-scattered back);
* tensor parallel over ``model``: attention on the rank's own heads (the
  flash kernel's (B, H_local, S, dh) operands), the MLP and the experts on
  its own d_ff columns, each closed by a `psum` over ``model``; a
  replicated value entering such a computation passes `enter` (its
  cotangent is summed over ``model``);
* KV heads replicated because ``model`` outnumbers them: every rank makes
  all of them (the cache holds them all, as ``rules.kv_cache`` says) and
  attends its q heads against the one group they read (global q head h
  reads kv head ``h // (H / KH)``);
* the vocabulary on ``model``: a masked lookup summed over ``model`` for
  the embedding, vocab-sharded logits, and a cross-entropy whose
  logsumexp and gold logit are reduced over ``model``;
* layers whose weights the rules shard without a head split this port
  parallelises (mamba2, xLSTM, attention whose q heads are not split, an
  MLP whose d_ff does not split): their weights are gathered whole and the
  layer runs replicated over ``model`` on the rank's batch rows; their
  sharded decode states are gathered and each rank writes back its block;
* MoE: ``moe_dispatch="shardmap"`` runs the reference's shard-local
  dispatch (`moe.moe_shardmap_local`); the global and local dispatches
  gather the batch, run the unsharded dispatch, and keep the rank's rows.

On a 1 x 1 mesh every spec but the FSDP ones is replicated and every
collective is over one rank, so each layer runs the unsharded port's
arithmetic: outputs equal the unsharded step's bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..dist.compat import (all_gather, axis_index, axis_size, enter, psum,
                           shard_map, to_dtensor)
from ..dist.sharding import P, placements
from .attention import (attention_layer, attn_kv_only, attn_q_only,
                        attn_qkv, blocked_attention, decode_attention)
from .common import (apply_mrope, apply_rope, head_rms_norm, rms_norm,
                     with_spec)
from .mamba2 import mamba2_decode_step, mamba2_forward
from .mlp import mlp
from .moe import moe_apply, moe_shardmap_local, xla_mean
from .transformer import (_wrap_remat, decode_state_specs, param_specs,
                          ssm_layer_names)
from .xlstm import (mlstm_block, mlstm_block_decode, slstm_block,
                    slstm_block_decode)

MODEL = "model"


# ---------------------------------------------------------------------------
# weights inside a body
# ---------------------------------------------------------------------------


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _gather(w, spec, axes):
    """`w`'s local block gathered over those of `spec`'s axes in `axes`."""
    for d, entry in enumerate(spec):
        sel = tuple(a for a in _names(entry) if a in axes)
        if sel:
            w = all_gather(w, sel if len(sel) > 1 else sel[0], d)
    return w


def fsdp(w, spec):
    """The weight with its FSDP (``data``) dims gathered."""
    return _gather(w, spec, ("data", "pod"))


def full(w, spec):
    """The whole weight: every sharded dim gathered."""
    return _gather(w, spec, ("data", "pod", MODEL))


def full_tree(p, s):
    return {k: full_tree(v, s[k]) if isinstance(v, dict) else full(v, s[k])
            for k, v in p.items()}


def _tp(spec, dim) -> bool:
    return MODEL in _names(spec[dim])


# ---------------------------------------------------------------------------
# layers inside a body (local tensors)
# ---------------------------------------------------------------------------


def _rotary(cfg, x, positions):
    if cfg.mrope_sections:
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    if cfg.use_rope:
        pos1d = positions[..., 0] if positions.dim() == 3 else positions
        return apply_rope(x, pos1d, cfg.rope_theta)
    return x


def _kv(p, s, cfg, x, kv_tp):
    """k, v (B, S, KH_local, dh) after qk-norm (no rotary): the rank's own
    KV heads when they split over ``model``, all of them otherwise (made
    from the replicated `x`, as a replicated computation)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    xk = enter(x, MODEL) if kv_tp else x
    k = (xk @ fsdp(p["wk"], s["wk"])).reshape(B, S, -1, dh)
    v = (xk @ fsdp(p["wv"], s["wv"])).reshape(B, S, -1, dh)
    if cfg.qk_norm:
        kn = enter(p["k_norm"], MODEL) if kv_tp else p["k_norm"]
        k = head_rms_norm(k, kn)
    return k, v


def _q(p, s, cfg, x):
    B, S, _ = x.shape
    q = (enter(x, MODEL) @ fsdp(p["wq"], s["wq"])).reshape(
        B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, enter(p["q_norm"], MODEL))
    return q


def _kv_for_heads(cfg, k, v, kv_tp, dim):
    """The KV heads this rank's q heads read (on head axis `dim`)."""
    if kv_tp:
        return k, v
    H, KH = cfg.n_heads, cfg.n_kv_heads
    Hl = H // axis_size(MODEL)
    lo = (axis_index(MODEL) * Hl) // (H // KH)
    return (enter(k, MODEL).narrow(dim, lo, 1),
            enter(v, MODEL).narrow(dim, lo, 1))


def attention_tp(p, s, cfg, x, positions, *, causal=True, backend="cuda",
                 kv_override=None, return_kv=False):
    """`attention.attention_layer` on the rank's heads.  kv_override:
    cross-attention's (k, v) from `_kv` of the encoder states."""
    if not _tp(s["wq"], 1):
        return attention_layer(full_tree(p, s), cfg, x, positions,
                               causal=causal, backend=backend,
                               kv_override=kv_override, return_kv=return_kv)
    B, S, _ = x.shape
    kv_tp = _tp(s["wk"], 1)
    q = _q(p, s, cfg, x)
    if kv_override is not None:
        k, v = kv_override
        causal, backend = False, "torch"
    else:
        k, v = _kv(p, s, cfg, x, kv_tp)
        q = _rotary(cfg, q, positions)
        k = _rotary(cfg, k, positions)
    ka, va = _kv_for_heads(cfg, k, v, kv_tp, 2)
    o = blocked_attention(q, ka, va, causal=causal, window=cfg.window,
                          q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk,
                          backend=backend)
    out = psum(o.reshape(B, S, -1) @ fsdp(p["wo"], s["wo"]), MODEL)
    if return_kv:
        return out, (k.transpose(1, 2), v.transpose(1, 2))
    return out


def cross_kv(p, s, cfg, enc_h):
    """Cross-attention's (k, v) of the encoder states, as `attention_tp`
    takes them (all heads when q heads do not split)."""
    if not _tp(s["wq"], 1):
        return attn_kv_only(full_tree(p, s), cfg, enc_h)
    return _kv(p, s, cfg, enc_h, _tp(s["wk"], 1))


def mlp_tp(p, s, cfg, x):
    first = "w_gate" if cfg.mlp_kind == "swiglu" else "w_in"
    if not _tp(s[first], 1):
        return mlp(full_tree(p, s), cfg, x)
    w = {k: fsdp(v, s[k]) for k, v in p.items()}
    return psum(mlp(w, cfg, enter(x, MODEL)), MODEL)


def moe_tp(p, s, cfg, x, batch_axes, mode, capacity_factor=1.25):
    """(y, drop): the shard-local dispatch under ``"shardmap"``; otherwise
    the unsharded dispatch on the gathered batch, the rank's rows kept."""
    if mode == "shardmap" and batch_axes:
        return moe_shardmap_local(p, s, cfg, x, capacity_factor=capacity_factor)
    Bl = x.shape[0]
    xg = all_gather(x, batch_axes, 0) if batch_axes else x
    y, drop = moe_apply(full_tree(p, s), cfg, xg,
                        capacity_factor=capacity_factor)
    if batch_axes:
        y = y.narrow(0, axis_index(batch_axes) * Bl, Bl)
    return y, drop


def dense_block_tp(lp, ls, cfg, h, positions, *, causal=True,
                   backend="cuda", enc_kv=None, want_kv=False,
                   batch_axes=(), moe_mode="global"):
    """`transformer._dense_block` on local shards: (h, drop or None, kv)."""
    attn_out = attention_tp(lp["attn"], ls["attn"], cfg,
                            rms_norm(h, lp["ln1"]), positions, causal=causal,
                            backend=backend, return_kv=want_kv)
    kv = ()
    if want_kv:
        attn_out, kv = attn_out
    h = h + attn_out
    if enc_kv is not None:
        h = h + attention_tp(lp["xattn"], ls["xattn"], cfg,
                             rms_norm(h, lp["ln_x"]), positions,
                             kv_override=enc_kv, backend=backend)
    hn = rms_norm(h, lp["ln2"])
    if "moe" in lp:
        y, drop = moe_tp(lp["moe"], ls["moe"], cfg, hn, batch_axes, moe_mode)
        return h + y, drop, kv
    return h + mlp_tp(lp["mlp"], ls["mlp"], cfg, hn), None, kv


# ---------------------------------------------------------------------------
# embedding, head, loss (local tensors)
# ---------------------------------------------------------------------------


def _vocab_lo(table_rows: int) -> int:
    return axis_index(MODEL) * table_rows


def embed_tp(table, spec, tokens):
    """(B, S) tokens -> (B, S, D) bf16: a masked lookup in the rank's
    vocab rows, summed over ``model``, when the vocab is sharded."""
    table = fsdp(table, spec)
    if not _tp(spec, 0):
        return table[tokens].to(torch.bfloat16)
    Vl = table.shape[0]
    idx = tokens.long() - _vocab_lo(Vl)
    ok = (idx >= 0) & (idx < Vl)
    e = F.embedding(idx.clamp(0, Vl - 1), table)
    e = torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                  device=e.device))
    return psum(e, MODEL).to(torch.bfloat16)


def logits_tp(params, specs, cfg, h):
    """(B, S, D) -> (B, S, V_local): the rank's vocab columns."""
    h = rms_norm(h, params["final_norm"])
    if cfg.tie_embeddings:
        head, tp = fsdp(params["embed"], specs["embed"]).T, \
            _tp(specs["embed"], 0)
    else:
        head, tp = fsdp(params["head"], specs["head"]), \
            _tp(specs["head"], 1)
    return (enter(h, MODEL) if tp else h) @ head


def xent_tp(logits, labels, mask, vocab_tp, batch_axes):
    """This rank's share of the masked mean cross-entropy: its rows'
    sum over the global mask count (the shares sum to the loss over the
    batch axes; every ``model`` rank holds the same share)."""
    lf = logits.float()
    if vocab_tp:
        Vl = lf.shape[-1]
        with torch.no_grad():
            m = all_gather(lf.amax(-1, keepdim=True), MODEL, -1).amax(
                -1, keepdim=True)
        lse = torch.log(psum(torch.exp(lf - m).sum(-1), MODEL)) + m[..., 0]
        idx = labels.long() - _vocab_lo(Vl)
        ok = (idx >= 0) & (idx < Vl)
        g = torch.gather(lf, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
        gold = psum(torch.where(ok, g, torch.zeros((), device=g.device)),
                    MODEL)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    count = mask.sum()
    if batch_axes:
        with torch.no_grad():
            count = psum(count, batch_axes)
    return torch.sum(nll * mask) / torch.clamp(count, min=1)


# ---------------------------------------------------------------------------
# the sharded model (DTensors between layers)
# ---------------------------------------------------------------------------


def _layer(tree, i):
    if isinstance(tree, list):
        return tree[i]
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(spec_tree):
    """The spec tree of one layer of a stacked tree (its leading None
    dropped)."""
    if isinstance(spec_tree, dict):
        return {k: _unstack(v) for k, v in spec_tree.items()}
    return P(*spec_tree[1:])


class Sharded:
    """One sharded step's view of the mesh: the rules, the param specs,
    the batch axes and the shard_map factory with its varying axes."""

    def __init__(self, cfg, rules, mesh, batch: int):
        self.cfg, self.rules, self.mesh = cfg, rules, mesh
        self.specs = param_specs(cfg, rules)
        ax = rules.batch_ax(batch)
        self.batch_axes = _names(ax)
        self.act = rules.act_hidden(batch)
        self.bspec = lambda nd: P(ax, *([None] * (nd - 1)))

    def map(self, f, in_specs, out_specs):
        return shard_map(f, mesh=self.mesh, in_specs=in_specs,
                         out_specs=out_specs, varying=self.batch_axes)

    def mean_over_batch(self, drop):
        """A per-shard scalar's mean over the batch shards."""
        if not self.batch_axes:
            return drop
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.size(self.mesh.mesh_dim_names.index(a))
        f = self.map(lambda d: psum(d, self.batch_axes) / n, (None,), None)
        return f(drop)


def _batch_inputs(sh, batch):
    """(tokens, extra inputs) as DTensors under the batch spec."""
    out = {}
    for k, v in batch.items():
        if k == "cur_len":
            continue
        out[k] = to_dtensor(v, sh.mesh, sh.bspec(v.dim()))
    return out


def _positions_local(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def forward(params, cfg, batch, rules, mesh, *, backend="cuda",
            want_cache=False):
    """`transformer.forward` on `mesh`: (logits DTensor under
    ``rules.act_logits``, aux, caches as DTensors under the stacked
    ``rules.kv_cache`` or None)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    sh = Sharded(cfg, rules, mesh, B)
    specs, act = sh.specs, sh.act
    ins = _batch_inputs(sh, batch)
    tok_spec = sh.bspec(2)
    moe_mode = cfg.moe_dispatch

    def emb(table, tok, *extra):
        h = embed_tp(table, specs["embed"], tok)
        if cfg.family == "vlm":
            img = extra[0].to(h.dtype)
            h = torch.cat([img, h[:, cfg.n_image_tokens:]], dim=1)
        return h

    extra = (ins["image_embeds"],) if cfg.family == "vlm" else ()
    h = sh.map(emb, (specs["embed"], tok_spec) + tuple(
        sh.bspec(3) for _ in extra), act)(params["embed"], ins["tokens"],
                                          *extra)
    h = with_spec(h, act, mesh)
    pos = ins.get("positions")
    pos_spec = sh.bspec(pos.dim()) if pos is not None else None

    def positions_of(hl, pl):
        return pl if pl is not None else _positions_local(
            hl.shape[0], hl.shape[1], hl.device)

    aux = {"moe_drop_frac": torch.zeros((), device=_local(h).device)}
    caches = {} if want_cache else None
    kv_store = []
    fam = cfg.family

    def block_body(ls, causal=True):
        def body(lp, hl, pl):
            return dense_block_tp(lp, ls, cfg, hl, positions_of(hl, pl),
                                  causal=causal, backend=backend,
                                  want_kv=want_cache,
                                  batch_axes=sh.batch_axes,
                                  moe_mode=moe_mode)
        return _wrap_remat(sh.map(body, (ls, act, pos_spec),
                                  (act, None, None)), cfg.remat)

    if fam in ("dense", "moe", "vlm"):
        ls = _unstack(specs["blocks"])
        f = block_body(ls)
        drops = []
        for i in range(cfg.n_layers):
            h, drop, kv = f(_layer(params["blocks"], i), h, pos)
            if drop is not None:
                drops.append(drop)
            if want_cache:
                kv_store.append(kv)
        if drops:
            aux["moe_drop_frac"] = sh.mean_over_batch(
                xla_mean(torch.stack(drops)))
    elif fam == "ssm":
        for name in ssm_layer_names(cfg):
            ls = specs["layers"][name]
            block = slstm_block if name.endswith("s") else mlstm_block

            def sbody(lp, hl, ls=ls, block=block):
                return hl + block(full_tree(lp, ls), cfg,
                                  rms_norm(hl, lp["ln"]))
            h = sh.map(sbody, (ls, act), act)(params["layers"][name], h)
    elif fam == "hybrid":
        period, L = cfg.attn_every, cfg.n_layers
        n_groups = L // period
        ms = _unstack(specs["mamba"])
        mf = _wrap_remat(sh.map(lambda lp, hl: hl + mamba2_forward(
            full_tree(lp, ms), cfg, rms_norm(hl, lp["ln"])),
            (ms, act), act), cfg.remat)
        # the reference does not remat the shared block
        shared = sh.map(lambda lp, hl, pl: dense_block_tp(
            lp, specs["shared_attn"], cfg, hl, positions_of(hl, pl),
            backend=backend, want_kv=want_cache), (specs["shared_attn"], act,
                                                   pos_spec), (act, None, None))

        def mamba_layers(lo, hi, h):
            for i in range(lo, hi):
                h = mf(_layer(params["mamba"], i), h)
            return h

        for gi in range(n_groups):
            h = mamba_layers(gi * period, (gi + 1) * period, h)
            h, _, kv = shared(params["shared_attn"], h, pos)
            if want_cache:
                kv_store.append(kv)
        h = mamba_layers(n_groups * period, L, h)
    elif fam == "encdec":
        enc = ins["enc_embeds"]
        es = _unstack(specs["enc_blocks"])
        ef = _wrap_remat(sh.map(lambda lp, el: dense_block_tp(
            lp, es, cfg, el, _positions_local(el.shape[0], el.shape[1],
                                              el.device),
            causal=False, backend=backend)[0], (es, act), act), cfg.remat)
        enc_h = sh.map(lambda e: e.to(torch.bfloat16), (act,), act)(enc)
        for i in range(cfg.enc_layers):
            enc_h = ef(_layer(params["enc_blocks"], i), enc_h)
        enc_h = sh.map(lambda e, w: rms_norm(e, w), (act, P(None)), act)(
            enc_h, params["enc_norm"])
        ds = _unstack(specs["dec_blocks"])

        def dbody(lp, hl, el, pl):
            ek, ev = cross_kv(lp["xattn"], ds["xattn"], cfg, el)
            hl, _, kv = dense_block_tp(lp, ds, cfg, hl, positions_of(hl, pl),
                                       backend=backend, enc_kv=(ek, ev),
                                       want_kv=want_cache)
            xkv = (ek.transpose(1, 2), ev.transpose(1, 2)) \
                if want_cache else ()
            return hl, kv, xkv
        df = _wrap_remat(sh.map(dbody, (ds, act, act, pos_spec),
                                (act, None, None)), cfg.remat)
        for i in range(cfg.n_layers):
            h, kv, xkv = df(_layer(params["dec_blocks"], i), h, enc_h, pos)
            if want_cache:
                kv_store.append(kv + xkv)
    else:
        raise ValueError(fam)

    head_spec = specs["embed"] if cfg.tie_embeddings else specs["head"]
    logit_spec = rules.act_logits(B, cfg.vocab_padded)
    hp = {"final_norm": params["final_norm"],
          ("embed" if cfg.tie_embeddings else "head"):
          params["embed" if cfg.tie_embeddings else "head"]}
    hs = {"final_norm": specs["final_norm"],
          ("embed" if cfg.tie_embeddings else "head"): head_spec}
    logits = sh.map(lambda p, hl: logits_tp(p, hs, cfg, hl), (hs, act),
                    logit_spec)(hp, h)
    logits = with_spec(logits, logit_spec, mesh)
    if want_cache and kv_store:
        caches = _stack_caches(sh, cfg, kv_store, B)
    return logits, aux, caches


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _stack_caches(sh, cfg, kv_store, B):
    """Per-layer local (k, v[, cross_k, cross_v]) -> stacked DTensors
    under ``P(None, *rules.kv_cache(B, KH))``."""
    names = ("k", "v", "cross_k", "cross_v")
    spec = P(None, *sh.rules.kv_cache(B, cfg.n_kv_heads))
    pl = placements(sh.mesh, spec)
    out = {}
    for j in range(len(kv_store[0])):
        local = torch.stack([kv[j] for kv in kv_store])
        out[names[j]] = DTensor.from_local(local, sh.mesh, pl,
                                           run_check=False)
    return out


def lm_loss(params, cfg, batch, rules, mesh, *, backend="torch"):
    """`transformer.lm_loss` on `mesh`: (loss, aux).  The loss is a 0-d
    DTensor, `Partial` over the batch axes (each rank holds its rows'
    share; ``loss.full_tensor()`` is the loss) and replicated over the
    others; backpropagate its local share (``loss.to_local()``)."""
    logits, aux, _ = forward(params, cfg, batch, rules, mesh,
                             backend=backend)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    sh = Sharded(cfg, rules, mesh, B)
    tok = to_dtensor(tokens, mesh, sh.bspec(2))
    vocab_tp = rules._model(cfg.vocab_padded) == MODEL

    def body(lg, tk):
        labels = torch.cat([tk[:, 1:], tk[:, :1]], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1].zero_()
        if cfg.family == "vlm":
            mask[:, :cfg.n_image_tokens].zero_()
        return xent_tp(lg, labels, mask, vocab_tp, sh.batch_axes)

    share = sh.map(body, (rules.act_logits(B, cfg.vocab_padded),
                          sh.bspec(2)), None)(logits, tok)
    pl = [Partial() if n in sh.batch_axes else Replicate()
          for n in mesh.mesh_dim_names]
    return DTensor.from_local(share, mesh, pl, run_check=False), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _own(new, old, spec_entry_dim):
    """Write the rank's block of a state gathered over ``model``."""
    n = old.shape[spec_entry_dim]
    old.copy_(new.narrow(spec_entry_dim, axis_index(MODEL) * n, n))


def _state_full(st, sspec):
    """A layer's decode state with its ``model``-sharded dims gathered."""
    return {k: _gather(v, sspec[k], (MODEL,)) for k, v in st.items()}


def _state_write(st, sspec, new):
    for k, v in st.items():
        dims = [d for d, e in enumerate(sspec[k]) if MODEL in _names(e)]
        if dims:
            _own(new[k], v, dims[0])
        else:
            v.copy_(new[k])


def attn_decode_tp(p, s, cfg, h, kc, vc, cur, positions):
    """One token's attention against the local caches (written at cur)."""
    B = h.shape[0]
    tp = _tp(s["wq"], 1)
    if tp:
        kv_tp = _tp(s["wk"], 1)
        q = _rotary(cfg, _q(p, s, cfg, h), positions)
        k, v = _kv(p, s, cfg, h, kv_tp)
        k = _rotary(cfg, k, positions)
        wo = fsdp(p["wo"], s["wo"])
    else:
        pf = full_tree(p, s)
        q, k, v = attn_qkv(pf, cfg, h, positions)
        wo = pf["wo"]
    idx = cur.reshape(1)
    kc.index_copy_(2, idx, k.transpose(1, 2).to(kc.dtype))
    vc.index_copy_(2, idx, v.transpose(1, 2).to(vc.dtype))
    ka, va = _kv_for_heads(cfg, kc, vc, kv_tp, 1) if tp else (kc, vc)
    o = decode_attention(q, ka, va, cur + 1, window=cfg.window)
    out = o.reshape(B, 1, -1) @ wo
    return psum(out, MODEL) if tp else out


def decode_step(params, cfg, batch, state, rules, mesh):
    """`transformer.decode_step` on `mesh`: the state (DTensors under
    `decode_state_specs`) is updated in place; returns (logits DTensor
    under ``rules.act_logits``, state)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    sh = Sharded(cfg, rules, mesh, B)
    specs, act = sh.specs, sh.act
    ins = _batch_inputs(sh, batch)
    cur = torch.as_tensor(batch["cur_len"], dtype=torch.int64,
                          device=_local(ins["tokens"]).device).reshape(())
    _, sspecs = decode_state_specs(cfg, 1, B, rules)
    h = sh.map(lambda t, tk: embed_tp(t, specs["embed"], tk),
               (specs["embed"], sh.bspec(2)), act)(params["embed"],
                                                  ins["tokens"])
    pos = ins.get("positions")
    pos_spec = sh.bspec(pos.dim()) if pos is not None else None
    fam = cfg.family
    moe_mode = cfg.moe_dispatch

    def positions_of(hl, pl):
        return pl if pl is not None else cur.to(torch.int32).expand(
            hl.shape[0], 1)

    def ffn(lp, ls, hl):
        hn = rms_norm(hl, lp["ln2"])
        if "moe" in lp:
            return hl + moe_tp(lp["moe"], ls["moe"], cfg, hn, sh.batch_axes,
                               moe_mode)[0]
        return hl + mlp_tp(lp["mlp"], ls["mlp"], cfg, hn)

    def attn_block(ls, kvs):
        def body(lp, hl, kc, vc, pl):
            hl = hl + attn_decode_tp(lp["attn"], ls["attn"], cfg,
                                     rms_norm(hl, lp["ln1"]), kc, vc, cur,
                                     positions_of(hl, pl))
            return ffn(lp, ls, hl)
        return sh.map(body, (ls, act, kvs, kvs, pos_spec), act)

    kv1 = _unstack(sspecs["k"]) if "k" in sspecs else None
    if fam in ("dense", "moe", "vlm"):
        f = attn_block(_unstack(specs["blocks"]), kv1)
        for i in range(cfg.n_layers):
            h = f(_layer(params["blocks"], i), h, state["k"][i],
                  state["v"][i], pos)
    elif fam == "ssm":
        for name in ssm_layer_names(cfg):
            ls, ss = specs["layers"][name], sspecs[name]
            step = slstm_block_decode if name.endswith("s") else \
                mlstm_block_decode

            def sbody(lp, hl, st, ls=ls, ss=ss, step=step):
                y, new = step(full_tree(lp, ls), cfg, rms_norm(hl, lp["ln"]),
                              _state_full(st, ss))
                _state_write(st, ss, new)
                return hl + y
            h = sh.map(sbody, (ls, act, ss), act)(params["layers"][name], h,
                                                  state[name])
    elif fam == "hybrid":
        period, L = cfg.attn_every, cfg.n_layers
        n_groups = L // period
        ms = _unstack(specs["mamba"])
        mss = _unstack(sspecs["mamba"])

        def mbody(lp, hl, st):
            y, new = mamba2_decode_step(full_tree(lp, ms), cfg,
                                        rms_norm(hl, lp["ln"]),
                                        _state_full(st, mss))
            _state_write(st, mss, new)
            return hl + y
        mf = sh.map(mbody, (ms, act, mss), act)

        def mamba_layers(lo, hi, h):
            for i in range(lo, hi):
                h = mf(_layer(params["mamba"], i), h,
                       _layer(state["mamba"], i))
            return h

        shared = attn_block(specs["shared_attn"], kv1)
        for gi in range(n_groups):
            h = mamba_layers(gi * period, (gi + 1) * period, h)
            h = shared(params["shared_attn"], h, state["k"][gi],
                       state["v"][gi], pos)
        h = mamba_layers(n_groups * period, L, h)
    elif fam == "encdec":
        ds = _unstack(specs["dec_blocks"])
        xs = _unstack(sspecs["cross_k"])

        def dbody(lp, hl, kc, vc, xk, xv, pl):
            hl = hl + attn_decode_tp(lp["attn"], ds["attn"], cfg,
                                     rms_norm(hl, lp["ln1"]), kc, vc, cur,
                                     positions_of(hl, pl))
            hn = rms_norm(hl, lp["ln_x"])
            if _tp(ds["xattn"]["wq"], 1):
                q = _q(lp["xattn"], ds["xattn"], cfg, hn)
                xa, va = _kv_for_heads(cfg, xk, xv,
                                       _tp(ds["xattn"]["wk"], 1), 1)
                o = decode_attention(q, xa, va, xk.shape[2])
                hl = hl + psum(o.reshape(hl.shape[0], 1, -1) @ fsdp(
                    lp["xattn"]["wo"], ds["xattn"]["wo"]), MODEL)
            else:
                pf = full_tree(lp["xattn"], ds["xattn"])
                q = attn_q_only(pf, cfg, hn)
                o = decode_attention(q, xk, xv, xk.shape[2])
                hl = hl + o.reshape(hl.shape[0], 1, -1) @ pf["wo"]
            return ffn(lp, ds, hl)
        df = sh.map(dbody, (ds, act, kv1, kv1, xs, xs, pos_spec), act)
        for i in range(cfg.n_layers):
            h = df(_layer(params["dec_blocks"], i), h, state["k"][i],
                   state["v"][i], state["cross_k"][i], state["cross_v"][i],
                   pos)
    else:
        raise ValueError(fam)

    head_spec = specs["embed"] if cfg.tie_embeddings else specs["head"]
    key = "embed" if cfg.tie_embeddings else "head"
    hp = {"final_norm": params["final_norm"], key: params[key]}
    hs = {"final_norm": specs["final_norm"], key: head_spec}
    logit_spec = rules.act_logits(B, cfg.vocab_padded)
    logits = sh.map(lambda p, hl: logits_tp(p, hs, cfg, hl), (hs, act),
                    logit_spec)(hp, h)
    return with_spec(logits, logit_spec, mesh), state
