"""Model composition, dense family (qwen3-4b, yi-6b, minitron-8b,
granite-34b: one block, differing in MLP kind and head counts).

Layers are stacked on a leading axis, as the reference's `stack_init`
makes them, and applied by a Python loop over that axis (the reference's
``lax.scan``).  The other families raise `NotImplementedError`: their
slices are queued in ROADMAP.md (Queue 1 item 8, "The remaining LM
families").  Training (`lm_loss`, remat) belongs to the training slice.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from .attention import attn_qkv, attention_layer, decode_attention
from .attention import init_attention
from .common import dense, layer_slice, rms_norm, stack_init
from .mlp import init_mlp, mlp

FAMILIES = ("dense",)


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            f"port has the dense family (ROADMAP.md Queue 1 item 8, "
            f"'The remaining LM families')")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_dense_block(gen, cfg) -> dict:
    ones = lambda: torch.ones(cfg.d_model, dtype=torch.bfloat16,
                              device=gen.device)
    return {"ln1": ones(), "attn": init_attention(gen, cfg), "ln2": ones(),
            "mlp": init_mlp(gen, cfg)}


def init_model(cfg, *, seed: int = 0, device=None) -> dict:
    """Seeded random parameters at the reference's shapes and scales: one
    `torch.Generator` on `device` (CUDA unless the caller asks for the CPU)
    draws every tensor in float32, one tensor at a time, each cast to bf16
    at once.  The numbers differ from the reference's `jax.random` ones;
    to compare the two, carry the reference's tree across with
    `core.convert.lm_params_from_numpy`."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Vp, D = cfg.vocab_padded, cfg.d_model
    p = {"embed": dense(gen, Vp, D, scale=0.02),
         "final_norm": torch.ones(D, dtype=torch.bfloat16, device=dev)}
    if not cfg.tie_embeddings:
        p["head"] = dense(gen, D, Vp, scale=0.02)
    p["blocks"] = stack_init(lambda: _init_dense_block(gen, cfg),
                             cfg.n_layers)
    return p


def param_bytes(params: dict) -> int:
    """Bytes of a nested dict of tensors (params or decode state)."""
    return sum(param_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in params.values())


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _dense_block(lp, cfg, h, positions, *, backend="cuda", want_kv=False):
    attn_out = attention_layer(lp["attn"], cfg, rms_norm(h, lp["ln1"]),
                               positions, backend=backend, return_kv=want_kv)
    kv = ()
    if want_kv:
        attn_out, kv = attn_out
    h = h + attn_out
    h = h + mlp(lp["mlp"], cfg, rms_norm(h, lp["ln2"]))
    return h, kv


def _positions_1d(B, S, device):
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ head


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def forward(params, cfg, batch, *, backend="cuda", want_cache=False):
    """batch: tokens (B,S) [+ positions].  Returns (logits (B, S, Vp),
    aux_dict, caches | None); caches k/v are (L, B, KH, S, dh), written
    layer by layer into one preallocated tensor each."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = params["embed"][tokens].to(torch.bfloat16)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_1d(B, S, tokens.device)
    blocks = params["blocks"]
    L = cfg.n_layers
    caches = None
    if want_cache:
        shape = (L, B, cfg.n_kv_heads, S, cfg.head_dim)
        caches = {"k": torch.empty(shape, dtype=h.dtype, device=h.device),
                  "v": torch.empty(shape, dtype=h.dtype, device=h.device)}
    for i in range(L):
        h, kv = _dense_block(layer_slice(blocks, i), cfg, h, positions,
                             backend=backend, want_kv=want_cache)
        if want_cache:
            caches["k"][i].copy_(kv[0])
            caches["v"][i].copy_(kv[1])
    aux = {"moe_drop_frac": torch.zeros((), device=h.device)}
    return _logits(params, cfg, h), aux, caches


# ---------------------------------------------------------------------------
# decode (one token against a pre-sized state)
# ---------------------------------------------------------------------------


def init_decode_state(cfg, seq_len: int, batch: int, device=None) -> dict:
    """Zero KV caches (L, B, KH, seq_len, dh) bf16 on `device` (CUDA unless
    the caller asks for the CPU)."""
    check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def decode_step(params, cfg, batch, state):
    """One decode step.  batch: tokens (B,1), cur_len int or int32 scalar
    (number of already-cached positions; the new token is written at index
    cur_len).  Returns (logits (B,1,Vp), new_state).

    Unlike the reference (`dynamic_update_slice` on a donated state), the
    caches are updated in place: `new_state` is `state`, its k/v written
    at ``cur_len`` by `index_copy_`."""
    check_family(cfg)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    cur = torch.as_tensor(batch["cur_len"], dtype=torch.int64,
                          device=tokens.device).reshape(())
    h = params["embed"][tokens].to(torch.bfloat16)
    positions = batch.get("positions")
    if positions is None:
        positions = cur.to(torch.int32).expand(B, 1)
    idx = cur.reshape(1)
    for i in range(cfg.n_layers):
        lp = layer_slice(params["blocks"], i)
        kc, vc = state["k"][i], state["v"][i]
        q, k, v = attn_qkv(lp["attn"], cfg, rms_norm(h, lp["ln1"]),
                           positions)
        kc.index_copy_(2, idx, k.transpose(1, 2).to(kc.dtype))
        vc.index_copy_(2, idx, v.transpose(1, 2).to(vc.dtype))
        o = decode_attention(q, kc, vc, cur + 1, window=cfg.window)
        h = h + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
        h = h + mlp(lp["mlp"], cfg, rms_norm(h, lp["ln2"]))
    return _logits(params, cfg, h), state
