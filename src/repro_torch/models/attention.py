"""Attention layers: GQA/MQA with qk-norm, RoPE/M-RoPE, sliding window,
cross-attention.  Two backends for the full-sequence path, as `core/serve`
names them: ``"cuda"`` (the default) runs the hand-written flash attention
kernel (`kernels/flash_attention`), ``"torch"`` the blocked "triangular"
online-softmax walk in plain torch (the twin of the reference's XLA path:
per q chunk, exactly the kv chunks it can see).  Cross-attention (q and kv
of different lengths, which no kernel takes) and decode attention over a
cache are plain torch on either backend, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from .common import apply_mrope, apply_rope, dense, head_rms_norm

NEG_INF = -1e30
BACKENDS = ("cuda", "torch")


# ---------------------------------------------------------------------------
# blocked attention — prefill
# ---------------------------------------------------------------------------


def _attn_block(q, k, v, q0, k0, causal, window):
    """q: (B, bq, H, dh) fp32-scaled; k/v: (B, bk, KH, dh).
    Returns (scores-reduced partials): m (B, bq, H), l, acc (B, bq, H, dh)."""
    B, bq, H, dh = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, bq, KH, G, dh)
    s = torch.einsum("bqkgd,btkd->bqkgt", qg, k.float())
    rows = q0 + torch.arange(bq, device=q.device)[:, None]
    cols = k0 + torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((bq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols >= rows - window + 1
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bqkgt,btkd->bqkgd", p, v.float())
    return (m.reshape(B, bq, H), l.reshape(B, bq, H),
            acc.reshape(B, bq, H, dh))


def blocked_attention(q, k, v, *, causal=True, window=0, q_chunk=1024,
                      kv_chunk=1024, backend="cuda"):
    """q: (B, S, H, dh); k/v: (B, T, KH, dh) -> (B, S, H, dh).

    ``backend="cuda"``: the flash attention kernel on (B, H, S, dh)
    views of the (B, S, H, dh) activations, read and written in place in
    bf16 (the twin `mha_ref` when the tensors lie on the CPU).
    ``backend="torch"``: a loop over q chunks, each walking exactly the kv
    chunks it can see, so causal and sliding windows do near-ideal flops.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    B, S, H, dh = q.shape
    T = k.shape[1]
    if backend == "cuda":
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
        return o.transpose(1, 2)
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk:
        q_chunk = S  # odd lengths (tests): single block
    if T % kv_chunk:
        kv_chunk = T
    nq, nk = S // q_chunk, T // kv_chunk
    scale = dh ** -0.5
    qf = q.float() * scale
    outs = []
    for qi in range(nq):
        qb = qf[:, qi * q_chunk:(qi + 1) * q_chunk]
        lo, hi = 0, nk
        if causal:
            hi = min(nk, ((qi + 1) * q_chunk + kv_chunk - 1) // kv_chunk)
        if window > 0:
            lo = max(0, (qi * q_chunk - window + 1) // kv_chunk)
        m = torch.full((B, q_chunk, H), NEG_INF, device=q.device)
        l = torch.zeros((B, q_chunk, H), device=q.device)
        acc = torch.zeros((B, q_chunk, H, dh), device=q.device)
        for ki in range(lo, hi):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            mb, lb, ab = _attn_block(qb, k[:, sl], v[:, sl], qi * q_chunk,
                                     ki * kv_chunk, causal, window)
            m_new = torch.maximum(m, mb)
            a1 = torch.exp(m - m_new)
            a2 = torch.exp(mb - m_new)
            l = l * a1 + lb * a2
            acc = acc * a1[..., None] + ab * a2[..., None]
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len, *, window=0):
    """q: (B, 1, H, dh); caches: (B, KH, S, dh); cur_len: int or int32
    scalar tensor — number of valid cache positions (the new token is at
    cur_len-1)."""
    B, _, H, dh = q.shape
    KH = k_cache.shape[1]
    G = H // KH
    S = k_cache.shape[2]
    scale = dh ** -0.5
    qg = (q.float() * scale).reshape(B, KH, G, dh)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float())
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = pos < cur_len
    if window > 0:
        mask &= pos >= cur_len - window
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,bktd->bkgd", p / l.clamp_min(1e-30),
                     v_cache.float())
    return o.reshape(B, 1, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# attention layer (params + apply)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg) -> dict:
    """cfg needs: d_model, n_heads, n_kv_heads, d_head, qk_norm."""
    D, H, KH, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense(gen, D, H * dh), "wk": dense(gen, D, KH * dh),
         "wv": dense(gen, D, KH * dh), "wo": dense(gen, H * dh, D)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=torch.bfloat16, device=gen.device)
        p["k_norm"] = torch.ones(dh, dtype=torch.bfloat16, device=gen.device)
    return p


def attention_specs(cfg, rules) -> dict:
    """The reference's spec tree of `init_attention` (no tensors)."""
    D, H, KH, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {"wq": rules.dense_in_heads(D, H, H * dh),
         "wk": rules.dense_in_heads(D, KH, KH * dh),
         "wv": rules.dense_in_heads(D, KH, KH * dh),
         "wo": rules.dense_out(H * dh, D)}
    if cfg.qk_norm:
        s["q_norm"] = rules.vector()
        s["k_norm"] = rules.vector()
    return s


def attn_qkv(p, cfg, x, positions):
    """projections + qk-norm + rotary; returns q (B,S,H,dh), k/v (B,S,KH,dh).
    positions=None skips rotary (cross-attention)."""
    B, S, D = x.shape
    H, KH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KH, dh)
    v = (x @ p["wv"]).reshape(B, S, KH, dh)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"])
        k = head_rms_norm(k, p["k_norm"])
    if positions is None:
        return q, k, v
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.use_rope:
        pos1d = positions[..., 0] if positions.dim() == 3 else positions
        q = apply_rope(q, pos1d, cfg.rope_theta)
        k = apply_rope(k, pos1d, cfg.rope_theta)
    return q, k, v


def attn_q_only(p, cfg, x):
    """Q projection only (decoder side of cross-attention, no rotary)."""
    B, S, D = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"])
    return q


def attn_kv_only(p, cfg, x):
    """K/V projections only (encoder side of cross-attention, no rotary)."""
    B, S, D = x.shape
    KH, dh = cfg.n_kv_heads, cfg.head_dim
    k = (x @ p["wk"]).reshape(B, S, KH, dh)
    v = (x @ p["wv"]).reshape(B, S, KH, dh)
    if cfg.qk_norm:
        k = head_rms_norm(k, p["k_norm"])
    return k, v


def attention_layer(p, cfg, x, positions, *, causal=True, backend="cuda",
                    kv_override=None, return_kv=False):
    """Full layer: qkv -> blocked attention -> output proj.
    return_kv: also return (k, v) as (B, KH, S, dh) for KV-cache building.

    kv_override: (k, v) (B, Se, KH, dh) from an encoder, for
    cross-attention: non-causal, no rotary, and always the plain blocked
    walk (``backend="torch"``), whatever `backend` says.  The flash
    kernel, like the TPU kernel it ports, takes one length for q and kv,
    and cross-attention's Se differs from S."""
    B, S, D = x.shape
    if kv_override is not None:
        q = attn_q_only(p, cfg, x)
        k, v = kv_override
        causal, backend = False, "torch"
    else:
        q, k, v = attn_qkv(p, cfg, x, positions)
    o = blocked_attention(q, k, v, causal=causal, window=cfg.window,
                          q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk,
                          backend=backend)
    out = o.reshape(B, S, -1) @ p["wo"]
    if return_kv:
        return out, (k.transpose(1, 2), v.transpose(1, 2))
    return out
