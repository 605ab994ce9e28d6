"""Plain-torch twin of the flash attention kernel: full (optionally causal
/ sliding-window) attention, as the reference's jnp oracle computes it."""
from __future__ import annotations

import torch


def mha_ref(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q: (B, H, S, dh); k/v: (B, KH, S, dh) with H % KH == 0.
    window > 0 enables sliding-window attention (causal only).
    Returns (B, H, S, dh) in q.dtype; softmax in fp32."""
    B, H, S, dh = q.shape
    KH = k.shape[1]
    g = H // KH
    scale = scale if scale is not None else dh ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki >= qi - window + 1
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.exp(logits - logits.amax(-1, keepdim=True)))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
