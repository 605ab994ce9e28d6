"""Plain-torch twins of the flash attention kernels.

`mha_ref`: full (optionally causal / sliding-window) attention, as the
reference's jnp oracle computes it; the wrapper's CPU path and the
contract of both kernels.  `flash_tc_ref`: the same function rounded
where the bf16 tensor-core kernel (csrc/flash_attention_tc.cu) rounds,
so that the kernel can be held to it more tightly than to `mha_ref`."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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


def flash_tc_ref(q, k, v, *, causal: bool = True, window: int = 0,
                 block: int = 128):
    """The bf16 kernel's arithmetic in plain torch: bf16 operands, the
    product Q.K^T accumulated in float32 and scaled after it, kv tiles of
    `block` with an online softmax in float32 (exp2 with scale*log2(e),
    masked scores -1e30, a row masked so far keeps p = 0), P entering P.V
    as the sum of two bf16 parts hi = bf16(p) and lo = bf16(p - hi), the
    row sums of the unrounded P, and acc / max(l, 1e-30) rounded to bf16.
    Shapes as `mha_ref`."""
    B, H, S, dh = q.shape
    g = H // k.shape[1]
    c = torch.tensor(math.log2(math.e) / math.sqrt(dh), dtype=torch.float32)
    qf = q.to(torch.bfloat16).float()
    kf = k.to(torch.bfloat16).float().repeat_interleave(g, dim=1)
    vf = v.to(torch.bfloat16).float().repeat_interleave(g, dim=1)
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, dh), device=q.device)
    for k0 in range(0, S, block):
        sl = slice(k0, min(k0 + block, S))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, sl])
        cols = torch.arange(sl.start, sl.stop, device=q.device)[None, :]
        live = torch.ones((S, cols.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            live &= cols <= rows
        if window > 0:
            live &= cols >= rows - window + 1
        s = s.masked_fill(~live, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        mb = torch.where(m_new == NEG_INF, 0.0, m_new * c)
        p = torch.exp2(s * c - mb)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", hi + lo,
                                         vf[:, :, sl])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)
