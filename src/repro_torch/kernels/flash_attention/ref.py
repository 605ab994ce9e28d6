"""Plain-torch twins of the flash attention kernels.

`mha_ref`: full (optionally causal / sliding-window) attention, as the
reference's jnp oracle computes it; the wrapper's CPU path and the
contract of both kernels.  `flash_tc_ref` and `flash_tf32x3_ref`: the
same function rounded where the bf16 kernel (csrc/flash_attention_tc.cu)
and the float32 kernel (csrc/flash_attention.cu) round, so that each
kernel can be held to its twin more tightly than to `mha_ref`."""
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


def tf32_round(x):
    """float32 `x` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32``: the sign-magnitude bits
    plus half a TF32 ulp, the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, parts: int):
    """a @ b (float32) on TF32 operands: ``parts`` 3 splits each operand
    as big = tf32(x), small = tf32(x - big) and sums small.big + big.small
    + big.big in float32; ``parts`` 1 is big.big alone.  Each product of
    two TF32 values is exact in float32."""
    ab, bb = tf32_round(a), tf32_round(b)
    if parts == 1:
        return ab @ bb
    if parts != 3:
        raise ValueError(f"parts must be 1 or 3; got {parts}")
    a_s, b_s = tf32_round(a - ab), tf32_round(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def flash_tf32x3_ref(q, k, v, *, causal: bool = True, window: int = 0,
                     parts: int = 3):
    """The float32 kernel's arithmetic in plain torch: q scaled by
    dh^-0.5 before the product, S = (q * scale).K^T and P.V each as three
    TF32 products (`_tf32_matmul`) accumulated in float32, masked scores
    -1e30, p = exp2(s*log2(e) - max*log2(e)) unnormalised on the unrounded
    scores, the row sums of the unrounded p, and acc / max(l, 1e-30).
    ``parts=1`` keeps one TF32 part of every operand, which misses the
    float32 bar.  Shapes as `mha_ref`; returns float32."""
    B, H, S, dh = q.shape
    g = H // k.shape[1]
    qf = q.float() * dh ** -0.5
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = _tf32_matmul(qf, kf.transpose(-1, -2), parts)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    live = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        live &= ki <= qi
    if window > 0:
        live &= ki >= qi - window + 1
    s = s.masked_fill(~live, NEG_INF)
    c = torch.tensor(math.log2(math.e), dtype=torch.float32)
    p = torch.exp2(s * c - s.amax(-1, keepdim=True) * c)
    acc = _tf32_matmul(p, vf, parts)
    return acc / p.sum(-1, keepdim=True).clamp_min(1e-30)
