"""Mamba2 (SSD) block — chunked parallel scan for prefill, O(1)-state
recurrence for decode (zamba2's backbone).

State per head: (P, N) with P = headdim, N = d_state.  Chunked algorithm
(Dao & Gu 2024): within-chunk attention-like masked matmul with cumulative
log-decay, cross-chunk state carried by a loop over chunks (the
reference's ``lax.scan``).  n_groups = 1.

The reference's three-operand einsums are written as pairwise products in
a fixed order: `torch.einsum` contracts left to right unless `opt_einsum`
is installed, and the wrong order materialises a (B, nc, t, s, H, P)
tensor, several GB at zamba2's widths.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import P
from .common import dense, normal, rms_norm, silu


def init_mamba2(gen, cfg) -> dict:
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    H = Di // cfg.ssm_headdim
    N = cfg.ssm_state
    conv_dim = Di + 2 * N
    dev = gen.device
    conv_w = normal(gen, (cfg.ssm_conv, conv_dim))
    # in_proj -> [z, x, B, C, dt]
    return {
        "w_in": dense(gen, D, 2 * Di + 2 * N + H),
        "w_out": dense(gen, Di, D),
        "conv_w": (conv_w * 0.2).to(torch.bfloat16),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "dt_bias": torch.zeros(H, dtype=torch.float32, device=dev),
        "D_skip": torch.ones(H, dtype=torch.float32, device=dev),
        "norm_w": torch.ones(Di, dtype=torch.bfloat16, device=dev),
    }


def mamba2_specs(cfg, rules) -> dict:
    """The reference's spec tree of `init_mamba2` (no tensors)."""
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    H = Di // cfg.ssm_headdim
    N = cfg.ssm_state
    return {"w_in": rules.dense_in(D, 2 * Di + 2 * N + H),
            "w_out": rules.dense_out(Di, D), "conv_w": P(None, None),
            "A_log": rules.vector(), "dt_bias": rules.vector(),
            "D_skip": rules.vector(), "norm_w": rules.vector()}


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``, no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(u, w):
    """u: (B, S, C); w: (W, C) depthwise causal conv via tap shifts, in
    u's dtype, the taps added in the reference's order."""
    W = w.shape[0]
    S = u.shape[1]
    out = u * w[-1]
    for t in range(1, W):
        shifted = F.pad(u, (0, 0, t, 0))[:, :S]
        out = out + shifted * w[W - 1 - t]
    return out


def _split_proj(p, cfg, xin):
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    H = Di // cfg.ssm_headdim
    N = cfg.ssm_state
    zxbcdt = xin @ p["w_in"]
    z, xc, Bc, Cc, dt = torch.split(zxbcdt, [Di, Di, N, N, H], dim=-1)
    return z, xc, Bc, Cc, dt, Di, H, N


def mamba2_forward(p, cfg, xin, chunk: int = 256):
    """xin: (B, S, D) -> (B, S, D).  Prefill path."""
    B, S, D = xin.shape
    z, xc, Bc, Cc, dt, Di, H, N = _split_proj(p, cfg, xin)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv = silu(causal_conv(conv_in, p["conv_w"]))
    xc, Bc, Cc = torch.split(conv, [Di, N, N], dim=-1)
    Pd = cfg.ssm_headdim
    xh = xc.reshape(B, S, H, Pd).float()
    dt = softplus(dt.float() + p["dt_bias"])                     # (B,S,H)
    A = -torch.exp(p["A_log"])                                    # (H,)
    la = dt * A                                                   # log decay
    xdt = xh * dt[..., None]
    Bf = Bc.float()
    Cf = Cc.float()

    chunk = min(chunk, S)
    assert S % chunk == 0
    nc = S // chunk
    lac = la.reshape(B, nc, chunk, H)
    Fc = torch.cumsum(lac, dim=2)                                 # (B,nc,L,H)
    xdtc = xdt.reshape(B, nc, chunk, H, Pd)
    Bcc = Bf.reshape(B, nc, chunk, N)
    Ccc = Cf.reshape(B, nc, chunk, N)

    # ---- intra-chunk: M[t,s] = (C_t·B_s) exp(F_t - F_s), s <= t ----------
    cb = torch.einsum("bntj,bnsj->bnts", Ccc, Bcc)
    dec = Fc[:, :, :, None, :] - Fc[:, :, None, :, :]             # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xin.device))
    # mask BEFORE exp, as the reference does
    dec = dec.masked_fill(~tri[None, None, :, :, None], -1e30)
    m = cb[..., None] * torch.exp(dec)                            # (B,nc,t,s,H)
    del dec
    y_intra = torch.einsum("bntsh,bnshp->bnthp", m, xdtc)
    del m

    # ---- chunk states: S_c = sum_s exp(F_L - F_s) B_s (x dt)_s -----------
    wS = torch.exp(Fc[:, :, -1:, :] - Fc)                         # (B,nc,L,H)
    S_chunk = torch.einsum("bnsj,bnshp->bnhjp", Bcc,
                           wS[..., None] * xdtc)                  # (B,nc,H,N,P)

    # ---- inter-chunk scan --------------------------------------------------
    decay_chunk = torch.exp(Fc[:, :, -1, :])                      # (B,nc,H)
    Sprev = torch.zeros((B, H, N, Pd), dtype=torch.float32,
                        device=xin.device)
    befores = []
    for c in range(nc):
        befores.append(Sprev)
        Sprev = Sprev * decay_chunk[:, c, :, None, None] + S_chunk[:, c]
    S_before = torch.stack(befores, dim=1)                        # (B,nc,H,N,P)
    y_inter = (torch.einsum("bntj,bnhjp->bnthp", Ccc, S_before)
               * torch.exp(Fc)[..., None])

    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(B, S, Di).to(xin.dtype)
    y = rms_norm(y * silu(z), p["norm_w"])
    return y @ p["w_out"]


def mamba2_init_state(cfg, batch: int, device) -> dict:
    Di = cfg.ssm_expand * cfg.d_model
    H = Di // cfg.ssm_headdim
    N = cfg.ssm_state
    conv_dim = Di + 2 * N
    return {
        "ssm": torch.zeros((batch, H, N, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=torch.bfloat16, device=device),
    }


def mamba2_decode_step(p, cfg, xin, state):
    """xin: (B, 1, D); state: {'ssm': (B,H,N,P), 'conv': (B,W-1,C)}.
    Returns (y (B, 1, D), new state); the state passed in is not
    written."""
    B = xin.shape[0]
    z, xc, Bc, Cc, dt, Di, H, N = _split_proj(p, cfg, xin)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)                    # (B,1,C)
    window = torch.cat([state["conv"], conv_in], dim=1)           # (B,W,C)
    conv = silu(torch.einsum("bwc,wc->bc", window.float(),
                               p["conv_w"].float()))[:, None]
    new_conv = window[:, 1:]
    xc, Bc, Cc = torch.split(conv.to(xin.dtype), [Di, N, N], dim=-1)
    Pd = cfg.ssm_headdim
    xh = xc.reshape(B, H, Pd).float()
    dt = softplus(dt[:, 0].float() + p["dt_bias"])                # (B,H)
    A = -torch.exp(p["A_log"])
    alpha = torch.exp(dt * A)                                     # (B,H)
    Bf = Bc[:, 0].float()                                         # (B,N)
    Cf = Cc[:, 0].float()
    S = state["ssm"] * alpha[..., None, None] + torch.einsum(
        "bj,bhp->bhjp", Bf, xh * dt[..., None])
    y = torch.einsum("bj,bhjp->bhp", Cf, S) + xh * p["D_skip"][None, :, None]
    y = y.reshape(B, 1, Di).to(xin.dtype)
    y = rms_norm(y * silu(z), p["norm_w"])
    return y @ p["w_out"], {"ssm": S, "conv": new_conv}
