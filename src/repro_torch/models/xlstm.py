"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) + sLSTM (scalar
memory), for the xlstm-125m architecture.

mLSTM prefills with an exact chunkwise-parallel form (TFLA-style): within a
chunk, weights W[t,s] = exp(F_t − F_s + ĩ_s) are computed in log space with a
per-row stabilizer mx_t = max(cummax_s≤t(ĩ_s − F_s), M_prev); the carried
state is (S̃, M) with true state S̃·exp(M).  The normalizer n is carried as an
augmented value column, and the output h = (C q)/max(|n·q|, exp(−a)) is
stabilizer-exact because numerator and denominator share the same scale.
Decode is the O(1) per-step stabilized recurrence (`mlstm_reference` runs
it over a sequence, the oracle of the chunked form).  sLSTM is a per-step
loop over time (the reference's ``lax.scan``).

The reference's three-operand einsums are written as pairwise products in
a fixed order (`torch.einsum` contracts left to right).
"""
from __future__ import annotations

import torch

from ..dist.sharding import P
from .common import dense, normal, rms_norm, silu
from .mamba2 import causal_conv, softplus

NEG_INF = -1e30


def _log_sigmoid(x):
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def mlstm_chunked(q, k, v, i_pre, logf, chunk: int = 256):
    """q/k/v: (B, S, H, dh) f32; i_pre/logf: (B, S, H) f32.
    Returns h: (B, S, H, dh)."""
    B, S, H, dh = q.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    nc = S // chunk
    qc = q.reshape(B, nc, chunk, H, dh)
    kc = k.reshape(B, nc, chunk, H, dh) * (dh ** -0.5)
    vc = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                  device=v.device)], dim=-1)
    vc = vc.reshape(B, nc, chunk, H, dh + 1)
    ic = i_pre.reshape(B, nc, chunk, H)
    fc = logf.reshape(B, nc, chunk, H)

    Fc = torch.cumsum(fc, dim=2)                  # (B,nc,L,H) inclusive
    g = ic - Fc                                   # ĩ_s − F_s
    cmax = torch.cummax(g, dim=2).values

    Sm = torch.zeros((B, H, dh, dh + 1), dtype=torch.float32,
                     device=q.device)
    M = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    hs = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]  # (B,L,H,*)
        Fb, gb, cmb = Fc[:, c], g[:, c], cmax[:, c]  # (B,L,H)
        mx = torch.maximum(cmb, M[:, None, :])    # (B,L,H)
        # intra: W[t,s] = exp(g_s − mx_t), s<=t
        expo = (gb[:, None, :, :] - mx[:, :, None, :]).masked_fill(
            ~tri[None, :, :, None], NEG_INF)
        Wts = torch.exp(expo)
        qkT = torch.einsum("bthd,bshd->btsh", qb, kb)
        num = torch.einsum("btsh,bshe->bthe", qkT * Wts, vb)
        # inter: exp(M − mx_t) · q_t S
        cI = torch.exp(M[:, None, :] - mx)        # (B,L,H)
        num = num + torch.einsum("bthd,bhde->bthe", qb, Sm) * cI[..., None]
        hv, hn = num[..., :dh], num[..., dh]
        denom = torch.maximum(hn.abs(), torch.exp(-(Fb + mx)))
        hs.append(hv / denom[..., None])
        # carry update
        mxL = torch.maximum(cmb[:, -1, :], M)
        Sm = (torch.exp(M - mxL)[:, :, None, None] * Sm
              + torch.einsum("bshd,bshe->bhde",
                             kb * torch.exp(gb - mxL[:, None, :])[..., None],
                             vb))
        M = Fb[:, -1, :] + mxL
    return torch.stack(hs, dim=1).reshape(B, S, H, dh)


def mlstm_decode_step(state, q, k, v, i_pre, logf):
    """state: {'C': (B,H,dh,dh+1), 'm': (B,H)}; q/k/v: (B,H,dh)."""
    C, m = state["C"], state["m"]
    dh = q.shape[-1]
    k = k * (dh ** -0.5)
    v1 = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                  device=v.device)], dim=-1)
    m_new = torch.maximum(logf + m, i_pre)
    C = (torch.exp(logf + m - m_new)[..., None, None] * C
         + torch.exp(i_pre - m_new)[..., None, None]
         * k[..., :, None] * v1[..., None, :])
    num = torch.einsum("bhd,bhde->bhe", q, C)
    hv, hn = num[..., :dh], num[..., dh]
    h = hv / torch.maximum(hn.abs(), torch.exp(-m_new))[..., None]
    return {"C": C, "m": m_new}, h


def mlstm_reference(q, k, v, i_pre, logf):
    """Per-step oracle for tests."""
    B, S, H, dh = q.shape
    state = {"C": torch.zeros((B, H, dh, dh + 1), dtype=torch.float32,
                              device=q.device),
             "m": torch.full((B, H), NEG_INF, dtype=torch.float32,
                             device=q.device)}
    hs = []
    for t in range(S):
        state, h = mlstm_decode_step(state, q[:, t], k[:, t], v[:, t],
                                     i_pre[:, t], logf[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


# ---------------------------------------------------------------------------
# mLSTM block (params + apply)
# ---------------------------------------------------------------------------


def init_mlstm_block(gen, cfg) -> dict:
    D = cfg.d_model
    Di = 2 * D
    H = cfg.n_heads
    p = {"w_up": dense(gen, D, 2 * Di)}
    conv_w = normal(gen, (4, Di))
    p["conv_w"] = (conv_w * 0.2).to(torch.bfloat16)
    p["w_q"] = dense(gen, Di, Di)
    p["w_k"] = dense(gen, Di, Di)
    p["w_v"] = dense(gen, Di, Di)
    p["w_if"] = dense(gen, Di, 2 * H)
    p["norm_w"] = torch.ones(Di, dtype=torch.bfloat16, device=gen.device)
    p["w_down"] = dense(gen, Di, D)
    return p


def mlstm_block_specs(cfg, rules) -> dict:
    """The reference's spec tree of `init_mlstm_block` (no tensors)."""
    D = cfg.d_model
    Di, H = 2 * D, cfg.n_heads
    return {"w_up": rules.dense_in(D, 2 * Di), "conv_w": P(None, None),
            "w_q": rules.dense_in(Di, Di), "w_k": rules.dense_in(Di, Di),
            "w_v": rules.dense_in(Di, Di), "w_if": rules.dense_in(Di, 2 * H),
            "norm_w": rules.vector(), "w_down": rules.dense_out(Di, D)}


def _mlstm_block_pre(p, cfg, x):
    B, S, D = x.shape
    Di, H = 2 * D, cfg.n_heads
    dh = Di // H
    up = x @ p["w_up"]
    xm, z = torch.chunk(up, 2, dim=-1)
    xconv = silu(causal_conv(xm, p["conv_w"]))
    q = (xconv @ p["w_q"]).reshape(B, S, H, dh).float()
    k = (xconv @ p["w_k"]).reshape(B, S, H, dh).float()
    v = (xm @ p["w_v"]).reshape(B, S, H, dh).float()
    gates = (xconv @ p["w_if"]).float().reshape(B, S, 2, H)
    i_pre = gates[:, :, 0]
    logf = _log_sigmoid(gates[:, :, 1])
    return q, k, v, i_pre, logf, z, (Di, H, dh)


def mlstm_block(p, cfg, x, chunk: int = 256):
    B, S, D = x.shape
    q, k, v, i_pre, logf, z, (Di, H, dh) = _mlstm_block_pre(p, cfg, x)
    h = mlstm_chunked(q, k, v, i_pre, logf, chunk=chunk)
    h = h.reshape(B, S, Di).to(x.dtype)
    h = rms_norm(h, p["norm_w"]) * silu(z)
    return h @ p["w_down"]


def mlstm_block_init_state(cfg, batch: int, device) -> dict:
    D = cfg.d_model
    Di, H = 2 * D, cfg.n_heads
    dh = Di // H
    return {"C": torch.zeros((batch, H, dh, dh + 1), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, H), NEG_INF, dtype=torch.float32,
                            device=device),
            "conv": torch.zeros((batch, 3, Di), dtype=torch.bfloat16,
                                device=device)}


def mlstm_block_decode(p, cfg, x, state):
    """x: (B, 1, D).  Returns (y (B, 1, D), new state); the state passed
    in is not written."""
    B, _, D = x.shape
    Di, H = 2 * D, cfg.n_heads
    dh = Di // H
    up = x @ p["w_up"]
    xm, z = torch.chunk(up, 2, dim=-1)
    window = torch.cat([state["conv"], xm], dim=1)       # (B,4,Di)
    xconv = silu(torch.einsum("bwc,wc->bc", window.float(),
                                p["conv_w"].float()))
    xconv = xconv.to(x.dtype)[:, None]
    q = (xconv @ p["w_q"]).reshape(B, H, dh).float()
    k = (xconv @ p["w_k"]).reshape(B, H, dh).float()
    v = (xm @ p["w_v"]).reshape(B, H, dh).float()
    gates = (xconv @ p["w_if"]).float().reshape(B, 2, H)
    i_pre = gates[:, 0]
    logf = _log_sigmoid(gates[:, 1])
    cell, h = mlstm_decode_step({"C": state["C"], "m": state["m"]},
                                q, k, v, i_pre, logf)
    h = h.reshape(B, 1, Di).to(x.dtype)
    h = rms_norm(h, p["norm_w"]) * silu(z)
    return h @ p["w_down"], {"C": cell["C"], "m": cell["m"],
                             "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def init_slstm_block(gen, cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    p = {"w_gates": dense(gen, D, 4 * D)}
    r = normal(gen, (H, dh, 4 * dh))
    p["r_gates"] = (r * dh ** -0.5).to(torch.bfloat16)
    p["w_out"] = dense(gen, D, D)
    p["norm_w"] = torch.ones(D, dtype=torch.bfloat16, device=gen.device)
    return p


def slstm_block_specs(cfg, rules) -> dict:
    """The reference's spec tree of `init_slstm_block` (no tensors)."""
    D = cfg.d_model
    return {"w_gates": rules.dense_in(D, 4 * D), "r_gates": P(None, None, None),
            "w_out": rules.dense_out(D, D), "norm_w": rules.vector()}


def slstm_step(p, cfg, gates_x, state):
    """gates_x: (B, 4D) precomputed Wx part; state: dict of (B,H,dh)."""
    B = gates_x.shape[0]
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    # h is rounded to bf16, then multiplied in the promoted dtype of
    # (bf16, r_gates), as the reference's einsum does
    r = p["r_gates"]
    hb = state["h"].to(torch.bfloat16)
    dt = torch.promote_types(hb.dtype, r.dtype)
    rec = torch.einsum("bhd,hde->bhe", hb.to(dt), r.to(dt)).float()
    gx = gates_x.reshape(B, H, 4 * dh).float() + rec
    zt, it, ft, ot = torch.chunk(gx, 4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    m_new = torch.maximum(ft + state["m"], it)
    i_h = torch.exp(it - m_new)
    f_h = torch.exp(ft + state["m"] - m_new)
    c = f_h * state["c"] + i_h * z
    n = f_h * state["n"] + i_h
    h = o * c / n.clamp_min(1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}, h


def slstm_init_state(cfg, batch: int, device) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    zeros = lambda: torch.zeros((batch, H, dh), dtype=torch.float32,
                                device=device)
    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, H, dh), NEG_INF, dtype=torch.float32,
                            device=device),
            "h": zeros()}


def slstm_block(p, cfg, x):
    """x: (B, S, D) -> (B, S, D) by a loop over time."""
    B, S, D = x.shape
    gates_x = x @ p["w_gates"]                     # (B,S,4D)
    state = slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        state, h = slstm_step(p, cfg, gates_x[:, t], state)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    return rms_norm(h, p["norm_w"]) @ p["w_out"]


def slstm_block_decode(p, cfg, x, state):
    gates_x = x[:, 0] @ p["w_gates"]
    state, h = slstm_step(p, cfg, gates_x, state)
    B = x.shape[0]
    h = h.reshape(B, 1, cfg.d_model).to(x.dtype)
    return rms_norm(h, p["norm_w"]) @ p["w_out"], state
