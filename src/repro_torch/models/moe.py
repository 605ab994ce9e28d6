"""Mixture-of-experts FFN with capacity-based sort/scatter dispatch
(MaxText-style dense layout — no (T, E·C) one-hot blow-up).

Dispatch: flatten tokens -> top-k experts -> rank within expert via a sorted
cumulative count -> scatter into an (E, C, D) buffer (drop past capacity) ->
per-expert batched matmuls -> gather back, combine with gate weights.
All shapes static; the dropped-token fraction is an auxiliary output.

Routing follows the reference's tie rules exactly: top-k is a stable
descending sort (among equal logits the lower expert id comes first, as
``lax.top_k`` orders them) and the rank within an expert a stable
ascending sort.  The combine adds each token's k terms in choice order in
the activations' dtype, as the reference's scatter-add does, and never
through atomics.

On a mesh, ``moe_dispatch="shardmap"`` takes `moe_ffn_shardmap`: the
reference's fully manual dispatch, each rank routing its own tokens with
per-shard capacity, the experts' d_ff split over ``model`` and one psum
of the (T, D) tokens over ``model`` after the combine.  Without a mesh
the reference's `moe_apply` takes the global dispatch, and so does this
one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import P
from .common import dense


def init_moe(gen, cfg) -> dict:
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def experts(d_in, d_out):
        w = torch.empty((E, d_in, d_out), dtype=torch.bfloat16,
                        device=gen.device)
        for e in range(E):
            w[e] = dense(gen, d_in, d_out)
        return w

    return {"w_gate": dense(gen, D, E), "we_gate": experts(D, Fd),
            "we_up": experts(D, Fd), "we_down": experts(Fd, D)}


def moe_specs(cfg, rules) -> dict:
    """The reference's spec tree of `init_moe` (no tensors): the router
    replicated but for FSDP, the experts' F on model and D FSDP."""
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {"w_gate": P(rules.fsdp_ax, None),
            "we_gate": rules.expert_in(E, D, Fd),
            "we_up": rules.expert_in(E, D, Fd),
            "we_down": rules.expert_out(E, Fd, D)}


def xla_mean(x):
    """Mean of a float32 tensor as XLA takes ``jnp.mean``: the sum times
    the float32 reciprocal of the count (a division rounds otherwise)."""
    return x.sum() * torch.tensor(1.0 / x.numel(), dtype=x.dtype,
                                  device=x.device)


def capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots an expert: the reference's ``max(1, int(T·k/E·cf))``."""
    return max(1, int(T * k / E * capacity_factor))


def top_k(logits, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first and, among equal values, the lower index first (``lax.top_k``'s
    order; `torch.topk` promises none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits, k: int, C: int):
    """Routing of (..., T, E) float32 gate logits, batched over leading
    axes: gate logits and expert ids (..., T, k), then per (token, choice)
    pair in token-major order (..., T·k): expert id, rank within its
    expert, whether it fits the capacity `C`, and its destination slot
    (``e·C + rank``, or ``E·C`` when dropped)."""
    E = logits.shape[-1]
    gate, eidx = top_k(logits, k)
    e_flat = eidx.reshape(eidx.shape[:-2] + (-1,))
    P = e_flat.shape[-1]
    e_sorted, order = torch.sort(e_flat, dim=-1, stable=True)
    experts = torch.arange(E, device=logits.device).expand(
        e_flat.shape[:-1] + (E,)).contiguous()
    starts = torch.searchsorted(e_sorted, experts)
    rank_sorted = (torch.arange(P, device=logits.device)
                   - torch.gather(starts, -1, e_sorted))
    rank = torch.empty_like(e_flat).scatter_(-1, order, rank_sorted)
    keep = rank < C
    dest = torch.where(keep, e_flat * C + rank, E * C)
    return gate, eidx, e_flat, rank, keep, dest


def _experts(xe, p):
    """(..., E, C, D) -> (..., E, C, D): each expert's SwiGLU on its
    slots, as three batched products."""
    g = F.silu(torch.matmul(xe, p["we_gate"]))
    u = torch.matmul(xe, p["we_up"])
    return torch.matmul(g * u, p["we_down"])


def _dispatch(p, cfg, xf, capacity_factor):
    """xf: (shards, Tl, D) -> (y (shards, Tl, D), drop_frac): the
    reference's dispatch on each shard's tokens."""
    sh, Tl, D = xf.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    C = capacity(Tl, k, E, capacity_factor)
    logits = (xf @ p["w_gate"]).float()                       # (sh, Tl, E)
    gate, _, _, _, keep, dest = route(logits, k, C)
    gate = torch.softmax(gate, dim=-1).to(xf.dtype)
    drop_frac = 1.0 - xla_mean(keep.float())

    # scatter to (E*C, D): one trash row takes the dropped pairs
    src = xf.repeat_interleave(k, dim=1)                      # (sh, P, D)
    buf = xf.new_zeros((sh, E * C + 1, D))
    buf.scatter_(1, dest[..., None].expand(-1, -1, D), src)
    ye = _experts(buf[:, :E * C].reshape(sh, E, C, D), p)

    pair_out = torch.gather(ye.reshape(sh, E * C, D), 1,
                            dest.clamp_max(E * C - 1)[..., None]
                            .expand(-1, -1, D))
    pair_out = torch.where(keep[..., None], pair_out, 0)
    terms = (pair_out * gate.reshape(sh, -1, 1)).reshape(sh, Tl, k, D)
    y = torch.zeros_like(xf)
    for j in range(k):        # the reference's scatter-add, in choice order
        y = y + terms[:, :, j]
    return y, drop_frac


def moe_ffn(p, cfg, x, *, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (y (B, S, D), drop_frac scalar)."""
    B, S, D = x.shape
    y, drop = _dispatch(p, cfg, x.reshape(1, B * S, D), capacity_factor)
    return y.reshape(B, S, D), drop


def moe_ffn_local(p, cfg, x, *, capacity_factor: float = 1.25):
    """Data-local (shard-major) dispatch: tokens never cross their data
    shard.  The tokens are cut into ``moe_token_shards`` contiguous blocks
    (one when B does not divide) and each is ranked, scattered, computed
    and combined on its own with per-shard capacity C_local = C/shards."""
    B, S, D = x.shape
    shards = max(1, cfg.moe_token_shards)
    if B % shards:
        shards = 1
    y, drop = _dispatch(p, cfg, x.reshape(shards, B * S // shards, D),
                        capacity_factor)
    return y.reshape(B, S, D), drop


def moe_apply(p, cfg, x, mesh=None, rules=None, **kw):
    """The reference's three-way choice: ``moe_dispatch="shardmap"`` on a
    mesh takes `moe_ffn_shardmap`; ``"local"`` with more than one token
    shard the per-shard dispatch; anything else (``"shardmap"`` without a
    mesh included) the global one."""
    if cfg.moe_dispatch == "shardmap" and mesh is not None \
            and rules is not None:
        return moe_ffn_shardmap(p, cfg, x, mesh, rules, **kw)
    if cfg.moe_dispatch == "local" and cfg.moe_token_shards > 1:
        return moe_ffn_local(p, cfg, x, **kw)
    return moe_ffn(p, cfg, x, **kw)


def moe_shardmap_local(p, s, cfg, x, *, capacity_factor: float = 1.25):
    """The reference's shard_map body on this rank's shards (`p` local
    under the specs `s`, `x` (B_local, S, D)): the FSDP dims gathered over
    ``data``, the rank's tokens routed with their own capacity, the
    experts on the rank's d_ff columns, the combine in float32 and one psum
    over ``model`` of the (T, D) tokens.  Returns (y, drop fraction of
    the rank's tokens)."""
    from ..dist.compat import all_gather, enter, psum
    Bl, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    tp = s["we_gate"][2] == "model"

    def gathered(w, spec):
        for d, entry in enumerate(spec):
            if entry == "data":
                w = all_gather(w, "data", d)
        return w

    w = {name: gathered(p[name], s[name]) for name in p}
    T = Bl * S
    C = capacity(T, k, E, capacity_factor)
    xf = x.reshape(1, T, D)
    logits = (xf @ w["w_gate"]).float()
    gate, _, _, _, keep, dest = route(logits, k, C)
    gate = torch.softmax(gate, dim=-1).to(x.dtype)
    drop = 1.0 - xla_mean(keep.float())

    src = xf.repeat_interleave(k, dim=1)
    buf = xf.new_zeros((1, E * C + 1, D))
    buf.scatter_(1, dest[..., None].expand(-1, -1, D), src)
    xe = buf[:, :E * C].reshape(1, E, C, D)
    if tp:
        xe = enter(xe, "model")
    ye = _experts(xe, w)
    # the combine is linear in ye: the reduction over the d_ff shards is
    # deferred past it, a psum of (T, D) tokens, not of (E, C, D) slots
    pair_out = torch.gather(ye.reshape(1, E * C, D), 1,
                            dest.clamp_max(E * C - 1)[..., None]
                            .expand(-1, -1, D))
    pair_out = torch.where(keep[..., None], pair_out, 0)
    g = enter(gate, "model") if tp else gate
    terms = (pair_out * g.reshape(1, -1, 1)).float().reshape(T, k, D)
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    if tp:
        y = psum(y, "model")
    return y.to(x.dtype).reshape(Bl, S, D), drop


def moe_ffn_shardmap(p, cfg, x, mesh, rules, *,
                     capacity_factor: float = 1.25):
    """The reference's `moe_ffn_shardmap`: `moe_shardmap_local` under the
    shard_map shim, `p` DTensors under `moe_specs` and `x` (B, S, D) a
    DTensor (or a whole tensor) sharded on the batch axes.  Returns (y
    DTensor, the mean drop fraction over the shards).  A batch that does
    not split over the batch axes takes the global dispatch."""
    from ..dist.compat import psum, shard_map
    B = x.shape[0]
    axes = rules.batch_ax(B)
    if not axes:
        from ..dist.compat import to_dtensor
        full = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                for k, v in p.items()}
        xf = x.full_tensor() if hasattr(x, "full_tensor") else x
        y, drop = moe_ffn(full, cfg, xf, capacity_factor=capacity_factor)
        return to_dtensor(y, mesh, P(None, None, None)), drop
    names = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in names:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    s = moe_specs(cfg, rules)

    def body(pl, xl):
        y, drop = moe_shardmap_local(pl, s, cfg, xl,
                                     capacity_factor=capacity_factor)
        return y, psum(drop.detach(), names) / n

    return shard_map(body, mesh=mesh, in_specs=(s, P(axes, None, None)),
                     out_specs=(P(axes, None, None), None),
                     varying=names)(p, x)
