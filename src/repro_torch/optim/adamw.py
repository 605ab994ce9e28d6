"""AdamW with float32 master weights.

State per param leaf: master (float32), m (float32), v (float32), under
the same keys as the params, plus ``step`` (0-d int32).  Model params stay
in their own dtype (bf16) for compute and are re-cast from the master after
each update.  The reference shards the state with the params' specs
(ZeRO); `opt_state_specs` comes with the LM mesh.

The arithmetic and its order are the reference's: the step is incremented
first and the learning rate read at the new step; gradients are scaled by
``min(1, clip / (gnorm + 1e-9))``; bias corrections ``1 - b**step``;
weight decay applied to the master inside the same update.  Every update
is done in place, one piece of a leaf at a time (`PIECE` elements), so no
float32 temporary of a whole multi-GB stacked leaf is ever made.
"""
from __future__ import annotations

import dataclasses

import torch

PIECE = 1 << 24             # elements a piece: float32 temporaries <= 64 MB


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_leaves(tree) -> list:
    """Leaves of a nested dict of tensors in sorted key order, the order in
    which JAX flattens a dict (so leaf i is leaf i in both packages)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    """`fn` applied to every leaf of a nested dict, keeping its keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pieces(t: torch.Tensor) -> list:
    """1-D pieces of at most `PIECE` elements covering `t`: views when `t`
    is contiguous (state updated in place must be), else of a copy."""
    flat = t.reshape(-1)
    return [flat[i:i + PIECE] for i in range(0, flat.numel(), PIECE)]


def lr_at(cfg: AdamWConfig, step):
    """Warmup schedule at `step` (an int32 tensor): float32 0-d."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def init_opt_state(params: dict) -> dict:
    """float32 master copy, zero m and v, step 0 (on each param's
    device)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"master": tree_map(lambda p: p.to(torch.float32, copy=True),
                               params),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flattening order) of each leaf's
    float32 sum of squares; 0-d float32."""
    total = None
    for g in tree_leaves(tree):
        s = g.new_zeros((), dtype=torch.float32)
        for piece in _pieces(g):
            s = s + piece.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"}).

    Updated in place, as the reference donates them: every master, m and
    v tensor of `opt_state` and every tensor of `params` (the master cast
    back to the param's dtype); `new_params` is `params` and
    `new_opt_state` holds the same tensors and a new step.  `grads` (any
    float dtype, the params' keys) are read only."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step).to(gnorm.device)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(g, m, v, master, p):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        master.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * master))
        p.copy_(master)

    for g, m, v, ma, p in zip(tree_leaves(grads),
                              tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"]),
                              tree_leaves(opt_state["master"]),
                              tree_leaves(params)):
        if g.shape != p.shape:
            raise ValueError(f"gradient {tuple(g.shape)} for a param "
                             f"{tuple(p.shape)}")
        if not all(t.is_contiguous() for t in (m, v, ma, p)):
            raise ValueError("params and optimizer state must be "
                             "contiguous: they are updated in place")
        for parts in zip(*(_pieces(t) for t in (g, m, v, ma, p))):
            upd(*parts)
    new_opt = {"master": opt_state["master"], "m": opt_state["m"],
               "v": opt_state["v"], "step": step}
    return params, new_opt, {"grad_norm": gnorm, "lr": lr}
