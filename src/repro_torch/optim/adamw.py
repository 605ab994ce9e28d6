"""AdamW with float32 master weights.

State per param leaf: master (float32), m (float32), v (float32), under
the same keys as the params, plus ``step`` (0-d int32).  Model params stay
in their own dtype (bf16) for compute and are re-cast from the master after
each update.  On a mesh the state is sharded with the params' specs
(ZeRO, `opt_state_specs`): every tensor is a DTensor, the update works on
each rank's local blocks, and `global_norm` sums the local squares over
the shards.

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
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor

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


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _pieces(t: torch.Tensor) -> list:
    """1-D pieces of at most `PIECE` elements covering `t` (a DTensor: its
    local block): views when `t` is contiguous (state updated in place
    must be), else of a copy."""
    flat = _local(t).reshape(-1)
    return [flat[i:i + PIECE] for i in range(0, flat.numel(), PIECE)]


def lr_at(cfg: AdamWConfig, step):
    """Warmup schedule at `step` (an int32 tensor): float32 0-d."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def opt_state_specs(param_specs):
    """Optimizer state spec tree parallel to `init_opt_state`'s output."""
    from ..dist.sharding import P
    return {"master": param_specs, "m": param_specs, "v": param_specs,
            "step": P()}


def _zeros32(p):
    if isinstance(p, DTensor):
        from ..dist.compat import like
        return like(p, torch.zeros_like(p.to_local(), dtype=torch.float32))
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _master(p):
    if isinstance(p, DTensor):
        from ..dist.compat import like
        return like(p, p.to_local().to(torch.float32, copy=True))
    return p.to(torch.float32, copy=True)


def init_opt_state(params: dict) -> dict:
    """float32 master copy, zero m and v, step 0 (on each param's
    device; DTensors under the params' placements when the params are)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if leaves and isinstance(leaves[0], DTensor):
        from torch.distributed.tensor import Replicate
        mesh = leaves[0].device_mesh
        step = DTensor.from_local(
            torch.zeros((), dtype=torch.int32,
                        device=leaves[0].to_local().device),
            mesh, [Replicate()] * mesh.ndim, run_check=False)
    return {"master": tree_map(_master, params),
            "m": tree_map(_zeros32, params),
            "v": tree_map(_zeros32, params),
            "step": step}


def _over_shards(s, t):
    """A DTensor leaf's local sum summed over the mesh dims that shard it."""
    if not isinstance(t, DTensor):
        return s
    for d, pl in enumerate(t.placements):
        if pl.is_shard():
            s = fc.all_reduce(s, "sum", (t.device_mesh, d))
            s = s.wait() if isinstance(s, fc.AsyncCollectiveTensor) else s
    return s


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flattening order) of each leaf's
    float32 sum of squares; 0-d float32 (of the global tensors when the
    leaves are DTensors: each local sum is reduced over its shards)."""
    total = None
    for g in tree_leaves(tree):
        s = _local(g).new_zeros((), dtype=torch.float32)
        for piece in _pieces(g):
            s = s + piece.float().square().sum()
        s = _over_shards(s, g)
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
    n = _local(step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, n).to(gnorm.device)
    b1c = 1 - torch.pow(cfg.b1, n.float())
    b2c = 1 - torch.pow(cfg.b2, n.float())

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
        if not all(_local(t).is_contiguous() for t in (m, v, ma, p)):
            raise ValueError("params and optimizer state must be "
                             "contiguous: they are updated in place")
        for parts in zip(*(_pieces(t) for t in (g, m, v, ma, p))):
            upd(*parts)
    new_opt = {"master": opt_state["master"], "m": opt_state["m"],
               "v": opt_state["v"], "step": step}
    return params, new_opt, {"grad_norm": gnorm, "lr": lr}
