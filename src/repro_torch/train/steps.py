"""Step factories on one card: training, prefill and decode.

``make_train_step``   — microbatched gradient accumulation in float32, then
                        AdamW (`optim.adamw`), params and state updated in
                        place.
``make_grad_step``    — its first half: loss, aux and gradients.
``make_prefill_step`` — full forward returning the last position's logits
                        and the caches (none for the SSM family).
``make_decode_step``  — one token against a pre-sized state.

Every family of `configs/registry.py` is served and trained.  The
reference's factories jit with production-mesh shardings and return (fn,
shardings, ...); here there is no mesh, and each factory returns the
callable alone.  The reference's `bind_runtime` only resolves the MoE token
shards from the mesh, so on one card it is the identity; it, `make_rules`,
`param_and_opt_shardings` and `init_specs_only` come with the LM mesh.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..core.device import resolve_device
from ..models.common import layer_slice
from ..models.moe import xla_mean
from ..models.transformer import decode_step, forward, lm_loss
from ..optim.adamw import (AdamWConfig, adamw_update, tree_leaves,
                           tree_map)
from ..optim.compress import compressed_psum_grads

# stacked layer trees and the config field that gives their depth
STACKED = {"blocks": "n_layers", "mamba": "n_layers",
           "enc_blocks": "enc_layers", "dec_blocks": "n_layers"}


def _check_batch(shape: ShapeConfig, tokens) -> None:
    if tokens.shape[0] != shape.global_batch:
        raise ValueError(f"{shape.name}: batch of {tokens.shape[0]} "
                         f"requests; the shape serves {shape.global_batch}")


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _autograd_leaves(params: dict, cfg: ArchConfig, grads: dict) -> dict:
    """`params` as `forward` takes them, every tensor replaced by a fresh
    autograd leaf that shares its storage, each stacked layer tree split
    into a list of per-layer trees (so a layer's gradient is its own
    tensor: indexing the stack would allocate a zero tensor the size of the
    whole stack for every layer in the backward).  Each leaf's gradient is
    added into its view of `grads` (a tree like `params`) as soon as it is
    complete, and then freed."""
    def leaf(t, slot):
        a = t.detach().requires_grad_()
        a.register_post_accumulate_grad_hook(_add_grad_hook(slot))
        return a

    def walk(p, g):
        if isinstance(p, dict):
            return {k: walk(v, g[k]) for k, v in p.items()}
        return leaf(p, g)

    tree = {}
    for k, v in params.items():
        if k in STACKED:
            n = getattr(cfg, STACKED[k])
            tree[k] = [walk(layer_slice(v, i), layer_slice(grads[k], i))
                       for i in range(n)]
        else:
            tree[k] = walk(v, grads[k])
    return tree


def _add_grad_hook(slot: torch.Tensor):
    def hook(leaf):
        slot.add_(leaf.grad)
        leaf.grad = None        # each layer's gradient lives only this long
    return hook


def _check_train_backend(backend: str) -> None:
    if backend == "cuda":
        raise ValueError(
            "training needs backend='torch': the flash attention kernel "
            "has no backward (nor has the reference's Pallas kernel)")
    if backend != "torch":
        raise ValueError(f"backend must be 'torch'; got {backend!r}")


def make_grad_step(cfg: ArchConfig, shape: ShapeConfig, *, device=None,
                   backend: str = "torch"):
    """(params, batch) -> (loss, aux, grads).  With ``cfg.microbatch ==
    1`` the gradients are in the params' dtypes (as ``jax.value_and_grad``
    leaves them); above 1 the batch splits on its leading axis into
    ``microbatch`` pieces, each piece's gradients are added into float32
    accumulators, and the result is the accumulators over `microbatch`,
    the loss the sum of the pieces' over `microbatch` and the aux values
    their mean."""
    _check_train_backend(backend)
    dev = resolve_device(device)
    B, mb = shape.global_batch, max(1, cfg.microbatch)
    if B % mb:
        raise ValueError(f"{shape.name}: batch {B} does not split into "
                         f"{mb} microbatches")

    def grad_step(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        _check_batch(shape, batch["tokens"])
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=p.dtype if mb == 1 else torch.float32,
            device=p.device), params)
        pieces = [{k: v[j * (B // mb):(j + 1) * (B // mb)]
                   for k, v in batch.items()} for j in range(mb)]
        lsum, drops = None, []
        for piece in pieces:
            loss, aux = lm_loss(_autograd_leaves(params, cfg, grads), cfg,
                                piece, backend=backend)
            loss.backward()
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
            drops.append(aux["moe_drop_frac"].detach())
        if mb == 1:
            return lsum, {"moe_drop_frac": drops[0]}, grads
        for g in tree_leaves(grads):
            g.div_(mb)
        return lsum / mb, {"moe_drop_frac": xla_mean(torch.stack(drops))}, \
            grads

    return grad_step


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    opt_cfg: AdamWConfig = None, *, device=None,
                    backend: str = "torch", grad_compression: bool = False):
    """(params, opt_state, batch) -> (new_params, new_opt_state, metrics)
    with metrics ``loss``, ``grad_norm``, ``lr`` and ``moe_drop_frac``
    (0-d tensors).  `make_grad_step`, then (``grad_compression``) the int8
    round trip of every gradient, then `adamw_update`, which updates
    `params` and the state in place (the reference donates both).
    ``backend="cuda"`` raises: the flash kernel has no backward."""
    opt_cfg = opt_cfg or AdamWConfig()
    grad_step = make_grad_step(cfg, shape, device=device, backend=backend)

    def train_step(params, opt_state, batch):
        loss, aux, grads = grad_step(params, batch)
        if grad_compression:
            grads = compressed_psum_grads(grads)
        new_params, new_opt, stats = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        del grads
        metrics = {"loss": loss, **stats,
                   "moe_drop_frac": aux["moe_drop_frac"]}
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, device=None,
                      backend: str = "cuda"):
    """(params, batch) -> (logits[:, -1:], caches).  ``backend="cuda"``
    runs self-attention through the flash attention kernel, ``"torch"``
    through the blocked plain-torch walk.  Every tensor of the batch
    (tokens, and the family's positions, image_embeds or enc_embeds) is
    moved to `device` (CUDA unless the caller asks for the CPU); params
    must already be there."""
    dev = resolve_device(device)

    def prefill(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        _check_batch(shape, batch["tokens"])
        logits, _, caches = forward(params, cfg, batch, backend=backend,
                                    want_cache=True)
        # only the last position's logits are needed to continue decoding;
        # a copy, so that the whole (B, S, Vp) tensor is not kept alive
        return logits[:, -1:].clone(), caches

    return prefill


def _check_state(shape: ShapeConfig, state: dict) -> None:
    """KV caches (L, B, KH, T, dh) must hold ``shape.seq_len`` positions
    of ``shape.global_batch`` requests; a family without them (SSM) must
    hold recurrent states of that batch."""
    if "k" in state:
        batch, held = state["k"].shape[1], state["k"].shape[3]
        if held != shape.seq_len:
            raise ValueError(f"{shape.name}: state holds {held} positions; "
                             f"the shape serves {shape.seq_len}")
    else:   # xLSTM: a dict of per-layer states, batch first
        batch = next(iter(next(iter(state.values())).values())).shape[0]
    if batch != shape.global_batch:
        raise ValueError(f"{shape.name}: state of {batch} requests; the "
                         f"shape serves {shape.global_batch}")


def make_decode_step(cfg: ArchConfig, shape: ShapeConfig, device=None):
    """(params, batch, state) -> (logits (B, 1, Vp), new_state), with
    batch = {"tokens": (B, 1), "cur_len": int or scalar} (VLM: also
    "positions" (B, 1, 3)).  The state (KV caches sized ``shape.seq_len``
    and recurrent states, as the family has them) is updated in place:
    `new_state` is `state` (the reference donates the state instead)."""
    dev = resolve_device(device)

    def step(params, batch, state):
        batch = {k: v.to(dev) if hasattr(v, "to") else v
                 for k, v in batch.items()}
        _check_batch(shape, batch["tokens"])
        _check_state(shape, state)
        return decode_step(params, cfg, batch, state)

    return step
