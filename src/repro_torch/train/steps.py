"""Step factories: training, prefill and decode, on one card or a mesh.

``make_train_step``   — microbatched gradient accumulation in float32, then
                        AdamW (`optim.adamw`), params and state updated in
                        place.
``make_grad_step``    — its first half: loss, aux and gradients.
``make_prefill_step`` — full forward returning the last position's logits
                        and the caches (none for the SSM family).
``make_decode_step``  — one token against a pre-sized state.

Every family of `configs/registry.py` is served and trained.  Each
factory returns the callable alone.  With ``mesh=`` (a torch `DeviceMesh`,
axes ``("data", "model")`` or ``("pod", "data", "model")``) the step runs
sharded (`models.spmd`): params and optimizer state are DTensors under
`param_and_opt_shardings` (place a whole tree with `shard_params`), and
the callable carries the reference's ``in_shardings``, ``out_shardings``
and ``rules`` as attributes (the decode step also ``state_shapes``).
`make_rules` and `bind_runtime` read the mesh's shape as the reference's
do; `init_specs_only` is `models.transformer.param_specs`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig, ShapeConfig
from ..core.device import resolve_device
from ..dist.compat import like, to_dtensor
from ..dist.sharding import NamedSharding, P, ShardingRules
from ..models.common import layer_slice
from ..models.moe import xla_mean
from ..models.transformer import (decode_state_specs, decode_step, forward,
                                  lm_loss, param_specs)
from ..optim.adamw import (AdamWConfig, adamw_update, opt_state_specs,
                           tree_leaves, tree_map)
from ..optim.compress import compressed_psum_grads

# stacked layer trees and the config field that gives their depth
STACKED = {"blocks": "n_layers", "mamba": "n_layers",
           "enc_blocks": "enc_layers", "dec_blocks": "n_layers"}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def _mesh_shape(mesh) -> dict:
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def make_rules(cfg: ArchConfig, mesh) -> ShardingRules:
    shape = _mesh_shape(mesh)
    return ShardingRules(model_size=shape.get("model", 1),
                         data_size=shape.get("data", 1),
                         fsdp=cfg.fsdp,
                         multi_pod="pod" in shape,
                         pod_size=shape.get("pod", 1))


def bind_runtime(cfg: ArchConfig, mesh, batch: int) -> ArchConfig:
    """Resolve mesh-dependent runtime fields (the MoE token shards: how
    many ways the batch is actually sharded)."""
    rules = make_rules(cfg, mesh)
    ax = rules.batch_ax(batch)
    shape = _mesh_shape(mesh)
    shards = 1
    if ax:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            shards *= shape.get(a, 1)
    return dataclasses.replace(cfg, moe_token_shards=shards)


def init_specs_only(cfg: ArchConfig, rules: ShardingRules) -> dict:
    """The param spec tree without making a tensor."""
    return param_specs(cfg, rules)


def _spec_map(fn, specs):
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    return fn(specs)


def param_and_opt_shardings(cfg: ArchConfig, mesh):
    """(param shardings, optimizer-state shardings, param specs, rules)."""
    rules = make_rules(cfg, mesh)
    specs = init_specs_only(cfg, rules)
    pshard = _spec_map(lambda s: NamedSharding(mesh, s), specs)
    oshard = _spec_map(lambda s: NamedSharding(mesh, s),
                       opt_state_specs(specs))
    return pshard, oshard, specs, rules


def shard_params(tree, shardings):
    """A whole tree (params, optimizer state or decode state, the same on
    every rank: from one seed, or `core.convert.lm_params_from_numpy`)
    placed on the mesh: each rank keeps its blocks as DTensors."""
    if isinstance(tree, dict):
        return {k: shard_params(v, shardings[k]) for k, v in tree.items()}
    return to_dtensor(tree, shardings.mesh, shardings.spec)


def _batch_shardings(cfg, rules, mesh, B) -> dict:
    out = {"tokens": NamedSharding(mesh, rules.tokens(B))}
    bspec = P(rules.batch_ax(B), None, None)
    if cfg.family == "vlm":
        out["positions"] = NamedSharding(mesh, bspec)
        out["image_embeds"] = NamedSharding(mesh, bspec)
    if cfg.family == "encdec":
        out["enc_embeds"] = NamedSharding(mesh, bspec)
    return out


def _on_mesh(v, mesh):
    """A batch tensor on the mesh's device type (meta stays meta)."""
    if isinstance(v, DTensor) or not isinstance(v, torch.Tensor) \
            or v.device.type == "meta" or v.device.type == mesh.device_type:
        return v
    if mesh.device_type == "cuda":
        return v.to(torch.device("cuda", torch.cuda.current_device()))
    return v.to(mesh.device_type)


def _whole(v):
    return v.full_tensor() if isinstance(v, DTensor) else v


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
        g = leaf.grad
        if isinstance(g, DTensor):
            # a gradient partial over the batch axes is reduced here, once
            # a microbatch, before the accumulator adds it
            if tuple(g.placements) != tuple(slot.placements):
                g = g.redistribute(slot.device_mesh, slot.placements)
            slot.to_local().add_(g.to_local())
        else:
            slot.add_(g)
        leaf.grad = None        # each layer's gradient lives only this long
    return hook


def _zeros(p, dtype):
    if isinstance(p, DTensor):
        return like(p, torch.zeros_like(p.to_local(), dtype=dtype))
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _check_train_backend(backend: str) -> None:
    if backend == "cuda":
        raise ValueError(
            "training needs backend='torch': the flash attention kernel "
            "has no backward (nor has the reference's Pallas kernel)")
    if backend != "torch":
        raise ValueError(f"backend must be 'torch'; got {backend!r}")


def make_grad_step(cfg: ArchConfig, shape: ShapeConfig, *, device=None,
                   backend: str = "torch", mesh=None):
    """(params, batch) -> (loss, aux, grads).  With ``cfg.microbatch ==
    1`` the gradients are in the params' dtypes (as ``jax.value_and_grad``
    leaves them); above 1 the batch splits on its leading axis into
    ``microbatch`` pieces, each piece's gradients are added into float32
    accumulators, and the result is the accumulators over `microbatch`,
    the loss the sum of the pieces' over `microbatch` and the aux values
    their mean.

    With ``mesh=``, params are DTensors and so are the gradients (under
    the params' placements); the batch is whole tensors or DTensors, each
    microbatch its rows ``[j·B/mb, (j+1)·B/mb)`` placed on the batch axes;
    each layer's gradient is reduced over the batch axes before its
    accumulator adds it, and the loss is the global one."""
    _check_train_backend(backend)
    B, mb = shape.global_batch, max(1, cfg.microbatch)
    if B % mb:
        raise ValueError(f"{shape.name}: batch {B} does not split into "
                         f"{mb} microbatches")
    rules = None
    if mesh is not None:
        cfg = bind_runtime(cfg, mesh, B // mb)
        rules = make_rules(cfg, mesh)
    else:
        dev = resolve_device(device)

    def grad_step(params, batch):
        if mesh is None:
            batch = {k: v.to(dev) for k, v in batch.items()}
        else:
            batch = {k: _on_mesh(_whole(v), mesh) for k, v in batch.items()}
        _check_batch(shape, batch["tokens"])
        grads = tree_map(lambda p: _zeros(
            p, p.dtype if mb == 1 else torch.float32), params)
        pieces = [{k: v[j * (B // mb):(j + 1) * (B // mb)]
                   for k, v in batch.items()} for j in range(mb)]
        lsum, drops = None, []
        for piece in pieces:
            leaves = _autograd_leaves(params, cfg, grads)
            loss, aux = (lm_loss(leaves, cfg, piece, backend=backend)
                         if mesh is None else
                         lm_loss(leaves, cfg, piece, rules=rules, mesh=mesh,
                                 backend=backend))
            if mesh is None:
                loss.backward()
                loss = loss.detach()
            else:
                loss.to_local().backward()
                loss = loss.detach().full_tensor()
            lsum = loss if lsum is None else lsum + loss
            drops.append(aux["moe_drop_frac"].detach())
        if mb == 1:
            return lsum, {"moe_drop_frac": drops[0]}, grads
        for g in tree_leaves(grads):
            (g.to_local() if isinstance(g, DTensor) else g).div_(mb)
        return lsum / mb, {"moe_drop_frac": xla_mean(torch.stack(drops))}, \
            grads

    grad_step.rules = rules
    return grad_step


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    opt_cfg: AdamWConfig = None, *, device=None,
                    backend: str = "torch", grad_compression: bool = False,
                    mesh=None):
    """(params, opt_state, batch) -> (new_params, new_opt_state, metrics)
    with metrics ``loss``, ``grad_norm``, ``lr`` and ``moe_drop_frac``
    (0-d tensors).  `make_grad_step`, then (``grad_compression``) the int8
    round trip of every gradient, then `adamw_update`, which updates
    `params` and the state in place (the reference donates both).
    ``backend="cuda"`` raises: the flash kernel has no backward.  With
    ``mesh=``: params and state are DTensors under ``in_shardings``, and
    the metrics are the global values on every rank."""
    opt_cfg = opt_cfg or AdamWConfig()
    grad_step = make_grad_step(cfg, shape, device=device, backend=backend,
                               mesh=mesh)
    rules = grad_step.rules

    def train_step(params, opt_state, batch):
        loss, aux, grads = grad_step(params, batch)
        if grad_compression:
            grads = compressed_psum_grads(grads, rules, mesh)
        new_params, new_opt, stats = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        del grads
        metrics = {"loss": loss, **stats,
                   "moe_drop_frac": aux["moe_drop_frac"]}
        return new_params, new_opt, metrics

    if mesh is not None:
        B = shape.global_batch
        pshard, oshard, _, _ = param_and_opt_shardings(
            bind_runtime(cfg, mesh, B // max(1, cfg.microbatch)), mesh)
        rep = NamedSharding(mesh, P())
        train_step.in_shardings = (pshard, oshard, _batch_shardings(
            cfg, rules, mesh, B))
        train_step.out_shardings = (pshard, oshard, {
            "loss": rep, "grad_norm": rep, "lr": rep, "moe_drop_frac": rep})
        train_step.rules = rules
    return train_step


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, device=None,
                      backend: str = "cuda", mesh=None):
    """(params, batch) -> (logits[:, -1:], caches).  ``backend="cuda"``
    runs self-attention through the flash attention kernel, ``"torch"``
    through the blocked plain-torch walk.  Every tensor of the batch
    (tokens, and the family's positions, image_embeds or enc_embeds) is
    moved to `device` (CUDA unless the caller asks for the CPU); params
    must already be there.  With ``mesh=``: params DTensors, batch whole
    tensors or DTensors; logits and caches come back as DTensors."""
    if mesh is not None:
        cfg = bind_runtime(cfg, mesh, shape.global_batch)
        pshard, _, _, rules = param_and_opt_shardings(cfg, mesh)
    else:
        dev = resolve_device(device)
        rules = None

    def prefill(params, batch):
        if mesh is None:
            batch = {k: v.to(dev) for k, v in batch.items()}
        else:
            batch = {k: _on_mesh(v, mesh) for k, v in batch.items()}
        _check_batch(shape, batch["tokens"])
        kw = {} if mesh is None else {"rules": rules, "mesh": mesh}
        logits, _, caches = forward(params, cfg, batch, backend=backend,
                                    want_cache=True, **kw)
        # only the last position's logits are needed to continue decoding;
        # a copy, so that the whole (B, S, Vp) tensor is not kept alive
        if isinstance(logits, DTensor):
            return DTensor.from_local(
                logits.to_local()[:, -1:].clone(), mesh, logits.placements,
                run_check=False), caches
        return logits[:, -1:].clone(), caches

    if mesh is not None:
        prefill.in_shardings = (pshard, _batch_shardings(
            cfg, rules, mesh, shape.global_batch))
        prefill.rules = rules
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


def make_decode_step(cfg: ArchConfig, shape: ShapeConfig, device=None,
                     mesh=None):
    """(params, batch, state) -> (logits (B, 1, Vp), new_state), with
    batch = {"tokens": (B, 1), "cur_len": int or scalar} (VLM: also
    "positions" (B, 1, 3)).  The state (KV caches sized ``shape.seq_len``
    and recurrent states, as the family has them) is updated in place:
    `new_state` is `state` (the reference donates the state instead).
    With ``mesh=``: params and state DTensors (the state under
    ``in_shardings[2]``, whole trees placed by `shard_params`)."""
    if mesh is not None:
        B = shape.global_batch
        cfg = bind_runtime(cfg, mesh, B)
        pshard, _, _, rules = param_and_opt_shardings(cfg, mesh)
        state_shapes, state_specs = decode_state_specs(cfg, shape.seq_len, B,
                                                       rules)
        sshard = _spec_map(lambda s: NamedSharding(mesh, s), state_specs)
    else:
        dev = resolve_device(device)
        rules = None

    def step(params, batch, state):
        if mesh is None:
            batch = {k: v.to(dev) if hasattr(v, "to") else v
                     for k, v in batch.items()}
        else:
            batch = {k: _on_mesh(v, mesh) for k, v in batch.items()}
        _check_batch(shape, batch["tokens"])
        _check_state(shape, state)
        if mesh is None:
            return decode_step(params, cfg, batch, state)
        return decode_step(params, cfg, batch, state, rules=rules, mesh=mesh)

    if mesh is not None:
        bsh = _batch_shardings(cfg, rules, mesh, B)
        bsh.pop("image_embeds", None)
        bsh.pop("enc_embeds", None)
        bsh["cur_len"] = NamedSharding(mesh, P())
        step.in_shardings = (pshard, bsh, sshard)
        step.out_shardings = (NamedSharding(
            mesh, rules.act_logits(B, cfg.vocab_padded)), sshard)
        step.state_shapes = state_shapes
        step.rules = rules
    return step
