"""Step factories, the serving half: prefill and decode on one card.

``make_prefill_step`` — full forward returning the last position's logits
                        and the caches (none for the SSM family).
``make_decode_step``  — one token against a pre-sized state.

Every family of `configs/registry.py` is served.  The reference's
factories jit with production-mesh shardings and return (fn, shardings,
...); here there is no mesh, and each factory returns the callable alone.
The reference's `bind_runtime` only resolves the MoE token shards from the
mesh, so on one card it is the identity and has no counterpart (it comes
with the LM mesh).  Training (`make_train_step`, AdamW, grad accumulation)
belongs to the training slice.
"""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig
from ..core.device import resolve_device
from ..models.transformer import decode_step, forward


def _check_batch(shape: ShapeConfig, tokens) -> None:
    if tokens.shape[0] != shape.global_batch:
        raise ValueError(f"{shape.name}: batch of {tokens.shape[0]} "
                         f"requests; the shape serves {shape.global_batch}")


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
