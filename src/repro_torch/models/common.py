"""Shared model machinery: seeded dense init, stacked-layer init, norms,
activations, rotary embeddings (incl. 3-section M-RoPE), the loss.

Parameters are plain dicts of tensors shaped like the reference's param
tree.  Their PartitionSpec trees are built from the config alone
(`transformer.param_specs`; `stack_specs` is the spec half of the
reference's `stack_init`), and `with_spec` places a DTensor activation on
a mesh as the reference's sharding constraint does.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# param builders
# ---------------------------------------------------------------------------


class ShapeOnly:
    """Stands in for a generator on the ``meta`` device (where torch has
    none): `normal` then makes tensors of the right shapes and dtypes with
    no data, the counterpart of ``jax.eval_shape`` over an init."""
    device = torch.device("meta")


def generator(device: torch.device, seed: int):
    """A seeded `torch.Generator` on `device`, or `ShapeOnly` on meta."""
    if device.type == "meta":
        return ShapeOnly()
    return torch.Generator(device=device).manual_seed(seed)


def normal(gen, shape) -> torch.Tensor:
    """float32 standard normals of `shape` from `gen` on its device (no
    data on meta)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense(gen: torch.Generator, d_in: int, d_out: int,
          dtype=torch.bfloat16, scale=None) -> torch.Tensor:
    """(d_in, d_out) normal weights times `scale` (default d_in^-0.5),
    drawn in float32 on the generator's device from `gen`, then cast."""
    scale = scale if scale is not None else d_in ** -0.5
    w = normal(gen, (d_in, d_out))
    return (w.mul_(scale)).to(dtype)


def stack_init(init_fn: Callable, n: int) -> dict:
    """Stack `n` calls of `init_fn()` (a nested dict of tensors) along a
    new leading layer axis.  Layer 0 sets the shapes; every later layer is
    copied into its slice as soon as it is made, so the transient memory is
    one layer's tensors."""
    first = init_fn()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        out[0] = t
        return out

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    stacked = alloc(first)
    del first
    for i in range(1, n):
        fill(stacked, init_fn(), i)
    return stacked


def stack_specs(specs):
    """A layer's spec tree with a leading None (layer) dim on every spec,
    as the reference's `stack_init` gives its stacked params."""
    if isinstance(specs, dict):
        return {k: stack_specs(v) for k, v in specs.items()}
    from ..dist.sharding import P
    return P(None, *specs)


def with_spec(x, spec, mesh=None):
    """`x` redistributed to `spec`'s placements on `mesh` (a DTensor); the
    identity without a mesh, as the reference's constraint."""
    if mesh is None:
        return x
    from ..dist.sharding import placements
    pl = placements(mesh, spec)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def layer_slice(tree: dict, i: int) -> dict:
    """Layer `i` of a stacked param tree (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_list(tree, n: int) -> list:
    """The `n` layers of a stacked param tree as a list of per-layer trees
    (views), or `tree` itself when it is already such a list (the train
    step passes one, each layer's tensors their own autograd leaves)."""
    if isinstance(tree, list):
        return tree
    return [layer_slice(tree, i) for i in range(n)]


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps=1e-6):
    """Normalise in float32, cast back to x's dtype, then scale by `w` (in
    the reference's order: the product is in x's dtype)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def head_rms_norm(x, w, eps=1e-6):
    """qk-norm: normalize the last (head) dim; w is (dh,)."""
    return rms_norm(x, w, eps)


def silu(x):
    """``jax.nn.silu`` as XLA evaluates it, ``x · (1 / (1 + exp(−x)))``,
    each step rounded to x's dtype (in bf16, `F.silu` rounds once and
    differs in most elements).  Five elementwise passes where `F.silu`
    takes one, so only the recurrent blocks (mamba2, xLSTM) use it, on
    their narrow per-layer tensors, where it keeps the full-depth decode
    as close to the reference's as the reference's own drift; the FFNs'
    (tokens, d_ff) activations take `F.silu`."""
    return x * (1 / (1 + torch.exp(-x)))


ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(dh: int, theta: float = 10000.0):
    """(dh/2,) float64 numpy, as the reference computes them; a float32
    `torch.pow` gives other angles at theta = 1e6.  Callers round them to
    float32 on the host, so a device gets them in one upload."""
    return 1.0 / (theta ** (np.arange(0, dh, 2) / dh))


def _rotate(x, ang):
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, dh); positions: (B, S) int32."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta).astype(np.float32),
                            device=x.device)
    ang = positions[..., None].float() * freqs       # (B, S, dh/2)
    return _rotate(x, ang)


def apply_mrope(x, positions, sections, theta: float = 10000.0):
    """Qwen2-VL M-RoPE: positions (B, S, 3) = (t, h, w); `sections` gives the
    per-component share of the dh/2 frequency slots (sum == dh/2)."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta).astype(np.float32),
                            device=x.device)
    total = float(sum(sections))
    # each of the dh/2 frequency slots reads the position component whose
    # proportional share it falls in (as in the reference)
    comp = np.searchsorted(np.cumsum(sections) / total,
                           (np.arange(dh // 2) + 0.5) / (dh // 2))
    idx = torch.as_tensor(comp, dtype=torch.int64, device=x.device)
    idx = idx[None, None, :].expand(positions.shape[:2] + (dh // 2,))
    pos = torch.gather(positions.float(), -1, idx)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_xent(logits, labels, mask=None):
    """logits: (B, S, V); labels: (B, S) int.  float32 logsumexp less the
    gold logit; the mask-weighted mean over ``max(sum(mask), 1)`` (the
    plain mean without a mask)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
