"""int8 gradient compression (off by default).

Quantize a gradient leaf to int8 with a per-tensor float32 scale and
dequantize it.  In the reference, `compressed_psum_grads` models wire
compression of the cross-pod all-reduce: the reduction over ``pod`` runs
only when the mesh has one (``rules.multi_pod``); every leaf makes the
quantization round trip and the error-feedback hook ``g2 + (g - g2) *
0.0``.  On a mesh with a pod axis the port moves the int8 payload across
it: each pod's int8 blocks and scales are gathered over ``pod`` (a quarter
of the float32 wire bytes) and the result is the mean of the dequantised
payloads.  The gradients reaching it are already reduced over the batch
axes (the train step's hooks), so the pods hold the same payload and the
mean is the round trip itself.  A DTensor leaf's scale is the max over
its shards, the per-tensor scale of the whole gradient.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor

from .adamw import tree_map


def quantize_int8(g):
    scale = torch.clamp(g.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


_all_gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor


def _wait(t):
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def _leaf(g, pod_dim):
    """The round trip of one leaf (a DTensor: on its local block, with
    the scale of the whole tensor), its payload averaged over ``pod``."""
    if not isinstance(g, DTensor):
        g32 = g.to(torch.float32)
        q, scale = quantize_int8(g32)
        g2 = dequantize_int8(q, scale)
        return g2 + (g32 - g2) * 0.0      # EF hook point
    mesh = g.device_mesh
    g32 = g.to_local().to(torch.float32)
    amax = g32.abs().max()
    for d, pl in enumerate(g.placements):
        if pl.is_shard():
            amax = _wait(fc.all_reduce(amax, "max", (mesh, d)))
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    g2 = dequantize_int8(q, scale)
    if pod_dim is not None:
        n = mesh.size(pod_dim)
        qs = _wait(_all_gather(q.reshape(1, -1).contiguous(), 0,
                               (mesh, pod_dim)))
        ss = _wait(_all_gather(scale.reshape(1), 0, (mesh, pod_dim)))
        g2 = (dequantize_int8(qs, ss[:, None]).sum(0) / n).reshape(g32.shape)
    out = g2 + (g32 - g2) * 0.0           # EF hook point
    return DTensor.from_local(out, mesh, g.placements, run_check=False)


def compressed_psum_grads(grads, rules=None, mesh=None):
    """Quantize -> (gather over ``pod`` and average, when ``rules.multi_pod``
    on a mesh with that axis) -> dequantize, per leaf; float32 out."""
    pod_dim = None
    if rules is not None and getattr(rules, "multi_pod", False):
        names = getattr(mesh, "mesh_dim_names", None) or ()
        if "pod" not in names:
            raise ValueError("rules ask for a pod axis; the mesh "
                             f"{names or mesh} has none")
        pod_dim = names.index("pod")
    return tree_map(lambda g: _leaf(g, pod_dim), grads)
