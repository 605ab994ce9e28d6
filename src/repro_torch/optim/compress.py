"""int8 gradient compression (off by default).

Quantize a gradient leaf to int8 with a per-tensor float32 scale and
dequantize it.  In the reference, `compressed_psum_grads` models wire
compression of the cross-pod all-reduce: a psum over ``pod`` runs only
when the mesh has one (``rules.multi_pod``); without it, each leaf makes
the quantization round trip and the error-feedback hook ``g2 + (g - g2) *
0.0``, which is what this port does.  A pod axis comes with the LM mesh.
"""
from __future__ import annotations

import torch

from .adamw import tree_map


def quantize_int8(g):
    scale = torch.clamp(g.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum_grads(grads, rules=None):
    """Quantize -> dequantize per leaf (float32 out), with the reference's
    error-feedback hook point.  Raises if `rules` asks for a pod axis: the
    cross-pod reduction needs the LM mesh."""
    if rules is not None and getattr(rules, "multi_pod", False):
        raise NotImplementedError("compressed_psum_grads: the cross-pod "
                                  "reduction needs the LM mesh")

    def comp(g):
        g32 = g.to(torch.float32)
        q, scale = quantize_int8(g32)
        g2 = dequantize_int8(q, scale)
        return g2 + (g32 - g2) * 0.0      # EF hook point

    return tree_map(comp, grads)
