"""Device resolution for the port's device entry points.

The default is CUDA.  Without a GPU the caller must ask for the host
explicitly (``device="cpu"``); nothing quietly falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` or, when None, the CUDA device (raises if there is none)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain-torch path on the host")
        return torch.device("cuda")
    return torch.device(device)
