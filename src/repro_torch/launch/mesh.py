"""Meshes.  Functions, not module constants: importing this module never
touches device state.  The reference's `make_production_mesh` (16 x 16 or
2 x 16 x 16 chips) comes with the LM mesh."""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import resolve_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """Axis names, shape and device of a host mesh (one card, or the CPU,
    takes a 1 x 1 mesh; the train step runs on `device`)."""
    axis_names: tuple
    shape: tuple
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> HostMesh:
    """A (data, model) mesh over the devices there are (CUDA unless the
    caller asks for the CPU); raises when it needs more of them."""
    dev = resolve_device(device)
    # devices of that type there are; the host counts as one
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if data < 1 or model < 1 or data * model > have:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"{dev.type} devices; there are {have}")
    return HostMesh(AXES, (data, model), dev)
