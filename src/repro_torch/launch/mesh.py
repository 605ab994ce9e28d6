"""Meshes.  Functions, not module constants: importing this module never
touches device state or a process group.

`make_production_mesh` is the reference's 16 x 16 (``("data", "model")``)
or 2 x 16 x 16 (``("pod", "data", "model")``) mesh, as a torch
`DeviceMesh` over the ranks of the process group already initialised:
NCCL on cards, gloo on the CPU, or the ``fake`` backend
(`init_fake_group`) for a dry run that counts rank 0's share.
`make_host_mesh` keeps its 1 x 1 `HostMesh` for one device, and is a
`DeviceMesh` when a process group of ``data * model`` ranks is up.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..core.device import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


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


def _device_type() -> str:
    """"cuda" under NCCL, "cpu" under gloo and the fake group."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _device_mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a "
                           f"process group of {n} ranks; none is "
                           f"initialised")
    if dist.get_world_size() != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the current process group."""
    if multi_pod:
        return _device_mesh((2, 16, 16), POD_AXES)
    return _device_mesh((16, 16), AXES)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh: a `DeviceMesh` when a process group of
    ``data * model`` ranks is initialised (each rank on its own card, or
    the CPU under gloo), else a 1 x 1 `HostMesh` on `device` (CUDA unless
    the caller asks for the CPU); raises when it needs more devices."""
    if dist.is_initialized():
        return _device_mesh((data, model), AXES)
    dev = resolve_device(device)
    if data < 1 or model < 1 or data * model > 1:
        raise ValueError(f"a {data} x {model} mesh needs a process group "
                         f"of {data * model} ranks (torchrun "
                         f"--nproc-per-node {data * model})")
    return HostMesh(AXES, (data, model), dev)


def init_group(device=None):
    """Join the process group a launcher (``torchrun``) describes in the
    environment, or else a one-rank group of this process with an
    in-process store: NCCL when `device` is a card (the current card, set
    to ``LOCAL_RANK``), gloo when the caller asks for the CPU.  A card
    group that fails to form raises; nothing falls back to another
    backend."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    device_id = dev if dev.type == "cuda" else None
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, device_id=device_id)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, device_id=device_id)
    return dev


def init_fake_group(world_size: int) -> None:
    """The ``fake`` backend: `world_size` ranks, of which this process is
    rank 0; collectives return at once and move nothing, so one process
    counts one rank's step of a mesh it does not have."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, HostMesh)
