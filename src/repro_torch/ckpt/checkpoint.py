"""Checkpointing: one .npy per tree leaf + manifest, atomic directory
rename, keep-last-k, async save thread.

The format is the reference's, byte for byte, in both directions: a
checkpoint is ``<ckpt_dir>/step_%08d/`` (written as ``.tmp`` and then
renamed) holding ``manifest.json`` (``step``, ``leaves`` and the extra
meta) and one ``.npy`` per leaf, named by the leaf's key path joined with
``/`` and written with ``__``.  Leaves are taken in sorted key order, the
order in which JAX flattens a dict, so the manifests of the two packages
list them alike; bfloat16 is stored widened to float32.

Trees are nested dicts of tensors.  A tree of DTensors (a sharded train
state) is written as whole arrays, in the same files and manifest: every
rank takes part in gathering each leaf, rank 0 writes, and every rank
waits at a barrier until the checkpoint is on disk.  `restore_checkpoint`
with ``shardings=`` (a tree of `dist.sharding.NamedSharding`, the new
mesh's) places each leaf under its sharding: the elastic restart onto a
mesh of another shape.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.device import resolve_device

# dtypes numpy stores as they are; any other (bfloat16) is widened
_STD = {torch.float64, torch.float32, torch.float16, torch.int64,
        torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool}


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} in sorted key order at every level."""
    out = {}
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten_like(tree_like, flat: dict, prefix: str = "") -> dict:
    return {k: (_unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                else str(k)) if isinstance(v, dict)
                else flat[f"{prefix}/{k}" if prefix else str(k)])
            for k, v in tree_like.items()}


def _to_host(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype not in _STD:          # e.g. bfloat16: store widened
        t = t.to(torch.float32)
    return t.numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    blocking: bool = True, extra_meta: dict = None):
    """Write <ckpt_dir>/step_<n>/ atomically; prune to `keep` newest.  The
    leaves are copied to the host before returning; with ``blocking=False``
    the files are written by a thread, which is returned.  A tree holding
    DTensors is gathered whole on every rank, written by rank 0 alone
    (blocking), and every rank returns after a barrier."""
    flat = _flatten(tree)
    host = {k: _to_host(v) for k, v in flat.items()}
    sharded = dist.is_initialized() and any(
        isinstance(v, DTensor) for v in flat.values())

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}, **(extra_meta or {})}
        for k, v in host.items():
            fname = k.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), v)
            manifest["leaves"][k] = {"file": fname, "shape": list(v.shape),
                                     "dtype": str(v.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _prune(ckpt_dir, keep)

    if sharded:
        if dist.get_rank() == 0:
            _write()
        dist.barrier()
        return None
    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _steps(ckpt_dir: str) -> list:
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                  and not d.endswith(".tmp"))


def _prune(ckpt_dir: str, keep: int):
    for d in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return int(steps[-1].split("_")[1]) if steps else None


def _leaf_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_checkpoint(ckpt_dir: str, step: int, tree_like, device=None,
                       shardings=None):
    """(tree, manifest): every leaf of `tree_like` (a nested dict of
    tensors, or of anything with a torch ``dtype``) read from its file and
    cast to that dtype, on `device` (CUDA unless the caller asks for the
    CPU).  With `shardings` (a parallel tree of `NamedSharding`) each leaf
    becomes a DTensor under its sharding instead, on the mesh's devices:
    each rank reads the whole array and keeps its blocks."""
    from ..dist.compat import to_dtensor
    dev = resolve_device(device) if shardings is None else None
    placed = _flatten(shardings) if shardings is not None else None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for k, ref in _flatten(tree_like).items():
        meta = manifest["leaves"][k]
        arr = np.load(os.path.join(d, meta["file"]))
        if shardings is None:
            out[k] = torch.from_numpy(arr).to(device=dev, dtype=ref.dtype)
        else:
            sh = placed[k]
            t = torch.from_numpy(arr).to(device=_leaf_device(sh.mesh),
                                         dtype=ref.dtype)
            out[k] = to_dtensor(t, sh.mesh, sh.spec)
    return _unflatten_like(tree_like, out), manifest
