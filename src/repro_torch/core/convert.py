"""Carry index and serving state across from plain arrays and curve JSON.

The reference package's state is numpy arrays plus a curve's JSON, so an
index built (or a curve learned) there can be served here, and the reverse,
without importing either package into the other.  A candidate pool packed
by the reference (`pack_curve_pool`) crosses as its two int32 arrays.
An LM's parameter tree crosses as a nested dict of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from . import pgm as pgm_mod
from .curve import CurvePool, curve_from_json
from .device import resolve_device
from .index import IndexConfig, LMSFCIndex
from .serve import ServingArrays, upload_serving_arrays


def index_from_numpy(curve_json: str, cfg_dict: dict, xs, starts, mbrs,
                     sort_dims, page_zmin, page_zmax) -> LMSFCIndex:
    """An `LMSFCIndex` from its arrays; the PGM is rebuilt from
    `page_zmin` with the config's error bound (it is a pure function of
    the page z-mins)."""
    cfg = IndexConfig(**cfg_dict)
    curve = curve_from_json(curve_json)
    page_zmin = np.asarray(page_zmin, dtype=np.uint64)
    return LMSFCIndex(
        curve=curve, cfg=cfg, K=curve.K,
        xs=np.asarray(xs, dtype=np.uint64),
        starts=np.asarray(starts, dtype=np.int64),
        mbrs=np.asarray(mbrs, dtype=np.int64),
        sort_dims=np.asarray(sort_dims),
        page_zmin=page_zmin,
        page_zmax=np.asarray(page_zmax, dtype=np.uint64),
        pgm=pgm_mod.build_pgm(page_zmin, eps=cfg.pgm_eps))


def serving_arrays_from_numpy(points, page_zmin, page_zmax, page_mbr,
                              page_size, device=None) -> ServingArrays:
    """Torch `ServingArrays` on `device` (CUDA unless the caller asks for
    the CPU) from packed int32 arrays in the reference layout."""
    host = ServingArrays(
        points=np.asarray(points, dtype=np.int32),
        page_zmin=np.asarray(page_zmin, dtype=np.int32),
        page_zmax=np.asarray(page_zmax, dtype=np.int32),
        page_mbr=np.asarray(page_mbr, dtype=np.int32),
        page_size=np.asarray(page_size, dtype=np.int32))
    return upload_serving_arrays(host, device)


def curve_pool_from_numpy(pos, reg, d: int, K: int) -> CurvePool:
    """A `CurvePool` from packed layouts: ``pos`` (P, R, T) and ``reg``
    (P, M) int32 with T = d*K, as the reference's `pack_curve_pool` makes
    them."""
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    reg = np.ascontiguousarray(reg, dtype=np.int32)
    if pos.ndim != 3 or reg.ndim != 2 or len(pos) != len(reg):
        raise ValueError(f"need pos (P, R, T) and reg (P, M); got "
                         f"{pos.shape} and {reg.shape}")
    if pos.shape[2] != d * K:
        raise ValueError(f"pos has {pos.shape[2]} bits per region; "
                         f"d*K = {d * K}")
    return CurvePool(pos=pos, reg=reg, d=int(d), K=int(K))


def _tensor_from_numpy(a) -> torch.Tensor:
    """bfloat16 arrays (the `ml_dtypes` dtype `np.asarray` gives for a JAX
    bf16 array, which `torch.from_numpy` refuses) cross as their 16-bit
    patterns, recognised by dtype name so that no `ml_dtypes` import is
    needed; other dtypes cross as they are."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def lm_params_from_numpy(tree, device=None) -> dict:
    """The port's parameter dict from the reference's param tree given as
    nested dicts of numpy arrays (same keys, same shapes, layers stacked on
    the leading axis), on `device` (CUDA unless the caller asks for the
    CPU), bit for bit."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor_from_numpy(t).to(dev)
    return conv(tree)
