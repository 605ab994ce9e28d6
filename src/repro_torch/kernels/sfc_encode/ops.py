"""Public wrappers for the SFC encode kernels (csrc/sfc_encode.cu).

``backend="cuda"`` launches the CUDA kernel for CUDA tensors and uses the
plain-torch twin only for CPU tensors; ``backend="torch"`` always uses the
twin.  The curve reaches the kernel as data (`core.curve.curve_tables`,
`pack_curve_pool`), so one compiled kernel serves global and piecewise
curves alike, one curve or a whole pool.
"""
from __future__ import annotations

import torch

from ...core.curve import CurvePool, as_curve, curve_tables, pack_curve_pool
from .. import cuda_lib
from .ref import pool_tables, sfc_encode_pool_ref, sfc_encode_ref

BACKENDS = ("cuda", "torch")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")


def sfc_encode(x, curve, *, backend: str = "cuda"):
    """x: (n, d) int32 -> (n, 2) int32 Z64.  `curve` is any
    `MonotonicCurve` (legacy `Theta` values are coerced)."""
    curve = as_curve(curve)
    _check_backend(backend)
    if backend == "torch" or x.device.type == "cpu":
        return sfc_encode_ref(x, curve)
    cuda_lib.check_cuda_int32("x", x, 2)
    n, d = x.shape
    if d != curve.d:
        raise ValueError(f"x has {d} dims; the curve has {curve.d}")
    pos, reg = curve_tables(curve, x.device)
    R, T = pos.shape
    out = torch.empty((n, 2), dtype=torch.int32, device=x.device)
    if n:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        cuda_lib.launch("sfc_encode_launch", x.data_ptr(), pos.data_ptr(),
                        reg.data_ptr(), out.data_ptr(), n, d, T // d, R,
                        reg.shape[0], sms)
        cuda_lib.LAUNCHES["sfc_encode"] += 1
    return out


def sfc_encode_pool(x, curves, *, backend: str = "cuda"):
    """Candidate-batched encode: x (n, d) int32 shared by every curve, or
    (P, n, d) int32 with one point set per curve; `curves` a `CurvePool`
    (numpy or tensor arrays) or a list of `MonotonicCurve`s sharing (d, K)
    -> (P, n, 2) int32 Z64.  One launch encodes under every curve."""
    _check_backend(backend)
    pool = curves if isinstance(curves, CurvePool) else pack_curve_pool(
        curves)
    if backend == "torch" or x.device.type == "cpu":
        return sfc_encode_pool_ref(x, pool)
    cuda_lib.check_cuda_int32("x", x, 3 if x.dim() == 3 else 2)
    pos, reg = pool_tables(pool, x.device)
    cuda_lib.check_cuda_int32("pos", pos, 3)
    cuda_lib.check_cuda_int32("reg", reg, 2)
    P, R, T = pos.shape
    n, d = x.shape[-2:]
    if x.dim() == 3 and x.shape[0] != P:
        raise ValueError(f"x has {x.shape[0]} point sets for {P} curves")
    if d != pool.d:
        raise ValueError(f"x has {d} dims; the pool's curves have {pool.d}")
    out = torch.empty((P, n, 2), dtype=torch.int32, device=x.device)
    if n and P:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        x_stride = n * d if x.dim() == 3 else 0
        cuda_lib.launch("sfc_encode_pool_launch", x.data_ptr(), x_stride,
                        pos.data_ptr(), reg.data_ptr(), out.data_ptr(), n, d,
                        T // d, R, reg.shape[1], P, sms)
        cuda_lib.LAUNCHES["sfc_encode_pool"] += 1
    return out
