"""Public wrapper for the SFC encode kernel (csrc/sfc_encode.cu).

``backend="cuda"`` launches the CUDA kernel for CUDA tensors and uses the
plain-torch twin only for CPU tensors; ``backend="torch"`` always uses the
twin.  The curve reaches the kernel as data (`core.curve.curve_tables`), so
one compiled kernel serves global and piecewise curves alike.
"""
from __future__ import annotations

import torch

from ...core.curve import as_curve, curve_tables
from .. import cuda_lib
from .ref import sfc_encode_ref

BACKENDS = ("cuda", "torch")


def sfc_encode(x, curve, *, backend: str = "cuda"):
    """x: (n, d) int32 -> (n, 2) int32 Z64.  `curve` is any
    `MonotonicCurve` (legacy `Theta` values are coerced)."""
    curve = as_curve(curve)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
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
