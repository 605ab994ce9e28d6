"""Public wrapper for the flash attention kernel (csrc/flash_attention.cu).

``backend="cuda"`` launches the CUDA kernel for CUDA tensors and uses the
plain-torch twin `mha_ref` only for CPU tensors; ``backend="torch"``
always uses the twin.  Layout as the reference's `ops.flash_attention`:
q (B, H, S, dh), k/v (B, KH, S, dh); the kernel sees them flattened to
(B·H, S, dh) and (B·KH, S, dh) and maps query head ``bh`` to kv head
``bh // (H/KH)``.
"""
from __future__ import annotations

import torch

from .. import cuda_lib
from .ref import mha_ref

BACKENDS = ("cuda", "torch")
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "cuda"):
    """q: (B, H, S, dh); k/v: (B, KH, S, dh) -> (B, H, S, dh) in q.dtype.
    f32 or bf16 in, softmax in f32; dh in {32, 64, 128}; any S."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if backend == "torch" or q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16; got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_cuda(name, t, q.dtype, 4)
    B, H, S, dh = q.shape
    KH = k.shape[1]
    if k.shape != (B, KH, S, dh) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, KH, S, dh) = {(B, KH, S, dh)}; "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"H = {H} is not a multiple of KH = {KH}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported; one of {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    o = torch.empty_like(q)
    if o.numel():
        cuda_lib.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), o.data_ptr(), B * H, B * KH, S, dh,
                        int(bool(causal)), int(window), _DTYPE_CODES[q.dtype])
        cuda_lib.LAUNCHES["flash_attention"] += 1
    return o
