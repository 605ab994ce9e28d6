"""Public wrappers for the window-filter kernels (csrc/window_filter.cu).

``backend="cuda"`` launches the CUDA kernel for CUDA tensors and uses the
plain-torch twin only for CPU tensors; ``backend="torch"`` always uses the
twin.  There is no fallback from a CUDA tensor to the twin.  On ``meta``
tensors the kernel route allocates the kernel's outputs and launches
nothing (a shape-only run); on either device each call is one op to an
active step counter (`filter_work`).
"""
from __future__ import annotations

import torch

from .. import cuda_lib
from .ref import window_filter_ref, window_match_ref

BACKENDS = ("cuda", "torch")


def _use_ref(pts: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    return backend == "torch" or pts.device.type == "cpu"


def _check(pts, rect, size) -> tuple:
    cuda_lib.check_cuda_int32("pts", pts, 3)
    cuda_lib.check_cuda_int32("rect", rect, 3)
    cuda_lib.check_cuda_int32("size", size, 1)
    G, d, cap = pts.shape
    if tuple(rect.shape) != (G, d, 2) or tuple(size.shape) != (G,):
        raise ValueError(f"shapes disagree: pts {tuple(pts.shape)}, rect "
                         f"{tuple(rect.shape)}, size {tuple(size.shape)}")
    if rect.device != pts.device or size.device != pts.device:
        raise ValueError("pts, rect and size must be on one device")
    return G, d, cap


def filter_work(G: int, d: int, cap: int, out_bytes: int) -> int:
    """Bytes a filter call of G pages moves with every slot valid: the
    points, rectangles and sizes in once, `out_bytes` out.  (The bound in
    `chip_smoke.py` counts only the valid slots of its data; this count is
    from shapes alone, so a shape-only run gives it too.)"""
    return G * d * cap * 4 + G * d * 2 * 4 + G * 4 + out_bytes


def _count(key: str, pts, rect, size, out) -> None:
    G, d, cap = pts.shape
    cuda_lib.count_kernel(key, lambda: (
        0, filter_work(G, d, cap, out.numel() * out.element_size()),
        (tuple(pts.shape), tuple(rect.shape), tuple(size.shape)), out))


def window_filter(pts, rect, size, *, backend: str = "cuda"):
    """pts: (G, d, cap) int32; rect: (G, d, 2); size: (G,) -> (G,) int32."""
    if _use_ref(pts, backend):
        return window_filter_ref(pts, rect, size)
    G, d, cap = _check(pts, rect, size)
    out = torch.empty(G, dtype=torch.int32, device=pts.device)
    if G:
        if cuda_lib.on_card(pts):
            cuda_lib.launch("window_filter_launch", pts.data_ptr(),
                            rect.data_ptr(), size.data_ptr(), out.data_ptr(),
                            G, d, cap)
            cuda_lib.LAUNCHES["window_filter"] += 1
        _count("window_filter", pts, rect, size, out)
    return out


def window_match(pts, rect, size, *, backend: str = "cuda"):
    """Index-emitting variant of `window_filter`: the (G, cap) bool
    membership mask of valid points inside their rectangle."""
    if _use_ref(pts, backend):
        return window_match_ref(pts, rect, size)
    G, d, cap = _check(pts, rect, size)
    out = torch.empty((G, cap), dtype=torch.bool, device=pts.device)
    if G:
        if cuda_lib.on_card(pts):
            cuda_lib.launch("window_match_launch", pts.data_ptr(),
                            rect.data_ptr(), size.data_ptr(), out.data_ptr(),
                            G, d, cap)
            cuda_lib.LAUNCHES["window_match"] += 1
        _count("window_match", pts, rect, size, out)
    return out
