"""Public wrapper for the flash attention kernels.

``backend="cuda"`` launches a CUDA kernel for CUDA tensors and uses the
plain-torch twin `mha_ref` only for CPU tensors; ``backend="torch"``
always uses the twin.  Layout as the reference's `ops.flash_attention`:
q (B, H, S, dh), k/v (B, KH, S, dh), query head ``h`` reading kv head
``h // (H/KH)``.

Two kernels, chosen by dtype (`plan_flash_attention`):

- bfloat16: ``flash_attention_tc`` (csrc/flash_attention_tc.cu), wgmma
  tensor-core products fed by TMA.  It reads q, k and v and writes o
  through their strides, so any view with a contiguous last dimension and
  16-byte-aligned base and strides is taken as it lies; the model's
  (B, S, H, dh) activations seen as (B, H, S, dh) need no copy, and o has
  q's strides.
- float32: ``flash_attention`` (csrc/flash_attention.cu), mma.sync
  tensor-core products in TF32 with each operand split into two TF32
  parts (three products a product, float32-accurate), fed by cp.async,
  on contiguous, 16-byte-aligned (B·H, S, dh) and (B·KH, S, dh) copies.

On ``meta`` tensors the kernel route plans as on a card, allocates o with
the strides the card's o would have, and launches nothing (a shape-only
run).  On either device a call is one op to an active step counter, with
the function's work (`flash_work`), never the twin's.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import cuda_lib
from .ref import mha_ref

BACKENDS = ("cuda", "torch")
HEAD_DIMS = (32, 64, 128)
KERNELS = {torch.bfloat16: "flash_attention_tc",
           torch.float32: "flash_attention"}
ALIGN = 16          # bytes: TMA base and stride alignment, and the
                    # float32 kernel's 16-byte loads


@dataclass(frozen=True)
class FlashPlan:
    """What the wrapper launches: the kernel (its `LAUNCHES` key), the
    tensors it passes (views of the caller's for bf16, contiguous copies
    for float32) and, for bf16, their (batch, head, row) element
    strides."""
    kernel: str
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    B: int
    H: int
    KH: int
    S: int
    dh: int
    strides: tuple      # bf16: (q, k, v), each (batch, head, row)


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(row, col) pairs one head's softmax sees under the masks: row r
    sees cols [max(r - window + 1, 0), r + 1) when causal, else up to S."""
    full = S * S
    if causal:
        if window <= 0 or window >= S:
            return S * (S + 1) // 2
        return window * (window + 1) // 2 + (S - window) * window
    if window <= 0 or window >= S:
        return full
    return full - (S - window) * (S - window + 1) // 2


def flash_work(B: int, H: int, KH: int, S: int, dh: int, esize: int,
               causal: bool, window: int) -> tuple:
    """(flops, bytes) of the attention: 4*dh flops per visible pair and
    query head (QK^T and PV), and q, k, v and o moved once."""
    flops = 4 * dh * B * H * visible_pairs(S, causal, window)
    return flops, (2 * B * H + 2 * B * KH) * S * dh * esize


def _tma_strides(name: str, t: torch.Tensor) -> tuple:
    """(batch, head, row) element strides of a bf16 view the TMA can read:
    contiguous last dimension, base and strides 16-byte aligned.  A
    dimension of size 1 is never stepped, so its stride is not checked."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous; "
                         f"strides {tuple(t.stride())}")
    if t.data_ptr() % ALIGN:
        raise ValueError(f"{name}: base address must be {ALIGN}-byte "
                         f"aligned")
    out = []
    for size, st in zip(t.shape[:3], t.stride()[:3]):
        st = st if size > 1 else t.shape[-1]
        if (st * t.element_size()) % ALIGN:
            raise ValueError(f"{name}: strides {tuple(t.stride())} are not "
                             f"{ALIGN}-byte multiples")
        out.append(st)
    return tuple(out)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` (contiguous), or a copy in fresh storage when its base is not
    16-byte aligned: the float32 kernel reads rows as 16-byte vectors."""
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def plan_flash_attention(q, k, v, *, window: int = 0) -> FlashPlan:
    """Check q, k and v against what the kernels take and pick one; raise
    on anything else.  Reaches no card, so the CPU tests run it."""
    if q.dtype not in KERNELS:
        raise TypeError(f"q must be float32 or bfloat16; got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}; got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must have rank 4; got "
                             f"{tuple(t.shape)}")
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
    kernel = KERNELS[q.dtype]
    if kernel == "flash_attention":
        q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
        strides = ()
    else:
        strides = tuple(_tma_strides(n, t)
                        for n, t in (("q", q), ("k", k), ("v", v)))
    return FlashPlan(kernel, q, k, v, B, H, KH, S, dh, strides)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "cuda"):
    """q: (B, H, S, dh); k/v: (B, KH, S, dh) -> (B, H, S, dh) in q.dtype.
    f32 or bf16 in, softmax in f32; dh in {32, 64, 128}; any S.  The
    kernels are forward only: on the CUDA route, q, k or v that autograd
    would record (grad mode on and one requiring grad) raise."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if backend == "torch" or q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernels have no backward (nor has "
            "the reference's Pallas kernel), and their output would carry "
            "no gradient; train through backend='torch', or call under "
            "torch.no_grad()")
    plan = plan_flash_attention(q, k, v, window=window)
    o = torch.empty_like(plan.q)
    if not o.numel():
        return o
    B, H, KH, S, dh = plan.B, plan.H, plan.KH, plan.S, plan.dh
    if cuda_lib.on_card(q):
        ptrs = (plan.q.data_ptr(), plan.k.data_ptr(), plan.v.data_ptr(),
                o.data_ptr())
        if plan.kernel == "flash_attention":
            cuda_lib.launch("flash_attention_launch", *ptrs, B * H, B * KH,
                            S, dh, int(bool(causal)), int(window))
        else:
            strides = plan.strides + (_tma_strides("o", o),)
            arr = (ctypes.c_longlong * 12)(*(s for t in strides for s in t))
            cuda_lib.launch("flash_attention_tc_launch", *ptrs, arr, B, H,
                            KH, S, dh, int(bool(causal)), int(window))
        cuda_lib.LAUNCHES[plan.kernel] += 1
    cuda_lib.count_kernel(plan.kernel, lambda: (
        *flash_work(B, H, KH, S, dh, q.element_size(), causal, window),
        (tuple(q.shape), tuple(k.shape), tuple(v.shape)), o))
    return o
