"""A/B timing of a flash attention kernel against variant sources.

    python -m repro_torch.kernels.flash_attention.bench [--dtype DTYPE]
        [VARIANT.cu ...]

``--dtype bfloat16`` (the default) times `csrc/flash_attention_tc.cu`;
each variant is a copy of it with the same C entry point
(`flash_attention_tc_launch`).  ``--dtype float32`` times
`csrc/flash_attention.cu`; each variant has its entry point
(`flash_attention_launch`), e.g. an earlier version of the file.  Each
variant is built with `cuda_lib`'s nvcc flags into its own library under
``build/repro_torch/variants/``.  The library's kernel ("base") and every
variant are held against the dtype's rounding twin (`flash_tc_ref`,
`flash_tf32x3_ref`) at the wrapper's shapes, then timed at the qwen3-4b
prefill's call (B 4, H 32, KH 8, S 2,048, dh 128, causal; bf16 on the
model's strided views, float32 on contiguous tensors) by CUDA events
over 20 launches after a warm-up, median of 5, in turns: each in order,
then in reverse.  SDPA is timed last as the yardstick.  Needs one CUDA
card and `nvcc`.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .. import cuda_lib
from . import ops
from .ref import flash_tc_ref, flash_tf32x3_ref

SHAPES = ((1, 8, 2, 1000, 128, True, 0), (1, 2, 2, 512, 64, True, 64),
          (2, 4, 4, 256, 32, True, 0), (3, 6, 3, 129, 64, False, 0))
SLICE = (4, 32, 8, 2048, 128)
ENTRY = {"bfloat16": "flash_attention_tc_launch",
         "float32": "flash_attention_launch"}
TWIN = {"bfloat16": flash_tc_ref, "float32": flash_tf32x3_ref}


def _variant(src: Path, dtype: str):
    """The launch function of a variant source, built into its own
    library."""
    out = cuda_lib.BUILD_DIR / "variants" / f"{src.stem}_{src.parent.name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-o", str(out), str(src)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), ENTRY[dtype])
    fn.argtypes = list(cuda_lib._SIGNATURES[ENTRY[dtype]])
    fn.restype = ctypes.c_int

    def call(q, k, v, causal=True, window=0):
        plan = ops.plan_flash_attention(q, k, v, window=window)
        o = torch.empty_like(plan.q)
        stream = torch.cuda.current_stream().cuda_stream
        if dtype == "float32":
            err = fn(plan.q.data_ptr(), plan.k.data_ptr(), plan.v.data_ptr(),
                     o.data_ptr(), plan.B * plan.H, plan.B * plan.KH, plan.S,
                     plan.dh, int(causal), int(window), stream)
        else:
            st = plan.strides + (ops._tma_strides("o", o),)
            arr = (ctypes.c_longlong * 12)(*(s for t in st for s in t))
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     arr, plan.B, plan.H, plan.KH, plan.S, plan.dh,
                     int(causal), int(window), stream)
        if err:
            raise RuntimeError(f"{src}: CUDA error {err}")
        return o
    return call


def events_ms(fn, iters: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", type=Path)
    ap.add_argument("--dtype", choices=sorted(ENTRY), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    dt = getattr(torch, args.dtype)
    kernels = {"base": ops.flash_attention}
    for src in args.variants:
        kernels[f"{src.parent.name}/{src.name}"] = _variant(src, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    for B, H, KH, S, dh, causal, window in SHAPES:
        q, k, v = rnd(B, H, S, dh), rnd(B, KH, S, dh), rnd(B, KH, S, dh)
        twin = TWIN[args.dtype](q, k, v, causal=causal,
                                window=window).float()
        errs = {n: (f(q, k, v, causal=causal, window=window).float()
                    - twin).abs().max().item() for n, f in kernels.items()}
        print(f"max_abs_err vs {TWIN[args.dtype].__name__}",
              (B, H, KH, S, dh, causal, window), errs)
    B, H, KH, S, dh = SLICE
    if dt == torch.bfloat16:
        q, k, v = (rnd(B, S, h, dh).transpose(1, 2) for h in (H, KH, KH))
    else:
        q, k, v = rnd(B, H, S, dh), rnd(B, KH, S, dh), rnd(B, KH, S, dh)
    order = list(kernels) + list(reversed(kernels))
    ms = {n: [] for n in kernels}
    for n in order:
        ms[n].append(events_ms(lambda: kernels[n](q, k, v)))
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    sdpa = events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True))
    print("card", torch.cuda.get_device_name(0), args.dtype)
    print("ms in turns", ms, "sdpa", sdpa)
    return 0


if __name__ == "__main__":
    sys.exit(main())
