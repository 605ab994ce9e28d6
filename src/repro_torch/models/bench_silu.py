"""One-pass `F.silu` against the per-step-rounded `common.silu` in the
FFN, on one card, in one run.

    python -m repro_torch.models.bench_silu [--layers 36]

First the activation alone on seeded bf16 inputs at two FFN shapes:
qwen3-4b's gate activations of a 4 x 2,048-token prefill (8,192 x 9,728)
and mixtral-8x22b's expert slots of a 8,192-token prefill (8 x 2,560 x
16,384), each timed with CUDA events (median of 5 windows of 20 calls).
Then the qwen3-4b prefill that `chip_smoke.py`'s lm_serve phase drives
(published widths, seeded random bf16 weights, 4 x 2,048 seeded tokens,
the flash kernel) with each activation in the dense SwiGLU
(`ACTS["silu"]`), in turns A B B A, each turn the median of 3 prefills.
Prints the card (`nvidia-smi`'s name and power limit) and one JSON line.
Needs one CUDA card and `nvcc`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from unittest import mock

import torch
import torch.nn.functional as F

from ..configs.base import ShapeConfig
from ..configs.registry import get_arch
from ..train.steps import make_prefill_step
from .common import ACTS, silu
from .transformer import init_model

ACTIVATIONS = {"F.silu": F.silu, "common.silu": silu}
SHAPES = {"qwen3-4b_gate": (8192, 9728),
          "mixtral-8x22b_expert_gate": (8, 2560, 16384)}


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


def prefill_s(prefill, params, batch, reps: int = 3) -> float:
    prefill(params, batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"activation_ms": {}, "prefill_s": {}}
    for name, shape in SHAPES.items():
        x = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
        out["activation_ms"][name] = {
            act: events_ms(lambda: fn(x)) for act, fn in ACTIVATIONS.items()}
        del x
    cfg = dataclasses.replace(get_arch("qwen3-4b"), n_layers=args.layers)
    B, S = 4, 2048
    params = init_model(cfg, seed=args.seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device="cuda")}
    prefill = make_prefill_step(cfg, ShapeConfig("lm_prefill", S, B,
                                                 "prefill"))
    for act in ("F.silu", "common.silu", "common.silu", "F.silu"):
        with mock.patch.dict(ACTS, silu=ACTIVATIONS[act]):
            out["prefill_s"].setdefault(act, []).append(
                prefill_s(prefill, params, batch))
    out.update(arch=cfg.name, n_layers=cfg.n_layers, requests=B,
               prompt_tokens=S, device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
