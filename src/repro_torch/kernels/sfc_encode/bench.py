"""Old against new body of the SFC encode kernel, on one card, in one run.

    python -m repro_torch.kernels.sfc_encode.bench [VARIANT.cu ...]

"bitloop" is the body the library shipped before the nibble lookup tables
(`bitloop.cu` beside this file, one variable 64-bit shift per input bit),
built with `cuda_lib`'s nvcc flags into its own library under
``build/repro_torch/variants/``.  "lut" is the library's kernel with the
table in shared memory ("smem", where it fits) and read through L1
("l1"), the placement `ops.plan_encode` picks marked "planned".  Each
VARIANT is a copy of `csrc/sfc_encode.cu` with the same C entry points,
built like the old body and run the same ways.  All of them are
held against the plain twins at every shape, then timed in turns (each in
order, then in reverse) two ways: the profiler's mean device time of one
launch over 20 launches, and CUDA events over 20 back-to-back launches
(median of 5), which at small shapes time the host's launches.

Shapes, on seeded random curves and points: single encodes of a global
curve (d 2, K 32) and of a depth-2 piecewise curve (d 3, K 21, 64 regions)
at the path's call when its split ran per q_chunk (256 / 384 points), the
path's largest call now that a batch's split runs at once (8,192 /
12,288) and 2^20; pooled encodes of
8 global curves over 499,808 shared points and 8 piecewise curves over
50,000 (`chip_smoke.py`'s SMBO samples), 4 global curves over 3,200 points
each and 4 piecewise ones over 4,800 (the largest per-candidate calls) and
16 global curves over 2^20 shared points.  Needs one CUDA card and `nvcc`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ...core.curve import CurvePool, pack_curve_pool, random_curve
from ...core.sfc import lut_tables
from .. import cuda_lib
from . import ops
from .ref import sfc_encode_pool_ref

BITLOOP = Path(__file__).resolve().with_name("bitloop.cu")

# name, d, K, curve family, depth, P, n, points shared by the pool
SHAPES = (
    ("global_path256", 2, 32, "global", 1, 1, 256, True),
    ("global_path", 2, 32, "global", 1, 1, 8192, True),
    ("global_large", 2, 32, "global", 1, 1, 2**20, True),
    ("piecewise_path384", 3, 21, "piecewise", 2, 1, 384, True),
    ("piecewise_path", 3, 21, "piecewise", 2, 1, 12288, True),
    ("piecewise_large", 3, 21, "piecewise", 2, 1, 2**20, True),
    ("pool_global_shared", 2, 32, "global", 1, 8, 499808, True),
    ("pool_piecewise_shared", 3, 21, "piecewise", 2, 8, 50000, True),
    ("pool_global_per_candidate", 2, 32, "global", 1, 4, 3200, False),
    ("pool_piecewise_per_candidate", 3, 21, "piecewise", 2, 4, 4800, False),
    ("pool_global_large", 2, 32, "global", 1, 16, 2**20, True),
)


def _build(src: Path, entry: str, argtypes):
    """C entry point `entry` of `src`, built into its own library."""
    out = (cuda_lib.BUILD_DIR / "variants"
           / f"{src.stem}_{src.parent.name}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-o", str(out), str(src)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    print(f"== {src}\n{r.stdout}{r.stderr}", file=sys.stderr)
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _bitloop():
    """The old body's pool launch: x, x_stride, pos, reg, out, n, d, K, R,
    M, P, number of SMs, stream."""
    c = ctypes
    return _build(BITLOOP, "sfc_encode_bitloop_launch", (
        c.c_void_p, c.c_longlong, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_longlong, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_void_p))


def _variants(pool: CurvePool, x: torch.Tensor, bitloop, others) -> dict:
    """Each body as a call that writes (P, n, 2) into a fresh output."""
    P, R, T = pool.pos.shape
    n, d = x.shape[-2:]
    K, M = pool.K, pool.reg.shape[1]
    x_stride = n * d if x.dim() == 3 else 0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def lut_call(plan, fn=None):
        def call():
            out = torch.empty((P, n, 2), dtype=torch.int32, device=x.device)
            args = (x.data_ptr(), x_stride, pool.lut.data_ptr(),
                    pool.reg.data_ptr(), out.data_ptr(), n, d, K, R, M, P,
                    plan.placement == "smem", plan.blocks)
            if fn is None:
                cuda_lib.launch("sfc_encode_pool_launch", *args)
            elif fn(*args, stream()):
                raise RuntimeError("variant: CUDA error")
            return out
        return call

    def old():
        out = torch.empty((P, n, 2), dtype=torch.int32, device=x.device)
        err = bitloop(x.data_ptr(), x_stride, pool.pos.data_ptr(),
                      pool.reg.data_ptr(), out.data_ptr(), n, d, K, R, M, P,
                      sms, stream())
        if err:
            raise RuntimeError(f"bitloop: CUDA error {err}")
        return out

    planned = ops.plan_encode(n, P, R, d, K, sms)
    plans = {planned.placement: planned}
    if planned.placement == "smem":        # the same table through L1
        plans["l1"] = ops._plan(n, P, planned.table_bytes, False, sms)
    calls = {}
    for name, fn in {"lut": None, **others}.items():
        for placement, plan in plans.items():
            tag = " (planned)" if plan is planned else ""
            calls[f"{name} {placement}{tag}"] = lut_call(plan, fn)
    calls["bitloop"] = old
    return calls


def profiler_ms(fn, iters: int = 20) -> float:
    """Mean device time of one kernel launch over `iters` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0 and "encode" in e.key]
    count = sum(e.count for e in ev)
    return sum(e.self_device_time_total for e in ev) / count / 1e3 \
        if count else float("nan")


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bitloop = _bitloop()
    others = {f"{src.parent.name}/{src.name}": _build(
        src, "sfc_encode_pool_launch",
        cuda_lib._SIGNATURES["sfc_encode_pool_launch"])
        for src in args.variants}
    cuda_lib.library()
    print("card", torch.cuda.get_device_name(0), flush=True)
    for name, d, K, family, depth, P, n, shared in SHAPES:
        rng = np.random.default_rng(len(name) * 1000 + n)
        curves = [random_curve(rng, d, K, family=family, depth=depth)
                  for _ in range(P)]
        cp = pack_curve_pool(curves)
        pos = torch.from_numpy(cp.pos).to(dev)
        pool = CurvePool(pos=pos, reg=torch.from_numpy(cp.reg).to(dev), d=d,
                         K=K, lut=lut_tables(pos, d, K))
        shape = (n, d) if shared else (P, n, d)
        x = torch.from_numpy(rng.integers(0, 2**K, size=shape,
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
        calls = _variants(pool, x, bitloop, others)
        want = sfc_encode_pool_ref(x, pool)
        errs = {v: int((f().long() - want.long()).abs().max().item())
                for v, f in calls.items()}
        if any(errs.values()):
            print(json.dumps({"shape": name, "max_abs_err": errs}))
            return 1
        order = list(calls) + list(reversed(calls))
        prof = {v: [] for v in calls}
        wall = {v: [] for v in calls}
        for v in order:
            prof[v].append(profiler_ms(calls[v]))
            wall[v].append(events_ms(calls[v]))
        print(json.dumps({"shape": name, "P": P, "n": n, "d": d, "K": K,
                          "regions": int(pos.shape[1]),
                          "shared": shared, "max_abs_err": errs,
                          "profiler_ms_in_turns": prof,
                          "events_ms_in_turns": wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
