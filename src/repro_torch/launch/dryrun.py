"""Dry run: count every (arch × shape) cell's step once, without running it.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch]
  python -m repro_torch.launch.dryrun --arch lmsfc-serve
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape prefill_32k \\
      --device cuda --overrides '{"n_layers": 4}'
  python -m repro_torch.launch.dryrun --all --mesh pod|multipod

The reference lowers and compiles each cell's XLA program on a 256- or
512-device mesh of fake CPU devices and analyzes its HLO.  The port has no
compiler to ask: a cell's step (`make_train_step`, `make_prefill_step` or
`make_decode_step`) runs once under `dist.hlo_analysis.StepCounter`, which
records every op's flops and bytes, and each hand-written kernel's call as
one op of its own work.  By default the params, optimizer state, batch and
decode state are ``meta`` tensors (shapes and dtypes, no data), so a dry
run allocates nothing and needs no card, as the reference's fake devices
need no TPU; ``--device cuda`` counts the same step on seeded tensors on
the card instead (`chip_smoke.py` holds the two equal).

Per cell it writes the reference's JSON record (`arch`, `shape`, `mesh`,
`status`, `chips`, `params`, `active_params`, `model_flops_total`,
`model_flops_per_chip`, `roofline`, `useful_flops_ratio`, `lower_s`, the
counted run's seconds, and `compile_s`, 0) and, unless
``REPRO_SAVE_HLO=0``, the step's op log beside it
(``<out>/ops/<cell>.ops.json.gz``, the counterpart of the saved HLO).

``--mesh pod`` (16 x 16) and ``--mesh multipod`` (2 x 16 x 16) count one
chip's share of the sharded step: the process joins the ``fake`` process
group as rank 0 of 256 or 512 (`launch.mesh.init_fake_group`; its
collectives move nothing and return at once), builds the production
`DeviceMesh`, places the meta params, optimizer state, batch and decode
state under the step's shardings (rank 0's blocks), and runs the sharded
step (`models.spmd`) under the same `StepCounter`.  The record's flops
and bytes are one chip's; its collectives are priced with the ring
formulas over each collective's group.  ``--mesh host`` is one card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import time
import traceback

import torch

from ..configs.base import (SHAPES, ArchConfig, ShapeConfig, input_specs,
                            shape_applicable, spec_tensors)
from ..configs.registry import ARCHS, get_arch
from ..dist import roofline as rl
from ..dist.hlo_analysis import StepCounter, count_step, tensor_bytes
from ..models.transformer import init_decode_state, init_model
from ..optim.adamw import AdamWConfig, init_opt_state
from ..train.steps import (make_decode_step, make_prefill_step,
                           make_train_step, shard_params)

MESHES = {"host": "1x1", "pod": "16x16", "multipod": "2x16x16"}
CHIPS = {"host": 1, "pod": 256, "multipod": 512}
SKIP_REASON = "full-attention arch: no sub-quadratic long-context path"


def mesh_label(mesh: str) -> str:
    """The record's mesh label."""
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; one of {sorted(MESHES)}")
    return MESHES[mesh]


@contextlib.contextmanager
def production_mesh(mesh: str):
    """The `DeviceMesh` of ``pod`` / ``multipod`` (None for ``host``) over
    the current process group, or over the fake group joined here as rank
    0 and left again on exit."""
    import torch.distributed as dist
    from .mesh import init_fake_group, make_production_mesh
    if mesh == "host":
        yield None
        return
    made = not dist.is_initialized()
    if made:
        init_fake_group(CHIPS[mesh])
    try:
        yield make_production_mesh(multi_pod=mesh == "multipod")
    finally:
        if made:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one step's inputs and its count
# ---------------------------------------------------------------------------


def step_batch(cfg: ArchConfig, shape: ShapeConfig, device, seed: int = 0):
    """The batch of `input_specs`: empty on meta; on another device seeded
    tokens below the vocab, 1-D positions repeated over M-RoPE's three
    components, normal embeddings, and ``cur_len`` the cache's last slot."""
    specs = input_specs(cfg, shape)
    dev = torch.device(device)
    if dev.type == "meta":
        return spec_tensors(specs, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for k, (shp, dtype) in specs.items():
        if k == "tokens":
            t = torch.randint(0, cfg.vocab, shp, generator=gen,
                              dtype=dtype)
        elif k == "positions":
            S = shp[1]
            base = (shape.seq_len - 1 if shape.kind == "decode" else 0)
            t = (torch.arange(S, dtype=dtype) + base)[None, :, None].expand(
                shp).contiguous()
        elif k == "cur_len":
            t = torch.tensor(shape.seq_len - 1, dtype=dtype)
        else:
            t = torch.randn(shp, generator=gen).to(dtype)
        out[k] = t.to(dev)
    return out


def count_cell(cfg: ArchConfig, shape: ShapeConfig, *, device="meta",
               seed: int = 0, op_log: bool = False, mesh=None) -> dict:
    """Build a cell's step and its inputs on `device` and run it once under
    a `StepCounter`.  Returns the counter, the step's memory stats and the
    counted run's seconds.  Prefill serves through the kernels
    (``backend="cuda"``: on meta a kernel call is its shapes alone);
    training runs the plain torch walk, as the train step must.  With a
    `mesh` (a `DeviceMesh`) the step is the sharded one and its inputs
    this rank's blocks; the counts are this rank's."""
    dev = torch.device(device)
    params = init_model(cfg, seed=seed, device=dev)
    batch = step_batch(cfg, shape, dev, seed)
    if shape.kind == "train":
        step = make_train_step(cfg, shape, AdamWConfig(), device=dev,
                               mesh=mesh)
        if mesh is not None:
            params = shard_params(params, step.in_shardings[0])
        opt = init_opt_state(params)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, shape, device=dev, backend="cuda",
                                 mesh=mesh)
        if mesh is not None:
            params = shard_params(params, step.in_shardings[0])
        args = (params, batch)
    else:
        step = make_decode_step(cfg, shape, device=dev, mesh=mesh)
        state = init_decode_state(cfg, shape.seq_len, shape.global_batch,
                                  device=dev)
        if mesh is not None:
            params = shard_params(params, step.in_shardings[0])
            state = shard_params(state, step.in_shardings[2])
        args = (params, batch, state)
    arg_bytes = tensor_bytes(args)
    t0 = time.perf_counter()
    out, counter = count_step(step, *args, op_log=op_log)
    seconds = time.perf_counter() - t0
    stats = {"argument_size_in_bytes": arg_bytes,
             "output_size_in_bytes": tensor_bytes(out),
             "temp_size_in_bytes": counter.peak_bytes}
    return {"counter": counter, "memory_stats": stats, "seconds": seconds}


def _cell_name(arch: str, shape: str, label: str) -> str:
    return f"{arch}__{shape}__{label.replace('x', '_')}"


def _write(out_dir: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = _cell_name(rec["arch"], rec["shape"], rec["mesh"])
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def save_op_log(out_dir: str, name: str, counter: StepCounter) -> None:
    """The op log as ``<out_dir>/ops/<name>.ops.json.gz`` (off under
    ``REPRO_SAVE_HLO=0``, as the reference's HLO)."""
    if os.environ.get("REPRO_SAVE_HLO", "1") != "1":
        return
    os.makedirs(os.path.join(out_dir, "ops"), exist_ok=True)
    with gzip.open(os.path.join(out_dir, "ops", name + ".ops.json.gz"),
                   "wt") as f:
        json.dump({"cost": counter.analyze(), "ops": counter.op_log()}, f)


def _print_roofline(rec: dict, roof: rl.Roofline) -> None:
    print(f"== {rec['arch']} × {rec['shape']} × {rec['mesh']} ==")
    print("memory_stats:", roof.memory_stats)
    print("cost: flops/device={:.3e} bytes/device={:.3e}".format(
        roof.flops_per_device, roof.bytes_per_device))
    print("collectives:", json.dumps(roof.collectives))
    print("roofline terms (s): compute={:.4g} memory={:.4g} "
          "collective={:.4g} dominant={}".format(
              roof.compute_s, roof.memory_s, roof.collective_s,
              roof.dominant))


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------


def dryrun_cell(arch: str, shape_name: str, mesh: str = "host",
                out_dir: str = "results/dryrun_torch", verbose: bool = True,
                overrides: dict = None, device: str = "meta"):
    label = mesh_label(mesh)
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": label,
               "status": "skipped", "reason": SKIP_REASON}
        _write(out_dir, rec)
        return rec

    with production_mesh(mesh) as dmesh:
        run = count_cell(cfg, shape, device=device, op_log=True, mesh=dmesh)
    counter = run["counter"]
    save_op_log(out_dir, _cell_name(arch, shape_name, label), counter)
    roof = rl.analyze(counter.analyze(), run["memory_stats"])
    mf = rl.model_flops(cfg, shape)
    chips = CHIPS[mesh]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": label,
        "status": "ok", "chips": chips, "device": str(device),
        "lower_s": round(run["seconds"], 1), "compile_s": 0,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops_total": mf,
        "model_flops_per_chip": mf / chips,
        "roofline": roof.to_dict(),
        "useful_flops_ratio": (mf / chips) / max(roof.flops_per_device, 1.0),
        "kernel_calls": dict(counter.kernel_calls),
    }
    if verbose:
        _print_roofline(rec, roof)
        print("MODEL_FLOPS/counted flops per chip: {:.3f}".format(
            rec["useful_flops_ratio"]))
    _write(out_dir, rec)
    return rec


# ---------------------------------------------------------------------------
# lmsfc-serve: one Count batch of the paper's query engine
# ---------------------------------------------------------------------------


def serving_arrays(n_pages: int, cap: int, d: int, device="meta",
                   seed: int = 0):
    """`ServingArrays` of `n_pages` pages of `cap` points: empty on meta,
    else seeded (uniform coordinates, pages full, z and MBR bounds drawn
    at random: enough to count a batch, not an index)."""
    from ..core.serve import ServingArrays
    dev = torch.device(device)
    shapes = {"points": (n_pages, d, cap), "page_zmin": (n_pages, 2),
              "page_zmax": (n_pages, 2), "page_mbr": (n_pages, d, 2),
              "page_size": (n_pages,)}
    if dev.type == "meta":
        return ServingArrays(**{k: torch.empty(s, dtype=torch.int32,
                                               device=dev)
                                for k, s in shapes.items()})
    gen = torch.Generator(device="cpu").manual_seed(seed)
    arrays = {k: torch.randint(-2**31, 2**31 - 1, s, generator=gen,
                               dtype=torch.int32)
              for k, s in shapes.items()}
    arrays["page_size"].fill_(cap)
    return ServingArrays(**{k: v.to(dev) for k, v in arrays.items()})


def query_rects(q_batch: int, d: int, device="meta", seed: int = 0):
    """(q_batch, d, 2) int32 query rectangles (empty on meta)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty((q_batch, d, 2), dtype=torch.int32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lo = torch.randint(0, 2**30, (q_batch, d), generator=gen)
    hi = lo + torch.randint(0, 2**30, (q_batch, d), generator=gen)
    return torch.stack([lo, hi], -1).to(torch.int32).to(dev)


def _count_serve(fn, arrays, queries, dmesh):
    """`count_step` of the query fn; on a mesh, with the final reduction
    of the int32 counts over every chip."""
    if dmesh is None:
        return count_step(fn, arrays, queries, op_log=True)
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    def reduce(t):
        red = fc.all_reduce(t, "sum", dist.group.WORLD)
        return red.wait() if isinstance(red, fc.AsyncCollectiveTensor) \
            else red

    def fn_and_reduce(arrays, queries):
        out = fn(arrays, queries)       # the counts, and the overflow counts
        return tuple(map(reduce, out)) if isinstance(out, tuple) \
            else reduce(out)
    return count_step(fn_and_reduce, arrays, queries, op_log=True)


def dryrun_lmsfc_serve(mesh: str = "host",
                       out_dir: str = "results/dryrun_torch",
                       n_pages: int = None, cap: int = 1024,
                       d: int = 2, q_batch: int = 1024, max_cand: int = 64,
                       q_chunk: int = 16, k_maxsplit: int = 4,
                       device: str = "meta", verbose: bool = True):
    """Count one Count batch of `core.serve.make_query_fn` on one chip's
    share of the reference's cell (`n_pages` pages a chip; by default
    2^22 pages over the 256 chips of a pod, 16,384 pages of 1,024 points,
    16.8M points, 134 MB of coordinates, or over the 512 of ``multipod``),
    queries replicated, under the z-order curve.  On ``pod`` /
    ``multipod`` it adds the final reduction, the int32 counts (and
    overflow counts) summed over every chip of the mesh."""
    from ..core.curve import as_curve
    from ..core.serve import make_query_fn
    from ..core.theta import default_K, zorder

    label = mesh_label(mesh)
    chips = CHIPS[mesh]
    if n_pages is None:
        n_pages = 2**22 // max(chips, 256)
    curve = as_curve(zorder(d, default_K(d)))
    fn = make_query_fn(curve, k_maxsplit=k_maxsplit, max_cand=max_cand,
                       q_chunk=q_chunk, backend="cuda")
    arrays = serving_arrays(n_pages, cap, d, device)
    queries = query_rects(q_batch, d, device)
    arg_bytes = tensor_bytes((dataclasses.astuple(arrays), queries))
    t0 = time.perf_counter()
    with production_mesh(mesh) as dmesh:
        out, counter = _count_serve(fn, arrays, queries, dmesh)
    seconds = time.perf_counter() - t0
    shape = f"q{q_batch}_p{n_pages}_c{max_cand}_k{k_maxsplit}"
    save_op_log(out_dir, _cell_name("lmsfc-serve", shape, label), counter)
    roof = rl.analyze(counter.analyze(), {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": tensor_bytes(out),
        "temp_size_in_bytes": counter.peak_bytes})
    rec = {"arch": "lmsfc-serve", "shape": shape, "mesh": label,
           "status": "ok", "chips": chips, "device": str(device),
           "lower_s": round(seconds, 1), "compile_s": 0,
           "roofline": roof.to_dict(),
           "global_points": n_pages * cap * chips,
           "model_flops_total": 0, "model_flops_per_chip": 0,
           "useful_flops_ratio": 0,
           "kernel_calls": dict(counter.kernel_calls)}
    if verbose:
        _print_roofline(rec, roof)
    _write(out_dir, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="host", choices=sorted(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default="meta",
                    help="meta (shapes only, the default) or cuda")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ArchConfig field overrides (for "
                         "lmsfc-serve: dryrun_lmsfc_serve's knobs)")
    args = ap.parse_args(argv)
    mesh_label(args.mesh)
    overrides = json.loads(args.overrides) if args.overrides else None

    if args.arch == "lmsfc-serve" and not args.all:
        dryrun_lmsfc_serve(args.mesh, out_dir=args.out, device=args.device,
                           **(overrides or {}))
        print("dry-run complete")
        return
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        cells = [(args.arch, args.shape)]
    failures = []
    for a, s in cells:
        try:
            dryrun_cell(a, s, args.mesh, out_dir=args.out,
                        overrides=overrides, device=args.device)
        except Exception as e:
            traceback.print_exc()
            failures.append((a, s, str(e)[:200]))
            _write(args.out, {"arch": a, "shape": s,
                              "mesh": MESHES[args.mesh], "status": "failed",
                              "error": str(e)[:500]})
    if args.all:
        dryrun_lmsfc_serve(args.mesh, out_dir=args.out, device=args.device)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
