"""Training entry point.

    python -m repro_torch.launch.train --arch qwen3-4b --steps 100 \
        [--reduced | --full] [--ckpt-dir ckpts] [--resume] [--device cpu]

Runs on one device: CUDA unless ``--device`` names another.  Features
exercised: microbatch accumulation, AdamW, the LMSFC-indexed curriculum
pipeline, checkpoint/restart and FT supervisor heartbeats.

Under ``torchrun --nproc-per-node N`` with ``--data D --model M`` (D·M =
N) every rank joins the launcher's process group (NCCL on cards, gloo with
``--device cpu``) and trains sharded over a (D, M) `DeviceMesh`: params
and optimizer state are DTensors under the reference's specs, every rank
draws the same batches and keeps its rows, rank 0 logs and writes the
checkpoints (whole arrays, the same files), and ``--resume`` restores them
onto the mesh, whatever its shape when they were written.

Checkpoints are the reference's: params under ``--ckpt-dir``, the
optimizer state under ``<ckpt-dir>/opt``, the pipeline state in both
manifests as ``pipeline``.  The manifests also carry the batcher's random
generator state (``pipeline_rng``), which the reference does not save, so
that a resumed run draws the batches the uninterrupted run drew; a
checkpoint without it resumes with a fresh generator, as the reference
does.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs.base import ShapeConfig
from ..configs.registry import get_arch, reduced_config
from ..data.pipeline import (CurriculumPhase, IndexedDataset, TokenBatcher,
                             synth_corpus)
from ..models.transformer import init_model
from ..obs import log as obs_log
from ..optim.adamw import AdamWConfig, init_opt_state
from ..train.steps import make_train_step, shard_params
from .ft import Supervisor
from .mesh import init_group, is_device_mesh, make_host_mesh

logger = obs_log.get_logger("launch.train")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Runs the training; returns each step's metrics as floats
    (``step``, ``loss``, ``grad_norm``, ``lr``, ``moe_drop_frac``,
    ``seconds``)."""
    obs_log.configure()     # stdout, "%(message)s": byte-identical to print
    args = parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.data * args.model > 1 and not dist.is_initialized():
        init_group(args.device)
    mesh = make_host_mesh(args.data, args.model, device=args.device)
    sharded = is_device_mesh(mesh)
    if sharded:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        if dist.get_rank() != 0:
            obs_log.get_logger("launch.train").setLevel("WARNING")
    else:
        dev = mesh.device
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    step_fn = make_train_step(cfg, shape, AdamWConfig(lr=1e-3,
                                                      warmup_steps=10),
                              device=dev, mesh=mesh if sharded else None)

    params = init_model(cfg, seed=0, device=dev)
    shardings = (None, None)
    if sharded:
        shardings = step_fn.in_shardings[:2]
        params = shard_params(params, shardings[0])
    opt = init_opt_state(params)

    # --- LMSFC-indexed curriculum pipeline -------------------------------
    docs, meta = synth_corpus(4000, cfg.vocab, args.seq, seed=0)
    ds = IndexedDataset(docs, meta, seed=0, device=dev)
    phases = [
        CurriculumPhase("clean-short", (0.0, 0.0, 0.6, 0.0),
                        (0.5, 1.0, 1.0, 1.0), steps=args.steps // 2),
        CurriculumPhase("all", (0.0, 0.0, 0.0, 0.0),
                        (1.0, 1.0, 1.0, 1.0), steps=(args.steps + 1) // 2),
    ]
    batcher = TokenBatcher(ds, phases, args.batch, args.seq, seed=1)

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        params, _ = restore_checkpoint(args.ckpt_dir, start, params,
                                       None if sharded else dev,
                                       shardings=shardings[0])
        opt, manifest = restore_checkpoint(args.ckpt_dir + "/opt", start,
                                           opt, None if sharded else dev,
                                           shardings=shardings[1])
        if "pipeline" in manifest:
            batcher.set_state(manifest["pipeline"])
        if "pipeline_rng" in manifest:
            batcher.rng.bit_generator.state = manifest["pipeline_rng"]
        logger.info("resumed from step %d", start)

    sup = Supervisor(n_workers=1)
    it = iter(batcher)
    history = []
    t_start = time.time()
    for step in range(start, args.steps):
        try:
            batch_np, pipe_state = next(it)
        except StopIteration:
            break
        batch = {"tokens": torch.from_numpy(batch_np["tokens"]).to(dev)}
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, batch)
        vals = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        sup.heartbeat(0, dt)
        sup.check()
        history.append({"step": step, **vals, "seconds": dt})
        logger.info("step %d: loss=%.4f gnorm=%.3f %.0fms",
                    step, vals["loss"], vals["grad_norm"], dt * 1e3)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            meta_ = {"pipeline": pipe_state,
                     "pipeline_rng": batcher.rng.bit_generator.state}
            save_checkpoint(args.ckpt_dir, step + 1, params,
                            extra_meta=meta_)
            save_checkpoint(args.ckpt_dir + "/opt", step + 1, opt,
                            extra_meta=meta_)
    logger.info("done: %d steps in %.1fs",
                args.steps - start, time.time() - t_start)
    return history


if __name__ == "__main__":
    main()
