"""Query-cost proxy used as the SMBO objective (DESIGN.md §4).

The paper optimizes measured QueryTime (Eq. 2).  On this hardware-neutral
substrate we replace it with its dominant mechanical terms, evaluated by
actually building a (sampled) index and running the (sampled) workload:

    cost = Σ_q  c_page·pages(q) + c_scan·scanned(q) + c_idx·index_accesses(q)

c_page=1.0, c_scan=0.02, c_idx=0.1: one 8KB page access ≈ 50 point
inspections ≈ 10 learned-index probes.  Deterministic and noise-free, which
also removes the finite-sample evaluation noise the paper mentions.

Three evaluators produce bit-identical costs:
  'pooled'  — the whole candidate pool as one device program
              (core/batcheval.py run_workload_pool); the SMBO default
  'batched' — whole-workload numpy per candidate (core/batcheval.py)
  'legacy'  — the faithful per-query loop (core/query.py run_workload)

Every path returns the same integer `QueryStats` and combines them with the
same host-float expression below, so cost equality holds to the last ulp.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.sfc_encode.ops import sfc_encode_pool
from .batcheval import run_workload_batched, run_workload_pool
from .curve import as_curve, device_curve_pool
from .device import resolve_device
from .index import IndexConfig, LMSFCIndex
from .query import run_workload
from .zorder64 import z64_to_u64

C_PAGE = 1.0
C_SCAN = 0.02
C_IDX = 0.1

_EVALUATORS = {"legacy": run_workload, "batched": run_workload_batched}
POOL_ENGINES = ("auto", "torch", "np")


@dataclasses.dataclass
class CostBreakdown:
    pages: float
    scanned: float
    index_accesses: float

    @property
    def total(self) -> float:
        return C_PAGE * self.pages + C_SCAN * self.scanned + C_IDX * self.index_accesses


def workload_cost(index: LMSFCIndex, Ls: np.ndarray, Us: np.ndarray,
                  evaluator: str = "batched") -> CostBreakdown:
    if evaluator not in _EVALUATORS:
        raise ValueError(f"unknown evaluator {evaluator!r}; "
                         f"expected one of {sorted(_EVALUATORS)}")
    _, agg = _EVALUATORS[evaluator](index, Ls, Us)
    nq = max(1, len(Ls))
    return CostBreakdown(pages=agg.pages_accessed / nq,
                         scanned=agg.points_scanned / nq,
                         index_accesses=agg.index_accesses / nq)


def evaluate_curve(curve, data: np.ndarray, Ls: np.ndarray,
                   Us: np.ndarray, cfg: IndexConfig = None, K: int = None,
                   evaluator: str = "batched") -> float:
    """Build a (mini) index under the curve and return the scalar workload
    cost on the host.  This is the paper's BatchEval unit (Algorithm 1,
    line 4); accepts any `MonotonicCurve` or a legacy `Theta`."""
    cfg = cfg or IndexConfig(paging="heuristic")
    idx = LMSFCIndex.build(data, curve=as_curve(curve), cfg=cfg,
                           workload=(Ls, Us), K=K)
    return workload_cost(idx, Ls, Us, evaluator=evaluator).total


# legacy name (pre-curve call sites); same semantics, any curve accepted
evaluate_theta = evaluate_curve


def _stats_cost(agg, nq: int) -> float:
    """The one float combination shared by every evaluator path."""
    return CostBreakdown(pages=agg.pages_accessed / nq,
                         scanned=agg.points_scanned / nq,
                         index_accesses=agg.index_accesses / nq).total


def auto_engine(n_curves: int, n_queries: int, n_rows: int) -> str:
    """The pool engine ``engine="auto"`` takes: the device program when the
    pool and workload are big enough to amortize its launches, else the
    numpy loop."""
    return ("torch" if n_curves >= 4 and n_queries * n_rows >= 500_000
            else "np")


def pool_keys(curves, data: np.ndarray, device,
              backend: str = "cuda") -> np.ndarray:
    """Every curve's uint64 keys of `data`, (P, n): the data sample encoded
    under the whole pool in one `sfc_encode_pool` launch (shared points),
    where the per-candidate build would call `curve.encode_np(data)`.
    `curves`: a list of curves or a `CurvePool` (a `device_curve_pool`
    carries its lookup tables)."""
    x = np.ascontiguousarray(
        np.asarray(data, dtype=np.uint64).astype(np.uint32).view(np.int32))
    z = sfc_encode_pool(torch.from_numpy(x).to(device), curves,
                        backend=backend)
    return z64_to_u64(z.cpu().numpy())


def evaluate_pool(curves, data: np.ndarray, Ls: np.ndarray, Us: np.ndarray,
                  cfg: IndexConfig = None, K: int = None,
                  engine: str = "auto", *, device=None,
                  backend: str = "cuda") -> np.ndarray:
    """Costs for a whole candidate pool in one pass (Algorithm 1, line 4
    on the device): encode the data under every candidate (one pooled
    launch), build the per-candidate mini-indexes on the host, then
    evaluate all of them against the workload with `run_workload_pool`.

    Each returned cost is bit-identical to `evaluate_curve` on the same
    candidate: identical index build, identical integer stats, identical
    host float combination.  ``engine``: 'torch' (the device program),
    'np' (host numpy loop), or 'auto' (`auto_engine`).  `device` is CUDA
    unless the caller passes ``device="cpu"``; ``backend="torch"`` runs
    the encode kernel's plain twin instead of the kernel."""
    dev = resolve_device(device)
    if engine not in POOL_ENGINES:
        raise ValueError(f"unknown pool engine {engine!r}; "
                         f"expected one of {POOL_ENGINES}")
    curves = [as_curve(c) for c in curves]
    if not curves:
        return np.zeros(0, dtype=np.float64)
    cfg = cfg or IndexConfig(paging="heuristic")
    nq = len(np.atleast_2d(Ls))
    if engine == "auto":
        engine = auto_engine(len(curves), nq, len(data))
    pool, keys = None, [None] * len(curves)
    if engine == "torch":           # the round's lookup tables, built once
        pool = device_curve_pool(curves, dev)
        keys = pool_keys(pool, data, dev, backend)
    idxs = [LMSFCIndex.build(data, curve=c, cfg=cfg, workload=(Ls, Us), K=K,
                             z=z, device=dev) for c, z in zip(curves, keys)]
    results = run_workload_pool(idxs, Ls, Us, engine=engine, device=dev,
                                backend=backend, pool=pool)
    return np.array([_stats_cost(agg, max(1, nq)) for _, agg in results],
                    dtype=np.float64)
