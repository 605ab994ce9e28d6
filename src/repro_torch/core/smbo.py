"""SMBO learning of the SFC parameter (paper §5.2, Algorithm 1), generic
over the curve family.

Surrogate = random forest (per the paper), acquisition = Expected
Improvement, candidates = local perturbations of the incumbent + uniform
random curves.  The search space is any registered `MonotonicCurve` family:
``space="global"`` searches the paper's single-θ family, and
``space="piecewise"`` searches BMTree-style quadtree curves with an
independent θ per region (`depth` levels).  The objective is the
deterministic scan-cost proxy of cost.py evaluated on (sampled) data +
(sampled) workload — the paper's BatchEval with QueryTime replaced per
DESIGN.md §4.

Evaluation runs on the device by default: every BatchEval round (the
initial design and each iteration's selected candidates) goes through
`cost.evaluate_pool`, which encodes the data under the whole round with one
`sfc_encode_pool` launch and runs the whole candidate set as one device
program (core/batcheval.py `run_workload_pool`).  All evaluator choices
produce bit-identical costs — 'pooled' / 'pooled-torch' / 'pooled-np'
(engine auto/forced), 'batched' (per-candidate numpy) and 'legacy' (the
per-query loop).

Determinism: one `np.random.Generator` seeded from `seed` drives candidate
generation, the surrogate's bootstrap/feature draws, and the acquisition
tie-break (a seeded permutation before a stable sort), so same-seed runs
return identical `SMBOResult`s.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import obs
from .cost import evaluate_curve, evaluate_pool
from .curve import MonotonicCurve, init_curves, random_curve
from .device import resolve_device
from .index import IndexConfig
from .surrogate import RandomForest

_SQRT2 = math.sqrt(2.0)
_SQRT2PI = math.sqrt(2.0 * math.pi)


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / _SQRT2))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / _SQRT2PI


def expected_improvement(mu, sigma, best):
    """EI for minimization (float64 numpy reference; the SMBO loop runs
    the float32 `_ei`)."""
    sigma = np.maximum(sigma, 1e-9)
    z = (best - mu) / sigma
    return (best - mu) * _norm_cdf(z) + sigma * _norm_pdf(z)


def _ei(mu, sigma, best) -> np.ndarray:
    """EI in float32, returned as float64: the twin of the reference's
    jitted EI, which runs with 64-bit floats off and so converts `mu`,
    `sigma` and `best` to float32 and computes every step in float32.
    Float64 here would break float32 ties that the reference keeps and so
    select other candidates.  It runs on the host: a pool is some 48 values,
    fewer than a device launch is worth."""
    f32 = torch.float32
    mu = torch.as_tensor(np.asarray(mu), dtype=f32)
    sigma = torch.as_tensor(np.asarray(sigma), dtype=f32)
    b = torch.tensor(best, dtype=f32)
    sigma = torch.maximum(sigma, torch.tensor(1e-9, dtype=f32))
    z = (b - mu) / sigma
    cdf = 0.5 * (1.0 + torch.special.erf(z / torch.tensor(_SQRT2, dtype=f32)))
    pdf = torch.exp(-0.5 * z * z) / torch.tensor(_SQRT2PI, dtype=f32)
    return ((b - mu) * cdf + sigma * pdf).numpy().astype(np.float64)


@dataclasses.dataclass
class SMBOResult:
    curve_best: MonotonicCurve
    y_best: float
    history: list          # (iteration, y_best)
    evaluated: list        # (curve, y)

    @property
    def theta_best(self) -> MonotonicCurve:
        """Legacy alias from the single-θ era; holds the best *curve*
        (accepted everywhere a θ used to be via `as_curve`)."""
        return self.curve_best


# evaluator name -> run_workload_pool engine for the pooled paths
_POOL_ENGINES = {"pooled": "auto", "pooled-torch": "torch", "pooled-np": "np"}


def learn_sfc(data: np.ndarray, Ls: np.ndarray, Us: np.ndarray, *,
              K: int, cfg: IndexConfig = None, space: str = "global",
              depth: int = 1, max_iters: int = 10, n_init: int = 8,
              pool_size: int = 48, evals_per_iter: int = 4, seed: int = 0,
              verbose: bool = False, evaluator: str = "pooled",
              device=None, backend: str = "cuda") -> SMBOResult:
    """Algorithm 1 over the chosen curve family.  data/workload should
    already be sampled by the caller (the paper defaults to 5% of the
    data); `depth` only applies to ``space="piecewise"``.

    `evaluator` picks the BatchEval path (all cost-identical):
    'pooled' (default; one device program per round, engine auto-selected),
    'pooled-torch' / 'pooled-np' (engine forced), 'batched' (per-candidate
    numpy), 'legacy' (per-query loop).  `device` is CUDA unless the caller
    passes ``device="cpu"`` (raises without a card); ``backend="torch"``
    runs the encode kernel's plain twin instead of the kernel."""
    if evaluator not in _POOL_ENGINES and evaluator not in ("legacy",
                                                            "batched"):
        raise ValueError(
            f"unknown evaluator {evaluator!r}; expected one of "
            f"{sorted(_POOL_ENGINES) + ['batched', 'legacy']}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = data.shape[1]
    cfg = cfg or IndexConfig(paging="heuristic")

    def evaluate_batch(cs: list) -> list:
        """Line 4 (BatchEval) for one candidate round."""
        with obs.span("smbo.pool_eval", candidates=len(cs),
                      evaluator=evaluator):
            if evaluator in _POOL_ENGINES:
                ys = evaluate_pool(cs, data, Ls, Us, cfg, K,
                                   engine=_POOL_ENGINES[evaluator],
                                   device=dev, backend=backend)
                return [float(v) for v in ys]
            return [evaluate_curve(c, data, Ls, Us, cfg, K,
                                   evaluator=evaluator) for c in cs]

    # --- line 1: initial design + surrogate ------------------------------
    init = init_curves(d, K, family=space, depth=depth)
    seen = set(init)
    while len(init) < n_init:
        c = random_curve(rng, d, K, family=space, depth=depth)
        if c not in seen:
            seen.add(c)
            init.append(c)

    with obs.span("smbo.init_design", space=space, n_init=len(init)):
        evaluated = list(zip(init, evaluate_batch(init)))
    if obs.enabled():
        obs.inc("smbo.evaluations", len(init), space=space)
    model = RandomForest(rng=rng)
    ybest_idx = int(np.argmin([y for _, y in evaluated]))
    curve_best, y_best = evaluated[ybest_idx]
    history = [(0, y_best)]

    for it in range(1, max_iters + 1):
        with obs.span("smbo.iteration", space=space, iteration=it):
            X = np.stack([c.features() for c, _ in evaluated])
            y = np.asarray([v for _, v in evaluated])
            model.fit(X, y)

            # --- line 3: SelectCands via EI over a perturbation pool -----
            pool = curve_best.neighbors(rng, n=pool_size // 2, max_swaps=3)
            pool += [random_curve(rng, d, K, family=space, depth=depth)
                     for _ in range(pool_size - len(pool))]
            pool = [c for c in pool if c not in seen] or pool
            Xp = np.stack([c.features() for c in pool])
            mu, sigma = model.predict(Xp)
            ei = _ei(mu, sigma, y_best)
            # seeded tie-break: shuffle, then stable-sort by EI descending —
            # equal-EI candidates come out in seeded-random (but
            # reproducible) order instead of pool-construction order
            perm = rng.permutation(len(pool))
            top = perm[np.argsort(-ei[perm], kind="stable")][:evals_per_iter]

            # --- line 4: BatchEval ---------------------------------------
            cands = [pool[int(j)] for j in top]
            seen.update(cands)
            for c, yv in zip(cands, evaluate_batch(cands)):
                evaluated.append((c, yv))
                if yv < y_best:
                    y_best, curve_best = yv, c
        if obs.enabled():
            obs.inc("smbo.evaluations", len(cands), space=space)
            obs.set_gauge("smbo.best_cost", float(y_best), space=space)
            obs.set_gauge("smbo.iteration", float(it), space=space)
        history.append((it, y_best))
        if verbose:
            print(f"[smbo] iter {it}: best cost {y_best:.3f}")

    return SMBOResult(curve_best=curve_best, y_best=y_best,
                      history=history, evaluated=evaluated)
