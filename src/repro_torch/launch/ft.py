"""Fault-tolerance supervisor: per-step deadlines, EWMA straggler detection,
checkpoint-restore elastic downsizing.

On a real cluster every host runs this wrapper around the same SPMD program
(torch.distributed); here the coordinator logic is exercised against simulated
worker heartbeats so the policy itself is tested.  Policy:

  * heartbeat: every worker reports step completion times.
  * straggler: worker whose EWMA step time exceeds median·straggler_factor
    for `patience` consecutive steps -> marked slow.
  * hard failure: missed deadline (no heartbeat within `deadline_s`).
  * response: (1) checkpoint at the last synced step is the restore point,
    (2) the mesh is rebuilt without the failed/slow hosts (data axis
    shrinks to the largest divisor <= healthy count), (3) restore onto the
    new mesh via ckpt/checkpoint.restore_checkpoint with new shardings.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class WorkerState:
    ewma: float = 0.0
    slow_count: int = 0
    last_beat: float = 0.0
    healthy: bool = True


@dataclasses.dataclass
class FTConfig:
    straggler_factor: float = 2.0
    patience: int = 3
    deadline_s: float = 300.0
    ewma_alpha: float = 0.3


class Supervisor:
    def __init__(self, n_workers: int, cfg: FTConfig = None):
        self.cfg = cfg or FTConfig()
        self.workers = {i: WorkerState(last_beat=time.monotonic())
                        for i in range(n_workers)}
        self.events = []

    def heartbeat(self, worker: int, step_time: float,
                  now: float = None) -> None:
        w = self.workers[worker]
        a = self.cfg.ewma_alpha
        w.ewma = step_time if w.ewma == 0 else a * step_time + (1 - a) * w.ewma
        w.last_beat = now if now is not None else time.monotonic()

    def _median_ewma(self):
        vals = sorted(w.ewma for w in self.workers.values()
                      if w.healthy and w.ewma > 0)
        return vals[len(vals) // 2] if vals else 0.0

    def check(self, now: float = None):
        """Returns list of (worker, reason) newly-unhealthy workers."""
        now = now if now is not None else time.monotonic()
        med = self._median_ewma()
        out = []
        for i, w in self.workers.items():
            if not w.healthy:
                continue
            if now - w.last_beat > self.cfg.deadline_s:
                w.healthy = False
                out.append((i, "deadline"))
                continue
            if med > 0 and w.ewma > self.cfg.straggler_factor * med:
                w.slow_count += 1
                if w.slow_count >= self.cfg.patience:
                    w.healthy = False
                    out.append((i, "straggler"))
            else:
                w.slow_count = 0
        self.events.extend(out)
        return out

    def healthy_count(self) -> int:
        return sum(w.healthy for w in self.workers.values())

    def elastic_data_axis(self, model_size: int, chips_per_host: int = 4):
        """Largest power-of-two data-axis size that the healthy hosts can
        support with the fixed model axis."""
        chips = self.healthy_count() * chips_per_host
        data = max(1, chips // model_size)
        p = 1
        while p * 2 <= data:
            p *= 2
        return p
