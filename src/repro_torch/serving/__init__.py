"""repro_torch.serving — the async serving front with SLO-driven adaptive
batching, admission control, and a multi-client load harness.

The layer between many concurrent clients and the execution stack
(`repro_torch.api.exec`):

  `AsyncServer` / `ServerTicket` — thread-safe non-blocking
      `submit(query)` returning futures; a background drain loop
      coalesces pending submissions into engine super-batches through
      the Session/Executor path (served results stay bit-identical to
      serial execution, auditable via `query_log()` + `replay_serial`).
  `SLOConfig` / `AdaptiveController` — the serving contract (p99
      target, bounded queue, overload policy, per-kind weights) and the
      AIMD controller that trades coalescing-window fill against
      observed p99.
  `WeightedFairQueue` / `ServerOverloaded` — per-kind bounded FIFOs
      with stride-scheduled fair dequeue; the shed signal of the
      'reject' overload policy.
  `LoadSpec` / `make_query_log` / `run_open_loop` / `sweep` — the
      open-loop load harness: Poisson arrivals, Zipfian spatial skew,
      hundreds of interleaved clients, p50/p99-vs-sustained-q/s curves.

Entry point: ``db.serve(slo=..., engine=...)`` or
``router.serve(slo=..., engine=...)``.
`ServingTimeout` (a `TimeoutError`) is shared with `Session.Ticket`.
"""
from ..api.exec.session import ServingTimeout
from .loadgen import (Arrival, LoadSpec, make_query_log, quantiles_ms,
                      run_open_loop, sweep)
from .server import (AsyncServer, RESULT_FIELDS, ServerTicket,
                     assert_bit_identical, replay_serial)
from .slo import (AdaptiveController, DEFAULT_WEIGHTS, ServerOverloaded,
                  SLOConfig, WeightedFairQueue)

__all__ = [
    "AsyncServer", "ServerTicket", "ServingTimeout",
    "SLOConfig", "AdaptiveController", "WeightedFairQueue",
    "ServerOverloaded", "DEFAULT_WEIGHTS",
    "LoadSpec", "Arrival", "make_query_log", "run_open_loop", "sweep",
    "quantiles_ms", "replay_serial", "assert_bit_identical",
    "RESULT_FIELDS",
]
