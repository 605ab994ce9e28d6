"""repro_torch.api.exec — the execution layer between the typed query
algebra and the engines: first-class plans, a shape-bucketed executor and
the Session micro-batcher.  (The reference's multi-shard `Router` comes
with the multi-device slice, ROADMAP Queue 1 item 7.)

  `QueryPlan` / `Planner` — every dispatch decision (engine routing,
      padded shapes, candidate/hit budgets, the escalation ladder) as an
      inspectable object; `Database.explain(q)` returns one.
  `Executor` / `CacheStats` — plan execution with a bounded,
      shape-bucketed query-fn cache shared across engines.
  `Session` / `Ticket` — micro-batching: interleaved multi-client
      submissions coalesced into engine-shaped super-batches,
      demultiplexed deterministically in submission order.
"""
from .executor import CacheStats, Executor
from .plan import ExecAccounting, Planner, QueryPlan, Step
from .session import ServingTimeout, Session, Ticket

__all__ = [
    "CacheStats", "Executor",
    "ExecAccounting", "Planner", "QueryPlan", "Step",
    "ServingTimeout", "Session", "Ticket",
]
