"""repro_torch.api.exec — the execution layer between the typed query
algebra and the engines: first-class plans, a shape-bucketed executor,
the Session micro-batcher, and the multi-shard Router.

  `QueryPlan` / `Planner` — every dispatch decision (engine routing,
      padded shapes, candidate/hit budgets, the escalation ladder) as an
      inspectable object; `Database.explain(q)` returns one.
  `Executor` / `CacheStats` — plan execution with a bounded,
      shape-bucketed query-fn cache shared across engines.
  `Session` / `Ticket` — micro-batching: interleaved multi-client
      submissions coalesced into engine-shaped super-batches,
      demultiplexed deterministically in submission order.
  `Router` / `ShardSpec` / `RouterPlan` — one logical dataset served
      from N shard Databases (repro_torch.dist sharding rules partition
      the rows); scatter a plan, execute per shard, merge exactly.
"""
from .executor import CacheStats, Executor
from .plan import ExecAccounting, Planner, QueryPlan, Step
from .router import Router, RouterPlan, ShardSpec
from .session import ServingTimeout, Session, Ticket

__all__ = [
    "CacheStats", "Executor",
    "ExecAccounting", "Planner", "QueryPlan", "Step",
    "Router", "RouterPlan", "ShardSpec",
    "ServingTimeout", "Session", "Ticket",
]
