"""repro_torch.api — the port's public index-lifecycle API.

One object (`Database`) covers the paper's whole pipeline — SMBO curve
learning (a global θ or a BMTree-style `PiecewiseCurve`), index build,
window queries on any execution engine (CPU, the plain-torch 'torch'
engine, the 'cuda' engine on the hand-written kernels, the page-sharded
'distributed' engine over a mesh of devices, the 'store' engine over an
on-disk segment), LMSFCb delta updates, and LMSFCa rebuilds — with exact
counts by construction on every engine.  It mirrors `repro.api` of the
JAX package name for name.

Execution is first-class (`repro_torch.api.exec`): `db.explain(q)`
returns the structured `QueryPlan` (engine routing, shape buckets,
escalation ladder), the `Executor` runs plans through a bounded
shape-bucketed query-fn cache, `db.session()` micro-batches interleaved
multi-client submissions, and `Router` serves one logical dataset from N
shard Databases with exact scatter/merge.
"""
from ..core.curve import (GlobalTheta, MonotonicCurve, PiecewiseCurve,
                          as_curve, curve_from_json)
from .database import Database
from .deltas import DeltaStore, get_delta_store
from .engines import (BaseEngine, StaleServingError, engine_capabilities,
                      engine_names, make_engine, register_engine)
from .exec import (CacheStats, ExecAccounting, Executor, Planner, QueryPlan,
                   Router, RouterPlan, ServingTimeout, Session, ShardSpec,
                   Step, Ticket)
from .policy import FractionRebuildPolicy, NeverRebuild, RebuildPolicy
from .queries import Count, Knn, Point, Query, Range
from .result import (EngineConfig, KnnResult, PointResult, QueryResult,
                     RangeResult)

__all__ = [
    "Database", "DeltaStore", "get_delta_store",
    "MonotonicCurve", "GlobalTheta", "PiecewiseCurve", "as_curve",
    "curve_from_json",
    "BaseEngine", "StaleServingError", "engine_capabilities",
    "engine_names", "make_engine", "register_engine",
    "FractionRebuildPolicy", "NeverRebuild", "RebuildPolicy",
    "Query", "Count", "Range", "Point", "Knn",
    "EngineConfig", "QueryResult", "RangeResult", "PointResult",
    "KnnResult",
    "QueryPlan", "Planner", "Step", "ExecAccounting",
    "Executor", "CacheStats", "Router", "RouterPlan", "ShardSpec",
    "Session", "ServingTimeout", "Ticket",
]
