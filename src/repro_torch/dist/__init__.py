"""Distribution layer: sharding rules, HLO analysis and the step counter,
roofline.

``sharding``     — logical-axis -> partition spec (`sharding.P`) mapping for
                   every model family; the `Router` partitions rows with its
                   batch-axis rule.
``hlo_analysis`` — the reference's loop-aware HLO text analyzer, and
                   `StepCounter`, which counts a port step's flops, bytes
                   and collectives as it runs (on ``meta`` or the card).
``roofline``     — MODEL_FLOPS accounting + compute/memory/wire time terms
                   at the H100's ceilings.
"""
from . import hlo_analysis, roofline, sharding
from .sharding import ShardingRules

__all__ = ["ShardingRules", "hlo_analysis", "roofline", "sharding"]
