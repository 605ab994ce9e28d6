"""Distribution layer: sharding rules.

``sharding`` — logical-axis -> partition spec (`sharding.P`) mapping for
               every model family; the `Router` partitions rows with its
               batch-axis rule.
"""
from . import sharding
from .sharding import ShardingRules

__all__ = ["ShardingRules", "sharding"]
