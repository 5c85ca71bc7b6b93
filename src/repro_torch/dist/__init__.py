"""Distributed execution of dynamic control flow (paper §2, §4.3):
logical-axis sharding rules on a ``DeviceMesh`` and the microbatch
pipeline that runs loop iterations concurrently across devices. Same
names and ``__all__`` as the JAX package's ``repro.dist``."""
from . import pipeline, sharding
from .pipeline import (distributed_while, make_pipelined_fn, pipeline_loop,
                       stage_count)
from .sharding import (ShardingRules, constrain, logical_to_sharding,
                       resolve_rules)

__all__ = [
    "sharding", "pipeline",
    "ShardingRules", "resolve_rules", "constrain", "logical_to_sharding",
    "pipeline_loop", "make_pipelined_fn", "distributed_while", "stage_count",
]
