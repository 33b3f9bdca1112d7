"""`repro_torch.dist`: the sharding context, gradient compression, the
pipeline, and the row-sharded query engine (the port of ``repro.dist``).

``context`` carries the active :class:`ShardingRules` so model code can
express sharding with *logical* axis names (``batch``, ``heads``...) and run
unchanged both unsharded (unit tests) and over a ``DeviceMesh`` (DTensor
parameters; train, the mesh branches of ``models/layers.py``).
``compression`` implements the int8 ring all-reduce with error feedback;
``pipeline`` the microbatch pipeline schedule over a mesh axis; ``query``
partitions a ``BitmapIndex``'s row space into row-range shards with
per-shard query planning (``BitmapIndex.shard(n_shards, devices)`` is the
front door).
"""

from .compression import ErrorFeedback, collective_bytes_saved, dequantize_int8, quantize_int8
from .context import ShardingRules, axis_size, constrain, get_rules, use_rules
from .pipeline import pipeline_forward

# The sharded query engine's re-exports are lazy (PEP 562), as the
# reference's: model code imports repro_torch.dist.context at module level
# and must not drag the query/storage/planner stack in with it.
_QUERY_EXPORTS = (
    "ShardedBitmapIndex",
    "ShardedPlan",
    "ShardedResult",
    "ShardedTileStore",
    "shard_boundaries",
)

__all__ = ["ShardingRules", "axis_size", "constrain", "get_rules", "use_rules",
           "ErrorFeedback", "collective_bytes_saved", "dequantize_int8", "quantize_int8",
           "pipeline_forward", *_QUERY_EXPORTS]


def __getattr__(name):
    if name in _QUERY_EXPORTS:
        from . import query

        return getattr(query, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
