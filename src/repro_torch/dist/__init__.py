"""`repro_torch.dist`: the row-sharded query engine.

``query`` partitions a ``BitmapIndex``'s row space into row-range shards
with per-shard query planning (``BitmapIndex.shard(n_shards, devices)`` is
the front door).  The reference's model-side modules of ``repro.dist``
(sharding context, gradient compression, pipeline) are not ported here.
"""

from .query import (
    ShardedBitmapIndex,
    ShardedPlan,
    ShardedResult,
    ShardedTileStore,
    shard_boundaries,
)

__all__ = [
    "ShardedBitmapIndex",
    "ShardedPlan",
    "ShardedResult",
    "ShardedTileStore",
    "shard_boundaries",
]
