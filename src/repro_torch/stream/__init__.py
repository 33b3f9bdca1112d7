"""`repro_torch.stream`: the streaming update engine.

Makes the bitmap index updatable without rebuilds and keeps registered
query results fresh incrementally:

  * :class:`DeltaStore` -- sparse per-column set/clear tile buffers plus
    row-space ``append_rows`` (host numpy), overlaid on an immutable base
    :class:`~repro_torch.storage.TileStore`;
  * :class:`~repro_torch.stream.overlay.OverlayStore` -- the
    TileStore-shaped read view every executor backend answers
    ``base ⊕ delta`` through (its dense view is patched on the device);
  * :class:`StreamingIndex` -- mutation API, planner-driven overlay
    queries, tile-granular compaction (:class:`CompactionPolicy`,
    ``TileStore.apply_tile_updates``), materialized views refreshed
    through the circuit kernel only over mutated tiles, and the durable
    checkpoint / WAL / recover path of :mod:`repro_torch.persist`.

A :class:`~repro_torch.dist.query.ShardedBitmapIndex` base keeps one delta
per row shard; refresh, compaction and checkpoints run per shard.
"""

from .delta import DeltaStore
from .index import CompactionPolicy, MaterializedView, StreamingIndex
from .overlay import OverlayStore

__all__ = [
    "DeltaStore",
    "OverlayStore",
    "StreamingIndex",
    "CompactionPolicy",
    "MaterializedView",
]
