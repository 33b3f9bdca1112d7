"""`repro_torch.persist`: versioned on-disk index format, WAL + snapshot
recovery, and persisted planner calibration.

  * :mod:`~repro_torch.persist.format` -- the ``.bmsnap`` framing: header,
    checksummed raw sections, JSON manifest footer;
  * :mod:`~repro_torch.persist.snapshot` -- ``save``/``load`` of one
    TileStore / BitmapIndex with zero-copy ``np.memmap`` reconstruction;
  * :mod:`~repro_torch.persist.shards` -- one file per tile-range shard for
    ``ShardedBitmapIndex`` (each device loads only its own);
  * :mod:`~repro_torch.persist.wal` -- the ``.bmwal`` write-ahead log of
    streaming mutation batches (per-record CRC, monotone versions);
  * :mod:`~repro_torch.persist.tiers` -- ``PagedTileStore``, the
    host-resident read tier that gathers only plan-touched tiles;
  * :mod:`~repro_torch.persist.calibration` -- ``calibration.json``.

The ``.bmsnap``, ``sharded.json`` and ``.bmwal`` bytes are the reference's:
files written by either package load and replay in the other.  High-level
entry points live on the owning classes: ``BitmapIndex.save`` / ``.load``,
``ShardedBitmapIndex.save`` / ``.load``, and ``StreamingIndex.checkpoint``
/ ``.recover``.
"""
from .calibration import (
    CALIBRATION_FILE,
    ensure_calibration,
    load_calibration,
    save_calibration,
)
from .format import FormatError, read_manifest, schema_digest, verify_snapshot
from .shards import load_shard, load_sharded, read_shard_map, save_sharded
from .snapshot import load, load_index, save, snapshot_info
from .tiers import PagedTileStore
from .wal import WriteAheadLog, query_from_obj, query_to_obj

__all__ = [
    "CALIBRATION_FILE",
    "FormatError",
    "PagedTileStore",
    "WriteAheadLog",
    "ensure_calibration",
    "load_calibration",
    "save_calibration",
    "load",
    "load_index",
    "load_shard",
    "load_sharded",
    "query_from_obj",
    "query_to_obj",
    "read_manifest",
    "read_shard_map",
    "save",
    "save_sharded",
    "schema_digest",
    "snapshot_info",
    "verify_snapshot",
]
