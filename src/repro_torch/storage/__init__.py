"""`repro_torch.storage`: the tile-classified column store.

Ported so far: :class:`TileStore`'s build and statistics half (tile
classification into all-zero / all-one / dirty, container kinds,
per-column and member-subset statistics, the dense view on the device) and
the container codecs it needs.  The tile-skipping executor
(``tiled_fused``) and the block-RLE primitives are not ported yet.
"""

from .containers import (
    CONT_DENSE,
    CONT_NONE,
    CONT_RUN,
    CONT_SPARSE,
    CONTAINER_CROSSOVER,
    run_max_intervals,
    sparse_max_positions,
)
from .tilestore import (
    TILE_DIRTY,
    TILE_ONE,
    TILE_RUN,
    TILE_ZERO,
    ColumnStats,
    MemberStats,
    TileStore,
)

__all__ = [
    "TileStore",
    "ColumnStats",
    "MemberStats",
    "TILE_ZERO",
    "TILE_ONE",
    "TILE_DIRTY",
    "TILE_RUN",
    "CONT_NONE",
    "CONT_DENSE",
    "CONT_SPARSE",
    "CONT_RUN",
    "CONTAINER_CROSSOVER",
    "sparse_max_positions",
    "run_max_intervals",
]
