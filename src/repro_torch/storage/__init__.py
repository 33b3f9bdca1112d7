"""`repro_torch.storage`: the tile-classified column store.

Ported so far: :class:`TileStore` (tile classification into all-zero /
all-one / dirty, container kinds, per-column and member-subset statistics,
the dense view on the device, the store-wide packs and their device
mirrors, the cell and event gathers), the container codecs, and the
tile-skipping executor :func:`run_tiled_circuit` (``tiled_fused``) with
its ``scan`` and ``merge`` engines, and the block-RLE primitives of
``storage/tiles.py`` (:class:`BlockStats`, :func:`classify_tiles`,
:func:`runcount`, the ``rbmrg_block`` pruner :func:`rbmrg_block_threshold`).
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
from .tiled import run_tiled_circuit
from .tiles import BlockStats, classify_tiles, rbmrg_block_threshold, runcount
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
    "run_tiled_circuit",
    "BlockStats",
    "classify_tiles",
    "rbmrg_block_threshold",
    "runcount",
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
