"""Deprecated shim: block-RLE tile primitives live in ``repro_torch.storage``.

Tile classification is owned by the storage engine
(:mod:`repro_torch.storage.tiles` for the raw primitives,
:class:`repro_torch.storage.TileStore` for the index-native layout).
Import from ``repro_torch.storage``; this module re-exports for
compatibility with the reference's ``core.blockrle`` only.
"""
from __future__ import annotations

from repro_torch.storage.tiles import (  # noqa: F401
    BlockStats,
    classify_tiles,
    rbmrg_block_threshold,
    runcount,
)

__all__ = ["BlockStats", "classify_tiles", "rbmrg_block_threshold", "runcount"]
