"""`PagedTileStore`: a cold/warm-tier read view over a memmap-backed store.

A snapshot loaded with ``repro_torch.persist.snapshot.load`` keeps every
pack host-resident as ``np.memmap`` views -- the OS pages bytes in on
first touch.  But the executor's all-dense fast path ships the WHOLE
densified dirty pack to the device on first use (``TileStore.dirty``),
which defeats paging the moment one query runs.  ``PagedTileStore``
closes that hole:

  * it advertises ``paged = True``, which routes
    ``repro_torch.storage.tiled.run_tiled_circuit`` to the ``merge``
    engine and through the per-tile
    ``gather_cells`` / ``gather_events`` path even for all-dense stores
    -- only the tiles a query's plan actually touches are read off the
    mapping and shipped to the device, per launch;
  * materialized tile words are kept in a host-side LRU cache (capacity
    in tiles), so repeated queries over a working set stop re-reading /
    re-decompressing the file;
  * metadata (classes, kinds, stats, cardinalities) passes straight
    through -- it is tiny and already resident.

Dense-path backends still work (``densify()`` delegates) but count as
``full_materializations`` in :meth:`cache_info` -- if that number is
nonzero the index is too dense-hot for paging and should be loaded with
``to_device=True`` instead.  Plan with ``tiled_fused`` (the planner does
so on its own whenever tile-skipping pays) to stay on the paged path.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.obs import REGISTRY as _OBS

__all__ = ["PagedTileStore"]

# Page-cache accounting mirrored onto the process-wide registry (no-ops
# until ``repro_torch.obs.enable()``); the instance attributes below stay the
# exact-count source of truth for existing callers.
_PAGE_EVENTS = _OBS.counter(
    "repro_persist_page_events_total",
    "Paged tile-store cache events (hit / miss / eviction / densify)",
    ("event",),
)


class PagedTileStore:
    """LRU-paged read view satisfying the TileStore execution surface."""

    #: run_tiled_circuit checks this to avoid the whole-pack device path
    paged = True

    def __init__(self, base, *, capacity_tiles: int = 4096):
        self._base = base
        self._capacity = max(1, int(capacity_tiles))
        self._cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.full_materializations = 0

    # -- geometry / metadata passthrough -----------------------------------
    @property
    def device(self):
        """The base store's device: where gathered tiles and results go."""
        return self._base.device

    @property
    def n(self):
        return self._base.n

    @property
    def r(self):
        return self._base.r

    @property
    def n_words(self):
        return self._base.n_words

    @property
    def n_tiles(self):
        return self._base.n_tiles

    @property
    def tile_words(self):
        return self._base.tile_words

    @property
    def containers(self):
        return self._base.containers

    @property
    def classes_word(self):
        return self._base.classes_word

    @property
    def container_kinds(self):
        return self._base.container_kinds

    @property
    def storage_words_cell(self):
        return self._base.storage_words_cell

    @property
    def cardinalities(self):
        return self._base.cardinalities

    @property
    def densities(self):
        return self._base.densities

    @property
    def clean_fraction(self):
        return self._base.clean_fraction

    @property
    def dirty_words(self):
        return self._base.dirty_words

    def member_stats(self, slots=None):
        return self._base.member_stats(slots)

    def block_stats(self):
        return self._base.block_stats()

    # -- paged read path ---------------------------------------------------
    def gather_cells(self, cols, tiles) -> np.ndarray:
        """Tile materialisation through the LRU: cached (col, tile) cells
        are served from memory, misses read the mapping once and enter
        the cache."""
        cols = np.asarray(cols, np.int64)
        tiles = np.asarray(tiles, np.int64)
        out = np.empty((cols.size, self.tile_words), np.uint32)
        miss_rows = []
        evicted = 0
        for i, key in enumerate(zip(cols.tolist(), tiles.tolist())):
            got = self._cache.get(key)
            if got is not None:
                self._cache.move_to_end(key)
                out[i] = got
                self.hits += 1
            else:
                miss_rows.append(i)
                self.misses += 1
        if miss_rows:
            sel = np.asarray(miss_rows)
            fetched = self._base.gather_cells(cols[sel], tiles[sel])
            out[sel] = fetched
            for j, i in enumerate(miss_rows):
                key = (int(cols[i]), int(tiles[i]))
                self._cache[key] = fetched[j]
                if len(self._cache) > self._capacity:
                    self._cache.popitem(last=False)
                    self.evictions += 1
                    evicted += 1
        if _OBS.enabled:
            n_miss = len(miss_rows)
            if cols.size - n_miss:
                _PAGE_EVENTS.inc(cols.size - n_miss, event="hit")
            if n_miss:
                _PAGE_EVENTS.inc(n_miss, event="miss")
            if evicted:
                _PAGE_EVENTS.inc(evicted, event="eviction")
        return out

    def gather_events(self, cols, tiles):
        # event payloads ARE the compressed containers -- smaller than any
        # cached densification, so they read through uncached
        return self._base.gather_events(cols, tiles)

    # -- dense-path escape hatches (counted) -------------------------------
    def densify(self):
        self.full_materializations += 1
        _PAGE_EVENTS.inc(1, event="densify")
        return self._base.densify()

    def column(self, i: int):
        return self.densify()[int(i)]

    @property
    def dirty(self):
        self.full_materializations += 1
        return self._base.dirty

    @property
    def dirty_index(self):
        return self._base.dirty_index

    @property
    def _dirty_np(self):
        self.full_materializations += 1
        return self._base._dirty_np

    # -- accounting --------------------------------------------------------
    def cache_info(self) -> dict:
        return {
            "capacity_tiles": self._capacity,
            "cached_tiles": len(self._cache),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "full_materializations": self.full_materializations,
        }
