"""`DeltaStore`: sparse per-column mutation buffers over one `TileStore`.

The base store is immutable (the property every stale ``BitmapIndex``
reference relies on), so mutations accumulate HERE: each touched tile is
buffered as its full patched words (base tile ⊕ the set/clear bits so
far).  Storing patched words rather than separate set/clear masks makes
the ordering semantics trivial -- a later ``clear`` of a bit a previous
``set`` turned on simply lands in the same buffered tile -- and makes the
overlay read path (``repro_torch.stream.overlay``) a pure array substitution:
patched tiles replace their base tiles in gathers, everything else reads
the base store untouched.

``append_rows`` extends the *row space* (the universe ``r``): appended
bits land in the base store's partial final tile and/or brand-new tiles,
which are just more buffered tiles -- tiles past the base store's range
read as all-zero, exactly what an un-appended column holds there.

A ``DeltaStore`` is deliberately shard-local, as in the reference: the
streaming engine keeps one per row shard of a sharded base.  Everything here is host numpy over
``uint32`` words: the device work of a mutation happens when a query or a
view refresh reads the overlay.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bitmaps import n_words_for
from repro_torch.storage import TileStore
from repro_torch.storage.tilestore import _popcount_words

__all__ = ["DeltaStore", "base_tile_batch"]


def base_tile_batch(base: TileStore, cols: np.ndarray, tiles: np.ndarray
                    ) -> np.ndarray:
    """Base-store words for (col, tile) cells, uint32[M, tile_words].

    THE one reconstruction of a tile's words (all-zero / all-one /
    container payload, all-zero past the base range) -- the delta's
    copy-on-write materialisation, the overlay's cardinality deltas and
    the view refresh gather all read through here.  Container-aware:
    sparse/run tiles decompress individually, never store-wide.
    """
    return base.gather_cells(np.asarray(cols, np.int64),
                             np.asarray(tiles, np.int64))


class DeltaStore:
    """Sparse tile-granular mutations overlaid on a base :class:`TileStore`."""

    def __init__(self, base: TileStore):
        self.base = base
        self.tile_words = base.tile_words
        self.span = base.tile_words * 32  # bits per tile
        self.n = base.n
        #: current universe size; grows with :meth:`append_rows`
        self.r = base.r
        #: column slot -> {tile index -> patched uint32[tile_words]}
        self._tiles: dict[int, dict[int, np.ndarray]] = {}

    # -- current geometry --------------------------------------------------
    @property
    def n_words(self) -> int:
        return n_words_for(self.r)

    @property
    def n_tiles(self) -> int:
        return (self.n_words + self.tile_words - 1) // self.tile_words

    @property
    def empty(self) -> bool:
        return not self._tiles and self.r == self.base.r

    @property
    def patched_tiles(self) -> int:
        """Distinct (column, tile) pairs buffered."""
        return sum(len(t) for t in self._tiles.values())

    @property
    def delta_words(self) -> int:
        """uint32 words buffered (the compaction-policy pressure metric)."""
        return self.patched_tiles * self.tile_words

    # -- tile access -------------------------------------------------------
    def base_tile(self, col: int, t: int) -> np.ndarray:
        """The base store's words for tile ``t`` (all-zero past its range)."""
        return base_tile_batch(self.base, [col], [t])[0]

    def tile(self, col: int, t: int) -> np.ndarray:
        """Current (base ⊕ delta) words of one tile -- NOT a live buffer."""
        got = self._tiles.get(col, {}).get(t)
        return got.copy() if got is not None else self.base_tile(col, t)

    def patch_tile(self, col: int, t: int, words: np.ndarray) -> int:
        """Replace one tile's words outright (the materialized-view refresh
        write path).  Returns the popcount delta vs the previous current
        words -- the per-tile increment that keeps view counts exact."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        if words.shape != (self.tile_words,):
            raise ValueError(f"expected uint32[{self.tile_words}], got {words.shape}")
        before = _popcount_words(self.tile(col, t))
        self._tiles.setdefault(col, {})[t] = words
        return _popcount_words(words) - before

    # -- mutations ---------------------------------------------------------
    def _positions(self, positions) -> np.ndarray:
        pos = np.atleast_1d(np.asarray(positions, dtype=np.int64))
        if pos.size and not ((0 <= pos) & (pos < self.r)).all():
            bad = pos[(pos < 0) | (pos >= self.r)][0]
            raise ValueError(f"bit position {bad} outside universe [0, {self.r})")
        return pos

    def set_bits(self, col: int, positions) -> list:
        """Set bits of one column; returns the touched tile indices."""
        return self._mutate(col, positions, set_=True)

    def clear_bits(self, col: int, positions) -> list:
        """Clear bits of one column; returns the touched tile indices."""
        return self._mutate(col, positions, set_=False)

    def _materialize_cells(self, cols: np.ndarray, tiles: np.ndarray) -> None:
        """Ensure every (col, tile) cell has a buffered patch target --
        missing cells' base words fetched in one vectorised pass."""
        missing = [
            (c, t)
            for c, t in zip(np.asarray(cols).tolist(), np.asarray(tiles).tolist())
            if t not in self._tiles.get(c, ())
        ]
        if not missing:
            return
        arr = base_tile_batch(
            self.base, [c for c, _ in missing], [t for _, t in missing]
        )
        for i, (c, t) in enumerate(missing):
            self._tiles.setdefault(c, {})[t] = arr[i]  # disjoint row views

    def _mutate(self, col: int, positions, *, set_: bool) -> list:
        if not 0 <= col < self.n:
            raise ValueError(f"column slot {col} outside [0, {self.n})")
        pos = self._positions(positions)
        if pos.size == 0:
            return []
        tiles = pos // self.span
        uniq = np.unique(tiles)
        self._materialize_cells(np.full(uniq.size, col, np.int64), uniq)
        tmap = self._tiles[col]
        # one vectorised bit apply across every touched tile: fold the
        # per-position bit masks into one OR-mask per touched word
        # (reduceat over the sorted flat word index -- ufunc.at is an
        # order of magnitude slower on large batches), then apply
        stacked = np.stack([tmap[t] for t in uniq.tolist()])
        rows = np.searchsorted(uniq, tiles)
        local = pos - tiles * self.span
        flat = rows * self.tile_words + (local // 32)
        b = np.uint32(1) << (local % 32).astype(np.uint32)
        order = np.argsort(flat, kind="stable")
        flat_w, start = np.unique(flat[order], return_index=True)
        masks = np.bitwise_or.reduceat(b[order], start)
        view = stacked.reshape(-1)
        if set_:
            view[flat_w] |= masks
        else:
            view[flat_w] &= ~masks
        for i, t in enumerate(uniq.tolist()):
            tmap[t] = stacked[i]
        return [int(t) for t in uniq.tolist()]

    _KEY_SHIFT = 40  # (col << 40) | tile packs a (col, tile) cell id

    def apply_batch(self, cols, pos, on) -> dict:
        """Apply a batch of single-bit updates across MANY columns in one
        vectorised pass: ``on[i]`` sets bit ``pos[i]`` of column
        ``cols[i]``, else clears it.  Set masks apply before clear masks
        (the documented ``update(sets=..., clears=...)`` semantics).
        Returns {column -> sorted touched tile list}.

        One lexsort of the batch replaces the per-column ``_mutate``
        pipeline -- the serving engine's step batches and the benchmark's
        update streams spend their time here.
        """
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        pos = self._positions(pos)
        on = np.atleast_1d(np.asarray(on, dtype=bool))
        if not (cols.size == pos.size == on.size):
            raise ValueError("cols/pos/on must align")
        if cols.size == 0:
            return {}
        if not ((0 <= cols) & (cols < self.n)).all():
            raise ValueError(f"column slot outside [0, {self.n})")
        tiles = pos // self.span
        key = (cols << self._KEY_SHIFT) | tiles
        uniq = np.unique(key)
        ucols = (uniq >> self._KEY_SHIFT).astype(np.int64)
        utiles = (uniq & ((1 << self._KEY_SHIFT) - 1)).astype(np.int64)
        touched: dict = {}
        self._materialize_cells(ucols, utiles)
        for c, t in zip(ucols.tolist(), utiles.tolist()):
            touched.setdefault(c, []).append(t)
        stacked = np.stack(
            [self._tiles[int(c)][int(t)] for c, t in zip(ucols, utiles)]
        )
        rows = np.searchsorted(uniq, key)
        local = pos - tiles * self.span
        flat = rows * self.tile_words + (local // 32)
        b = np.uint32(1) << (local % 32).astype(np.uint32)
        view = stacked.reshape(-1)
        for mask_sel, set_ in ((on, True), (~on, False)):
            if not mask_sel.any():
                continue
            f = flat[mask_sel]
            bb = b[mask_sel]
            order = np.argsort(f, kind="stable")
            fw, start = np.unique(f[order], return_index=True)
            masks = np.bitwise_or.reduceat(bb[order], start)
            if set_:
                view[fw] |= masks
            else:
                view[fw] &= ~masks
        for i, (c, t) in enumerate(zip(ucols.tolist(), utiles.tolist())):
            self._tiles[c][t] = stacked[i]
        return touched

    def append_rows(self, bits: np.ndarray) -> list:
        """Grow the universe by ``bits.shape[1]`` positions (dense bool
        ``[n, k]``, one row per column).  Returns every tile index
        overlapping the appended range -- they all changed for every
        column's consumers, even where the new bits are zero."""
        bits = np.asarray(bits)
        if bits.ndim != 2 or bits.shape[0] != self.n:
            raise ValueError(f"expected bool[{self.n}, k], got shape {bits.shape}")
        k = bits.shape[1]
        if k == 0:
            return []
        old_r = self.r
        self.r = old_r + k
        for col in range(self.n):
            on = np.nonzero(bits[col])[0]
            if on.size:
                self._mutate(col, old_r + on, set_=True)
        t0, t1 = old_r // self.span, (self.r - 1) // self.span
        return list(range(int(t0), int(t1) + 1))

    # -- aggregate views ---------------------------------------------------
    def updates(self) -> dict:
        """The buffered tiles as ``TileStore.apply_tile_updates`` input."""
        return {c: dict(t) for c, t in self._tiles.items() if t}

    def card_delta(self, col: int) -> int:
        """Column cardinality change vs the base store."""
        tmap = self._tiles.get(col)
        if not tmap:
            return 0
        return sum(
            _popcount_words(w) - _popcount_words(self.base_tile(col, t))
            for t, w in tmap.items()
        )

    def snapshot(self) -> dict:
        """Immutable view of the buffered tiles: {col: {tile: words}}.
        Mutations never write into captured word arrays (every batch
        stacks-copies and rebinds), so shallow dict copies freeze the
        state -- what :class:`~repro_torch.stream.overlay.OverlayStore` reads."""
        return {c: dict(t) for c, t in self._tiles.items() if t}
