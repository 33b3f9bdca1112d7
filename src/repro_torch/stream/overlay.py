"""`OverlayStore`: a TileStore-shaped read view of ``base ⊕ delta``.

Every executor in ``repro_torch.query.executors`` reads a shard through a
``ShardContext`` whose data accessors come from a store: the tiled path
gathers cells guided by ``store.classes_word`` and the container surface,
the dense paths pull ``store.densify()``, and the planner prices both from
``store.member_stats``.  ``OverlayStore`` implements exactly that surface
over an immutable base :class:`~repro_torch.storage.TileStore` plus a
:class:`~repro_torch.stream.delta.DeltaStore` -- so a streaming index
answers EVERY backend bit-identically to a from-scratch rebuild, without
merging:

  * ``classes_word`` is the base classification with ONLY the patched
    tiles reclassified (a clean tile a delta bit landed in stops masking
    as a constant; a dirty tile cleared to all-zero starts to);
  * ``dirty`` is the base's densified dirty pack on the device with the
    patched tiles' words appended at the end; ``dirty_index`` redirects
    patched tiles there (both built on first use: the tiled route over
    containers never reads them);
  * ``densify()`` is built on the device: a clone of the base's resident
    dense view with every patched tile written by one indexed store of one
    ``int32[P, tile_words]`` upload (words past ``n_words`` masked off);
  * ``member_stats`` / ``cardinalities`` fold the delta's popcount deltas
    in, so the planner prices the overlaid data, not the stale base.

The view has no ``device_packs``: the tiled route's engine resolver then
picks the ``merge`` engine for it, as the reference's does.  Construction
is O(metadata + patched tiles); nothing is respliced.  Cold paths that
genuinely need a merged store (bit-level RUN stats, reclassification at
another granularity) fall back to :meth:`solid` --
``base.apply_tile_updates(...)``, the same tile-granular merge compaction
adopts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmaps import n_words_for
from repro_torch.device import WORD_DTYPE, to_words
from repro_torch.storage import (
    CONT_DENSE,
    CONT_NONE,
    CONT_RUN,
    CONT_SPARSE,
    TILE_DIRTY,
    TILE_ONE,
    MemberStats,
    TileStore,
)
from repro_torch.storage.tiles import BlockStats
from repro_torch.storage.tilestore import (
    _classify_tile_words,
    _popcount_words,
    _signature_counts,
)

from .delta import DeltaStore, base_tile_batch

__all__ = ["OverlayStore"]


class OverlayStore:
    """Read-only TileStore-duck-typed view of a base store plus a delta."""

    def __init__(self, base: TileStore, delta: DeltaStore):
        if delta.base is not base:
            raise ValueError("delta was recorded against a different base store")
        self.base = base
        # SNAPSHOT the delta at construction: every surface of this view
        # (tiled gathers, dense view, cardinalities, solid()) must describe
        # the same instant, or a stale index reference would answer
        # backend-dependently after later mutations
        self._patched = delta.snapshot()
        self.tile_words = tw = base.tile_words
        self.r = delta.r
        self.n_words = n_words_for(self.r)
        self.n_tiles = (self.n_words + tw - 1) // tw
        n = base.n

        classes = np.zeros((n, self.n_tiles), np.uint8)
        classes[:, : base.n_tiles] = base.classes_word
        # flatten the snapshot's patched tiles into ONE vectorised pass --
        # classification and class scatter
        pc, pt, words = [], [], []
        for col, tmap in self._patched.items():
            pc.extend([col] * len(tmap))
            pt.extend(tmap.keys())
            words.extend(tmap.values())
        if pc:
            pcols = np.asarray(pc, np.int64)
            ptiles = np.asarray(pt, np.int64)
            pwords = np.stack(words)  # [P, tw]
            cls = _classify_tile_words(pwords)
            classes[pcols, ptiles] = cls
            self._extra = np.ascontiguousarray(pwords[cls >= TILE_DIRTY])
        else:
            pcols = ptiles = np.zeros(0, np.int64)
            pwords = np.zeros((0, tw), np.uint32)
            cls = np.zeros(0, np.uint8)
            self._extra = np.zeros((0, tw), np.uint32)
        self._pcols, self._ptiles, self._pcls = pcols, ptiles, cls
        self._pwords = pwords
        self._classes_word = classes
        self._dirty_index_cache: np.ndarray | None = None
        self._dirty_np_cache: np.ndarray | None = None
        self._dirty_dev: torch.Tensor | None = None
        self._dense: torch.Tensor | None = None
        self._solid_cache: TileStore | None = None
        self._member_stats_cache: dict = {}
        self._card_cache: tuple | None = None
        self._kinds_cache: np.ndarray | None = None
        self._swc_cache: np.ndarray | None = None
        self._patch_pos_cache: np.ndarray | None = None

    # -- geometry / identity ----------------------------------------------
    @property
    def n(self) -> int:
        return self.base.n

    @property
    def device(self) -> torch.device:
        """The base's device: where the dense view and results live."""
        return self.base.device

    # -- tile-path surface -------------------------------------------------
    @property
    def classes_word(self) -> np.ndarray:
        return self._classes_word

    @property
    def dirty_index(self) -> np.ndarray:
        """int64[n, n_tiles]: row of :attr:`dirty` per (column, tile), -1
        clean; patched dirty tiles point past the base's rows."""
        if self._dirty_index_cache is None:
            index = np.full((self.n, self.n_tiles), -1, np.int64)
            index[:, : self.base.n_tiles] = self.base.dirty_index
            if self._pcols.size:
                dirty = self._pcls >= TILE_DIRTY
                base_nd = int((self.base.classes_word >= TILE_DIRTY).sum())
                idx_vals = np.full(self._pcols.size, -1, np.int64)
                idx_vals[dirty] = base_nd + np.arange(int(dirty.sum()))
                index[self._pcols, self._ptiles] = idx_vals
            self._dirty_index_cache = index
        return self._dirty_index_cache

    @property
    def _dirty_np(self) -> np.ndarray:
        if self._dirty_np_cache is None:
            self._dirty_np_cache = (
                np.concatenate([self.base._dirty_np, self._extra])
                if self._extra.size
                else self.base._dirty_np
            )
        return self._dirty_np_cache

    @property
    def dirty(self) -> torch.Tensor:
        """int32[rows, tile_words] on the device: the base's dirty pack, then
        the patched dirty tiles (one upload of the patched words)."""
        if self._dirty_dev is None:
            if self._extra.size:
                self._dirty_dev = torch.cat(
                    [self.base.dirty, to_words(self._extra, self.device)]
                )
            else:
                self._dirty_dev = self.base.dirty
        return self._dirty_dev

    # -- container surface (what the container-native executor reads) -----
    @property
    def container_kinds(self) -> np.ndarray:
        """Base container kinds with patched tiles as dense containers
        (patched words are raw; compaction re-compresses them)."""
        if self._kinds_cache is None:
            kinds = np.zeros((self.n, self.n_tiles), np.uint8)
            kinds[:, : self.base.n_tiles] = self.base.container_kinds
            if self._pcols.size:
                kinds[self._pcols, self._ptiles] = np.where(
                    self._pcls >= TILE_DIRTY, CONT_DENSE, CONT_NONE
                ).astype(np.uint8)
            self._kinds_cache = kinds
        return self._kinds_cache

    @property
    def storage_words_cell(self) -> np.ndarray:
        if self._swc_cache is None:
            swc = np.zeros((self.n, self.n_tiles), np.int32)
            swc[:, : self.base.n_tiles] = self.base.storage_words_cell
            if self._pcols.size:
                swc[self._pcols, self._ptiles] = np.where(
                    self._pcls >= TILE_DIRTY, self.tile_words, 0
                )
            self._swc_cache = swc
        return self._swc_cache

    @property
    def _patch_pos(self) -> np.ndarray:
        """int64[n, n_tiles]: row of ``_extra`` per patched-dirty cell."""
        if self._patch_pos_cache is None:
            pp = np.full((self.n, self.n_tiles), -1, np.int64)
            dirty = self._pcls >= TILE_DIRTY
            if dirty.any():
                pp[self._pcols[dirty], self._ptiles[dirty]] = np.arange(
                    int(dirty.sum())
                )
            self._patch_pos_cache = pp
        return self._patch_pos_cache

    def gather_cells(self, cols, tiles) -> np.ndarray:
        """Materialised (base ⊕ delta) words of arbitrary cells, host
        uint32[M, tile_words] -- patched tiles from the overlay buffer, the
        rest straight off the base's container packs (decompressed per
        cell, never store-wide)."""
        cols = np.asarray(cols, np.int64)
        tiles = np.asarray(tiles, np.int64)
        out = np.zeros((cols.size, self.tile_words), np.uint32)
        inb = tiles < self.n_tiles
        if not inb.all():
            sel = np.nonzero(inb)[0]
            out[sel] = self.gather_cells(cols[sel], tiles[sel])
            return out
        cls = self._classes_word[cols, tiles]
        out[cls == TILE_ONE] = 0xFFFFFFFF
        pp = self._patch_pos[cols, tiles]
        hit = pp >= 0
        if hit.any():
            out[hit] = self._extra[pp[hit]]
        rest = (cls >= TILE_DIRTY) & ~hit
        if rest.any():
            out[rest] = self.base.gather_cells(cols[rest], tiles[rest])
        return out

    def gather_events(self, cols, tiles):
        """Boundary events of compressed cells.  Patched tiles are never
        sparse/run containers (see :attr:`container_kinds`), so every
        requested cell lives in the base packs."""
        return self.base.gather_events(cols, tiles)

    # -- dense-path surface ------------------------------------------------
    def densify(self) -> torch.Tensor:
        """Dense int32[n, n_words] view with the patched tiles written in,
        built on the device and cached per overlay.

        Starts from the base's resident dense view (cloned, or copied into
        a wider buffer when appends grew the universe) and writes every
        patched tile -- clean or dirty -- with one indexed store of one
        upload of the patched words; tile words past ``n_words`` are
        masked off.  The words equal the reference's host-built array.
        """
        if self._dense is not None:
            return self._dense
        base = self.base.densify()
        dev = base.device
        n, nw, tw = self.n, self.n_words, self.tile_words
        if base.shape[1] == nw:
            dense = base.clone()
        else:
            dense = torch.zeros((n, nw), dtype=WORD_DTYPE, device=dev)
            dense[:, : base.shape[1]] = base
        if self._pcols.size:
            word = self._ptiles[:, None] * tw + np.arange(tw)[None, :]  # [P, tw]
            keep = word < nw
            flat = (self._pcols[:, None] * nw + word)[keep]
            vals = to_words(self._pwords, dev)[torch.from_numpy(keep).to(dev)]
            dense.view(-1)[torch.from_numpy(flat).to(dev)] = vals
        self._dense = dense
        return self._dense

    def column(self, i: int) -> torch.Tensor:
        return self.densify()[int(i)]

    # -- planner surface ---------------------------------------------------
    @property
    def cardinalities(self) -> tuple:
        if self._card_cache is None:
            deltas = {}
            for col, tmap in self._patched.items():
                ts = list(tmap)
                patched = np.stack([tmap[t] for t in ts])
                basew = base_tile_batch(self.base, [col] * len(ts), ts)
                deltas[col] = _popcount_words(patched) - _popcount_words(basew)
            self._card_cache = tuple(
                c + deltas.get(i, 0)
                for i, c in enumerate(self.base.cardinalities)
            )
        return self._card_cache

    @property
    def densities(self) -> tuple:
        return tuple(c / max(self.r, 1) for c in self.cardinalities)

    @property
    def clean_fraction(self) -> float:
        if self._classes_word.size == 0:
            return 1.0
        return float((self._classes_word <= TILE_ONE).mean())

    @property
    def dirty_words(self) -> int:
        return int((self._classes_word >= TILE_DIRTY).sum()) * self.tile_words

    def member_stats(self, slots=None) -> MemberStats:
        """Same aggregate `TileStore.member_stats` computes, over the
        overlaid classes and cardinalities (cached per subset)."""
        key = None if slots is None else tuple(slots)
        cached = self._member_stats_cache.get(key)
        if cached is not None:
            return cached
        idx = np.arange(self.n) if slots is None else np.asarray(list(key))
        if idx.size == 0:
            return MemberStats(0, self.n_words, self.tile_words, 1.0, 0.0, 0, 0)
        cls = self._classes_word[idx]
        dirty_tiles = int((cls >= TILE_DIRTY).sum())
        cards = self.cardinalities
        dens = [cards[i] / max(self.r, 1) for i in idx]
        sigs, counts = _signature_counts(cls)
        signatures = tuple(
            (int(cnt), int((sig == TILE_ONE).sum()), int((sig >= TILE_DIRTY).sum()))
            for sig, cnt in zip(sigs, counts)
        )
        kinds = self.container_kinds[idx]
        stats = MemberStats(
            n=int(idx.size),
            n_words=self.n_words,
            tile_words=self.tile_words,
            clean_fraction=1.0 - dirty_tiles / max(cls.size, 1),
            density=float(np.mean(dens)),
            dirty_words=dirty_tiles * self.tile_words,
            case3_tiles=int(((cls >= TILE_DIRTY).any(axis=0)).sum()),
            signatures=signatures,
            container_tiles=(
                int((kinds == CONT_DENSE).sum()),
                int((kinds == CONT_SPARSE).sum()),
                int((kinds == CONT_RUN).sum()),
            ),
            compressed_words=int(self.storage_words_cell[idx].sum()),
        )
        self._member_stats_cache[key] = stats
        return stats

    def block_stats(self) -> BlockStats:
        return BlockStats(
            classes=self._classes_word.copy(),
            tile_words=self.tile_words,
            n_words=self.n_words,
        )

    # -- cold paths: fall back to the merged store -------------------------
    def solid(self) -> TileStore:
        """The merged (base ⊕ snapshot) TileStore -- what compaction would
        have adopted at this view's instant; built lazily, tile-granularly,
        and cached."""
        if self._solid_cache is None:
            self._solid_cache = self.base.apply_tile_updates(
                {c: dict(t) for c, t in self._patched.items()}, r=self.r
            )
        return self._solid_cache

    @property
    def col_stats(self) -> tuple:
        return self.solid().col_stats

    @property
    def runcounts(self) -> tuple:
        return self.solid().runcounts

    @property
    def classes(self) -> np.ndarray:
        return self.solid().classes

    def with_tile_words(self, tile_words: int) -> "TileStore":
        return self.solid().with_tile_words(tile_words)

    # -- mutations are the streaming engine's job --------------------------
    def append(self, packed_row):
        raise TypeError(
            "OverlayStore is a read view; mutate through StreamingIndex "
            "(set_bits/clear_bits/append_rows) or compact() first"
        )

    replace = append
    slice_tiles = append
