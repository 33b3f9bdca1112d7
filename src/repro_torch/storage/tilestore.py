"""`TileStore`: the hybrid tile-classified column store (build and statistics half).

The single source of truth for column data in the query engine.  Each
column (a packed bitmap over the universe ``r``) is split into tiles of
``tile_words`` 32-bit words and classified at build time:

  * ``TILE_ZERO`` (0)  -- every word 0
  * ``TILE_ONE``  (1)  -- every word 0xFFFFFFFF
  * ``TILE_DIRTY`` (2) -- anything else
  * ``TILE_RUN``  (3)  -- dirty, but a single 0/1 transition inside the
    tile (one run boundary); a bit-level refinement computed lazily for
    the planner's RUNCOUNT-style estimates.

Dirty tiles additionally carry a **container kind**
(``repro_torch.storage.containers``): low-popcount tiles are *sparse
containers* (sorted uint16 bit positions), few-run tiles are *run
containers* ((start, end) uint16 interval pairs), the rest are *dense
containers* (the classic packed words), packed contiguously per column.

Classification and statistics are host-side numpy over ``uint32`` words:
this is the paper's "index build time" work that makes the planner
data-aware without any per-query scanning.  The dense view that the dense
backends read is an ``int32`` tensor on the store's device: ``from_packed``
keeps the tensor it was given (``densify()`` hands it back and never
re-uploads a reconstruction).

Ported: construction, classification, container kinds and storage words,
per-column and member-subset statistics, ``append`` / ``replace`` /
``with_tile_words``, the dense view, and the pack/gather half that the
tile-skipping executor (``storage.tiled``) reads: the store-wide packs and
their device mirrors (``packs`` / ``device_packs`` / ``dirty``) and the
cell and event gathers, ``block_stats`` (the 3-class view that
``rbmrg_block`` reads), the snapshot constructor ``from_arrays``, the
streaming compaction path ``apply_tile_updates`` and the row-shard
constructors ``slice_tiles`` / ``concat_tiles`` (``repro_torch.dist``).

Stores are immutable: ``append`` / ``replace`` return a new ``TileStore``
that shares nothing mutable with the old one, so stale references keep
working (the property ``BitmapIndex.add_column`` relies on).  A store is
hashable by identity and weak-referenceable (the plan memo keys on it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bitmaps import n_words_for, pack
from repro_torch.device import resolve_device, to_numpy_u32, to_words
from repro_torch.obs import REGISTRY as _OBS

from .containers import (
    CONT_DENSE,
    CONT_NONE,
    CONT_RUN,
    CONT_SPARSE,
    compress_tiles,
    concat_ranges,
    containers_supported,
    words_from_runs,
    words_from_sparse,
)

__all__ = [
    "TILE_ZERO",
    "TILE_ONE",
    "TILE_DIRTY",
    "TILE_RUN",
    "ColumnStats",
    "MemberStats",
    "TileStore",
]

TILE_ZERO, TILE_ONE, TILE_DIRTY, TILE_RUN = 0, 1, 2, 3

# member-statistics accounting on the process registry (no-op until
# obs.enable()): tiles the signature pass read, and cache misses by how they
# were answered -- ``summary`` (no member has a clean tile: per-column sums
# alone) or ``scan`` (the signature pass over the members' clean tiles)
_STATS_TILES = _OBS.counter(
    "repro_plan_stats_tiles_scanned_total",
    "Tiles the member-statistics signature pass read",
)
_STATS_PASSES = _OBS.counter(
    "repro_plan_stats_total",
    "Member-statistics cache misses by pass (summary or scan)",
    ("pass",),
)
_STATS_TILES_B = _STATS_TILES.bind()
_STATS_SUMMARY = _STATS_PASSES.bind(**{"pass": "summary"})
_STATS_SCAN = _STATS_PASSES.bind(**{"pass": "scan"})


def _signature_counts(cls: np.ndarray, *, return_inverse: bool = False):
    """Distinct per-tile class signatures of ``cls`` ([members, n_tiles]).

    Returns ``(signatures, counts)`` -- or ``(signatures, inverse)`` with
    ``return_inverse`` (the tiled executor's grouping).  Equivalent to
    ``np.unique(cls.T, axis=0)`` but via a void view over contiguous rows
    -- axis-unique's lexsort of object rows dominated planner and dispatch
    time on multi-thousand-tile stores."""
    rows = np.ascontiguousarray(cls.T)
    if rows.size == 0:
        return rows, np.zeros(0, np.int64)
    v = rows.view(np.dtype((np.void, rows.shape[1]))).ravel()
    uniq, second = np.unique(
        v, return_inverse=return_inverse, return_counts=not return_inverse
    )
    sigs = uniq.view(np.uint8).reshape(uniq.size, rows.shape[1])
    return sigs, second


if hasattr(np, "bitwise_count"):  # numpy >= 2.0
    def _popcount_words(row: np.ndarray) -> int:
        return int(np.bitwise_count(row).sum())
else:  # byte-table fallback for numpy 1.x
    _POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)

    def _popcount_words(row: np.ndarray) -> int:
        return int(_POP8[row.view(np.uint8)].sum())


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Build-time statistics of one column."""

    cardinality: int
    density: float
    runcount: int
    n_dirty_tiles: int  # DIRTY + RUN
    clean_fraction: float  # fraction of tiles that are ZERO/ONE


@dataclasses.dataclass(frozen=True)
class MemberStats:
    """Aggregate statistics of a member subset, consumed by the planner."""

    n: int
    n_words: int
    tile_words: int
    clean_fraction: float  # over (member, tile) pairs
    density: float  # mean member density
    dirty_words: int  # words a DENSE dirty pack would store for the members
    case3_tiles: int  # tiles where at least one member is dirty
    #: distinct tile-class signatures over the subset, as
    #: (tile_count, n_one, n_dirty) triples -- lets the planner price the
    #: tiled executor's per-signature dispatch overhead without specializing
    signatures: tuple = ()
    #: (dense, sparse, run) container counts over the subset's dirty tiles
    container_tiles: tuple = (0, 0, 0)
    #: words actually stored for the subset's dirty tiles (compressed;
    #: == dirty_words when every container is dense / containers are off)
    compressed_words: int = 0


@dataclasses.dataclass(frozen=True)
class _ColumnSummaries:
    """A store's per-column figures that :meth:`TileStore.member_stats`
    sums: dirty tiles, (dense, sparse, run) container tiles and stored
    words, each indexed by column, and each column's sorted clean tiles."""

    dirty: np.ndarray  # int64 [N]
    containers: np.ndarray  # int64 [N, 3]
    words: np.ndarray  # int64 [N]
    clean: tuple  # N sorted int64 arrays of ZERO / ONE tile indices


@dataclasses.dataclass(frozen=True)
class _Column:
    """One classified column: per-tile word classes + container payloads.

    Word-level classification (all-zero / all-one / dirty) is all that
    execution and planning need and costs one vectorised comparison pass.
    Dirty tiles are compressed into per-kind packs in tile order (see
    ``repro_torch.storage.containers``); the bit-level metadata (exact runcount,
    RUN tagging) still needs an 8x ``unpackbits`` expansion, so the store
    computes it lazily on first access of ``classes`` / ``col_stats``.
    """

    classes: np.ndarray  # uint8 [n_tiles], word-level: ZERO/ONE/DIRTY only
    kinds: np.ndarray  # uint8 [n_tiles], container kind (CONT_NONE clean)
    dense: np.ndarray  # uint32 [n_dense, tile_words], tile order
    spos: np.ndarray  # uint16 [sum p], sparse positions, tile order
    soff: np.ndarray  # int64 [n_sparse + 1]
    runs: np.ndarray  # uint16 [n_intervals, 2], (start, end), tile order
    roff: np.ndarray  # int64 [n_run + 1], interval-count offsets
    cardinality: int

    def dirty_words_dense(self, tile_words: int) -> np.ndarray:
        """EVERY dirty tile of this column densified, uint32[nd, tw]."""
        dk = self.kinds[self.classes >= TILE_DIRTY]
        out = np.empty((dk.size, tile_words), np.uint32)
        out[dk == CONT_DENSE] = self.dense
        if (dk == CONT_SPARSE).any():
            out[dk == CONT_SPARSE] = words_from_sparse(
                self.spos, self.soff, tile_words
            )
        if (dk == CONT_RUN).any():
            out[dk == CONT_RUN] = words_from_runs(self.runs, self.roff, tile_words)
        return out

    def storage_words(self, tile_words: int) -> int:
        """uint32-word-equivalents this column's containers occupy.

        Sparse tiles are charged per-tile ``ceil(p/2)`` (positions do not
        pool across tiles), matching ``TileStore.storage_words_cell`` --
        so census / member-stats / footprint metrics all agree."""
        sparse = int(((np.diff(self.soff) + 1) // 2).sum()) if len(self.soff) > 1 else 0
        return self.dense.shape[0] * tile_words + sparse + len(self.runs)


def _classify_column(row: np.ndarray, tile_words: int, *,
                     containers: bool = True) -> _Column:
    """Word-level classification + container compression of one padded
    column (uint32[n_tiles * tile_words])."""
    n_tiles = row.size // tile_words
    tiles = row.reshape(n_tiles, tile_words)
    all_zero = (tiles == 0).all(axis=1)
    all_one = (tiles == 0xFFFFFFFF).all(axis=1)
    classes = np.full(n_tiles, TILE_DIRTY, dtype=np.uint8)
    classes[all_zero] = TILE_ZERO
    classes[all_one] = TILE_ONE
    dirty_mask = classes == TILE_DIRTY
    ckinds, dense, spos, soff, runs, roff = compress_tiles(
        tiles[dirty_mask], tile_words, containers=containers
    )
    kinds = np.zeros(n_tiles, np.uint8)
    kinds[dirty_mask] = ckinds
    return _Column(
        classes=classes,
        kinds=kinds,
        dense=dense,
        spos=spos,
        soff=soff,
        runs=runs,
        roff=roff,
        cardinality=_popcount_words(row),
    )


def _classify_tile_words(words: np.ndarray) -> np.ndarray:
    """Word-level class (ZERO / ONE / DIRTY) of each row of
    uint32[M, tile_words], as uint8[M] in one vectorised pass."""
    all_one = (words == 0xFFFFFFFF).all(axis=1)
    return np.where(
        all_one, TILE_ONE, np.where(words.any(axis=1), TILE_DIRTY, TILE_ZERO)
    ).astype(np.uint8)


def _slice_column(c: _Column, t0: int, t1: int, tile_words: int) -> _Column:
    """Tile-range slice of one column's classes/kinds/packs -- nothing is
    reclassified, offsets are rebased."""
    classes = np.ascontiguousarray(c.classes[t0:t1])
    kinds = np.ascontiguousarray(c.kinds[t0:t1])
    d0 = int((c.kinds[:t0] == CONT_DENSE).sum())
    dn = int((kinds == CONT_DENSE).sum())
    dense = np.ascontiguousarray(c.dense[d0 : d0 + dn])
    s0 = int((c.kinds[:t0] == CONT_SPARSE).sum())
    sn = int((kinds == CONT_SPARSE).sum())
    soff = c.soff[s0 : s0 + sn + 1] - c.soff[s0]
    spos = np.ascontiguousarray(c.spos[c.soff[s0] : c.soff[s0 + sn]])
    r0 = int((c.kinds[:t0] == CONT_RUN).sum())
    rn = int((kinds == CONT_RUN).sum())
    roff = c.roff[r0 : r0 + rn + 1] - c.roff[r0]
    runs = np.ascontiguousarray(c.runs[c.roff[r0] : c.roff[r0 + rn]])
    card = _popcount_words(dense) if dense.size else 0
    card += int((classes == TILE_ONE).sum()) * tile_words * 32
    card += len(spos)
    if len(runs):
        card += int(
            (runs[:, 1].astype(np.int64) - runs[:, 0].astype(np.int64)).sum()
        )
    return _Column(classes=classes, kinds=kinds, dense=dense, spos=spos,
                   soff=soff, runs=runs, roff=roff, cardinality=card)


def _concat_columns(parts: list) -> _Column:
    """Inverse of :func:`_slice_column`: stitch tile-range columns."""
    soffs, shift = [parts[0].soff], parts[0].soff[-1]
    roffs, rshift = [parts[0].roff], parts[0].roff[-1]
    for p in parts[1:]:
        soffs.append(p.soff[1:] + shift)
        shift += p.soff[-1]
        roffs.append(p.roff[1:] + rshift)
        rshift += p.roff[-1]
    return _Column(
        classes=np.concatenate([p.classes for p in parts]),
        kinds=np.concatenate([p.kinds for p in parts]),
        dense=np.concatenate([p.dense for p in parts]),
        spos=np.concatenate([p.spos for p in parts]),
        soff=np.concatenate(soffs),
        runs=np.concatenate([p.runs for p in parts]),
        roff=np.concatenate(roffs),
        cardinality=sum(p.cardinality for p in parts),
    )


def _tile_cardinalities(c: _Column, tiles, tile_words: int) -> np.ndarray:
    """Popcount of the listed tiles, read from metadata/payloads only."""
    tiles = np.asarray(tiles, np.int64)
    out = np.zeros(tiles.size, np.int64)
    cls = c.classes[tiles]
    out[cls == TILE_ONE] = tile_words * 32
    kinds = c.kinds[tiles]
    dpos = np.cumsum(c.kinds == CONT_DENSE) - 1
    spos_ord = np.cumsum(c.kinds == CONT_SPARSE) - 1
    rpos = np.cumsum(c.kinds == CONT_RUN) - 1
    dn = kinds == CONT_DENSE
    if dn.any():
        if hasattr(np, "bitwise_count"):
            out[dn] = np.bitwise_count(c.dense[dpos[tiles[dn]]]).sum(
                axis=1, dtype=np.int64
            )
        else:
            out[dn] = [
                _popcount_words(c.dense[dpos[t]]) for t in tiles[dn]
            ]
    sp = kinds == CONT_SPARSE
    if sp.any():
        s = spos_ord[tiles[sp]]
        out[sp] = c.soff[s + 1] - c.soff[s]
    rn = kinds == CONT_RUN
    if rn.any():
        s = rpos[tiles[rn]]
        lens = c.runs[:, 1].astype(np.int64) - c.runs[:, 0].astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(lens)])
        out[rn] = csum[c.roff[s + 1]] - csum[c.roff[s]]
    return out


def _bit_stats(row: np.ndarray, classes: np.ndarray, tile_words: int, r: int):
    """Bit-level pass over one padded column: (runcount, run_mask)."""
    n_tiles = classes.size
    bits = np.unpackbits(row.view(np.uint8), bitorder="little")
    flips = bits[1:] != bits[:-1]
    rc = int(flips[: max(r - 1, 0)].sum()) + 1
    # transitions strictly inside each tile: positions [j*S, (j+1)*S - 2]
    span = tile_words * 32
    inner = np.concatenate([flips, [False]]).reshape(n_tiles, span)
    inner_counts = inner[:, : span - 1].sum(axis=1)
    run_mask = (classes >= TILE_DIRTY) & (inner_counts == 1)
    return rc, run_mask


class TileStore:
    """Tile-classified columns: classes + per-column container payloads."""

    def __init__(self, columns: list, *, tile_words: int, n_words: int, r: int,
                 dense=None, containers: bool = True, device=None):
        self._cols: tuple = tuple(columns)
        self.tile_words = int(tile_words)
        self.n_words = int(n_words)
        self.r = int(r)
        #: where the dense view lives (and where the dense backends run)
        self.device = dense.device if dense is not None else resolve_device(device)
        #: whether dirty tiles may be stored compressed (sparse/run);
        #: False keeps the legacy all-dense layout, and tile spans beyond
        #: uint16 positions force it off
        self.containers = bool(containers) and containers_supported(tile_words)
        self.n_tiles = (self.n_words + self.tile_words - 1) // self.tile_words
        # word-level classes [N, n_tiles]
        self._classes_word = (
            np.stack([c.classes for c in self._cols])
            if self._cols
            else np.zeros((0, self.n_tiles), np.uint8)
        )
        self._kinds_cache: np.ndarray | None = None
        self._dirty_np_cache: np.ndarray | None = None
        self._dirty_index_cache: np.ndarray | None = None
        self._storage_words_cell: np.ndarray | None = None
        self._packs: dict | None = None
        self._device_packs: tuple | None = None
        self._dirty_dev: torch.Tensor | None = None
        self._dense = dense  # optional cached int32[N, n_words] tensor on `device`
        # bit-level metadata (RUN tags, runcounts): computed on first access
        self._refined_classes: np.ndarray | None = None
        self._col_stats: tuple | None = None
        # member_stats memo: stores are immutable, so the aggregate (incl.
        # the np.unique signature pass) per member subset never changes --
        # planners hit this once per (shard, subset), not once per query
        self._member_stats_cache: dict = {}
        self._summaries: _ColumnSummaries | None = None

    # -- legacy densified dirty surface ------------------------------------
    def _assemble_dirty(self) -> None:
        """EVERY dirty tile as a dense row (compressed tiles decompressed)
        -- the densify-first consumers' view, assembled once on demand."""
        if self._dirty_np_cache is not None:
            return
        counts = [int((c.classes >= TILE_DIRTY).sum()) for c in self._cols]
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        index = np.full((len(self._cols), self.n_tiles), -1, np.int64)
        for i, c in enumerate(self._cols):
            index[i, c.classes >= TILE_DIRTY] = offsets[i] + np.arange(counts[i])
        self._dirty_index_cache = index
        self._dirty_np_cache = (
            np.concatenate(
                [c.dirty_words_dense(self.tile_words) for c in self._cols]
            )
            if any(counts)
            else np.zeros((0, self.tile_words), np.uint32)
        )

    @property
    def dirty_index(self) -> np.ndarray:
        """int64[N, n_tiles]: row of ``dirty`` per (column, tile), -1 clean."""
        self._assemble_dirty()
        return self._dirty_index_cache

    @property
    def _dirty_np(self) -> np.ndarray:
        self._assemble_dirty()
        return self._dirty_np_cache

    # -- container surface -------------------------------------------------
    @property
    def container_kinds(self) -> np.ndarray:
        """uint8[N, n_tiles]: CONT_NONE (clean) / CONT_DENSE / CONT_SPARSE /
        CONT_RUN per (column, tile)."""
        if self._kinds_cache is None:
            self._kinds_cache = (
                np.stack([c.kinds for c in self._cols])
                if self._cols
                else np.zeros((0, self.n_tiles), np.uint8)
            )
        return self._kinds_cache

    def _assemble_packs(self) -> None:
        """Store-wide per-kind packs + (column, tile) -> ordinal tables."""
        if self._packs is not None:
            return
        n = len(self._cols)
        kinds = self.container_kinds
        p: dict = {}
        for name, kind in (("dense", CONT_DENSE), ("sparse", CONT_SPARSE),
                           ("run", CONT_RUN)):
            counts = (kinds == kind).sum(axis=1)
            offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            index = np.full((n, self.n_tiles), -1, np.int64)
            for i in range(n):
                index[i, kinds[i] == kind] = offsets[i] + np.arange(counts[i])
            p[f"{name}_index"] = index
        p["dense_pack"] = (
            np.concatenate([c.dense for c in self._cols])
            if n
            else np.zeros((0, self.tile_words), np.uint32)
        )
        soffs, shift = [np.zeros(1, np.int64)], 0
        for c in self._cols:
            soffs.append(c.soff[1:] + shift)
            shift += c.soff[-1]
        p["sparse_bounds"] = np.concatenate(soffs)
        p["sparse_pack"] = (
            np.concatenate([c.spos for c in self._cols])
            if n else np.zeros(0, np.uint16)
        )
        roffs, rshift = [np.zeros(1, np.int64)], 0
        for c in self._cols:
            roffs.append(c.roff[1:] + rshift)
            rshift += c.roff[-1]
        p["run_bounds"] = np.concatenate(roffs)
        p["run_pack"] = (
            np.concatenate([c.runs for c in self._cols])
            if n else np.zeros((0, 2), np.uint16)
        )
        self._packs = p

    @property
    def packs(self) -> dict:
        """The store-wide per-kind packs + ordinal tables (host numpy,
        assembled lazily): ``dense_pack``/``sparse_pack``/``sparse_bounds``/
        ``run_pack``/``run_bounds`` and the int64[N, n_tiles]
        ``dense_index``/``sparse_index``/``run_index`` tables."""
        self._assemble_packs()
        return self._packs

    def device_packs(self) -> tuple:
        """Pack mirrors on the store's device for the single-scan engine
        (``repro_torch.kernels.tiled_scan``), uploaded once per store:

        * ``dense_pack1`` int32[D + 2, tile_words] -- the dense pack plus
          an all-zeros sentinel row at ``D`` and an all-ones row (``-1``)
          at ``D + 1``, so clean cells gather by class without a branch;
        * ``sparse_pack1`` uint16[S + 1] -- one zero pad entry;
        * ``run_pack1`` uint16[R + 1, 2] -- one (0, 0) pad interval.

        The uint16 packs are read as such by the kernel; the plain version
        widens them with ``.to(torch.int32)``.
        """
        if self._device_packs is None:
            self._assemble_packs()
            p = self._packs
            tw = self.tile_words
            dense1 = np.concatenate([
                p["dense_pack"],
                np.zeros((1, tw), np.uint32),
                np.full((1, tw), 0xFFFFFFFF, np.uint32),
            ])
            sparse1 = np.concatenate([p["sparse_pack"], np.zeros(1, np.uint16)])
            run1 = np.concatenate([p["run_pack"], np.zeros((1, 2), np.uint16)])
            self._device_packs = (
                to_words(dense1, self.device),
                torch.from_numpy(sparse1).to(self.device),
                torch.from_numpy(np.ascontiguousarray(run1)).to(self.device),
            )
        return self._device_packs

    @property
    def dirty(self) -> torch.Tensor:
        """The densified dirty-tile words, int32[total_dirty, tile_words] on
        the store's device (compressed containers expanded on first access);
        rows are indexed by :attr:`dirty_index`."""
        if self._dirty_dev is None:
            self._dirty_dev = to_words(self._dirty_np, self.device)
        return self._dirty_dev

    def gather_cells(self, cols, tiles) -> np.ndarray:
        """Materialised words of arbitrary (column, tile) cells, host
        uint32[M, tile_words] -- container-aware: dense cells are pack
        rows, sparse/run cells decompress, clean cells fill by class, and
        tiles past ``n_tiles`` read all-zero."""
        cols = np.asarray(cols, np.int64)
        tiles = np.asarray(tiles, np.int64)
        tw = self.tile_words
        out = np.zeros((cols.size, tw), np.uint32)
        inb = tiles < self.n_tiles
        if not inb.all():
            sel = np.nonzero(inb)[0]
            out[sel] = self.gather_cells(cols[sel], tiles[sel])
            return out
        self._assemble_packs()
        cls = self._classes_word[cols, tiles]
        out[cls == TILE_ONE] = 0xFFFFFFFF
        kinds = self.container_kinds[cols, tiles]
        dn = kinds == CONT_DENSE
        if dn.any():
            out[dn] = self._packs["dense_pack"][
                self._packs["dense_index"][cols[dn], tiles[dn]]
            ]
        sp = kinds == CONT_SPARSE
        if sp.any():
            s = self._packs["sparse_index"][cols[sp], tiles[sp]]
            b = self._packs["sparse_bounds"]
            take = concat_ranges(b[s], b[s + 1])
            off = np.concatenate([[0], np.cumsum(b[s + 1] - b[s])])
            out[sp] = words_from_sparse(self._packs["sparse_pack"][take], off, tw)
        rn = kinds == CONT_RUN
        if rn.any():
            s = self._packs["run_index"][cols[rn], tiles[rn]]
            b = self._packs["run_bounds"]
            take = concat_ranges(b[s], b[s + 1])
            off = np.concatenate([[0], np.cumsum(b[s + 1] - b[s])])
            out[rn] = words_from_runs(self._packs["run_pack"][take], off, tw)
        return out

    def gather_events(self, cols, tiles):
        """Boundary events of compressed (sparse/run) cells: every sparse
        position contributes toggles at ``p`` and ``p + 1``, every run
        interval at its endpoints.  Returns host ``(cell, bitpos)`` arrays
        -- ``cell`` indexes the input (col, tile) pair.  Cells must be
        SPARSE or RUN containers (the event path's precondition)."""
        cols = np.asarray(cols, np.int64)
        tiles = np.asarray(tiles, np.int64)
        self._assemble_packs()
        kinds = self.container_kinds[cols, tiles]
        out_cell, out_pos = [], []
        sp = kinds == CONT_SPARSE
        if sp.any():
            s = self._packs["sparse_index"][cols[sp], tiles[sp]]
            b = self._packs["sparse_bounds"]
            take = concat_ranges(b[s], b[s + 1])
            cell = np.repeat(np.nonzero(sp)[0], b[s + 1] - b[s])
            p = self._packs["sparse_pack"][take].astype(np.int64)
            out_cell += [cell, cell]
            out_pos += [p, p + 1]
        rn = kinds == CONT_RUN
        if rn.any():
            s = self._packs["run_index"][cols[rn], tiles[rn]]
            b = self._packs["run_bounds"]
            take = concat_ranges(b[s], b[s + 1])
            cell = np.repeat(np.nonzero(rn)[0], b[s + 1] - b[s])
            iv = self._packs["run_pack"][take].astype(np.int64)
            out_cell += [cell, cell]
            out_pos += [iv[:, 0], iv[:, 1]]
        if not out_cell:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(out_cell), np.concatenate(out_pos)

    @property
    def storage_words_cell(self) -> np.ndarray:
        """int32[N, n_tiles]: uint32-word-equivalents stored per (column,
        tile) cell -- 0 clean, ``tile_words`` dense, ``ceil(p/2)`` sparse,
        ``i`` run.  The planner's container-aware pricing input.  Computed
        from each column's own offset tables (payloads are in tile order)."""
        if self._storage_words_cell is None:
            kinds = self.container_kinds
            out = np.zeros(kinds.shape, np.int32)
            out[kinds == CONT_DENSE] = self.tile_words
            for i, c in enumerate(self._cols):
                sp = c.kinds == CONT_SPARSE
                if sp.any():
                    out[i, sp] = (np.diff(c.soff) + 1) // 2
                rn = c.kinds == CONT_RUN
                if rn.any():
                    out[i, rn] = np.diff(c.roff)
            self._storage_words_cell = out
        return self._storage_words_cell

    def container_census(self, slots=None) -> dict:
        """Per-kind tile counts + storage words of a member subset (default
        all columns) -- the "what is this data stored as" report."""
        idx = np.arange(self.n) if slots is None else np.asarray(list(slots))
        kinds = self.container_kinds[idx]
        cells = self.storage_words_cell[idx]
        return {
            "clean": int((kinds == CONT_NONE).sum()),
            "dense": int((kinds == CONT_DENSE).sum()),
            "sparse": int((kinds == CONT_SPARSE).sum()),
            "run": int((kinds == CONT_RUN).sum()),
            "storage_words": int(cells.sum()),
            "dense_equiv_words": int((kinds > CONT_NONE).sum()) * self.tile_words,
        }

    def storage_words(self) -> int:
        """Total uint32-word-equivalents the container packs occupy."""
        return sum(c.storage_words(self.tile_words) for c in self._cols)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_packed(cls, columns, *, tile_words: int = 64, r: int | None = None,
                    containers: bool = True, device=None) -> "TileStore":
        """Build from packed bitmaps int32[N, n_words] (a tensor, or numpy
        ``uint32``).  The words are classified on the host; the tensor on
        ``device`` is kept as the dense view."""
        dev = to_words(columns, resolve_device(device))
        arr = to_numpy_u32(dev)
        if arr.ndim != 2:
            raise ValueError(f"expected int32[N, n_words], got shape {arr.shape}")
        n, nw = arr.shape
        r = int(r) if r is not None else nw * 32
        n_tiles = (nw + tile_words - 1) // tile_words
        enabled = bool(containers) and containers_supported(tile_words)
        tail = n_tiles * tile_words - nw
        cols = [
            _classify_column(np.pad(arr[i], (0, tail)) if tail else arr[i],
                             tile_words, containers=enabled)
            for i in range(n)
        ]
        return cls(cols, tile_words=tile_words, n_words=nw, r=r, dense=dev,
                   containers=enabled)

    @classmethod
    def from_dense(cls, bits, *, tile_words: int = 64,
                   containers: bool = True, device=None) -> "TileStore":
        """Build from a dense boolean/int array [N, r]."""
        dev = resolve_device(device)
        if not isinstance(bits, torch.Tensor):
            bits = np.asarray(bits)
        return cls.from_packed(pack(bits, dev), tile_words=tile_words,
                               r=bits.shape[-1], containers=containers, device=dev)

    @classmethod
    def from_arrays(cls, arrays, *, tile_words: int, n_words: int, r: int,
                    containers: bool = True, device=None) -> "TileStore":
        """Trusted zero-copy constructor from the :attr:`packs` surface.

        ``arrays`` is a mapping holding ``classes`` / ``kinds`` (uint8
        [N, n_tiles]), ``cardinalities`` (int64 [N]) and the eight pack /
        ordinal-table arrays exactly as :attr:`packs` lays them out.  The
        arrays are adopted as-is (they may be read-only ``np.memmap``
        views over a snapshot file): per-column payloads become slices of
        the store-wide packs -- the per-column concatenation order of
        ``_assemble_packs`` guarantees contiguity -- so nothing larger
        than the offset rebases is copied.  Classification is NOT re-run;
        callers must hand back arrays a ``TileStore`` produced.  The packs
        stay host numpy; ``device`` (default: the CUDA card) is where the
        dense view and the device pack mirrors are uploaded on first use.
        """
        dev = resolve_device(device)
        classes = np.asarray(arrays["classes"])
        kinds = np.asarray(arrays["kinds"])
        cards = np.asarray(arrays["cardinalities"], np.int64)
        if classes.ndim != 2 or classes.shape != kinds.shape:
            raise ValueError(
                f"classes/kinds must both be uint8[N, n_tiles], got "
                f"{classes.shape} vs {kinds.shape}"
            )
        n, n_tiles = classes.shape
        if n_tiles != (int(n_words) + int(tile_words) - 1) // int(tile_words):
            raise ValueError(
                f"{n_tiles} tiles inconsistent with n_words={n_words} at "
                f"tile_words={tile_words}"
            )
        if cards.shape != (n,):
            raise ValueError(f"expected {n} cardinalities, got {cards.shape}")
        dense_pack = arrays["dense_pack"]
        sparse_pack, sb = arrays["sparse_pack"], arrays["sparse_bounds"]
        run_pack, rb = arrays["run_pack"], arrays["run_bounds"]
        cols = []
        d0 = s0 = r0 = 0  # per-kind tile ordinals consumed so far
        for i in range(n):
            ki = kinds[i]
            dn = int((ki == CONT_DENSE).sum())
            sn = int((ki == CONT_SPARSE).sum())
            rn = int((ki == CONT_RUN).sum())
            cols.append(_Column(
                classes=classes[i],
                kinds=ki,
                dense=dense_pack[d0:d0 + dn],
                spos=sparse_pack[sb[s0]:sb[s0 + sn]],
                soff=np.asarray(sb[s0:s0 + sn + 1], np.int64) - sb[s0],
                runs=run_pack[rb[r0]:rb[r0 + rn]],
                roff=np.asarray(rb[r0:r0 + rn + 1], np.int64) - rb[r0],
                cardinality=int(cards[i]),
            ))
            d0 += dn
            s0 += sn
            r0 += rn
        if d0 != len(dense_pack) or sb[s0] != len(sparse_pack) \
                or rb[r0] != len(run_pack):
            raise ValueError("pack sizes inconsistent with the kind arrays")
        store = object.__new__(cls)
        store._cols = tuple(cols)
        store.tile_words = int(tile_words)
        store.n_words = int(n_words)
        store.r = int(r)
        store.device = dev
        store.containers = bool(containers) and containers_supported(tile_words)
        store.n_tiles = n_tiles
        store._classes_word = classes
        store._kinds_cache = kinds
        store._dirty_np_cache = None
        store._dirty_index_cache = None
        store._dirty_dev = None
        store._packs = {
            "dense_index": np.asarray(arrays["dense_index"]),
            "sparse_index": np.asarray(arrays["sparse_index"]),
            "run_index": np.asarray(arrays["run_index"]),
            "dense_pack": np.asarray(dense_pack),
            "sparse_pack": np.asarray(sparse_pack),
            "sparse_bounds": np.asarray(sb),
            "run_pack": np.asarray(run_pack),
            "run_bounds": np.asarray(rb),
        }
        store._storage_words_cell = None
        store._device_packs = None
        store._dense = None
        store._refined_classes = None
        store._col_stats = None
        store._member_stats_cache = {}
        store._summaries = None
        if not (kinds > CONT_DENSE).any():
            # all-dense layout: the densified dirty pack IS the dense pack
            # (same per-column tile order), so the dirty surface reads the
            # memmap directly -- no assembly copy
            store._dirty_np_cache = store._packs["dense_pack"]
            store._dirty_index_cache = store._packs["dense_index"]
        return store

    def _row_words(self, packed_row) -> torch.Tensor:
        row = to_words(packed_row, self.device)
        if tuple(row.shape) != (self.n_words,):
            raise ValueError(f"expected shape ({self.n_words},), got {tuple(row.shape)}")
        return row

    def _classify_row(self, row: torch.Tensor) -> _Column:
        padded = np.pad(to_numpy_u32(row),
                        (0, self.n_tiles * self.tile_words - self.n_words))
        return _classify_column(padded, self.tile_words,
                                containers=self.containers)

    def append(self, packed_row) -> "TileStore":
        """New store with one more column; only the new column is classified
        -- and compressed, so query results fed back as virtual columns are
        stored in container form, not as dense words."""
        row = self._row_words(packed_row)
        col = self._classify_row(row)
        dense = None
        if self._dense is not None:
            dense = torch.cat([self._dense, row[None]], dim=0)
        return TileStore(list(self._cols) + [col], tile_words=self.tile_words,
                         n_words=self.n_words, r=self.r, dense=dense,
                         containers=self.containers, device=self.device)

    def replace(self, i: int, packed_row) -> "TileStore":
        """New store with column ``i`` swapped; only its tiles are reclassified
        (the slot-mask update path: untouched columns keep their packs).  The
        dense view is cloned before the row is written: the old store's view
        stays as it was."""
        row = self._row_words(packed_row)
        col = self._classify_row(row)
        cols = list(self._cols)
        cols[int(i)] = col
        dense = None
        if self._dense is not None:
            dense = self._dense.clone()
            dense[int(i)] = row
        return TileStore(cols, tile_words=self.tile_words, n_words=self.n_words,
                         r=self.r, dense=dense, containers=self.containers,
                         device=self.device)

    def apply_tile_updates(self, updates: dict, *, r: int | None = None
                           ) -> "TileStore":
        """New store with individual tiles' words swapped -- the streaming
        compaction path (``repro_torch.stream``).

        ``updates`` maps column slot -> {tile index -> uint32[tile_words]}
        (the tile's full new words, padding bits zero).  Only the touched
        tiles are reclassified -- each into the CHEAPEST container for its
        new contents (a mutated sparse tile that filled up becomes dense,
        a cleared dense tile becomes sparse or vanishes) -- and only the
        touched columns' packs are respliced; untouched columns share
        their ``_Column`` (classes, packs, stats) with this store.
        Per-column cardinality is maintained by popcount deltas of the
        swapped tiles.

        ``r`` may *grow* the universe (``repro_torch.stream``'s
        ``append_rows``): new tiles default to all-zero for every column,
        so only columns with set bits in the appended region need entries
        in ``updates``.  The new store's dense view is rebuilt lazily from
        its tiles on the first ``densify()``.
        """
        r_new = int(r) if r is not None else self.r
        if r_new < self.r:
            raise ValueError(f"universe cannot shrink ({self.r} -> {r_new})")
        nw_new = n_words_for(r_new)
        tw = self.tile_words
        n_tiles_new = (nw_new + tw - 1) // tw
        growth = n_tiles_new - self.n_tiles
        cols = []
        for i, old in enumerate(self._cols):
            upd = updates.get(i)
            if not upd and not growth:
                cols.append(old)  # shares classes/packs/stats, immutable
                continue
            if not upd:
                cols.append(
                    dataclasses.replace(
                        old,
                        classes=np.concatenate(
                            [old.classes, np.zeros(growth, np.uint8)]
                        ),
                        kinds=np.concatenate(
                            [old.kinds, np.zeros(growth, np.uint8)]
                        ),
                    )
                )
                continue
            cols.append(self._respliced_column(old, upd, n_tiles_new, growth))
        return TileStore(cols, tile_words=tw, n_words=nw_new, r=r_new,
                         containers=self.containers, device=self.device)

    def _respliced_column(self, old: _Column, upd: dict, n_tiles_new: int,
                          growth: int) -> _Column:
        """One touched column of :meth:`apply_tile_updates`: reclassify +
        recompress the updated tiles, splice untouched payload slices."""
        tw = self.tile_words
        classes = np.concatenate(
            [old.classes, np.zeros(growth, np.uint8)]
        ) if growth else old.classes.copy()
        ut = np.fromiter(upd, np.int64, len(upd))
        if ut.size and not ((0 <= ut) & (ut < n_tiles_new)).all():
            bad = ut[(ut < 0) | (ut >= n_tiles_new)][0]
            raise ValueError(f"tile {bad} outside [0, {n_tiles_new})")
        ut.sort()
        new_words = np.empty((ut.size, tw), np.uint32)
        for j, t in enumerate(ut.tolist()):
            w = np.ascontiguousarray(upd[t], dtype=np.uint32)
            if w.shape != (tw,):
                raise ValueError(
                    f"tile update must be uint32[{tw}], got {w.shape}"
                )
            new_words[j] = w
        # popcount-delta cardinality: new - old for every touched tile
        card = old.cardinality + _popcount_words(new_words)
        in_base = ut < self.n_tiles
        card -= int(_tile_cardinalities(old, ut[in_base], tw).sum())
        new_classes = _classify_tile_words(new_words)
        classes[ut] = new_classes
        nd_mask = new_classes >= TILE_DIRTY
        nkinds, ndense, nspos, nsoff, nruns, nroff = compress_tiles(
            new_words[nd_mask], tw, containers=self.containers
        )
        upd_dirty = ut[nd_mask]  # sorted tile ids of the compressed batch
        kinds = np.concatenate(
            [old.kinds, np.zeros(growth, np.uint8)]
        ) if growth else old.kinds.copy()
        kinds[ut] = 0
        kinds[upd_dirty] = nkinds
        # splice packs in tile order: updated tiles from the new batch,
        # untouched tiles from the old packs -- vectorised per kind (one
        # fancy index per source), never a per-tile Python pass
        old_dense_pos = np.cumsum(old.kinds == CONT_DENSE) - 1
        old_sparse_pos = np.cumsum(old.kinds == CONT_SPARSE) - 1
        old_run_pos = np.cumsum(old.kinds == CONT_RUN) - 1
        new_dense_pos = np.cumsum(nkinds == CONT_DENSE) - 1
        new_sparse_pos = np.cumsum(nkinds == CONT_SPARSE) - 1
        new_run_pos = np.cumsum(nkinds == CONT_RUN) - 1
        dirty_t = np.nonzero(classes >= TILE_DIRTY)[0]
        is_new = np.isin(dirty_t, upd_dirty)
        new_j = np.searchsorted(upd_dirty, dirty_t)  # valid where is_new

        dsel = kinds[dirty_t] == CONT_DENSE
        d_tiles, d_new = dirty_t[dsel], is_new[dsel]
        dense = np.empty((d_tiles.size, tw), np.uint32)
        if (~d_new).any():
            dense[~d_new] = old.dense[old_dense_pos[d_tiles[~d_new]]]
        if d_new.any():
            dense[d_new] = ndense[new_dense_pos[new_j[dsel][d_new]]]

        def splice_var(sel, old_pos, old_off, old_pack, new_pos, new_off,
                       new_pack, empty):
            tiles_k, from_new = dirty_t[sel], is_new[sel]
            counts = np.zeros(tiles_k.size, np.int64)
            o = old_pos[tiles_k[~from_new]] if (~from_new).any() else None
            if o is not None:
                counts[~from_new] = old_off[o + 1] - old_off[o]
            j = new_pos[new_j[sel][from_new]] if from_new.any() else None
            if j is not None:
                counts[from_new] = new_off[j + 1] - new_off[j]
            off = np.zeros(tiles_k.size + 1, np.int64)
            np.cumsum(counts, out=off[1:])
            pack = np.empty((int(off[-1]),) + empty.shape[1:], empty.dtype)
            if o is not None:
                pack[concat_ranges(off[:-1][~from_new], off[1:][~from_new])] = \
                    old_pack[concat_ranges(old_off[o], old_off[o + 1])]
            if j is not None:
                pack[concat_ranges(off[:-1][from_new], off[1:][from_new])] = \
                    new_pack[concat_ranges(new_off[j], new_off[j + 1])]
            return pack, off

        spos, soff = splice_var(
            kinds[dirty_t] == CONT_SPARSE, old_sparse_pos, old.soff, old.spos,
            new_sparse_pos, nsoff, nspos, np.zeros((0,), np.uint16),
        )
        runs, roff = splice_var(
            kinds[dirty_t] == CONT_RUN, old_run_pos, old.roff, old.runs,
            new_run_pos, nroff, nruns, np.zeros((0, 2), np.uint16),
        )
        return _Column(
            classes=classes,
            kinds=kinds,
            dense=dense,
            spos=spos,
            soff=soff,
            runs=runs,
            roff=roff,
            cardinality=card,
        )

    def with_tile_words(self, tile_words: int) -> "TileStore":
        """Reclassify the whole store at a different tile granularity."""
        if tile_words == self.tile_words:
            return self
        return TileStore.from_packed(self.densify(), tile_words=tile_words,
                                     r=self.r, containers=self.containers,
                                     device=self.device)

    def slice_tiles(self, t0: int, t1: int) -> "TileStore":
        """New store over the tile range [t0, t1) -- the row-space shard
        constructor.  Classes, kinds and container packs are sliced, never
        recomputed or reclassified, so carving S shards costs
        O(N * n_tiles) host bookkeeping; each shard carries its own offset
        tables, member statistics and device pack mirrors (built lazily
        like any other store's).  A dense view on the device is sliced as
        a strided view of the parent's (no copy); the shard's device is
        the parent's."""
        t0, t1 = int(t0), int(t1)
        if not 0 <= t0 < t1 <= self.n_tiles:
            raise ValueError(f"tile range [{t0}, {t1}) outside [0, {self.n_tiles})")
        tw = self.tile_words
        w0 = t0 * tw
        nw_local = min(self.n_words, t1 * tw) - w0
        r_local = min(self.r, t1 * tw * 32) - w0 * 32
        if r_local <= 0:
            raise ValueError(f"tile range [{t0}, {t1}) holds no bits of the universe")
        cols = [_slice_column(c, t0, t1, tw) for c in self._cols]
        dense = None
        if self._dense is not None:
            dense = self._dense[:, w0 : w0 + nw_local]
        return TileStore(cols, tile_words=tw, n_words=nw_local, r=r_local,
                         dense=dense, containers=self.containers, device=self.device)

    @classmethod
    def concat_tiles(cls, stores, *, n_words: int | None = None,
                     r: int | None = None) -> "TileStore":
        """Inverse of :meth:`slice_tiles`: stitch tile-range stores back
        into one on the first store's device.  Classes and container packs
        are concatenated per column -- nothing is reclassified, the shards
        already hold the answer."""
        stores = list(stores)
        first = stores[0]
        tw = first.tile_words
        if any(s.tile_words != tw or s.n != first.n for s in stores):
            raise ValueError("stores must share tile_words and column count")
        if n_words is None:
            n_words = sum(s.n_words for s in stores)
        if r is None:
            r = sum(s.r for s in stores)
        cols = [
            _concat_columns([s._cols[i] for s in stores])
            for i in range(first.n)
        ]
        dense = None
        if all(s._dense is not None for s in stores):
            dense = torch.cat([s._dense.to(first.device) for s in stores], dim=1)
        return cls(cols, tile_words=tw, n_words=n_words, r=r, dense=dense,
                   containers=first.containers, device=first.device)

    # -- accessors ---------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self._cols)

    @property
    def classes_word(self) -> np.ndarray:
        """Word-level classes (ZERO/ONE/DIRTY) -- all execution needs."""
        return self._classes_word

    @property
    def classes(self) -> np.ndarray:
        """Full classes incl. RUN tags (triggers the lazy bit-level pass)."""
        self._bit_refine()
        return self._refined_classes

    @property
    def col_stats(self) -> tuple:
        """Per-column :class:`ColumnStats` (triggers the lazy bit pass)."""
        self._bit_refine()
        return self._col_stats

    def _bit_refine(self) -> None:
        if self._col_stats is not None:
            return
        padded = self._padded_host()
        refined = self._classes_word.copy()
        stats = []
        for i, c in enumerate(self._cols):
            rc, run_mask = _bit_stats(
                padded[i], self._classes_word[i], self.tile_words, self.r
            )
            refined[i][run_mask] = TILE_RUN
            n_dirty = int((self._classes_word[i] >= TILE_DIRTY).sum())
            stats.append(
                ColumnStats(
                    cardinality=c.cardinality,
                    density=c.cardinality / max(self.r, 1),
                    runcount=rc,
                    n_dirty_tiles=n_dirty,
                    clean_fraction=1.0 - n_dirty / max(self.n_tiles, 1),
                )
            )
        self._refined_classes = refined
        self._col_stats = tuple(stats)

    def _padded_host(self) -> np.ndarray:
        """Host uint32[N, n_tiles * tile_words] reconstructed from tiles."""
        out = np.zeros((self.n, self.n_tiles, self.tile_words), np.uint32)
        out[self._classes_word == TILE_ONE] = 0xFFFFFFFF
        out[self._classes_word >= TILE_DIRTY] = self._dirty_np
        return out.reshape(self.n, -1)

    @property
    def cardinalities(self) -> tuple:
        return tuple(c.cardinality for c in self._cols)

    @property
    def densities(self) -> tuple:
        return tuple(c.cardinality / max(self.r, 1) for c in self._cols)

    @property
    def runcounts(self) -> tuple:
        return tuple(s.runcount for s in self.col_stats)

    @property
    def clean_fraction(self) -> float:
        """Fraction of (column, tile) pairs that are all-zero/all-one."""
        if self._classes_word.size == 0:
            return 1.0
        return float((self._classes_word <= TILE_ONE).mean())

    @property
    def dirty_words(self) -> int:
        """Words a dense dirty pack would hold (the legacy metric; see
        :meth:`storage_words` for what the containers actually occupy)."""
        return int((self._classes_word >= TILE_DIRTY).sum()) * self.tile_words

    def densify(self) -> torch.Tensor:
        """Dense int32[N, n_words] view on the store's device (cached) for
        dense-path backends."""
        if self._dense is None:
            self._dense = to_words(
                np.ascontiguousarray(self._padded_host()[:, : self.n_words]), self.device
            )
        return self._dense

    def column(self, i: int) -> torch.Tensor:
        return self.densify()[int(i)]

    def block_stats(self):
        """Legacy 3-class view (ZERO/ONE/DIRTY) for ``rbmrg_block``."""
        from .tiles import BlockStats

        return BlockStats(classes=self._classes_word.copy(),
                          tile_words=self.tile_words, n_words=self.n_words)

    def _column_summaries(self) -> "_ColumnSummaries":
        """Per-column figures that member statistics sum (built once)."""
        if self._summaries is None:
            cls, kinds = self._classes_word, self.container_kinds
            self._summaries = _ColumnSummaries(
                dirty=(cls >= TILE_DIRTY).sum(axis=1),
                containers=np.stack(
                    [(kinds == k).sum(axis=1)
                     for k in (CONT_DENSE, CONT_SPARSE, CONT_RUN)], axis=1
                ),
                words=self.storage_words_cell.sum(axis=1, dtype=np.int64),
                clean=tuple(np.flatnonzero(row <= TILE_ONE) for row in cls),
            )
        return self._summaries

    def member_stats(self, slots=None) -> MemberStats:
        """Planner-facing aggregate over a member subset (default: all).
        Cached per subset (the store is immutable).

        Sums of per-column summaries, except the tile-class signatures: a
        tile where no member is clean has the all-DIRTY signature, which
        sorts last, so the signature pass reads only the union ``U`` of the
        members' clean tiles -- none at all on a dense index."""
        key = None if slots is None else tuple(slots)
        cached = self._member_stats_cache.get(key)
        if cached is not None:
            return cached
        idx = np.arange(self.n) if slots is None else np.asarray(list(key))
        if idx.size == 0:
            stats = MemberStats(0, self.n_words, self.tile_words, 1.0, 0.0, 0, 0)
            self._member_stats_cache[key] = stats
            return stats
        summ = self._column_summaries()
        dirty_tiles = int(summ.dirty[idx].sum())
        dens = [self._cols[i].cardinality / max(self.r, 1) for i in idx]
        clean = [summ.clean[i] for i in idx if summ.clean[i].size]
        signatures, scanned, case3 = [], 0, 0
        if clean:
            union = np.zeros(self.n_tiles, bool)
            for c in clean:
                union[c] = True
            cls = self._classes_word[idx]
            if not union.all():
                cls = cls[:, np.flatnonzero(union)]
            sigs, counts = _signature_counts(cls)
            signatures = [
                (int(cnt), int((sig == TILE_ONE).sum()),
                 int((sig >= TILE_DIRTY).sum()))
                for sig, cnt in zip(sigs, counts)
            ]
            scanned = cls.shape[1]
            case3 = int((cls >= TILE_DIRTY).any(axis=0).sum())
            _STATS_SCAN.inc()
            _STATS_TILES_B.inc(scanned)
        else:
            _STATS_SUMMARY.inc()
        rest = self.n_tiles - scanned  # tiles where every member is dirty
        if rest:
            signatures.append((rest, 0, int(idx.size)))
        cont = summ.containers[idx].sum(axis=0)
        stats = MemberStats(
            n=int(idx.size),
            n_words=self.n_words,
            tile_words=self.tile_words,
            clean_fraction=1.0 - dirty_tiles / max(idx.size * self.n_tiles, 1),
            density=float(np.mean(dens)),
            dirty_words=dirty_tiles * self.tile_words,
            case3_tiles=rest + case3,
            signatures=tuple(signatures),
            container_tiles=tuple(int(x) for x in cont),
            compressed_words=int(summ.words[idx].sum()),
        )
        self._member_stats_cache[key] = stats
        return stats
