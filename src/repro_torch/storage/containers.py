"""Compressed tile containers: sparse position lists and run intervals.

The paper's premise is that threshold/symmetric queries stay cheap
*because* the operands are compressed bitmaps that can be combined without
full materialization; Roaring showed the winning realisation is a hybrid
of array ("sparse"), run and bitmap containers chosen per chunk.  This
module is that idea at our tile granularity:

  * a dirty tile whose popcount ``p`` is at or below
    :func:`sparse_max_positions` can be stored as a **sparse container**:
    the sorted in-tile bit positions as uint16 (``ceil(p/2)`` words
    instead of ``tile_words``);
  * a dirty tile with at most :func:`run_max_intervals` maximal 1-runs can
    be stored as a **run container**: (start, end) uint16 endpoint pairs,
    end exclusive (``i`` words for ``i`` intervals);
  * everything else stays a **dense container** -- the classic packed
    dirty-tile words.

Classification picks the cheapest eligible representation (ties prefer
run over sparse over dense).  Containers only exist for dirty tiles --
all-zero / all-one tiles remain pure metadata, exactly as before.

:func:`rasterize_toggles` turns interval endpoints into packed words with
a branch-free prefix-XOR: it decodes run containers, and it rasterizes the
value changes of :func:`evaluate_event_tiles`, the container-native
residual evaluation that the tiled executor's ``merge`` engine runs on the
host (the oracle its device ``scan`` engine is held against).

This module is host-side numpy: words are ``uint32`` here and become
``int32`` tensors only at the device boundary (``repro_torch.device``).

Positions are tile-local, so uint16 works for any ``tile_words * 32 <=
65535`` (the default 64-word tile spans 2048 bits); larger tiles fall
back to dense containers (:func:`containers_supported`).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "CONT_NONE",
    "CONT_DENSE",
    "CONT_SPARSE",
    "CONT_RUN",
    "CONTAINER_CROSSOVER",
    "containers_supported",
    "sparse_max_positions",
    "run_max_intervals",
    "compress_tiles",
    "popcounts",
    "interval_counts",
    "sparse_from_words",
    "runs_from_words",
    "words_from_sparse",
    "words_from_runs",
    "rasterize_toggles",
    "concat_ranges",
    "truth_table_bits",
    "evaluate_event_tiles",
]

# container kind of a tile (a refinement of the word-level DIRTY class;
# clean tiles are CONT_NONE -- they store nothing)
CONT_NONE, CONT_DENSE, CONT_SPARSE, CONT_RUN = 0, 1, 2, 3

#: the executor evaluates a residual tile container-natively (boundary
#: events instead of a densified gather) when the tile's compressed words
#: are at most this fraction of the dense gather ``m * tile_words``.  At
#: 1.0 the event path runs exactly when it reads fewer words than the
#: dense path would -- the planner prices the same split.
CONTAINER_CROSSOVER = 1.0


def containers_supported(tile_words: int) -> bool:
    """uint16 tile-local positions need span <= 65535 bits."""
    return int(tile_words) * 32 <= 0xFFFF


def sparse_max_positions(tile_words: int) -> int:
    """Sparse eligibility threshold on popcount.

    ``2 * tile_words`` uint16 positions occupy exactly ``tile_words``
    words -- the storage-parity point with a dense container (and the same
    span fraction as Roaring's 4096-of-65536 array-container bound).
    """
    return 2 * int(tile_words)


def run_max_intervals(tile_words: int) -> int:
    """Run eligibility threshold on the number of maximal 1-runs.

    ``tile_words // 2`` interval pairs occupy half a dense container, so a
    run container is never a regression even against sparse."""
    return max(1, int(tile_words) // 2)


if hasattr(np, "bitwise_count"):  # numpy >= 2.0

    def popcounts(tiles: np.ndarray) -> np.ndarray:
        """Per-row popcount of uint32[m, tile_words]."""
        return np.bitwise_count(tiles).sum(axis=1, dtype=np.int64)

else:
    _POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)

    def popcounts(tiles: np.ndarray) -> np.ndarray:
        return (
            _POP8[tiles.view(np.uint8)]
            .reshape(tiles.shape[0], -1)
            .sum(axis=1, dtype=np.int64)
        )


def _rise_fall_masks(tiles: np.ndarray):
    """Bit masks of 0->1 ("rise") and 1->0 ("fall") transitions per tile.

    Transitions are tile-local: the bit before position 0 counts as 0, so
    a rise at bit p means a maximal 1-run starts at p, and a fall at p
    means one ended at p (exclusive).  A run reaching the tile's last bit
    has no fall mask bit -- its end is the span (handled by the caller).
    """
    prev = tiles << np.uint32(1)
    if tiles.shape[1] > 1:
        prev[:, 1:] |= tiles[:, :-1] >> np.uint32(31)
    rise = tiles & ~prev
    fall = ~tiles & prev
    return rise, fall


def interval_counts(tiles: np.ndarray) -> np.ndarray:
    """Number of maximal 1-runs per tile of uint32[m, tile_words]."""
    rise, _ = _rise_fall_masks(tiles)
    return popcounts(rise)


def _bit_positions(masks: np.ndarray):
    """(row, bit position) of every set bit, row-major sorted."""
    m = masks.shape[0]
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bits = np.unpackbits(
        masks.view(np.uint8).reshape(m, -1), axis=1, bitorder="little"
    )
    return np.nonzero(bits)


def concat_ranges(starts: np.ndarray, stops: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(starts[i], stops[i])`` -- the variable-length
    pack gather (sparse positions / run pairs of many tiles in one take)."""
    counts = (stops - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.repeat(starts - cum0, counts) + np.arange(total)


def sparse_from_words(tiles: np.ndarray):
    """uint32[m, tw] -> (positions uint16[P], offsets int64[m + 1])."""
    rows, pos = _bit_positions(tiles)
    off = np.zeros(tiles.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=tiles.shape[0]), out=off[1:])
    return pos.astype(np.uint16), off


def runs_from_words(tiles: np.ndarray):
    """uint32[m, tw] -> (runs uint16[I, 2] (start, end-exclusive), offsets
    int64[m + 1] in interval units, tile order)."""
    m, tw = tiles.shape
    span = tw * 32
    rise, fall = _rise_fall_masks(tiles)
    srow, spos = _bit_positions(rise)
    frow, fpos = _bit_positions(fall)
    top = ((tiles[:, -1] >> np.uint32(31)) & 1).astype(np.int64)
    n_starts = np.bincount(srow, minlength=m)
    n_falls = np.bincount(frow, minlength=m)
    off = np.zeros(m + 1, np.int64)
    np.cumsum(n_starts, out=off[1:])
    ends = np.empty(len(spos), np.int64)
    if len(fpos):
        cum0 = np.concatenate([[0], np.cumsum(n_falls)[:-1]])
        ord_in_row = np.arange(len(fpos)) - cum0[frow]
        ends[off[frow] + ord_in_row] = fpos
    trow = np.nonzero(top)[0]
    if len(trow):
        ends[off[trow] + n_falls[trow]] = span
    runs = np.stack([spos, ends], axis=1).astype(np.uint16)
    return runs, off


def words_from_sparse(pos: np.ndarray, off: np.ndarray, tile_words: int
                      ) -> np.ndarray:
    """Inverse of :func:`sparse_from_words`: uint32[m, tile_words]."""
    m = len(off) - 1
    out = np.zeros((m, tile_words), np.uint32)
    if len(pos) == 0:
        return out
    rows = np.repeat(np.arange(m), np.diff(off))
    p = pos.astype(np.int64)
    flat = rows * tile_words + p // 32
    b = np.uint32(1) << (p % 32).astype(np.uint32)
    # positions are sorted per tile, so flat is globally non-decreasing
    fw, start = np.unique(flat, return_index=True)
    out.reshape(-1)[fw] = np.bitwise_or.reduceat(b, start)
    return out


def rasterize_toggles(rows: np.ndarray, bitpos: np.ndarray, m: int,
                      tile_words: int) -> np.ndarray:
    """Bits set between toggle pairs, as packed words uint32[m, tile_words].

    ``bitpos`` entries are in ``[0, span]`` (a toggle at ``span`` falls off
    the tile); duplicate toggles at one position cancel.  Branch-free:
    XOR-scatter the toggles, prefix-XOR within each word by doubling
    shifts, then carry the word parities across the row.
    """
    t = np.zeros((m, tile_words + 1), np.uint32)
    if len(rows):
        flat = rows.astype(np.int64) * (tile_words + 1) + bitpos // 32
        mask = np.uint32(1) << (bitpos % 32).astype(np.uint32)
        order = np.argsort(flat, kind="stable")
        fw, start = np.unique(flat[order], return_index=True)
        t.reshape(-1)[fw] = np.bitwise_xor.reduceat(mask[order], start)
    for sh in (1, 2, 4, 8, 16):
        t ^= t << np.uint32(sh)
    carry = np.bitwise_xor.accumulate((t >> np.uint32(31)).astype(np.uint8),
                                      axis=1)
    cin = np.zeros_like(carry)
    cin[:, 1:] = carry[:, :-1]
    t ^= cin.astype(np.uint32) * np.uint32(0xFFFFFFFF)
    return t[:, :tile_words]


def words_from_runs(runs: np.ndarray, off: np.ndarray, tile_words: int
                    ) -> np.ndarray:
    """Inverse of :func:`runs_from_words`: uint32[m, tile_words]."""
    m = len(off) - 1
    if len(runs) == 0:
        return np.zeros((m, tile_words), np.uint32)
    rows = np.repeat(np.arange(m), np.diff(off))
    return rasterize_toggles(
        np.concatenate([rows, rows]),
        np.concatenate([runs[:, 0].astype(np.int64),
                        runs[:, 1].astype(np.int64)]),
        m,
        tile_words,
    )


def compress_tiles(tiles: np.ndarray, tile_words: int, *,
                   containers: bool = True):
    """Classify + compress a batch of dirty-tile words.

    Returns ``(kinds, dense, spos, soff, runs, roff)`` where ``kinds`` is
    uint8[m] over {CONT_DENSE, CONT_SPARSE, CONT_RUN} and the pack arrays
    hold the per-kind payloads in tile order.  With ``containers=False``
    (or an unsupported tile span) every tile stays dense -- the legacy
    layout, byte-identical to the pre-container store.
    """
    tiles = np.ascontiguousarray(tiles, np.uint32)
    m = tiles.shape[0]
    kinds = np.full(m, CONT_DENSE, np.uint8)
    if containers and containers_supported(tile_words) and m:
        pc = popcounts(tiles)
        iv = interval_counts(tiles)
        cost_sparse = np.where(
            pc <= sparse_max_positions(tile_words), (pc + 1) // 2,
            np.iinfo(np.int64).max,
        )
        cost_run = np.where(
            iv <= run_max_intervals(tile_words), iv, np.iinfo(np.int64).max
        )
        kinds[cost_sparse <= tile_words] = CONT_SPARSE
        kinds[
            (cost_run <= tile_words)
            & (cost_run <= cost_sparse)
        ] = CONT_RUN
    dense = np.ascontiguousarray(tiles[kinds == CONT_DENSE])
    sp = kinds == CONT_SPARSE
    spos, soff = sparse_from_words(tiles[sp])
    rn = kinds == CONT_RUN
    runs, roff = runs_from_words(tiles[rn])
    return kinds, dense, spos, soff, runs, roff


def truth_table_bits(tt: int, n_inputs: int) -> np.ndarray:
    """A circuit output's exact truth table (bigint, bit a = f(combo a))
    as a bool lookup array of size ``2 ** n_inputs``."""
    size = 1 << n_inputs
    raw = tt.to_bytes(max(1, size // 8), "little")
    return np.unpackbits(
        np.frombuffer(raw, np.uint8), bitorder="little"
    )[:size].astype(bool)


def evaluate_event_tiles(rows: np.ndarray, bitpos: np.ndarray,
                         wires: np.ndarray, m: int, tile_words: int,
                         tables: tuple, n_inputs: int) -> np.ndarray:
    """Container-native residual evaluation over boundary events.

    Every sparse position and run interval of a tile's inputs becomes a
    pair of *events* -- bit positions where that input toggles.  Sorting
    the events of a tile and XOR-accumulating per-input masks yields the
    input combination of every segment between consecutive boundaries (the
    merge phase of MergeOpt, vectorised across all tiles at once); each
    output's exact truth table then maps combinations to values, and the
    value *changes* are toggles rasterized into packed words.

    ``rows``/``bitpos``/``wires``: one entry per event (output tile row in
    [0, m), position in [0, span], residual input index).  ``tables`` is
    the tuple of per-output truth-table bigints.  Returns
    uint32[len(tables), m, tile_words].
    """
    k = len(tables)
    out = np.empty((k, m, tile_words), np.uint32)
    order = np.lexsort((bitpos, rows))
    rows = rows[order]
    bitpos = bitpos[order]
    masks = np.uint32(1) << wires[order].astype(np.uint32)
    xacc = np.bitwise_xor.accumulate(masks) if len(masks) else masks
    # reset the accumulator at tile-group starts: combo = xacc ^ carry-in
    starts = np.nonzero(np.diff(rows, prepend=-1))[0]
    if len(rows):
        group_len = np.diff(np.append(starts, len(rows)))
        prev = np.where(starts > 0, xacc[np.maximum(starts - 1, 0)], 0)
        combo = xacc ^ np.repeat(prev, group_len).astype(np.uint32)
    else:
        combo = xacc
    for j, tt in enumerate(tables):
        lut = truth_table_bits(tt, n_inputs)
        background = bool(tt & 1)  # f(all inputs zero)
        vals = lut[combo]
        prevv = np.roll(vals, 1)
        prevv[starts] = background
        chg = vals != prevv
        words = rasterize_toggles(rows[chg], bitpos[chg], m, tile_words)
        out[j] = ~words if background else words
    return out
