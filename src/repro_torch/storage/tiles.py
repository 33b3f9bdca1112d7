"""Tile classification primitives and the RBMRG block pruner (paper 4.1).

Word-granular RLE (EWAH marker words, iterator skipping) is data-dependent
pointer chasing.  The *insight* is kept at tile granularity instead (clean
runs are processed in O(1), only dirty words do bit work):

  * a bitmap is split into tiles of ``tile_words`` words;
  * each tile is classified all-zero / all-one / dirty;
  * for a threshold query, per tile we know k = #all-one inputs and
    d = #dirty inputs, giving the paper's RBMRG 3-case split:
      1. T - k <= 0        -> output tile is all ones      (no bit work)
      2. T - k >  d        -> output tile is all zeros     (no bit work)
      3. otherwise          -> a (T-k)-threshold over the d dirty tiles

Everything runs on the device the words lie on: the classes, the case
split, and the case-3 gather, which is one index operation per
``(#dirty, T - k)`` bucket.  Each bucket is evaluated once as an
``[nd, B * tile_words]`` threshold with the named algorithm (every
threshold algorithm is word-wise, so this equals the reference's ``vmap``
over the bucket's tiles).  The reference copies the whole input to the
host and walks the case-3 tiles in Python.

:func:`rbmrg_block_threshold` is the bare-threshold pruner; the
generalisation to arbitrary compiled circuits is
:func:`repro_torch.storage.tiled.run_tiled_circuit`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import WORD_DTYPE, resolve_device, to_words

__all__ = ["BlockStats", "classify_tiles", "rbmrg_block_threshold", "runcount"]


@dataclasses.dataclass
class BlockStats:
    """Per-(bitmap, tile) classification. 0 = all-zero, 1 = all-one, 2 = dirty."""

    classes: np.ndarray  # uint8 [N, n_tiles]
    tile_words: int
    n_words: int

    @property
    def clean_fraction(self) -> float:
        return float((self.classes != 2).mean())


def _words(bitmaps, device) -> torch.Tensor:
    """int32[N, n_words]: a tensor where it lies, anything else on ``device``."""
    if isinstance(bitmaps, torch.Tensor) and device is None:
        return to_words(bitmaps, bitmaps.device)
    return to_words(bitmaps, resolve_device(device))


def _padded_tiles(arr: torch.Tensor, tile_words: int) -> torch.Tensor:
    """int32[N, n_tiles, tile_words], the last tile zero-padded."""
    n, nw = arr.shape
    n_tiles = (nw + tile_words - 1) // tile_words
    pad = n_tiles * tile_words - nw
    if pad:
        arr = torch.nn.functional.pad(arr, (0, pad))
    return arr.reshape(n, n_tiles, tile_words)


def _classes(tiles: torch.Tensor) -> torch.Tensor:
    """uint8[N, n_tiles] classes of padded tiles, on their device."""
    cls = torch.full(tiles.shape[:2], 2, dtype=torch.uint8, device=tiles.device)
    cls[(tiles == 0).all(dim=2)] = 0
    cls[(tiles == -1).all(dim=2)] = 1
    return cls


def classify_tiles(bitmaps, tile_words: int = 64, *, device=None) -> BlockStats:
    """Tile classification ('index build time' work), computed on the
    device the words lie on (``device``, default the CUDA card, for
    anything that is not a tensor); the classes come back as host numpy."""
    arr = _words(bitmaps, device)
    cls = _classes(_padded_tiles(arr, tile_words))
    return BlockStats(classes=cls.cpu().numpy(), tile_words=tile_words,
                      n_words=int(arr.shape[1]))


def runcount(bitmaps, *, device=None) -> int:
    """Paper's RUNCOUNT: total number of 0/1 runs across the collection
    (over every bit of every word, as the reference counts)."""
    from repro_torch.core.bitmaps import popcount

    arr = _words(bitmaps, device)
    # transitions between bit j and bit j + 1 inside a word (bits 0..30) ...
    inner = popcount((arr ^ ((arr >> 1) & 0x7FFFFFFF)) & 0x7FFFFFFF).sum(dim=1)
    # ... and between bit 31 of a word and bit 0 of the next one
    across = ((((arr[:, :-1] >> 31) & 1) ^ (arr[:, 1:] & 1))).sum(dim=1)
    return int((inner + across + 1).sum().item())


def _evaluate_bucket(rows: torch.Tensor, tt: int, algorithm: str) -> torch.Tensor:
    """theta(tt) over ``rows`` int32[nd, words], the OR / AND folds at the
    ends as in the reference."""
    from repro_torch.query.executors import _wide_and, _wide_or, run_threshold_backend

    if tt == 1:
        return _wide_or(rows)
    if tt == rows.shape[0]:
        return _wide_and(rows)
    return run_threshold_backend(rows, tt, algorithm)


def rbmrg_block_threshold(bitmaps, t: int, stats: BlockStats | None = None,
                          tile_words: int = 64, algorithm: str = "ssum", *, device=None):
    """Threshold with RBMRG-style clean/dirty pruning at tile granularity.

    Returns ``(packed result int32[n_words], info dict)`` on the words'
    device.  ``info`` reports how much bit-level work the pruning skipped --
    the paper's Table 4 claim that run-aware merging does O(RUNCOUNT log N)
    instead of O(rN/W) work -- and equals the reference's key for key.
    """
    arr = _words(bitmaps, device)
    n, nw = arr.shape
    dev = arr.device
    if stats is None:
        stats = classify_tiles(arr, tile_words)
    tw = stats.tile_words
    n_tiles = stats.classes.shape[1]
    tiles = _padded_tiles(arr, tw)
    cls = torch.from_numpy(np.ascontiguousarray(stats.classes)).to(dev)
    k = (cls == 1).sum(dim=0)  # all-one inputs per tile
    d = (cls == 2).sum(dim=0)  # dirty inputs per tile
    case1 = (t - k) <= 0
    case2 = (t - k) > d
    case3 = ~(case1 | case2)
    out = torch.zeros((n_tiles, tw), dtype=WORD_DTYPE, device=dev)
    out[case1] = -1

    dirty_words_processed = 0
    idx3 = torch.nonzero(case3).squeeze(1)
    if idx3.numel():
        # bucket the case-3 tiles by (#dirty, residual threshold): one gather
        # and one evaluation per bucket
        keys = d[idx3] * (n + 2) + (t - k[idx3])
        uniq, inverse = torch.unique(keys, return_inverse=True)
        for b, key in enumerate(uniq.tolist()):
            nd, tt = divmod(int(key), n + 2)
            tis = idx3[inverse == b]
            # the dirty rows of each tile, ascending: nd per tile
            rows = torch.nonzero((cls[:, tis] == 2).T)[:, 1].view(-1, nd)
            gathered = tiles[rows, tis[:, None]]  # [B, nd, tw]
            dirty_words_processed += gathered.numel()
            flat = gathered.transpose(0, 1).reshape(nd, -1)
            out[tis] = _evaluate_bucket(flat, tt, algorithm).view(-1, tw)
    info = {
        "n_tiles": int(n_tiles),
        "case1_tiles": int(case1.sum().item()),
        "case2_tiles": int(case2.sum().item()),
        "case3_tiles": int(case3.sum().item()),
        "dirty_words_processed": int(dirty_words_processed),
        "total_words": int(n * nw),
        "work_fraction": float(dirty_words_processed) / max(1, n * nw),
    }
    return out.view(-1)[:nw], info
