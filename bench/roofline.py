"""The yardstick of the kernels' roofline: the least bytes a query needs.

A column is counted as the best compressed store would hold it: each tile
of ``tile_words`` words at the least of its dense size (4 bytes a word),
its array size (2 bytes a set row) and its run size (4 bytes a run), and an
all-zero or all-one tile at 0.  A query needs the tiles of every column it
reads, plus its result (4 bytes a word).  This reads only the data the
benchmark made, never the program's store, plan or circuit.
"""
from __future__ import annotations

import torch

from bench.common import popcount64, words_from_int32

#: One NVIDIA H100 SXM's HBM3 bandwidth, NVIDIA's data sheet, at 700 W.
PEAK_BYTES_PER_S = 3.35e12


def tile_bytes(columns: torch.Tensor, tile_words: int) -> torch.Tensor:
    """int64 [N, n_tiles]: the least bytes of each tile of each column."""
    n, n_words = columns.shape
    n_tiles = (n_words + tile_words - 1) // tile_words
    out = torch.empty(n, n_tiles, dtype=torch.int64, device=columns.device)
    for c in range(n):
        w = torch.zeros(n_tiles * tile_words, dtype=torch.int64, device=columns.device)
        w[:n_words] = words_from_int32(columns[c])
        w = w.view(n_tiles, tile_words)
        prev_msb = torch.zeros_like(w)
        prev_msb[:, 1:] = w[:, :-1] >> 31
        starts = w & ~(((w << 1) & 0xFFFFFFFF) | prev_msb)
        card = popcount64(w).sum(1)
        runs = popcount64(starts).sum(1)
        size = torch.minimum(torch.minimum(torch.full_like(card, 4 * tile_words), 2 * card), 4 * runs)
        clean = (card == 0) | (card == 32 * tile_words)
        out[c] = torch.where(clean, torch.zeros_like(size), size)
    return out


def query_bytes(cols_read, per_column_bytes, n_words: int) -> int:
    """Least bytes of one query: the columns it reads, and its result."""
    return int(sum(int(per_column_bytes[c]) for c in cols_read)) + 4 * n_words
