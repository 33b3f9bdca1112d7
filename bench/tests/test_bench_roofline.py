"""The roofline's numerator on a hand-made index."""
import torch

import _bench  # noqa: F401
from bench import roofline
from bench.common import words_to_int32


def _col(words):
    return words_to_int32(torch.tensor(words, dtype=torch.int64))


def test_tile_bytes_take_the_least_container():
    tw = 4  # 4-word tiles, 128 rows
    zero = [0, 0, 0, 0]
    ones = [0xFFFFFFFF] * 4
    one_row = [1, 0, 0, 0]                      # 1 row: array 2 B, 1 run 4 B -> 2
    one_run = [0xFFFF0000, 0xFFFFFFFF, 0xFFFF, 0]  # 48 rows in one run -> 4
    dense = [0x55555555] * 4                    # 64 rows, 64 runs -> dense 16
    spanning = [0, 0, 0, 0x80000000]            # the last row of the tile
    cols = torch.stack([_col(zero + ones + one_row + one_run),
                        _col(dense + spanning + one_row + zero)])
    got = roofline.tile_bytes(cols, tw)
    assert got.tolist() == [[0, 0, 2, 4], [16, 2, 2, 0]]
    per_col = got.sum(1).tolist()
    assert per_col == [6, 20]
    assert roofline.query_bytes([0, 1], per_col, 16) == 6 + 20 + 64
    assert roofline.query_bytes([1], per_col, 16) == 20 + 64


def test_a_run_across_a_tile_boundary_counts_in_both_tiles():
    cols = torch.stack([_col([0, 0, 0, 0x80000000, 1, 0, 0, 0])])
    assert roofline.tile_bytes(cols, 4).tolist() == [[2, 2]]


def test_padding_of_a_last_partial_tile_is_empty():
    cols = torch.stack([_col([0xFFFFFFFF] * 4 + [0xFFFFFFFF] * 2)])
    assert roofline.tile_bytes(cols, 4).tolist() == [[0, 4]]
