"""The generators: exact cardinality, distinct sorted rows, the same words
for the same seed, and the vectorised ClusterData against the recursive one."""
import numpy as np
import pytest
import torch

import _bench  # noqa: F401
from bench.common import popcount64, words_from_int32
from bench.datagen import clustered, uniform


def _positions(words: torch.Tensor) -> np.ndarray:
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    return np.nonzero(((w[:, None] >> np.arange(32)) & 1).reshape(-1))[0]


def _runs(pos: np.ndarray) -> np.ndarray:
    """Lengths of the runs of consecutive rows in sorted positions."""
    if pos.size == 0:
        return pos
    breaks = np.nonzero(np.diff(pos) != 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks + 1, [pos.size]])
    return ends - starts


@pytest.mark.parametrize("mod,per_card,block", [(uniform, 3, None), (clustered, 100, None),
                                               (clustered, 3, None), (clustered, 100, 4096)])
@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 1])
def test_exact_card_and_same_words_for_the_same_seed(mod, per_card, block, seed):
    r = 100_003
    cfg = {"columns": 5, "universe": r, "card": r // per_card}
    if block:
        cfg["block_rows"] = block
    a = mod.generate(cfg, seed, "cpu")
    assert a.dtype == torch.int32 and a.shape == (5, (r + 31) // 32)
    assert popcount64(words_from_int32(a)).sum(1).tolist() == [r // per_card] * 5
    assert torch.equal(a, mod.generate(cfg, seed, "cpu"))
    assert not torch.equal(a, mod.generate(cfg, seed + 1, "cpu"))
    for row in a:
        pos = _positions(row)
        assert pos.max() < r


def test_cluster_data_recursive_is_sorted_distinct_and_exact():
    rng = np.random.default_rng(3)
    for card, r in ((1, 10), (10, 10), (100, 1000), (1000, 3000)):
        out = clustered.cluster_data(rng, card, r)
        assert out.size == card and np.all(np.diff(out) > 0) and out[0] >= 0 and out[-1] < r


@pytest.mark.parametrize("per_card,blocks", [(3, 1), (100, 1), (100, 8)])
def test_run_lengths_are_distributed_like_the_recursive_original(per_card, blocks):
    """Mean run length and the share of single-row runs, over many sets."""
    r, n = 1 << 16, 192
    card = r // per_card
    cfg = {"columns": n, "universe": r, "card": card, "block_rows": r // blocks}
    vec = clustered.generate(cfg, 11, "cpu")
    runs_v = np.concatenate([_runs(_positions(row)) for row in vec])
    rng = np.random.default_rng(11)
    _, first, last, budget = clustered.blocks(1, r, card, r // blocks, "cpu")
    runs_r = np.concatenate([
        _runs(np.concatenate([int(a) + clustered.cluster_data(rng, int(c), int(b) - int(a) + 1)
                              for a, b, c in zip(first, last, budget)]))
        for _ in range(n)])
    assert runs_v.sum() == runs_r.sum() == n * card
    assert abs(runs_v.mean() / runs_r.mean() - 1) < 0.05
    assert abs((runs_v == 1).mean() - (runs_r == 1).mean()) < 0.03
    # clustered, not uniform: far longer runs than a uniform set's
    uni = uniform.generate({"columns": n, "universe": r, "card": card}, 11, "cpu")
    runs_u = np.concatenate([_runs(_positions(row)) for row in uni])
    assert runs_v.mean() > 1.1 * runs_u.mean()


def test_blocks_hold_their_share_of_the_budget():
    r, block, card = 40_000, 4096, 1_000
    words = clustered.generate({"columns": 3, "universe": r, "card": card, "block_rows": block},
                               8, "cpu")
    for row in words:
        pos = _positions(row)
        per_block = np.bincount(pos // block, minlength=(r + block - 1) // block)
        assert per_block.sum() == card
        sizes = np.minimum(block, r - np.arange(per_block.size) * block)
        assert np.all(np.abs(per_block - sizes * card / r) <= 1)
