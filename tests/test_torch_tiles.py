"""The block-RLE primitives (``storage/tiles.py``) and the ``rbmrg_block``
pruner of the port against the reference, on the cases of
``tests/test_blockrle.py``: equal classes, RUNCOUNTs, result words and
``info`` dicts, key for key."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import clean_fraction_bits, u32
from repro.core.bitmaps import pack as r_pack
from repro.storage import TileStore as RStore
from repro.storage import classify_tiles as r_classify
from repro.storage import rbmrg_block_threshold as r_rbmrg
from repro.storage import runcount as r_runcount
from repro_torch.device import to_words
from repro_torch.storage import BlockStats, TileStore
from repro_torch.storage import classify_tiles as t_classify
from repro_torch.storage import rbmrg_block_threshold as t_rbmrg
from repro_torch.storage import runcount as t_runcount
from repro_torch.storage import tiles as t_tiles


def _clustered(n, r, seed=0, lo=8000, hi=40000):
    """Bitmaps with runs much longer than a tile (EWAH-friendly data)."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, r), bool)
    for i in range(n):
        pos = 0
        while pos < r:
            run = int(rng.integers(lo, hi))
            bits[i, pos:pos + run] = rng.random() < 0.4
            pos += run
    return bits


def _packed(bits):
    return np.asarray(r_pack(jnp.asarray(bits)))


def _const_rows(zero_rows, one_rows, nw, random_rows=0, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.full((one_rows, nw), 0xFFFFFFFF, np.uint32),
        rng.integers(0, 2**32, (random_rows, nw), dtype=np.uint32),
        np.zeros((zero_rows, nw), np.uint32),
    ])


CASES = {
    "clustered_40_tiles": lambda: _packed(_clustered(9, 64 * 32 * 40, seed=1)),
    "clustered_64_tiles": lambda: _packed(_clustered(8, 64 * 32 * 64, seed=2)),
    "dense_random": lambda: _packed(np.random.default_rng(3).random((6, 64 * 32 * 8)) < 0.5),
    "case1_all_one": lambda: _const_rows(0, 4, 64 * 3, random_rows=2),
    "case2_all_zero": lambda: _const_rows(5, 0, 64 * 2, random_rows=2, seed=1),
    "partial_final_tile": lambda: _packed(_clustered(7, (64 * 2 + 17) * 32 - 5, seed=9,
                                                     lo=300, hi=4000)),
    "all_clean_extreme": lambda: _const_rows(3, 5, 64 * 16),
    "clean_fraction": lambda: _packed(clean_fraction_bits(8, 0.6, seed=4)),
    "word_shorter_than_a_tile": lambda: _packed(np.random.default_rng(6).random((5, 300)) < 0.2),
}


@pytest.mark.parametrize("tile_words", (8, 64))
@pytest.mark.parametrize("case", list(CASES))
def test_classify_tiles_equals_reference(case, tile_words):
    words = CASES[case]()
    want = r_classify(jnp.asarray(words), tile_words=tile_words)
    got = t_classify(to_words(words, "cpu"), tile_words=tile_words)
    assert isinstance(got, BlockStats) and got.classes.dtype == np.uint8
    assert np.array_equal(got.classes, want.classes)
    assert (got.tile_words, got.n_words) == (want.tile_words, want.n_words)
    assert got.clean_fraction == want.clean_fraction
    # host arrays go to the named device
    assert np.array_equal(t_classify(words, tile_words, device="cpu").classes, want.classes)


@pytest.mark.parametrize("case", list(CASES))
def test_runcount_equals_reference(case):
    words = CASES[case]()
    assert t_runcount(to_words(words, "cpu")) == r_runcount(jnp.asarray(words))


def test_runcount_degenerate_and_bit_31():
    r = 64 * 32
    alternating = np.zeros((1, r), bool)
    alternating[0, ::2] = True
    half = np.zeros((1, r), bool)
    half[0, : r // 2] = True
    for words in (_packed(alternating), _packed(np.vstack([alternating, half])),
                  np.zeros((1, 64), np.uint32), np.full((1, 64), 0xFFFFFFFF, np.uint32),
                  np.array([[0x80000000, 0x00000001, 0x80000000, 0xFFFFFFFE]], np.uint32)):
        assert t_runcount(words, device="cpu") == r_runcount(jnp.asarray(words))
    assert t_runcount(_packed(alternating), device="cpu") == r


@pytest.mark.parametrize("case", list(CASES))
def test_rbmrg_block_threshold_equals_reference(case):
    words = CASES[case]()
    n = words.shape[0]
    for t in sorted({0, 1, 2, 3, (n + 1) // 2, n - 1, n, n + 1}):
        want, want_info = r_rbmrg(jnp.asarray(words), t, tile_words=64)
        got, got_info = t_rbmrg(to_words(words, "cpu"), t, tile_words=64)
        assert np.array_equal(u32(got), np.asarray(want)), (case, t)
        assert got_info == want_info, (case, t)
        assert all(type(v) in (int, float) for v in got_info.values())


@pytest.mark.parametrize("algorithm", ("ssum", "looped", "csvckt", "scancount", "fused"))
def test_rbmrg_block_threshold_algorithms_and_tile_widths(algorithm):
    words = CASES["clean_fraction"]()
    for tw in (8, 64):
        for t in (2, 3, 5):
            want, want_info = r_rbmrg(jnp.asarray(words), t, tile_words=tw, algorithm=algorithm)
            got, got_info = t_rbmrg(to_words(words, "cpu"), t, tile_words=tw,
                                    algorithm=algorithm)
            assert np.array_equal(u32(got), np.asarray(want)), (algorithm, tw, t)
            assert got_info == want_info


def test_rbmrg_block_threshold_with_given_stats_and_store_block_stats():
    words = CASES["partial_final_tile"]()
    ref_store = RStore.from_packed(jnp.asarray(words))
    store = TileStore.from_packed(to_words(words, "cpu"), device="cpu")
    want_stats, got_stats = ref_store.block_stats(), store.block_stats()
    assert isinstance(got_stats, BlockStats)
    assert np.array_equal(got_stats.classes, want_stats.classes)
    assert (got_stats.tile_words, got_stats.n_words) == (want_stats.tile_words,
                                                         want_stats.n_words)
    assert got_stats.classes is not store.classes_word  # a copy
    for t in (1, 3, 7):
        want, want_info = r_rbmrg(jnp.asarray(words), t, stats=want_stats)
        got, got_info = t_rbmrg(to_words(words, "cpu"), t, stats=got_stats)
        assert np.array_equal(u32(got), np.asarray(want))
        assert got_info == want_info


def test_pruning_accounting_extremes():
    got, info = t_rbmrg(CASES["all_clean_extreme"](), 4, device="cpu")
    assert info["dirty_words_processed"] == 0 and bool((got == -1).all())
    got, info = t_rbmrg(CASES["all_clean_extreme"](), 6, device="cpu")
    assert info["dirty_words_processed"] == 0 and not bool(got.any())
    _, info = t_rbmrg(CASES["dense_random"](), 3, device="cpu")
    assert info["case3_tiles"] == info["n_tiles"]
    _, info = t_rbmrg(CASES["clustered_64_tiles"](), 4, device="cpu")
    assert info["work_fraction"] < 0.5
    assert info["case1_tiles"] + info["case2_tiles"] + info["case3_tiles"] == info["n_tiles"]


def test_blockrle_shim_reexports_storage():
    legacy = importlib.import_module("repro_torch.core.blockrle")
    for name in ("BlockStats", "classify_tiles", "rbmrg_block_threshold", "runcount"):
        assert getattr(legacy, name) is getattr(t_tiles, name)
    assert sorted(legacy.__all__) == sorted(importlib.import_module("repro.core.blockrle").__all__)
