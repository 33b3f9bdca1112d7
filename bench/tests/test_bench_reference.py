"""The plain reference against a brute-force count of bits on small data."""
import numpy as np
import pytest
import torch

import _bench  # noqa: F401
from bench import reference, templates
from bench.common import words_to_int32


def _pack(bits: np.ndarray) -> torch.Tensor:
    n, r = bits.shape
    padded = np.zeros((n, (r + 31) // 32 * 32), bool)
    padded[:, :r] = bits
    w = (padded.reshape(n, -1, 32).astype(np.int64) << np.arange(32)).sum(-1)
    return words_to_int32(torch.from_numpy(w))


def _unpack(words: torch.Tensor, r: int) -> np.ndarray:
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    return ((w[:, None] >> np.arange(32)) & 1).reshape(-1)[:r].astype(bool)


def _brute(bits: np.ndarray, spec: dict) -> np.ndarray:
    m = bits[spec["members"]].astype(int)
    if spec["kind"] == "weighted":
        s = (m * np.asarray(spec["weights"])[:, None]).sum(0)
        return s >= spec["t"]
    c = m.sum(0)
    if spec["kind"] == "threshold":
        return c >= spec["t"]
    if spec["kind"] == "interval":
        return (c >= spec["lo"]) & (c <= spec["hi"])
    return (c >= spec["t"]) & ~bits[spec["drop"]]


@pytest.mark.parametrize("kind", ["threshold", "interval", "weighted", "andnot"])
@pytest.mark.parametrize("n_read", [8, 12, 16])
@pytest.mark.parametrize("r", [1000, 4096, 5003])
def test_evaluate_matches_a_brute_force_count(kind, n_read, r):
    rng = np.random.default_rng(r * 31 + n_read)
    bits = rng.random((16, r)) < rng.uniform(0.05, 0.7, size=(16, 1))
    t = int(rng.integers(2, n_read - 1))
    params = {"threshold": {"t": t}, "andnot": {"t": t}, "weighted": {"weights": [1, 2, 3, 4]},
              "interval": {"lo": 2, "hi": int(rng.integers(3, n_read // 2 + 1))}}
    spec = templates.draw_spec(rng, kind, n_read, 16, params)
    got = reference.evaluate(_pack(bits), spec, r, block_words=7)
    assert np.array_equal(_unpack(got, r), _brute(bits, spec))
    assert reference.mismatched_words(got, _pack(_brute(bits, spec)[None])[0]) == 0


def test_tail_bits_past_the_universe_stay_clear():
    r = 70
    bits = np.ones((4, r), bool)
    words = _pack(bits)
    words[:, -1] = -1  # rows past r set in the input
    got = reference.evaluate(words, {"kind": "threshold", "members": [0, 1, 2, 3], "t": 2}, r)
    assert int(got[-1]) & ~((1 << (r - 64)) - 1) == 0


def test_apply_update_sets_before_clears():
    r = 256
    words = _pack(np.zeros((2, r), bool))
    reference.apply_update(words, 1, np.array([3, 40, 40, 200]), np.array([40, 7]))
    got = _unpack(words[1], r)
    assert sorted(np.nonzero(got)[0].tolist()) == [3, 200]
    assert not _unpack(words[0], r).any()


def test_count_bits_saturate():
    r = 64
    bits = np.ones((20, r), bool)
    spec = {"kind": "threshold", "members": list(range(20)), "t": 16}
    exact = reference.evaluate(_pack(bits), spec, r)
    nibble = reference.evaluate(_pack(bits), spec, r, count_bits=4)
    assert _unpack(exact, r).all() and not _unpack(nibble, r).any()
