"""Shared helpers of the tests/test_torch_*.py parity tests.

Every test feeds the same numpy-seeded bits to the JAX reference (``repro``)
and to the PyTorch port (``repro_torch``, on ``device="cpu"``) and compares
packed ``uint32`` words with ``np.array_equal``: results are bitmaps, so the
tolerance is none.
"""
import numpy as np
import torch

from repro_torch.device import to_numpy_u32, to_words

TILE_BITS = 64 * 32


def words(n, nw, seed=0):
    """uint32[n, nw] random words (top bits set about half the time)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, nw), dtype=np.uint32)


def t_words(arr) -> torch.Tensor:
    return to_words(arr, "cpu")


def u32(x) -> np.ndarray:
    """A port result (tensor) or a reference result (jax array) as numpy uint32."""
    if isinstance(x, torch.Tensor):
        return to_numpy_u32(x)
    return np.asarray(x, dtype=np.uint32)


def clean_fraction_bits(n, clean_fraction, seed, n_tiles=5, tail_bits=700):
    """Columns with ~clean_fraction all-zero/all-one tiles + a partial tile."""
    rng = np.random.default_rng(seed)
    r = n_tiles * TILE_BITS + tail_bits
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for tj in range(n_tiles + 1):
            lo, hi = tj * TILE_BITS, min((tj + 1) * TILE_BITS, r)
            u = rng.random()
            if u < clean_fraction / 2:
                pass
            elif u < clean_fraction:
                bits[i, lo:hi] = True
            else:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.35
    return bits


def container_mix_bits(n, seed, n_tiles=6, tail_bits=333):
    """Columns whose dirty tiles are a mix of sparse (a few bits), runny (a
    few long runs) and dense (35% random) content, plus clean tiles."""
    rng = np.random.default_rng(seed)
    r = n_tiles * TILE_BITS + tail_bits
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for tj in range(n_tiles + 1):
            lo, hi = tj * TILE_BITS, min((tj + 1) * TILE_BITS, r)
            kind = rng.integers(0, 5)
            if kind == 0:
                continue
            if kind == 1:
                bits[i, lo:hi] = True
            elif kind == 2:  # sparse
                pos = rng.integers(lo, hi, size=rng.integers(1, 20))
                bits[i, pos] = True
            elif kind == 3:  # a few runs
                for _ in range(rng.integers(1, 4)):
                    a = rng.integers(lo, hi)
                    bits[i, a:min(hi, a + rng.integers(1, 400))] = True
            else:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.35
    return bits
