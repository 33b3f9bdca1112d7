"""Shared pieces of the harness: clocks, quantiles, seeds, module lookup."""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def time_call(fn, *args, **kw):
    """A call, then a device synchronise: the result is on the device when
    this returns (frozen copy of the port's benchmark helper)."""
    out = fn(*args, **kw)
    sync(out)
    return out


def sync(t=None) -> None:
    """Wait for the device that ``t`` lives on (every CUDA device if None)."""
    if isinstance(t, torch.Tensor):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (``tag``) of a run's ``--seed``; any
    whole number is accepted, negative or past 64 bits."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             (int(seed) >> 64) & 0xFFFFFFFF, 1 if seed < 0 else 0]
    words += [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def quantile(values, q: float) -> float:
    """The ``q`` quantile by linear interpolation between order statistics
    (numpy's default rule), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = (len(xs) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one file of the harness by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_part_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def words_to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as int32 words with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def words_from_int32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned values in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 value below 2**32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def pack_positions(col: torch.Tensor, pos: torch.Tensor, n_cols: int, n_words: int) -> torch.Tensor:
    """int32 [n_cols, n_words] with bit ``pos[i]`` of column ``col[i]`` set;
    the (col, pos) pairs must be distinct."""
    flat = col * n_words + (pos >> 5)
    acc = torch.zeros(n_cols * n_words, dtype=torch.int64, device=pos.device)
    acc.index_add_(0, flat, torch.ones_like(pos) << (pos & 31))
    return words_to_int32(acc).view(n_cols, n_words)


class Sampler:
    """A seeded reservoir of ``k`` items (the same picks for the same count)."""

    def __init__(self, k: int, seed: int, tag: str):
        self.k = k
        self.rng = np.random.default_rng(derive_seed(seed, tag))
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item
