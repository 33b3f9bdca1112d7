"""The paper's synthetic bitmap datasets and similarity-query workloads (5.3, 5.4).

Generators mirror the paper exactly (scaled ranges available):
  * uniform   -- |B_i| = card elements drawn uniformly from [0, r)
  * clustered -- |B_i| elements in runs (Anh & Moffat-style clustered sets)
with the paper's three densities: dense r = 3 * card, moderate r = 100 * card,
sparse r = 1000 * card (paper used card = 10_000, seed 1111).

Similarity queries (5.4): pick a row id, select the N bitmaps whose sets
contain it; when fewer than N qualify, replicate bitmaps (the paper's
weighted-threshold trick); when more, take the first N.

The sets and query selections are host numpy, drawn from the same seeded
generators as the reference's, so both packages produce the same data.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bitmaps import from_positions
from repro_torch.device import to_numpy_u32


def uniform_set(rng: np.random.Generator, card: int, r: int) -> np.ndarray:
    return np.sort(rng.choice(r, size=min(card, r), replace=False))


def clustered_set(rng: np.random.Generator, card: int, r: int) -> np.ndarray:
    """Clustered generation following Anh & Moffat: recursively split the
    budget into runs of consecutive integers."""
    out: list[int] = []

    def fill(lo: int, hi: int, n: int):
        if n <= 0 or lo >= hi:
            return
        if n >= hi - lo:
            out.extend(range(lo, hi))
            return
        mid = int(rng.integers(lo, hi))
        left = int(rng.hypergeometric(mid - lo, hi - mid, n)) if hi > mid else n
        fill(lo, mid, left)
        fill(mid, hi, n - left)

    fill(0, r, card)
    return np.array(sorted(set(out)), dtype=np.int64)


def synthetic_dataset(
    kind: str = "uniform",
    density: str = "dense",
    n_bitmaps: int = 64,
    card: int = 10_000,
    seed: int = 1111,
    *,
    device=None,
):
    """Returns (packed uint32 [N, n_words] as numpy, r, position lists).

    Each bitmap is built by ``core.bitmaps.from_positions`` on ``device``
    (default: the CUDA card) and read back, as the reference builds its
    bitmaps on its default device."""
    r = {"dense": 3 * card, "moderate": 100 * card, "sparse": 1000 * card}[density]
    rng = np.random.default_rng(seed)
    gen = uniform_set if kind == "uniform" else clustered_set
    lists = [gen(rng, card, r) for _ in range(n_bitmaps)]
    packed = np.stack([to_numpy_u32(from_positions(l, r, device)) for l in lists])
    return packed, r, lists


def similarity_query(lists: list[np.ndarray], n: int, rid: int | None = None, seed: int = 0):
    """Select N bitmap indices for a similarity query on ``rid`` (5.4)."""
    rng = np.random.default_rng(seed)
    if rid is None:
        rid = int(rng.integers(0, max(int(l[-1]) for l in lists if len(l)) + 1))
    hits = [i for i, l in enumerate(lists) if len(l) and np.searchsorted(l, rid) < len(l) and l[np.searchsorted(l, rid)] == rid]
    if not hits:
        hits = [int(rng.integers(0, len(lists)))]
    if len(hits) >= n:
        return hits[:n], rid
    # replicate (the paper's weighted-threshold trick)
    reps = [hits[i % len(hits)] for i in range(n)]
    return reps, rid
