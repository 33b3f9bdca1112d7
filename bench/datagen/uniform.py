"""Uniform sets (Kaser & Lemire, arXiv:1402.4073, 5.3): each column holds
``card`` rows drawn uniformly without replacement from ``[0, universe)``.

Made on the device from the seed, one ``randperm`` a column: the port's
``data/paper_datasets.py::uniform_set`` (a host ``choice`` without
replacement), drawn at scale on the card.
"""
from __future__ import annotations

import torch

from bench.common import derive_seed, pack_positions


def generate(cfg: dict, seed: int, device) -> torch.Tensor:
    """int32 [columns, universe / 32] packed words on ``device``."""
    n, r, card = int(cfg["columns"]), int(cfg["universe"]), int(cfg["card"])
    n_words = (r + 31) // 32
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, "data"))
    out = torch.empty(n, n_words, dtype=torch.int32, device=device)
    zero = torch.zeros(card, dtype=torch.int64, device=device)
    for c in range(n):
        pos = torch.randperm(r, generator=g, device=device)[:card]
        out[c] = pack_positions(zero, pos, 1, n_words)[0]
    return out
