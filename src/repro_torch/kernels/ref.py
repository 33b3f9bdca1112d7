"""Plain-tensor oracles for the kernels (SCANCOUNT-style vertical counters)."""
from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def _counts(bitmaps: torch.Tensor) -> torch.Tensor:
    """Per-position counts, shape [n_words, 32] (int64)."""
    bits = (bitmaps[:, :, None] >> _shifts(bitmaps.device)) & 1
    return bits.sum(dim=0)


def _pack_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """[n_words, 32] 0/1 lanes -> packed int32[n_words]."""
    lanes = lanes.to(torch.int32)
    return (lanes << _shifts(lanes.device)).sum(dim=-1, dtype=torch.int32)


def threshold_ref(bitmaps: torch.Tensor, t: int) -> torch.Tensor:
    """Oracle for the fused threshold kernel: counts >= T, packed."""
    return _pack_lanes(_counts(bitmaps) >= t)


def symmetric_ref(bitmaps: torch.Tensor, truth: tuple) -> torch.Tensor:
    """Oracle for the fused symmetric kernel: truth[count], packed."""
    table = torch.as_tensor([int(bool(v)) for v in truth], dtype=torch.int32,
                            device=bitmaps.device)
    return _pack_lanes(table[_counts(bitmaps)])
