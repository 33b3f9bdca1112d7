"""The plain reference: what each query of the traffic means, in plain torch.

A query is a spec (``bench/templates.py``): a symmetric function of the
member columns' bits at each row.  This module evaluates it from packed
``int32`` words (bit ``i`` of a column at word ``i // 32``, bit ``i % 32``)
by unpacking the bits of a block of words, summing them over the members
and packing the truth back.  It imports nothing of the program.
"""
from __future__ import annotations

import torch

from bench.common import words_to_int32

BLOCK_WORDS = 1 << 16


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def _pack(truth: torch.Tensor) -> torch.Tensor:
    """bool [w, 32] -> int32 [w] (LSB first)."""
    shifts = torch.arange(32, dtype=torch.int64, device=truth.device)
    return words_to_int32((truth.to(torch.int64) << shifts).sum(-1))


def _bits(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., w] -> int32 [..., w, 32] of 0/1."""
    return (words.unsqueeze(-1) >> _shifts(words.device)) & 1


def evaluate(columns: torch.Tensor, spec: dict, r: int, *, count_bits: int | None = None,
             block_words: int = BLOCK_WORDS) -> torch.Tensor:
    """The packed result of ``spec`` over ``columns`` (int32 [N, n_words])
    for a universe of ``r`` rows.  ``count_bits`` holds the member count in
    that many bits, saturating (used only by the control, never by a run)."""
    dev = columns.device
    n_words = columns.shape[1]
    members = torch.as_tensor(spec["members"], dtype=torch.int64, device=dev)
    kind = spec["kind"]
    weights = None
    if kind == "weighted":
        weights = torch.as_tensor(spec["weights"], dtype=torch.int32, device=dev)[:, None, None]
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    for s in range(0, n_words, block_words):
        e = min(s + block_words, n_words)
        bits = _bits(columns.index_select(0, members)[:, s:e])
        counts = (bits * weights).sum(0) if weights is not None else bits.sum(0)
        if count_bits is not None:
            counts = counts.clamp(max=(1 << count_bits) - 1)
        if kind == "threshold":
            truth = counts >= spec["t"]
        elif kind == "interval":
            truth = (counts >= spec["lo"]) & (counts <= spec["hi"])
        elif kind == "weighted":
            truth = counts >= spec["t"]
        elif kind == "andnot":
            drop = _bits(columns[spec["drop"], s:e]).bool()
            truth = (counts >= spec["t"]) & ~drop
        else:
            raise ValueError(f"unknown query kind {kind!r}")
        out[s:e] = _pack(truth)
    return out & tail_mask(r, n_words, dev)


def tail_mask(r: int, n_words: int, device) -> torch.Tensor:
    """int32 [n_words]: every bit of a row below ``r`` set."""
    idx = torch.arange(n_words, dtype=torch.int64, device=device)
    valid = (r - idx * 32).clamp(0, 32)
    return words_to_int32(torch.where(valid >= 32, (1 << 32) - 1, (1 << valid) - 1))


def apply_update(columns: torch.Tensor, col: int, sets, clears) -> None:
    """Set the bits of ``sets`` in column ``col``, then clear those of
    ``clears`` (an update's sets apply before its clears), in place."""
    dev = columns.device
    for pos, on in ((sets, True), (clears, False)):
        p = torch.unique(torch.as_tensor(pos, dtype=torch.int64, device=dev))
        if p.numel() == 0:
            continue
        words, inv = torch.unique(p >> 5, return_inverse=True)
        mask = torch.zeros(words.numel(), dtype=torch.int64, device=dev)
        mask.index_add_(0, inv, torch.ones_like(p) << (p & 31))
        m = words_to_int32(mask)
        row = columns[col]
        row[words] = (row[words] | m) if on else (row[words] & ~m)


def mismatched_words(got: torch.Tensor, want: torch.Tensor) -> int:
    """Words in which two packed results differ (every word, if the shapes do)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(max(got.numel(), want.numel()))
    return int((got.to(want.device) != want).sum())
