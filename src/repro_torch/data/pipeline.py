"""LM data pipeline (the port of ``repro.data.pipeline``).

Two producers, drawing the reference's numpy values:
  * ``lm_batches`` -- synthetic-but-learnable token streams for LM
    training (Zipf unigram sample + copy pattern so loss visibly falls),
    sharded by host;
  * ``arch_batch`` -- shape-correct random batches for any (arch x shape)
    cell.

Deterministic per (seed, step, host): a restart resumes the stream
exactly.  Batches are tensors on ``device`` (default: the CUDA card);
integer arrays stay int32, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["DataConfig", "lm_batch", "lm_batches", "arch_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int  # global batch
    seq: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng((cfg.seed, step, cfg.host_id))


def _on(arrays: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in arrays.items()}


def lm_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """One host's shard of the global batch for a given step."""
    rng = _rng_for(cfg, step)
    local = cfg.batch // cfg.n_hosts
    # Zipf-ish unigram sample ...
    ranks = rng.zipf(1.3, size=(local, cfg.seq + 1)).astype(np.int64)
    toks = np.minimum(ranks, cfg.vocab - 1)
    # ... with embedded copy structure: second half repeats the first half
    half = (cfg.seq + 1) // 2
    toks[:, half : 2 * half] = toks[:, :half]
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return _on({"tokens": tokens, "labels": labels}, device)


def lm_batches(cfg: DataConfig, start_step: int = 0, device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, device)
        step += 1


def arch_batch(cfg: ModelConfig, batch: int, seq: int, kind: str, seed: int = 0,
               device=None) -> dict:
    """Shape-correct random batch for an (arch x shape) cell."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    if cfg.frontend == "audio":
        out["features"] = rng.normal(size=(batch, seq, cfg.frontend_dim)).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
        return _on(out, device)
    s_text = seq
    if cfg.frontend == "vision":
        s_text = seq - cfg.frontend_tokens
        out["patches"] = rng.normal(
            size=(batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (batch, s_text), dtype=np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    if cfg.frontend == "vision":
        mask = np.ones((batch, seq), np.float32)
        mask[:, : cfg.frontend_tokens] = 0.0  # no LM loss on patch positions
        out["mask"] = mask
    return _on(out, device)
