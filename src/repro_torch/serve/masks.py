"""Attention-mask composition over packed bitmaps + KV-tile skip lists.

The paper's machinery applied to serving: a decode step's attention mask is
the conjunction/threshold of several *criteria bitmaps* over KV positions
(causal validity, sliding window, same-document, not-padding, retrieval
votes...).  Masks are packed int32 rows (32 KV positions/word, the uint32
bit pattern), composed with ``core.threshold`` / logical ops, and
classified into clean/dirty tiles by the storage engine
(:class:`repro_torch.storage.TileStore`) -- all-zero tiles are skipped
entirely by a block-sparse attention consumer (the skip decision is made
host/launch side, the paper's EWAH fast-forward insight).

`head_vote_mask` is the threshold showcase: K heads (or retrieval scorers)
each nominate KV pages they consider important; a page is kept if >= T of
them agree -- exactly a T-occurrence query over vote bitmaps, evaluated by
the fused circuit kernel (K1) on the card.

**Device**: a tensor is used where it lies; anything else goes to
``device`` (default: the CUDA card; ``device="cpu"`` runs the plain
versions).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmaps import pack
from repro_torch.core.threshold import threshold
from repro_torch.device import resolve_device, to_words
from repro_torch.storage import TILE_ZERO, TileStore

__all__ = [
    "causal_mask_bitmap",
    "window_mask_bitmap",
    "document_mask_bitmap",
    "compose_masks_all",
    "head_vote_mask",
    "kv_tile_skiplist",
]


def _where(x, device) -> torch.device:
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _values(x, device) -> torch.Tensor:
    dev = _where(x, device)
    return x.to(dev) if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x), device=dev
    )


def causal_mask_bitmap(q_pos: int, kv_positions, *, device=None) -> torch.Tensor:
    """Packed mask over KV slots: kv position valid and <= q_pos."""
    kv = _values(kv_positions, device)
    return pack((kv >= 0) & (kv <= q_pos), kv.device)


def window_mask_bitmap(q_pos: int, kv_positions, window: int, *,
                       device=None) -> torch.Tensor:
    kv = _values(kv_positions, device)
    return pack((kv >= 0) & (q_pos - kv < window), kv.device)


def document_mask_bitmap(doc_ids, q_doc: int, *, device=None) -> torch.Tensor:
    docs = _values(doc_ids, device)
    return pack(docs == q_doc, docs.device)


def compose_masks_all(*masks, device=None) -> torch.Tensor:
    """AND of criteria = theta(N, .) over the stacked mask bitmaps."""
    dev = _where(masks[0], device)
    stacked = torch.stack([to_words(m, dev) for m in masks])
    return threshold(stacked, stacked.shape[0], "ssum")


def head_vote_mask(votes, t: int, *, device=None) -> torch.Tensor:
    """KV pages nominated by >= t of the per-head vote bitmaps
    (votes: int32[n_heads, n_words]); the ``fused`` backend, so K1 on the
    card."""
    return threshold(to_words(votes, _where(votes, device)), t, "fused")


def kv_tile_skiplist(mask_words, n_kv: int, tile_positions: int = 2048, *,
                     device=None):
    """Classify a packed mask into KV tiles; returns (keep_tiles, info).

    keep_tiles: sorted indices of tiles with any live position -- the launch
    list for a block-sparse attention kernel; all-zero tiles are never read.
    """
    tile_words = max(1, tile_positions // 32)
    dev = _where(mask_words, device)
    store = TileStore.from_packed(
        to_words(mask_words, dev)[None, :], tile_words=tile_words, device=dev
    )
    classes = store.classes_word[0]  # zero/one/dirty is all the skiplist needs
    keep = np.nonzero(classes != TILE_ZERO)[0]
    info = {
        "n_tiles": int(classes.size),
        "skipped_tiles": int((classes == TILE_ZERO).sum()),
        "skip_fraction": float((classes == TILE_ZERO).mean()),
    }
    return keep, info
