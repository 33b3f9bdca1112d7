"""Packed-bitmap primitives on torch tensors.

A bitmap over ``r`` positions is stored as 32-bit words, LSB-first: bit
``i`` lives at word ``i // 32``, bit position ``i % 32``.  A *batch* of N
bitmaps is an ``int32[N, n_words]`` tensor whose words hold the same bit
pattern as the reference's ``uint32`` (see :mod:`repro_torch.device`):
``>>`` on int32 is arithmetic, so every logical shift here is masked.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import WORD_DTYPE, resolve_device, to_numpy_u32, to_words

WORD_BITS = 32

__all__ = [
    "WORD_BITS",
    "WORD_DTYPE",
    "n_words_for",
    "pack",
    "unpack",
    "popcount",
    "cardinality",
    "bitmap_and",
    "bitmap_or",
    "bitmap_xor",
    "bitmap_andnot",
    "bitmap_not",
    "tail_mask",
    "packed_tail_mask",
    "from_positions",
    "to_positions_np",
    "density",
]


def n_words_for(r: int) -> int:
    """Number of 32-bit words needed for ``r`` bit positions."""
    return (int(r) + WORD_BITS - 1) // WORD_BITS


def tail_mask(r: int) -> int:
    """Mask of valid bits in the final word for universe size ``r`` (as an
    unsigned Python int, like the reference)."""
    rem = int(r) % WORD_BITS
    return 0xFFFFFFFF if rem == 0 else (1 << rem) - 1


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=WORD_DTYPE, device=device)


@functools.lru_cache(maxsize=32)  # each entry pins n_words * 4 bytes on its device
def _packed_tail_mask(r: int, n_words: int, device: torch.device):
    if r >= n_words * WORD_BITS:
        return None
    mask = np.zeros(n_words, dtype=np.uint32)
    full = r // WORD_BITS
    mask[:full] = 0xFFFFFFFF
    if r % WORD_BITS:
        mask[full] = tail_mask(r)
    return to_words(mask, device)


def packed_tail_mask(r: int, n_words: int, device=None):
    """Per-word mask int32[n_words] keeping only bits below ``r``.

    ``None`` when no masking is needed (``r`` fills every word) so callers
    can skip the AND entirely.  Cached per (r, n_words, device).
    """
    return _packed_tail_mask(int(r), int(n_words), resolve_device(device))


def pack(bits, device=None) -> torch.Tensor:
    """Pack a boolean/int array ``[..., r]`` into ``int32[..., ceil(r/32)]``."""
    dev = resolve_device(device)
    bits = bits.to(dev) if isinstance(bits, torch.Tensor) else torch.as_tensor(
        np.asarray(bits), device=dev
    )
    r = bits.shape[-1]
    nw = n_words_for(r)
    pad = nw * WORD_BITS - r
    bits = bits.to(WORD_DTYPE)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (nw, WORD_BITS))
    # distinct bits per lane: the int32 sum is their OR (bit 31 wraps to the sign)
    return (bits << _shifts(dev)).sum(dim=-1, dtype=WORD_DTYPE)


def unpack(words: torch.Tensor, r: int | None = None) -> torch.Tensor:
    """Unpack ``int32[..., n_words]`` into boolean ``[..., r]``."""
    bits = (words[..., None] >> _shifts(words.device)) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    if r is not None:
        bits = bits[..., :r]
    return bits.to(torch.bool)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (int32).  torch has no popcount: SWAR, with
    masks that also clear the sign bits an arithmetic shift drags in."""
    x = words
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + ((x >> 4) & 0x0F0F0F0F)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def cardinality(words: torch.Tensor) -> torch.Tensor:
    """Number of ones in each bitmap (sum over the word axis, int64)."""
    return popcount(words).sum(dim=-1)


def bitmap_and(a, b):
    return torch.bitwise_and(a, b)


def bitmap_or(a, b):
    return torch.bitwise_or(a, b)


def bitmap_xor(a, b):
    return torch.bitwise_xor(a, b)


def bitmap_andnot(a, b):
    """a AND (NOT b) -- the paper's ANDNOT primitive."""
    return torch.bitwise_and(a, torch.bitwise_not(b))


def bitmap_not(a: torch.Tensor, r: int | None = None) -> torch.Tensor:
    """Bitwise complement; masks the invalid tail bits when ``r`` is given."""
    out = torch.bitwise_not(a)
    if r is not None:
        nw = out.shape[-1]
        mask = np.full(nw, 0xFFFFFFFF, dtype=np.uint32)
        mask[-1] = tail_mask(r)
        out = torch.bitwise_and(out, to_words(mask, out.device))
    return out


def from_positions(positions, r: int, device=None) -> torch.Tensor:
    """Build a packed bitmap from a (host) list/array of set positions."""
    dev = resolve_device(device)
    pos = np.asarray(positions, dtype=np.int64)
    out = np.zeros(n_words_for(r), dtype=np.uint32)
    if pos.size:
        np.bitwise_or.at(out, pos // WORD_BITS, np.uint32(1) << (pos % WORD_BITS).astype(np.uint32))
    return to_words(out, dev)


def to_positions_np(words) -> np.ndarray:
    """Host-side: sorted array of set positions in a packed bitmap."""
    w = to_numpy_u32(words)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0]


def density(words: torch.Tensor, r: int) -> torch.Tensor:
    return cardinality(words) / r
