"""Gradient compression: int8 ring all-reduce with error feedback (the port
of ``repro.dist.compression``).

The fp32 all-reduce moves ``2 (n-1)/n`` of the gradient bytes per rank;
quantising each hop to int8 (per-tensor absmax scale) cuts the wire bytes
4x.  The quantisation bias is kept bounded across steps by error feedback:
the residual of each lossy reduction is added back into the next step's
gradient before compression (Karimireddy et al. style).
"""
from __future__ import annotations

import torch

from repro_torch.dist.context import ring_shift

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "ErrorFeedback",
    "collective_bytes_saved",
]


def quantize_int8(x: torch.Tensor):
    """Per-tensor absmax int8 quantisation; returns (q, scale), ``scale`` a
    0-d float32 tensor.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    scale = torch.clamp_min(x.abs().max(), 1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _ring_allreduce_int8(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """All-reduce (sum) of this rank's ``x`` over the ``n`` ranks of
    ``group`` (``None``: the world) with int8-quantised hops.

    The standard two-phase ring: a reduce-scatter (n-1 chunk hops, partial
    sums re-quantised per hop) followed by an all-gather in which each
    fully-reduced chunk is quantised ONCE by its owner and relayed verbatim
    -- so every rank (owners included) decodes the *same* int8 payload and
    the result is bit-identical across the ring, which data-parallel
    training needs.  Wire bytes per rank: 2 (n-1)/n chunks of int8 = the
    fp32 all-reduce's / 4.  Each hop is one ``batch_isend_irecv`` to the
    next rank (the reference's ``ppermute``).
    """
    import torch.distributed as dist

    shape = x.shape
    flat = x.reshape(-1)
    size = flat.shape[0]
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    chunks = flat.reshape(n, -1).clone()
    idx = dist.get_rank(group)

    # reduce-scatter: at step s rank i sends its running sum of chunk
    # (i - s) mod n; after n-1 steps rank i owns chunk (i + 1) mod n
    for s in range(n - 1):
        q, scale = quantize_int8(chunks[(idx - s) % n])
        q, scale = ring_shift([q, scale], group)
        k = (idx - s - 1) % n
        chunks[k] = chunks[k] + dequantize_int8(q, scale)

    # all-gather: the owner quantises its chunk once; the payload is
    # forwarded unchanged so every rank writes identical decoded values
    own = (idx + 1) % n
    q, scale = quantize_int8(chunks[own])
    chunks[own] = dequantize_int8(q, scale)
    for s in range(n - 1):
        q, scale = ring_shift([q, scale], group)
        chunks[(idx - s) % n] = dequantize_int8(q, scale)
    return chunks.reshape(-1)[:size].reshape(shape)


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


class ErrorFeedback:
    """Residual accumulator making lossy gradient reduction unbiased-ish.

    ``apply(grads, reduce_fn)`` adds the stored residual into ``grads`` (a
    tensor, or a dict / list / tuple of them), runs the (lossy)
    ``reduce_fn``, and stores the new residual ``corrected - reduced`` so
    compression errors cancel over steps instead of compounding.
    """

    def __init__(self):
        self.residual = None

    def apply(self, grads, reduce_fn):
        if self.residual is None:
            self.residual = _tree_map(torch.zeros_like, grads)
        corrected = _tree_map(torch.add, grads, self.residual)
        reduced = reduce_fn(corrected)
        self.residual = _tree_map(torch.sub, corrected, reduced)
        return reduced


def collective_bytes_saved(n_elems: int, n_devices: int) -> dict:
    """Wire-byte accounting: fp32 psum ring vs int8 ring (per device)."""
    hops = 2 * (n_devices - 1) / n_devices  # reduce-scatter + all-gather
    fp32 = hops * n_elems * 4
    int8 = hops * n_elems * 1
    return {
        "fp32_psum_bytes": fp32,
        "int8_ring_bytes": int8,
        "saved_bytes": fp32 - int8,
    }
