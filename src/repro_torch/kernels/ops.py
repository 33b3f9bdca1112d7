"""Public wrappers for the fused circuit kernel, as in the reference's
``kernels/ops.py``.

.. deprecated:: these wrappers are thin shims over ``repro_torch.query``;
   prefer ``BitmapIndex.execute``, which plans the backend itself from
   TileStore statistics and lets fused queries compose (one kernel launch
   for a whole expression tree).  The shims keep their fused-kernel
   contract on dense data (``fused``: one launch of the circuit-program
   kernel, ``csrc/circuit_eval.cu``), but when the transient index's tile
   statistics favour skipping they route through the ``tiled_fused`` path
   (the block kernel, ``csrc/tiled_block.cu``) -- same results, a fraction
   of the words touched.  The family emits ONE consolidated
   DeprecationWarning per process (``core.deprecation``).  ``device`` is
   the transient index's device (default: the CUDA card); ``block_words``
   is accepted for parity and unused.
"""
from __future__ import annotations

import torch

from repro_torch.core.deprecation import warn_legacy_shim

__all__ = ["fused_threshold", "fused_symmetric", "fused_interval", "fused_weighted_threshold"]


def _execute_fused(name, bitmaps, expr, block_words=None, device=None):
    warn_legacy_shim(name)
    from repro_torch.query import BitmapIndex

    idx = BitmapIndex(bitmaps, device=device)
    plan = idx.explain(expr)
    backend = "tiled_fused" if plan.algorithm == "tiled_fused" else "fused"
    return idx.execute(expr, backend=backend, block_words=block_words)


def fused_threshold(bitmaps, t: int, block_words: int | None = None, *,
                    device=None) -> torch.Tensor:
    """Fused theta(T, .) over packed bitmaps int32[N, n_words]."""
    from repro_torch.query import Threshold

    return _execute_fused("kernels.ops.fused_threshold", bitmaps, Threshold(t),
                          block_words, device)


def fused_symmetric(bitmaps, truth, block_words: int | None = None, *,
                    device=None) -> torch.Tensor:
    """Fused arbitrary symmetric function given truth[w] for w = 0..N."""
    from repro_torch.query import Sym

    return _execute_fused("kernels.ops.fused_symmetric", bitmaps, Sym(tuple(truth)),
                          block_words, device)


def fused_interval(bitmaps, lo: int, hi: int, *, device=None) -> torch.Tensor:
    from repro_torch.query import Interval

    return _execute_fused("kernels.ops.fused_interval", bitmaps, Interval(lo, hi),
                          device=device)


def fused_weighted_threshold(bitmaps, weights, t: int, *, device=None) -> torch.Tensor:
    """Fused weighted threshold (binary weight decomposition, core/weighted)."""
    from repro_torch.query import Weighted

    return _execute_fused(
        "kernels.ops.fused_weighted_threshold",
        bitmaps,
        Weighted(tuple(int(w) for w in weights), t),
        device=device,
    )
