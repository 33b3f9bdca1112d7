"""Arbitrary symmetric Boolean functions over packed bitmaps (paper 2.2/4.4.1).

A symmetric function is determined by its value on each Hamming weight
0..N.  It is synthesised from the weight bits of the sideways-sum circuit,
merging contiguous true-runs into interval tests (>=lo ANDNOT >=hi+1),
exactly the construction sketched in 4.4.1.

Positions beyond ``r`` (the tail of the last word) have weight 0; when the
function is true at weight 0 the result is masked to ``r`` so the packed
result stays canonical.

.. deprecated:: these free functions are thin shims over ``repro_torch.query``
   (``Sym`` / ``Exactly`` / ``Interval`` / ``Parity`` / ``Majority``
   expressions executed through the compiled-circuit cache).  Prefer
   ``BitmapIndex.execute`` -- expressions compose, share adders, batch,
   and (because the index is TileStore-backed) get tile skipping on
   clean-heavy data.  The shims emit ONE consolidated DeprecationWarning
   per process (``core.deprecation``).  ``device`` is the transient
   index's device (default: the CUDA card).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .deprecation import warn_legacy_shim

__all__ = ["symmetric", "exactly", "interval", "parity", "majority"]


def _execute(name, bitmaps, expr, r, device):
    warn_legacy_shim(name)
    from repro_torch.query import execute

    return execute(bitmaps, expr, r=r, device=device)


def symmetric(bitmaps, truth: Sequence, r: int | None = None, *, device=None) -> torch.Tensor:
    """Apply the symmetric function given by ``truth[w]`` for weight w=0..N."""
    from repro_torch.query import Sym

    return _execute("core.symmetric.symmetric", bitmaps, Sym(tuple(truth)), r, device)


def exactly(bitmaps, k: int, r: int | None = None, *, device=None) -> torch.Tensor:
    """The paper's 'delta' function: weight == k exactly."""
    from repro_torch.query import Exactly

    return _execute("core.symmetric.exactly", bitmaps, Exactly(k), r, device)


def interval(bitmaps, lo: int, hi: int, r: int | None = None, *, device=None) -> torch.Tensor:
    """Weight within [lo, hi] (e.g. 'on sale in 2 to 10 stores')."""
    from repro_torch.query import Interval

    return _execute("core.symmetric.interval", bitmaps, Interval(lo, hi), r, device)


def parity(bitmaps, r: int | None = None, *, device=None) -> torch.Tensor:
    """Wide XOR == z0 of the sideways sum; synthesised directly."""
    from repro_torch.query import Parity

    return _execute("core.symmetric.parity", bitmaps, Parity(), r, device)


def majority(bitmaps, r: int | None = None, *, device=None) -> torch.Tensor:
    """theta(ceil(N/2)) -- the majority function, masked to ``r``."""
    from repro_torch.query import Majority

    return _execute("core.symmetric.majority", bitmaps, Majority(), r, device)
