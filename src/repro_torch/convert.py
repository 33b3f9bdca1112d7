"""State carried across from the reference package, as numpy arrays.

Data takes the place of weights here: both packages are given the same
bits.  Nothing of the reference is imported; the caller reads the arrays
off a reference index (``np.asarray(ref.columns)``, ``ref.names``,
``ref.r``) and hands them over.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import to_numpy_u32
from repro_torch.query.index import BitmapIndex

__all__ = ["index_from_reference_arrays", "words_to_numpy"]


def index_from_reference_arrays(columns_u32: np.ndarray, names, r: int, *,
                                tile_words: int = 64, containers: bool = True,
                                device=None) -> BitmapIndex:
    """A :class:`BitmapIndex` over the reference's packed ``uint32[N, n_words]``
    columns, names and universe size, on ``device`` (default: the CUDA card)."""
    cols = np.ascontiguousarray(np.asarray(columns_u32, dtype=np.uint32))
    return BitmapIndex(cols, tuple(names), r=int(r), tile_words=tile_words,
                       containers=containers, device=device)


def words_to_numpy(result) -> np.ndarray:
    """A packed result (int32 tensor, or a list of them) as numpy ``uint32``."""
    if isinstance(result, (list, tuple)):
        return np.stack([to_numpy_u32(x) for x in result])
    return to_numpy_u32(result)
