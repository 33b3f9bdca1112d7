"""Device rule and the numpy ``uint32`` <-> torch ``int32`` word boundary."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_words", "to_numpy_u32", "WORD_DTYPE"]

#: packed words on the torch side: int32 carrying the uint32 bit pattern
WORD_DTYPE = torch.int32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; without one this raises ``RuntimeError``
    instead of carrying on somewhere else.  The CPU is used only when the
    caller names it (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain CPU versions"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_words(words, device) -> torch.Tensor:
    """Packed words (numpy ``uint32``/``int32``, nested ints, or an int32
    tensor) as an ``int32`` tensor on ``device``, bit pattern unchanged."""
    if isinstance(words, torch.Tensor):
        if words.dtype != WORD_DTYPE:
            raise TypeError(f"packed word tensors must be int32, got {words.dtype}")
        return words.to(device)
    arr = np.asarray(words)
    if arr.dtype != np.int32:
        arr = np.ascontiguousarray(arr.astype(np.uint32, copy=False)).view(np.int32)
    # always a copy: the tensor never aliases the caller's (maybe read-only) array
    host = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return host.to(device)


def to_numpy_u32(words) -> np.ndarray:
    """An int32 word tensor (or array) as host numpy ``uint32``."""
    if isinstance(words, torch.Tensor):
        if words.dtype != WORD_DTYPE:
            raise TypeError(f"packed word tensors must be int32, got {words.dtype}")
        words = words.detach().cpu().contiguous().numpy()
    arr = np.ascontiguousarray(np.asarray(words))
    if arr.dtype == np.int32:
        return arr.view(np.uint32)
    return arr.astype(np.uint32, copy=False)
