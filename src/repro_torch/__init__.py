"""PyTorch/CUDA port of the bitmap threshold/symmetric query engine.

The JAX package ``repro`` is the reference; this package is its port to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.  It imports
``torch`` and ``numpy`` only.  Sub-packages and modules carry the
reference's names (``core.bitmaps``, ``query.index``, ...), so a reader
finds each counterpart.

Conventions:

* **Words** are ``torch.int32`` holding the bit pattern of the reference's
  ``uint32`` (torch has no shifts on ``uint32``).  All-ones is ``-1``; a
  logical right shift is ``(x >> s) & mask``.  Host-side numpy arrays stay
  ``uint32``; :func:`repro_torch.device.to_words` and
  :func:`repro_torch.device.to_numpy_u32` cross the boundary.
* **Device rule**: every entry point takes ``device=None``, which means the
  CUDA card and raises ``RuntimeError`` when there is none.  Only an
  explicit ``device="cpu"`` runs on the CPU, through the plain versions of
  the kernels.  Nothing moves to the CPU by itself.
"""

from .device import resolve_device, to_numpy_u32, to_words

__all__ = ["resolve_device", "to_words", "to_numpy_u32"]
