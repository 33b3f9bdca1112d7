"""Dense threshold algorithms over packed bitmaps, as plain tensor code.

Every algorithm takes ``bitmaps: int32[N, n_words]`` and a threshold ``T``
(Python int) and returns the packed result ``int32[n_words]`` whose bit i
is set iff at least T of the N input bitmaps have bit i set.

Ported here (paper section in parentheses):
  * scancount            -- counter array over positions (4.2); the oracle
  * scancount_streaming  -- the same with O(chunk) working set in N
  * ssum / treeadd / srtckt / sopckt -- gate circuits, evaluated gate by gate

The fused evaluation of the same circuits in one kernel is
``kernels.threshold_ssum``.  LOOPED and CSVCKT are not ported yet (see
ROADMAP.md).
"""
from __future__ import annotations

import torch

from . import circuits as _ckt
from .bitmaps import WORD_DTYPE

__all__ = ["hamming_weight_words", "ALGORITHMS"]


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=WORD_DTYPE, device=device)


def _pack_lanes(ge: torch.Tensor) -> torch.Tensor:
    return (ge.to(WORD_DTYPE) << _shifts(ge.device)).sum(dim=-1, dtype=WORD_DTYPE)


def _scancount(bitmaps: torch.Tensor, t: int) -> torch.Tensor:
    n = bitmaps.shape[0]
    # counter dtype chosen like the paper's byte/short/int switch
    cdt = torch.int8 if n < 128 else torch.int16 if n < (1 << 15) else torch.int32
    bits = ((bitmaps[:, :, None] >> _shifts(bitmaps.device)) & 1).to(cdt)
    counts = bits.sum(dim=0, dtype=cdt if n < 128 else torch.int32)
    return _pack_lanes(counts >= t)


def _scancount_streaming(bitmaps: torch.Tensor, t: int, chunk: int = 128) -> torch.Tensor:
    """SCANCOUNT over input chunks: O(r) counter state and O(chunk * r)
    working set regardless of N -- the answer to the paper's section 6
    question ("would there be applications where N = 1,000,000?"): the
    circuit family is infeasible there, streaming counters are not."""
    n, nw = bitmaps.shape
    shifts = _shifts(bitmaps.device)
    counts = torch.zeros((nw, 32), dtype=torch.int32, device=bitmaps.device)
    for lo in range(0, n, chunk):
        blk = bitmaps[lo:lo + chunk]
        counts += ((blk[:, :, None] >> shifts) & 1).sum(dim=0, dtype=torch.int32)
    return _pack_lanes(counts >= t)


def _circuit_threshold(bitmaps: torch.Tensor, t: int, kind: str) -> torch.Tensor:
    n = bitmaps.shape[0]
    circ = _ckt.build_threshold_circuit(n, t, kind)
    (out,) = circ.evaluate([bitmaps[i] for i in range(n)])
    return out


def hamming_weight_words(bitmaps: torch.Tensor, kind: str = "ssum") -> list:
    """Vertical counter: list of packed weight-bit planes, LSB first."""
    n = bitmaps.shape[0]
    circ = _ckt.build_weight_circuit(n, kind)
    return circ.evaluate([bitmaps[i] for i in range(n)])


# Every backend name of the reference; the ones not ported yet raise
# NotImplementedError in query.executors.
ALGORITHMS = (
    "scancount", "scancount_streaming", "looped", "ssum", "treeadd", "srtckt",
    "sopckt", "csvckt", "fused", "tiled_fused", "wide_or", "wide_and",
    "rbmrg_block", "dsk",
)
