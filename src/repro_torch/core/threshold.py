"""Dense threshold algorithms over packed bitmaps, as plain tensor code.

Every algorithm takes ``bitmaps: int32[N, n_words]`` and a threshold ``T``
(Python int) and returns the packed result ``int32[n_words]`` whose bit i
is set iff at least T of the N input bitmaps have bit i set.

Algorithms (paper section in parentheses):
  * scancount            -- counter array over positions (4.2); the oracle
  * scancount_streaming  -- the same with O(chunk) working set in N
  * looped               -- O(NT) bit-parallel dynamic program (4.5, Algorithm 3)
  * ssum / treeadd / srtckt / sopckt -- gate circuits, evaluated gate by gate
  * csvckt               -- carry-save vertical counter (4.5.1, Algorithm 4)

The fused evaluation of the same circuits in one kernel is
``kernels.threshold_ssum``; :func:`threshold` reaches every backend of
``query.executors`` by name.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from . import circuits as _ckt
from .bitmaps import WORD_DTYPE

__all__ = ["threshold", "weighted_threshold", "hamming_weight_words", "ALGORITHMS"]


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


#: unpacked counter bits one step of SCANCOUNT_STREAMING may hold (int32s)
_STREAM_WORK = 1 << 26


def _scancount_streaming(bitmaps: torch.Tensor, t: int, chunk: int = 128) -> torch.Tensor:
    """SCANCOUNT over input chunks: O(r) counter state and O(chunk * r)
    working set regardless of N -- the answer to the paper's section 6
    question ("would there be applications where N = 1,000,000?"): the
    circuit family is infeasible there, streaming counters are not.  Each
    chunk of rows is also cut along the words, so a step unpacks at most
    ``_STREAM_WORK`` counter bits (at 2^22 words a chunk of 64 rows would
    otherwise unpack 32 GiB)."""
    n, nw = bitmaps.shape
    shifts = _shifts(bitmaps.device)
    counts = torch.zeros((nw, 32), dtype=torch.int32, device=bitmaps.device)
    for lo in range(0, n, chunk):
        blk = bitmaps[lo:lo + chunk]
        step = max(1, _STREAM_WORK // (blk.shape[0] * 32))
        for w in range(0, nw, step):
            part = blk[:, w:w + step]
            counts[w:w + step] += ((part[:, :, None] >> shifts) & 1).sum(dim=0, dtype=torch.int32)
    return _pack_lanes(counts >= t)


def _looped(bitmaps: torch.Tensor, t: int) -> torch.Tensor:
    """LOOPED (4.5, Algorithm 3): C_j |= C_{j-1} & B_i."""
    n = bitmaps.shape[0]
    cs = [torch.zeros_like(bitmaps[0]) for _ in range(t + 1)]  # cs[1..t]
    cs[1] = bitmaps[0]
    for i in range(1, n):
        b = bitmaps[i]
        for j in range(min(t, i + 1), 1, -1):
            cs[j] = cs[j] | (cs[j - 1] & b)
        cs[1] = cs[1] | b
    return cs[t]


@functools.lru_cache(maxsize=4096)
def _tabulated_circuit(n: int, t: int, kind: str):
    """The (N, T) circuit of ``kind``, built once per process: the paper
    tabulates circuits per (N, T), the reference gets the same from its jit
    cache, and building and optimising one takes longer on the host than
    the kernel runs."""
    return _ckt.build_threshold_circuit(n, t, kind)


def _circuit_threshold(bitmaps: torch.Tensor, t: int, kind: str) -> torch.Tensor:
    n = bitmaps.shape[0]
    (out,) = _tabulated_circuit(n, t, kind).evaluate([bitmaps[i] for i in range(n)])
    return out


def hamming_weight_words(bitmaps: torch.Tensor, kind: str = "ssum") -> list:
    """Vertical counter: list of packed weight-bit planes, LSB first."""
    n = bitmaps.shape[0]
    circ = _ckt.build_weight_circuit(n, kind)
    return circ.evaluate([bitmaps[i] for i in range(n)])


def _csvckt(bitmaps: torch.Tensor, t: int) -> torch.Tensor:
    """CSVCKT (4.5.1, Algorithm 4): a carry-save redundant vertical counter,
    converted to binary and compared with T by adding -T.  Only the words
    are tensors; the schedule (``time``'s trailing zeros) and -T's bits are
    Python ints."""
    n = bitmaps.shape[0]
    zero = torch.zeros_like(bitmaps[0])
    ndigits = 1 + int(np.floor(np.log2(2 * n)))
    c1 = [zero] * ndigits  # first bit of each redundant digit
    c2 = [zero] * ndigits  # second bit
    time = 0
    for i in range(n):
        c = bitmaps[i]
        time += 1
        x = (time & -time).bit_length() - 1  # number of trailing zeros of time
        for p in range(min(x, ndigits)):
            a, b = c1[p], c2[p]
            c1[p] = zero
            s = a ^ b
            c2[p] = s ^ c
            c = (a & b) | (c & s)
        # remaining carry parks in the next digit's (guaranteed-free) slot
        nxt = min(x, ndigits - 1)
        c1[nxt] = c1[nxt] | c
    # convert redundant encoding to binary
    v = []
    cin = zero
    for i in range(ndigits):
        a, b = c1[i], c2[i]
        s = a ^ b
        v.append(s ^ cin)
        cin = (a & b) | (cin & s)
    v.append(cin)
    # compare against T: add -T (two's complement over ndigits+1 bits) and
    # inspect the sign bit (paper: "subtract T and check the sign")
    width = len(v)
    neg_t = (-t) & ((1 << width) - 1)
    cin = zero
    out = []
    for i in range(width):
        a = v[i]
        if (neg_t >> i) & 1:
            s = ~a
            out.append(s ^ cin)
            cin = a | (cin & s)
        else:
            s = a
            out.append(s ^ cin)
            cin = cin & s
    return ~out[width - 1]  # sign bit clear => count - T >= 0


# Every name is a runnable executor of query.executors.
ALGORITHMS = (
    "scancount", "scancount_streaming", "looped", "ssum", "treeadd", "srtckt",
    "sopckt", "csvckt", "fused", "tiled_fused", "wide_or", "wide_and",
    "rbmrg_block", "dsk",
)


def threshold(bitmaps, t: int, algorithm: str = "ssum", *, device=None) -> torch.Tensor:
    """theta(T, {B_1..B_N}) over packed bitmaps; returns a packed bitmap.

    A tensor is used where it lies; anything else goes to ``device``
    (default: the CUDA card).

    .. deprecated:: prefer the query layer --
       ``repro_torch.query.BitmapIndex.execute(Threshold(t))`` plans the
       backend from data statistics and composes with other queries; the
       string ``algorithm=`` argument survives as an explicit backend
       override.  This shim delegates to
       ``repro_torch.query.executors.run_threshold_backend``.
    """
    from repro_torch.query.executors import run_threshold_backend

    return run_threshold_backend(bitmaps, t, algorithm, device=device)


def weighted_threshold(bitmaps, weights: Sequence[int], t: int, algorithm: str = "ssum",
                       *, device=None) -> torch.Tensor:
    """Weighted threshold via input replication (paper 2.3).

    Integer weight w_i means bitmap i is replicated w_i times.  Practical
    only for small weights, exactly as the paper notes.
    """
    from repro_torch.device import resolve_device, to_words

    reps = []
    for i, w in enumerate(weights):
        if w < 0:
            raise ValueError("weights must be non-negative integers")
        reps.extend([i] * int(w))
    if not reps:
        raise ValueError("all weights zero")
    if not isinstance(bitmaps, torch.Tensor) or device is not None:
        bitmaps = to_words(bitmaps, resolve_device(device))
    expanded = bitmaps[torch.as_tensor(reps, device=bitmaps.device)]
    return threshold(expanded, t, algorithm)
