"""Executable backends for threshold plans, behind ONE dispatch point.

Every algorithm name the planner can emit resolves here:

  * circuit family, gate by gate -- ssum, treeadd, srtckt, sopckt (plain
    tensor ops, one per gate), and the counters scancount /
    scancount_streaming
  * fused / circuit         -- the whole compiled circuit in ONE launch of
    the CUDA circuit-program kernel (``kernels.threshold_ssum``); on a CPU
    device both names run the kernel's plain version
  * tiled_fused             -- the tile-skipping executor
    (``storage.tiled.run_tiled_circuit``): clean tiles fold to constants,
    the rest run in at most two dispatches (event stage + the block
    kernel of ``kernels.tiled_scan``)
  * looped / csvckt         -- the paper's LOOPED and CSVCKT (plain tensor
    ops, ``core.threshold``)
  * wide_or / wide_and      -- the T=1 / T=N degenerate reductions
  * column                  -- a view of one row
  * rbmrg_block             -- tile-level clean/dirty pruning on the rows'
    device, bare thresholds only (``storage.tiles``; tiled_fused
    generalises it)
  * dsk                     -- DivideSkip over host position lists
    (``core.listalgos``), for the paper's sparse, T~N regime

Backends are *shard-local* functions: they see one :class:`ShardContext`
(the tile store, dense view, compiled circuit and bare-threshold shape of
one row-range of the index) and never touch device placement themselves.
:func:`run_plan` is the single entrypoint that dispatches a plan against a
context.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.planner import CIRCUIT_BACKENDS
from repro_torch.device import WORD_DTYPE, resolve_device, to_words
from repro_torch.query.execinfo import make_exec_info

__all__ = [
    "THRESHOLD_BACKENDS",
    "ShardContext",
    "run_plan",
    "run_threshold_backend",
]

_DEVICE_ALGOS = (
    "scancount", "scancount_streaming", "looped", "csvckt",
    "ssum", "treeadd", "srtckt", "sopckt",
)

THRESHOLD_BACKENDS = _DEVICE_ALGOS + (
    "fused", "tiled_fused", "wide_or", "wide_and", "rbmrg_block", "dsk",
)

def _device_threshold(bitmaps: torch.Tensor, t: int, algorithm: str) -> torch.Tensor:
    from repro_torch.core.threshold import (
        _circuit_threshold,
        _csvckt,
        _looped,
        _scancount,
        _scancount_streaming,
    )

    if algorithm == "scancount":
        return _scancount(bitmaps, t)
    if algorithm == "scancount_streaming":
        return _scancount_streaming(bitmaps, t)
    if algorithm == "looped":
        return _looped(bitmaps, t)
    if algorithm == "csvckt":
        return _csvckt(bitmaps, t)
    return _circuit_threshold(bitmaps, t, algorithm)


def _fold(bitmaps: torch.Tensor, op) -> torch.Tensor:
    # a fold over rows: torch has no bitwise reduction over an axis
    acc = bitmaps[0].clone()
    for i in range(1, bitmaps.shape[0]):
        op(acc, bitmaps[i], out=acc)
    return acc


def _wide_or(bitmaps: torch.Tensor) -> torch.Tensor:
    return _fold(bitmaps, torch.bitwise_or)


def _wide_and(bitmaps: torch.Tensor) -> torch.Tensor:
    return _fold(bitmaps, torch.bitwise_and)


def _dsk_threshold(bitmaps: torch.Tensor, t: int) -> torch.Tensor:
    """Host DivideSkip over per-bitmap sorted position lists; the result
    goes back to the rows' device."""
    from repro_torch.core.bitmaps import from_positions, to_positions_np
    from repro_torch.core.listalgos import dsk

    arr = bitmaps.cpu()
    r = arr.shape[1] * 32
    lists = [to_positions_np(row) for row in arr]
    return from_positions(dsk(lists, t, r), r, device=bitmaps.device)


@dataclasses.dataclass
class ShardContext:
    """Everything a shard-local backend needs to execute one plan.

    A *shard* is a row-range of the universe: the whole index on a single
    device.  Data accessors are thunks so a backend only pays for the
    representation it reads.
    """

    n: int  # columns in the shard (same for every shard of an index)
    dense: Callable  # () -> int32[n, local_words] packed dense view
    store: Callable | None = None  # () -> TileStore (tile-classified shard)
    circuit: Callable | None = None  # () -> compiled Circuit (shared, cached)
    bare: tuple | None = None  # (member slots | None, T) for bare thresholds
    column: int | None = None  # slot for 'column' plans
    block_words: int | None = None  # parity with the reference; unused by the kernel
    #: tiled case-3 engine override: "scan" (the device engine) / "merge"
    #: (host event-merge oracle) / None (auto per store)
    tiled_engine: str | None = None

    def member_rows(self) -> torch.Tensor:
        """Dense rows of the bare-threshold member subset (a gathered copy
        when the subset is a proper one)."""
        rows = self.dense()
        slots = self.bare[0]
        if slots is not None:
            rows = rows[torch.as_tensor(list(slots), device=rows.device)]
        return rows


def _dense_exec_info(backend: str, engine: str, n_rows: int, out: torch.Tensor,
                     launches: int = 1) -> dict:
    """ExecInfo for a backend that reads every member row densely.

    ``words_touched`` is the roofline traffic term: N input rows read plus
    each output row written, all at the shard's word width.
    """
    k = 1 if out.dim() == 1 else out.shape[0]
    nw = int(out.shape[-1])
    total = n_rows * nw + k * nw
    return make_exec_info(
        backend,
        engine=engine,
        n_outputs=k,
        total_words=total,
        words_touched=total,
        dirty_words_gathered=n_rows * nw,
        words_by_kind={"dense": n_rows * nw},
        launches=launches,
        work_fraction=1.0,
    )


def run_plan(ctx: ShardContext, plan):
    """THE executor entrypoint: run one plan against one shard's data.

    ``plan`` is a ``core.planner.Plan`` or a backend name.  Returns
    ``(packed result, info)`` -- ``info`` is an ExecInfo
    (:mod:`repro_torch.query.execinfo`): the tiled executor's case-split
    accounting when it ran, a dense-traffic accounting for every other
    backend.  Every backend resolves through here;
    callers own device placement, backends own compute.
    """
    alg = getattr(plan, "algorithm", plan)
    if alg == "column":
        if ctx.column is None:
            raise ValueError("'column' plan without a column slot in the context")
        out = ctx.dense()[ctx.column]
        nw = int(out.shape[-1])
        return out, make_exec_info(
            "column", engine="view", total_words=nw, words_touched=nw,
            words_by_kind={"dense": nw}, launches=0, work_fraction=1.0,
        )
    if alg == "tiled_fused":
        if ctx.store is None or ctx.circuit is None:
            raise ValueError("'tiled_fused' needs a tile store and a compiled circuit")
        from repro_torch.storage import run_tiled_circuit

        return run_tiled_circuit(
            ctx.store(), ctx.circuit(), block_words=ctx.block_words,
            engine=ctx.tiled_engine,
        )
    if alg in THRESHOLD_BACKENDS and ctx.bare is not None:
        slots, t = ctx.bare
        if alg == "fused":
            # member subsets are read in place: the program indexes the rows
            dense = ctx.dense()
            out = _fused_threshold(dense, t, slots)
            n_rows = dense.shape[0] if slots is None else len(slots)
        else:
            rows = ctx.member_rows()
            out = run_threshold_backend(rows, t, alg, block_words=ctx.block_words)
            n_rows = rows.shape[0]
        engine = "host" if alg == "dsk" else "dense"
        return out, _dense_exec_info(alg, engine, int(n_rows), out)
    if alg in CIRCUIT_BACKENDS:
        from repro_torch.kernels.threshold_ssum import run_circuit_cached

        if ctx.circuit is None:
            raise ValueError(f"backend {alg!r} needs a compiled circuit in the context")
        rows = ctx.dense()
        out = run_circuit_cached(rows, ctx.circuit(), block_words=ctx.block_words)
        return out, _dense_exec_info(alg, "dense", int(rows.shape[0]), out)
    if alg in THRESHOLD_BACKENDS:
        raise ValueError(
            f"backend {alg!r} only executes bare Threshold queries; "
            "use 'circuit', 'fused' or 'tiled_fused' for composite expressions"
        )
    raise ValueError(f"unknown backend {alg!r}")


def _fused_threshold(bitmaps: torch.Tensor, t: int, slots=None) -> torch.Tensor:
    """theta(T, .) over rows ``slots`` of ``bitmaps`` (default all) through
    the circuit-program kernel, with the reference's vacuous short cuts."""
    from repro_torch.core.threshold import _tabulated_circuit
    from repro_torch.kernels.threshold_ssum import run_circuit_cached

    n = bitmaps.shape[0] if slots is None else len(slots)
    if t <= 0:
        return torch.full_like(bitmaps[0], -1)
    if t > n:
        return torch.zeros_like(bitmaps[0])
    return run_circuit_cached(bitmaps, _tabulated_circuit(n, t, "ssum"), rows=slots)


def run_threshold_backend(bitmaps, t: int, backend: str, *,
                          block_words: int | None = None, device=None) -> torch.Tensor:
    """theta(T, .) over packed int32[N, n_words] via a named backend.

    T must be a Python int (circuits are tabulated per (N, T)).
    T <= 0 and T > N short-circuit before backend dispatch.  A tensor is
    used where it lies; anything else is moved to ``device`` (default: the
    CUDA card).  ``block_words`` is accepted for parity and unused.
    """
    if not isinstance(t, int):
        raise TypeError("T must be a static Python int (circuits are tabulated per (N,T))")
    if not isinstance(bitmaps, torch.Tensor) or device is not None:
        bitmaps = to_words(bitmaps, resolve_device(device))
    if bitmaps.dtype != WORD_DTYPE:
        raise TypeError(f"packed words must be int32, got {bitmaps.dtype}")
    if bitmaps.dim() != 2:
        raise ValueError(f"expected int32[N, n_words], got shape {tuple(bitmaps.shape)}")
    n = bitmaps.shape[0]
    if t <= 0:
        return torch.full_like(bitmaps[0], -1)
    if t > n:
        return torch.zeros_like(bitmaps[0])
    if backend == "wide_or":
        if t != 1:
            raise ValueError(f"wide_or computes theta(1, .); got T={t}")
        return _wide_or(bitmaps)
    if backend == "wide_and":
        if t != n:
            raise ValueError(f"wide_and computes theta(N, .); got T={t}, N={n}")
        return _wide_and(bitmaps)
    if backend == "rbmrg_block":
        from repro_torch.storage import rbmrg_block_threshold

        out, _info = rbmrg_block_threshold(bitmaps, t)
        return out
    if backend == "tiled_fused":
        from repro_torch.core.circuits import build_threshold_circuit
        from repro_torch.storage import TileStore, run_tiled_circuit

        store = TileStore.from_packed(bitmaps, device=bitmaps.device)
        circ = build_threshold_circuit(n, t, "ssum")
        out, _info = run_tiled_circuit(store, circ, block_words=block_words)
        return out
    if backend == "dsk":
        return _dsk_threshold(bitmaps, t)
    if backend == "fused":
        return _fused_threshold(bitmaps, t)
    if backend in _DEVICE_ALGOS:
        return _device_threshold(bitmaps, t, backend)
    raise ValueError(f"unknown algorithm {backend!r}; valid: {THRESHOLD_BACKENDS}")
