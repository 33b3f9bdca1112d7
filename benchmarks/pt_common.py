"""What the port's paper benchmarks (``benchmarks/pt_*.py``) share: the
command line's ``--device``, a timer whose window holds the device's work,
the device ops one call dispatches, and the words check against SCANCOUNT
on the CPU.

Run the scripts from the repo root with ``PYTHONPATH=src:.`` (the
``benchmarks`` package must be importable, as for ``benchmarks/run.py``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import to_numpy_u32


def parse_args(argv=None, *, smoke: bool = False) -> argparse.Namespace:
    """``--device`` (default: the CUDA card) and, where the reference
    script has one, ``--smoke``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    if smoke:
        ap.add_argument("--smoke", action="store_true", help="tiny shapes, for CI")
    return ap.parse_args(argv)


def sync(dev) -> None:
    """Wait for the work queued on ``dev`` (nothing to wait for on the CPU
    or for host work, ``dev=None``)."""
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_call(fn, dev, reps: int) -> tuple:
    """``(mean seconds of one call of fn, the warm-up call's result)``: one
    warm-up call, then ``reps`` timed calls.

    Every call ends in a synchronise of ``dev``, where the reference's calls
    end in ``block_until_ready()``: the window holds the device's work, not
    only its enqueue.  ``dev=None`` times host work (the list algorithms).
    The caller checks the warm-up's result, so no extra call is made."""
    first = fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        sync(dev)
    return (time.perf_counter() - t0) / reps, first


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched under it that do device work: views
    and bare allocations (``empty*``) are not counted."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and not func.__name__.startswith(("empty", "new_empty")):
            self.ops += 1
        return func(*args, **(kwargs or {}))


def ops_per_call(fn) -> int:
    """Device ops one call of ``fn`` dispatches: its aten ops (views and
    bare allocations excepted; each launches about one kernel on the card),
    plus the launches of the port's own kernels (K1, K2, K3), which bypass
    aten.  Counted on the host, so the count is the same on every device
    and every run."""
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK

    def own():
        return (K.launch_counts["circuit_eval"] + TK.launch_counts["tiled_block"]
                + TK.launch_counts["tiled_events"])

    before = own()
    with _OpCount() as mode:
        fn()
    return mode.ops + own() - before


def with_ops(derived: str, ops: int) -> str:
    """The reference's ``derived`` text, plus ``ops=N``."""
    return f"{derived} ops={ops}".strip()


def check_words(got, expect: np.ndarray, what: str) -> None:
    """Raise unless ``got`` (packed words on any device) equals ``expect``
    (numpy ``uint32``, SCANCOUNT on the CPU over the same bits)."""
    bad = int((to_numpy_u32(got) != expect).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} mismatched words against scancount on the CPU")


def check_ids(ids, expect: np.ndarray, what: str) -> None:
    """Raise unless a list algorithm's ids are the set bits of ``expect``."""
    from repro_torch.core.bitmaps import to_positions_np

    want = to_positions_np(expect)
    if not np.array_equal(np.asarray(ids, dtype=np.int64), want.astype(np.int64)):
        raise AssertionError(f"{what}: ids differ from the set bits of scancount on the CPU")
