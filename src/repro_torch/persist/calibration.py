"""Persisted planner calibration constants (``calibration.json``).

Calibration constants (``core.calibration.Calibration`` -- per-backend
words->µs roofline rates) are device properties, not index data, so they
live in their own small JSON artifact beside an index's files.

Constants are stamped with the topology they were measured on
(``core.calibration.device_signature``: ``cudax1`` on one card,
``cpux1`` on the CPU); loading a file stamped for another topology returns
None (the caller re-measures) unless ``allow_mismatch`` is set.  The
portable ``identity`` calibration is accepted everywhere.  Writes are
tmp+rename atomic.  The file format is the reference's.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.core.calibration import (
    Calibration,
    device_signature,
    measure_calibration,
    set_calibration,
)

__all__ = [
    "CALIBRATION_FILE",
    "save_calibration",
    "load_calibration",
    "ensure_calibration",
]

CALIBRATION_FILE = "calibration.json"


def _resolve(path) -> Path:
    p = Path(path)
    return p / CALIBRATION_FILE if p.is_dir() or not p.suffix else p


def save_calibration(calib: Calibration, path) -> Path:
    """Write constants as sorted-key JSON (atomic tmp+rename); ``path`` may
    be a directory (gets ``calibration.json``) or an explicit file."""
    target = _resolve(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(target.suffix + ".tmp")
    tmp.write_text(json.dumps(calib.to_obj(), indent=2, sort_keys=True))
    os.replace(tmp, target)
    return target


def load_calibration(path, *, allow_mismatch: bool = False,
                     device=None) -> Calibration | None:
    """Read persisted constants; None when absent, unreadable, or measured
    on another device topology than ``device``'s (default: the card when
    one is present) -- stale constants are worse than none.

    Accepts the full topology signature (``cudax1``), the bare device type
    (``cuda``; adopted as the full signature) and the portable
    ``identity`` calibration."""
    target = _resolve(path)
    if not target.exists():
        return None
    try:
        obj = json.loads(target.read_text())
    except (OSError, ValueError):
        return None
    calib = Calibration.from_obj(obj)
    signature = device_signature(device)
    kind = signature.split("x")[0]
    if not allow_mismatch and calib.device not in ("identity", kind, signature):
        return None
    if calib.device == kind:
        # bare device-type stamp: adopt the full signature so the
        # topology-staleness check doesn't immediately reset the constants
        calib.device = signature
    return calib


def ensure_calibration(path, *, activate: bool = True, **measure_kw) -> Calibration:
    """Load persisted constants or measure-and-persist them on first use.

    A server's startup path: one call yields this device's constants (a
    measurement pass the first time, a JSON read after) and installs them
    as the process-active calibration so every later plan is priced in
    microseconds.  ``measure_kw`` goes to :func:`measure_calibration`
    (``device=`` among them)."""
    calib = load_calibration(path, device=measure_kw.get("device"))
    if calib is None:
        calib = measure_calibration(**measure_kw)
        save_calibration(calib, path)
    if activate:
        set_calibration(calib)
    return calib
