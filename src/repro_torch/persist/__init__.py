"""`repro_torch.persist`: persisted planner calibration constants.

Ported so far: ``calibration.json`` (:mod:`~repro_torch.persist.calibration`).
The snapshot format, shards, WAL and paged tiers of the reference's
``repro.persist`` are later work (``ROADMAP.md``).
"""
from .calibration import ensure_calibration, load_calibration, save_calibration

__all__ = ["ensure_calibration", "load_calibration", "save_calibration"]
