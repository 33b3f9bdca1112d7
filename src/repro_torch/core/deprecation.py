"""One consolidated DeprecationWarning for the legacy free-function shims.

``kernels.ops.fused_*`` and ``core.symmetric.*`` predate the query layer;
they execute through ``repro_torch.query.execute`` (which builds a transient
``BitmapIndex`` on a TileStore, so the planner routes clean-heavy data
through the tiled path automatically).  Rather than one warning per call
-- these shims sit in loops -- the whole family emits a single
DeprecationWarning per process, naming the replacement.
"""
from __future__ import annotations

import warnings

_warned = False


def warn_legacy_shim(name: str) -> None:
    """Emit the family-wide DeprecationWarning once per process."""
    global _warned
    if _warned:
        return
    _warned = True
    warnings.warn(
        f"{name} (and the other kernels.ops.fused_* / core.symmetric.* "
        "free functions) is a deprecated shim over repro_torch.query; use "
        "BitmapIndex.execute, which plans from TileStore statistics and "
        "routes clean-heavy data through the tiled_fused backend. "
        "This warning is emitted once for the whole shim family.",
        DeprecationWarning,
        stacklevel=3,
    )


def reset_legacy_shim_warning() -> None:
    """Re-arm the once-per-process warning (for tests)."""
    global _warned
    _warned = False
