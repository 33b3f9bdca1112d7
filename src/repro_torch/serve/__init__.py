"""Serving layer of the port: the query front-end.

  * :mod:`~repro_torch.serve.frontend` -- :class:`QueryServer`, the
    high-throughput multi-client query front-end: shape-bucketed
    micro-batching over ``execute_many``, semantic request deduplication,
    a version-keyed result cache invalidated by streaming version bumps,
    bounded-queue admission control, and planner-calibration feedback.

The reference's model-decode slot engine (``serve/engine.py::ServeEngine``)
waits for ``ROADMAP.md`` Queue 1 item 12 (the LM substrate), and its slot
masks (``serve/masks.py``) for item 11.
"""
from .frontend import Overloaded, QueryServer, shape_bucket

__all__ = ["Overloaded", "QueryServer", "shape_bucket"]
