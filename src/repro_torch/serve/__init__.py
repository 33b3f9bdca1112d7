"""Serving layer of the port: the decode engine, the query front-end and
attention masks.

  * :mod:`~repro_torch.serve.engine` -- :class:`ServeEngine`, the
    continuous-batching decode engine whose slot-selection state is a
    streaming bitmap index (slot queries run K1 on the card);
  * :mod:`~repro_torch.serve.frontend` -- :class:`QueryServer`, the
    high-throughput multi-client query front-end: shape-bucketed
    micro-batching over ``execute_many``, semantic request deduplication,
    a version-keyed result cache invalidated by streaming version bumps,
    bounded-queue admission control, and planner-calibration feedback;
  * :mod:`~repro_torch.serve.masks` -- attention-mask composition over
    packed bitmaps, head-vote thresholds (K1 on the card) and KV-tile skip
    lists.
"""
from .engine import Request, ServeEngine
from .frontend import Overloaded, QueryServer, shape_bucket

__all__ = ["Request", "ServeEngine", "Overloaded", "QueryServer", "shape_bucket"]
