"""Declarative, composable queries over a bitmap index.

The paper's closing observation -- "the result of our computation is again a
bitmap which can be further processed within a bitmap index" -- promoted to
the API: queries are expression trees built from symmetric-function leaves
(:class:`Threshold`, :class:`Interval`, :class:`Exactly`, :class:`Parity`,
:class:`Majority`, :class:`Weighted`, :class:`Sym`), named columns
(:class:`Col`), and boolean combinators (:class:`And`, :class:`Or`,
:class:`Not`, :class:`AndNot`), executed against a :class:`BitmapIndex`::

    idx = BitmapIndex.from_dense(on_sale, names=store_names)   # on the card
    hot = idx.execute(And(Interval(2, 10), Not(Threshold(15))))

Execution is planner-driven (``core.planner``): a whole expression tree
compiles into ONE shared Boolean circuit (sub-queries share the sideways-sum
adder via CSE) evaluated in one launch of the CUDA circuit-program kernel
(``kernels.threshold_ssum``).  Bare thresholds route to the specialised
backends (wide OR/AND, streaming scancount) the paper recommends, and
clean-heavy data to the tile-skipping ``tiled_fused`` route
(``storage.tiled``), whose block stage is a second hand-written kernel
(``kernels.tiled_scan``).
"""

from .expr import (
    And,
    AndNot,
    Col,
    Exactly,
    Interval,
    Majority,
    Not,
    Or,
    Parity,
    Query,
    Sym,
    Threshold,
    Weighted,
    bind_members,
    canonical_key,
    column_refs,
)
from .compile import build_query_circuit
from .executors import (
    THRESHOLD_BACKENDS,
    ShardContext,
    run_plan,
    run_threshold_backend,
)
from .index import (
    BitmapIndex,
    IndexStats,
    circuit_for,
    clear_compiled_cache,
    compiled_cache_info,
    execute,
    plan_memo_info,
)

__all__ = [
    "Query",
    "Col",
    "Threshold",
    "Interval",
    "Exactly",
    "Parity",
    "Majority",
    "Weighted",
    "Sym",
    "And",
    "Or",
    "Not",
    "AndNot",
    "BitmapIndex",
    "IndexStats",
    "execute",
    "circuit_for",
    "build_query_circuit",
    "run_plan",
    "ShardContext",
    "run_threshold_backend",
    "THRESHOLD_BACKENDS",
    "compiled_cache_info",
    "clear_compiled_cache",
    "plan_memo_info",
    "bind_members",
    "canonical_key",
    "column_refs",
]
