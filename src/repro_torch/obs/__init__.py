"""repro_torch.obs -- unified observability: metrics, trace spans, drift, slow log.

The port's copy of the reference's ``repro.obs``: the same metric names
(``repro_*``), labels and fixed bucket edges, so dashboards and
:func:`lint_prometheus` carry over.  Spans time the host: on a CUDA card
an ``execute`` span measures planning and the enqueue of the kernels,
not their device time (nothing in a span synchronises).  Each span is
also a profiler range ``repro.<name>``, so a ``torch.profiler`` session
puts the device work launched inside a span under its range; the port
adds four spans the reference lacks (``program``, ``launch``, ``events``,
``block``: K1's lookup and launch, the tiled route's two stages).

One layer every subsystem reports into (the paper's words-touched cost
accounting made operational):

* ``REGISTRY`` -- process-wide :class:`MetricsRegistry` (counters,
  gauges, histograms with fixed log-spaced bucket edges so cross-shard
  merges are exact).  Starts **disabled**: every instrumented hot path
  costs one branch until ``enable()`` is called.
* ``span()`` -- per-query trace spans (plan / compile / dispatch /
  decode), each carrying predicted cost next to measured wall time and
  words.
* ``record_drift()`` -- the predicted-vs-realised words ratio as a
  first-class metric feeding the calibration feedback story.
* ``SLOW_QUERIES`` -- threshold-gated ring buffer of slow span trees.
* ``dump()`` / ``export_prometheus()`` / ``export_jsonl()`` -- snapshot
  surfaces.

Typical production setup::

    import repro_torch.obs as obs
    obs.enable(slow_query_threshold_s=0.050)
    ... serve traffic ...
    print(obs.export_prometheus())
    tree = obs.last_trace()          # most recent request's span tree
    print(tree.format())
"""
from __future__ import annotations

import json

from repro_torch.obs import trace as trace
from repro_torch.obs.registry import (
    BUCKET_EDGES,
    Counter,
    Gauge,
    Histogram,
    HistogramState,
    MetricsRegistry,
    lint_prometheus,
)
from repro_torch.obs.slowlog import SlowQueryLog
from repro_torch.obs.trace import (
    NULL_SPAN,
    Span,
    current_span,
    span,
)

REGISTRY = MetricsRegistry(enabled=False)
SLOW_QUERIES = SlowQueryLog()

_LAST_TRACE: list = [None]

# Drift accounting: predicted words (plan cost model) vs measured words
# (executor ExecInfo) per backend.  The ratio histogram makes systematic
# model error visible; its per-series count IS the sample counter.
DRIFT_RATIO = REGISTRY.histogram(
    "repro_calibration_drift_ratio",
    "measured_words / predicted_words per query", ("backend",),
)
QUERY_WALL = REGISTRY.histogram(
    "repro_query_wall_seconds", "End-to-end query wall time", ("backend",),
)
QUERY_WORDS = REGISTRY.histogram(
    "repro_query_words_touched", "Measured words touched per query", ("backend",),
)

#: per-backend (wall, words, ratio) HistogramStates, cached so the hot
#: :func:`record_drift` takes the registry lock once per query instead of
#: once per family (cleared by :func:`reset` alongside the series).
_DRIFT_STATES: dict = {}


def _on_root(root: Span) -> None:
    _LAST_TRACE[0] = root
    SLOW_QUERIES.maybe_record(root)


trace.add_root_listener(_on_root)


def enable(slow_query_threshold_s: float | None = None) -> None:
    """Turn on metrics + tracing (and optionally set the slow-query bar)."""
    REGISTRY.enabled = True
    trace.enabled = True
    if slow_query_threshold_s is not None:
        SLOW_QUERIES.set_threshold(slow_query_threshold_s)


def disable() -> None:
    REGISTRY.enabled = False
    trace.enabled = False


def enabled() -> bool:
    return REGISTRY.enabled


def reset() -> None:
    """Zero metrics, clear the slow log and last trace (tests/benches)."""
    REGISTRY.reset()
    _DRIFT_STATES.clear()  # cached states died with their series
    SLOW_QUERIES.clear()
    _LAST_TRACE[0] = None


def counter(name: str, help: str = "", labels=()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels=()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels=()) -> Histogram:
    return REGISTRY.histogram(name, help, labels)


def record_drift(backend: str, predicted_words: float | None,
                 measured_words: float, wall_s: float) -> None:
    """One predicted-vs-realised observation (no-op when disabled)."""
    if not REGISTRY.enabled:
        return
    states = _DRIFT_STATES.get(backend)
    lock = REGISTRY._lock
    if states is None:
        key = (str(backend),)
        with lock:
            states = _DRIFT_STATES[backend] = tuple(
                fam._series.setdefault(key, HistogramState())
                for fam in (QUERY_WALL, QUERY_WORDS, DRIFT_RATIO)
            )
    wall_st, words_st, ratio_st = states
    with lock:
        wall_st.observe(wall_s)
        words_st.observe(measured_words)
        if predicted_words and predicted_words > 0:
            ratio_st.observe(measured_words / predicted_words)


def drift_samples() -> int:
    """Total predicted-vs-measured observations across backends."""
    return int(DRIFT_RATIO.merged().count)


def last_trace() -> Span | None:
    """The most recent completed root span tree (None if tracing off)."""
    return _LAST_TRACE[0]


def export_prometheus() -> str:
    return REGISTRY.export_prometheus()


def export_jsonl() -> str:
    return REGISTRY.export_jsonl()


def dump() -> dict:
    """One JSON-ready snapshot of the whole observability surface."""
    last = _LAST_TRACE[0]
    ratio = DRIFT_RATIO.merged()
    return {
        "enabled": REGISTRY.enabled,
        "metrics": REGISTRY.snapshot(),
        "drift": {
            "samples": drift_samples(),
            "ratio_p50": ratio.quantile(0.5),
            "ratio_p95": ratio.quantile(0.95),
        },
        "slow_queries": SLOW_QUERIES.entries(),
        "slow_query_threshold_s": SLOW_QUERIES.threshold_s,
        "last_trace": last.to_dict() if last is not None else None,
    }


def dump_json(indent: int = 2) -> str:
    return json.dumps(dump(), indent=indent, default=str)


__all__ = [
    "BUCKET_EDGES", "Counter", "DRIFT_RATIO", "Gauge", "Histogram",
    "HistogramState", "MetricsRegistry", "NULL_SPAN", "REGISTRY",
    "SLOW_QUERIES", "Span", "SlowQueryLog", "counter", "current_span",
    "disable", "drift_samples", "dump", "dump_json", "enable", "enabled",
    "export_jsonl", "export_prometheus", "gauge", "histogram",
    "last_trace", "lint_prometheus", "record_drift",
    "reset", "span",
]
