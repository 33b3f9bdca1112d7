"""Process-wide metrics registry: counters, gauges, histograms.

One schema for every subsystem's accounting (query planner, executors,
kernels, serving front-end, streaming, persistence tiers).  Three design
constraints drive the implementation:

* **Exact cross-shard / cross-thread merging.**  Every histogram shares
  the same FIXED log-spaced bucket edges (``BUCKET_EDGES``), so merging
  two histograms is exact integer addition of bucket counts -- order
  and grouping never change the result (associative + commutative),
  which is what lets per-shard observations fold into
  one process view without approximation.
* **Thread safety.**  The serving front-end increments from a batcher
  thread while clients read; a single registry lock guards every
  mutation and snapshot.
* **Near-zero disabled cost.**  When ``registry.enabled`` is False every
  ``inc``/``set``/``observe`` is one attribute load and a branch -- no
  lock, no allocation, no mutation (tests assert *zero* registry
  mutations in disabled mode).

Exporters: Prometheus text exposition format (``export_prometheus``)
and JSONL (``export_jsonl``), one line per metric family.
"""
from __future__ import annotations

import json
import math
import threading
from bisect import bisect_left
from typing import Iterable

# Fixed log-spaced bucket edges: 4 buckets per decade, 1e-7 .. 1e9.
# Seconds-scale latencies (100ns .. hours) and word counts (1 .. 1e9)
# both land inside the span; everything else folds into the +Inf bucket.
BUCKETS_PER_DECADE = 4
_LO_DECADE, _HI_DECADE = -7, 9
BUCKET_EDGES: tuple[float, ...] = tuple(
    10.0 ** (k / BUCKETS_PER_DECADE)
    for k in range(
        _LO_DECADE * BUCKETS_PER_DECADE, _HI_DECADE * BUCKETS_PER_DECADE + 1
    )
)


def _label_key(label_names: tuple[str, ...], labels: dict) -> tuple:
    # hot path: build the key directly; a missing/extra label falls
    # through to the error (no set allocations per observation)
    try:
        key = tuple(str(labels[k]) for k in label_names)
    except KeyError:
        key = None
    if key is None or len(labels) != len(label_names):
        raise ValueError(
            f"expected labels {label_names}, got {tuple(labels)}"
        )
    return key


def _fmt_labels(label_names: tuple[str, ...], key: tuple) -> str:
    if not label_names:
        return ""
    inner = ",".join(
        f'{n}="{v}"' for n, v in zip(label_names, key)
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class HistogramState:
    """Bucket counts + sum/count for one labelled histogram series."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self) -> None:
        self.counts = [0] * (len(BUCKET_EDGES) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(BUCKET_EDGES, value)] += 1
        self.sum += value
        self.count += 1

    def merge(self, other: "HistogramState") -> "HistogramState":
        """Exact merge: same fixed edges everywhere, so bucket counts add."""
        out = HistogramState()
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.sum = self.sum + other.sum
        out.count = self.count + other.count
        return out

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) from bucket counts.

        Log-interpolates inside the winning bucket; the underflow bucket
        reports its upper edge and the overflow bucket the last edge (a
        finite lower bound -- callers asserting finiteness rely on it).
        """
        if self.count == 0:
            return math.nan
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                if i >= len(BUCKET_EDGES):
                    return BUCKET_EDGES[-1]
                if i == 0:
                    return BUCKET_EDGES[0]
                lo, hi = BUCKET_EDGES[i - 1], BUCKET_EDGES[i]
                frac = (rank - (cum - c)) / c
                return lo * (hi / lo) ** max(0.0, min(1.0, frac))
        return BUCKET_EDGES[-1]

    def to_dict(self) -> dict:
        return {"counts": list(self.counts), "sum": self.sum, "count": self.count}

    @classmethod
    def from_dict(cls, d: dict) -> "HistogramState":
        out = cls()
        out.counts = list(d["counts"])
        out.sum = float(d["sum"])
        out.count = int(d["count"])
        return out


class _Metric:
    __slots__ = ("name", "help", "label_names", "_reg", "_series")

    def __init__(self, reg: "MetricsRegistry", name: str, help: str,
                 label_names: tuple[str, ...]) -> None:
        self._reg = reg
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: dict = {}

    def _key(self, labels: dict) -> tuple:
        return _label_key(self.label_names, labels)

    def series(self) -> dict:
        with self._reg._lock:
            return dict(self._series)


class _BoundCounter:
    """A counter series with its label key pre-bound.

    Hot sites that always increment the same labelled series (kernel
    launch counters) pay one enabled check + lock per inc instead of
    rebuilding the label key each call.  Holds only the key, never the
    value, so ``MetricsRegistry.reset`` stays authoritative.
    """

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Counter", key: tuple) -> None:
        self._metric = metric
        self._key = key

    def inc(self, n: float = 1) -> None:
        m = self._metric
        reg = m._reg
        if not reg.enabled:
            return
        with reg._lock:
            m._series[self._key] = m._series.get(self._key, 0) + n


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if not self._reg.enabled:
            return
        key = self._key(labels)
        with self._reg._lock:
            self._series[key] = self._series.get(key, 0) + n

    def bind(self, **labels) -> _BoundCounter:
        """Pre-resolve one labelled series for repeated hot-path incs."""
        return _BoundCounter(self, self._key(labels))

    def value(self, **labels) -> float:
        with self._reg._lock:
            return self._series.get(self._key(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not self._reg.enabled:
            return
        key = self._key(labels)
        with self._reg._lock:
            self._series[key] = v

    def inc(self, n: float = 1, **labels) -> None:
        if not self._reg.enabled:
            return
        key = self._key(labels)
        with self._reg._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._reg._lock:
            return self._series.get(self._key(labels), 0)


class Histogram(_Metric):
    kind = "histogram"

    def observe(self, v: float, **labels) -> None:
        if not self._reg.enabled:
            return
        key = self._key(labels)
        with self._reg._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = HistogramState()
            state.observe(v)

    def state(self, **labels) -> HistogramState:
        with self._reg._lock:
            return self._series.get(self._key(labels)) or HistogramState()

    def merged(self) -> HistogramState:
        """Exact merge of every labelled series into one state."""
        out = HistogramState()
        with self._reg._lock:
            for s in self._series.values():
                out = out.merge(s)
        return out

    def quantile(self, q: float, **labels) -> float:
        if labels or not self.label_names:
            return self.state(**labels).quantile(q)
        return self.merged().quantile(q)


class MetricsRegistry:
    """A named set of metric families behind one lock.

    The process-wide default instance (``repro_torch.obs.REGISTRY``) starts
    *disabled*; subsystems that need always-on accounting (the serving
    front-end's ``info()`` counters) hold their own always-enabled
    instance and mirror into the global one.
    """

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       label_names: Iterable[str]) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help, tuple(label_names))
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = ()) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Zero every series (families stay registered)."""
        with self._lock:
            for m in self._metrics.values():
                m._series.clear()

    def snapshot(self) -> dict:
        """Plain-dict view of every family (for dump / tests)."""
        out = {}
        with self._lock:
            for m in self._metrics.values():
                samples = {}
                for key, v in m._series.items():
                    label = ",".join(key) if key else ""
                    samples[label] = (
                        v.to_dict() if isinstance(v, HistogramState) else v
                    )
                out[m.name] = {
                    "type": m.kind,
                    "help": m.help,
                    "labels": list(m.label_names),
                    "samples": samples,
                }
        return out

    # -- exporters ---------------------------------------------------------

    def export_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            for m in self._metrics.values():
                lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                if isinstance(m, Histogram):
                    for key, st in m._series.items():
                        base = list(zip(m.label_names, key))
                        cum = 0
                        for edge, c in zip(
                            list(BUCKET_EDGES) + [math.inf], st.counts
                        ):
                            cum += c
                            lbl = "{" + ",".join(
                                f'{n}="{v}"' for n, v in
                                base + [("le", _fmt_value(edge))]
                            ) + "}"
                            lines.append(f"{m.name}_bucket{lbl} {cum}")
                        sfx = _fmt_labels(m.label_names, key)
                        lines.append(f"{m.name}_sum{sfx} {st.sum!r}")
                        lines.append(f"{m.name}_count{sfx} {st.count}")
                else:
                    for key, v in m._series.items():
                        sfx = _fmt_labels(m.label_names, key)
                        lines.append(f"{m.name}{sfx} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    def export_jsonl(self) -> str:
        """One JSON object per metric family, one per line."""
        snap = self.snapshot()
        return "\n".join(
            json.dumps({"name": name, **fam}, sort_keys=True)
            for name, fam in snap.items()
        ) + ("\n" if snap else "")


def lint_prometheus(text: str) -> list[str]:
    """promtool-style pure-Python format check; returns problem strings.

    Checks: every sample's metric name was declared by a # TYPE line,
    HELP/TYPE precede samples, names are legal, label syntax parses,
    values parse as floats, histogram buckets are cumulative and end in
    an le="+Inf" bucket matching _count.
    """
    import re

    problems: list[str] = []
    typed: dict[str, str] = {}
    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)$"
    )
    label_re = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"$')
    buckets: dict[tuple, list[tuple[float, float]]] = {}
    counts: dict[tuple, float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3 or not name_re.match(parts[2]):
                problems.append(f"line {ln}: malformed HELP")
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped"
            ):
                problems.append(f"line {ln}: malformed TYPE")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            problems.append(f"line {ln}: unparseable sample {line!r}")
            continue
        name, _, labelstr, value = m.groups()
        base = name
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and name[: -len(sfx)] in typed:
                base = name[: -len(sfx)]
        if base not in typed:
            problems.append(f"line {ln}: sample {name!r} missing # TYPE")
        labels = {}
        if labelstr:
            for pair in labelstr.split(","):
                if not label_re.match(pair):
                    problems.append(f"line {ln}: bad label {pair!r}")
                else:
                    k, v = pair.split("=", 1)
                    labels[k] = v.strip('"')
        try:
            fval = float(value)
        except ValueError:
            problems.append(f"line {ln}: bad value {value!r}")
            continue
        if name.endswith("_bucket") and typed.get(base) == "histogram":
            le = labels.get("le")
            if le is None:
                problems.append(f"line {ln}: bucket missing le label")
            else:
                key = (base,) + tuple(
                    sorted((k, v) for k, v in labels.items() if k != "le")
                )
                buckets.setdefault(key, []).append((float(le), fval))
        if name.endswith("_count") and typed.get(base) == "histogram":
            counts[(base,) + tuple(sorted(labels.items()))] = fval
    for key, bl in buckets.items():
        vals = [c for _, c in bl]
        if vals != sorted(vals):
            problems.append(f"{key[0]}: bucket counts not cumulative")
        if not bl or bl[-1][0] != math.inf:
            problems.append(f"{key[0]}: missing le=+Inf bucket")
        elif key in counts and counts[key] != bl[-1][1]:
            problems.append(f"{key[0]}: +Inf bucket != _count")
    return problems
