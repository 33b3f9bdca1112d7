"""Observability overhead + export-surface benchmark (repro_torch.obs).

Measures what the unified observability layer costs on the query hot
path and exercises every export surface:

  * **enabled overhead** -- the same steady-state query stream (plan memo
    and compiled-circuit cache hot) timed with metrics + tracing OFF vs
    ON; the smoke config holds the enabled overhead under
    ``MAX_ENABLED_OVERHEAD_PCT``;
  * **disabled cost** -- the instrumented hot path with observability off
    pays one attribute load + branch per site; a micro-bench times that
    disabled site cost and reports the implied per-query overhead
    (held under ``MAX_DISABLED_OVERHEAD_PCT``);
  * **drift accounting** -- after the enabled run the calibration-drift
    sample count must be nonzero (every traced execute records one
    predicted-vs-measured observation);
  * **export lint** -- the Prometheus text exposition must pass the
    pure-Python scrape lint (``repro_torch.obs.lint_prometheus``), and the
    JSONL metrics + last span tree land in the trace artifact.

The port's counterpart of ``benchmarks/obs_bench.py``, on ``device``
(default: the CUDA card).  Each timed execute ends in a synchronise of the
device, where the reference's ends in ``block_until_ready``; spans time the
host (planning and the enqueue of kernels).  ``run`` writes
``artifacts/pt_bench/BENCH_obs.json`` (walls, overhead percentages, drift
counts, lint status) and ``artifacts/pt_bench/BENCH_obs_trace.jsonl``.

    PYTHONPATH=src:. python benchmarks/pt_obs_bench.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import pathlib
import statistics
import time

import numpy as np

from benchmarks.pt_common import sync
from repro_torch.device import resolve_device

ARTIFACTS = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "pt_bench"
OUT_PATH = ARTIFACTS / "BENCH_obs.json"
TRACE_PATH = ARTIFACTS / "BENCH_obs_trace.jsonl"

SMOKE = dict(n_cols=12, n_words=4096, n_queries=100, repeats=7)
FULL = dict(n_cols=24, n_words=8192, n_queries=400, repeats=7)

MAX_ENABLED_OVERHEAD_PCT = 5.0
MAX_DISABLED_OVERHEAD_PCT = 2.0
#: instrumentation sites one traced execute touches (spans + spot
#: counters + drift observes); deliberately over-counted for the implied
#: disabled-cost bound
DISABLED_SITES_PER_QUERY = 24


def _build_index(n_cols: int, n_words: int, seed: int = 0, device=None):
    from repro_torch.query import BitmapIndex

    rng = np.random.default_rng(seed)
    r = n_words * 32
    dens = rng.uniform(0.02, 0.4, n_cols)
    bits = rng.random((n_cols, r)) < dens[:, None]
    bits[: n_cols // 3, : r // 2] = False  # clean territory for tiling
    names = [f"store{i}" for i in range(n_cols)]
    return BitmapIndex.from_dense(bits, names=names, device=device), names


def _query_pool(names, n_queries: int, seed: int = 1):
    from repro_torch.query import And, Col, Interval, Not, Threshold

    rng = np.random.default_rng(seed)
    pool = [Interval(2, 10)]  # the abstract's 2-to-10-stores query
    while len(pool) < n_queries:
        k = int(rng.integers(3, min(8, len(names))))
        members = tuple(rng.choice(names, size=k, replace=False))
        t = int(rng.integers(1, k + 1))
        q = Threshold(t, over=members)
        if len(pool) % 3 == 1:
            q = And(q, Not(Col(str(rng.choice(names)))))
        pool.append(q)
    return pool


def _one_pass(idx, pool) -> None:
    for q in pool:
        idx.execute(q)
        sync(idx.device)


def _time_off_on(idx, pool, repeats: int) -> tuple[float, float, float]:
    """(off wall, on wall, overhead %) with obs OFF vs ON, per query.

    Each query is timed individually with the two modes interleaved
    back-to-back (off execute, on execute), ``repeats`` times; the
    per-mode wall is the sum over the pool of each query's MEDIAN time.
    Pass-level timing is not robust on shared boxes: scheduler/thermal
    bursts span whole passes and exceed the instrumentation cost being
    measured, while back-to-back pairing hits both modes with the same
    burst and the per-query median discards the outliers entirely."""
    import repro_torch.obs as obs

    dev = idx.device
    off_t: list[list[float]] = [[] for _ in pool]
    on_t: list[list[float]] = [[] for _ in pool]
    for _ in range(repeats):
        for qi, q in enumerate(pool):
            obs.disable()
            t0 = time.perf_counter()
            idx.execute(q)
            sync(dev)
            off_t[qi].append(time.perf_counter() - t0)
            obs.enable(slow_query_threshold_s=0.050)
            t0 = time.perf_counter()
            idx.execute(q)
            sync(dev)
            on_t[qi].append(time.perf_counter() - t0)
    obs.disable()
    wall_off = sum(statistics.median(t) for t in off_t)
    wall_on = sum(statistics.median(t) for t in on_t)
    return wall_off, wall_on, 100.0 * (wall_on - wall_off) / wall_off


def _disabled_site_cost() -> float:
    """Seconds per disabled instrumentation site (counter inc + span)."""
    import repro_torch.obs as obs
    from repro_torch.obs import trace

    if obs.enabled():
        raise AssertionError("the disabled-site probe needs observability off")
    c = obs.counter("repro_obs_bench_disabled_probe_total")
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        c.inc(1)
        trace.span("probe")
    return (time.perf_counter() - t0) / (2 * n)


def collect(smoke: bool = True, device=None) -> dict:
    """The measurements and exports of ``run``, without its contracts.

    Writes the trace artifact (``TRACE_PATH``); ends, as the reference's
    ``run`` does, with observability off, its registry reset and the
    compiled cache cleared."""
    import repro_torch.obs as obs
    from repro_torch.query import clear_compiled_cache

    dev = resolve_device(device)
    cfg = SMOKE if smoke else FULL
    idx, names = _build_index(cfg["n_cols"], cfg["n_words"], device=dev)
    pool = _query_pool(names, cfg["n_queries"])

    # warm everything BOTH modes will touch: kernel builds, plan memo, and
    # the lazy imports the first instrumented call performs
    obs.enable()
    _one_pass(idx, pool)
    obs.reset()

    wall_off, wall_on, enabled_overhead_pct = _time_off_on(
        idx, pool, cfg["repeats"]
    )

    site_cost = _disabled_site_cost()
    per_query_s = wall_off / len(pool)
    implied_disabled_pct = (
        100.0 * DISABLED_SITES_PER_QUERY * site_cost / per_query_s
    )

    # the drift / trace / export surfaces read the LAST enabled pass
    obs.enable(slow_query_threshold_s=0.050)
    obs.reset()
    _one_pass(idx, pool)

    drift = obs.drift_samples()
    last = obs.last_trace()
    prom = obs.export_prometheus()
    problems = obs.lint_prometheus(prom)

    lines = obs.export_jsonl().rstrip("\n").split("\n")
    lines.append(json.dumps(
        {"last_trace": None if last is None else last.to_dict()},
        default=str,
    ))
    TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
    TRACE_PATH.write_text("\n".join(lines) + "\n")

    dump = obs.dump()
    data = {
        "device": str(dev),
        "config": dict(cfg),
        "wall_off_s": wall_off,
        "wall_on_s": wall_on,
        "enabled_overhead_pct": enabled_overhead_pct,
        "disabled_site_cost_ns": site_cost * 1e9,
        "implied_disabled_overhead_pct": implied_disabled_pct,
        "drift_samples": drift,
        "drift": dump["drift"],
        "prometheus_lint_problems": problems,
        "prometheus_bytes": len(prom),
        "trace_artifact": str(TRACE_PATH),
    }

    if drift < len(pool):
        raise AssertionError(f"drift accounting broke: {drift} samples after "
                             f"{len(pool)} queries")
    if problems:
        raise AssertionError(f"Prometheus lint problems: {problems}")
    if last is None or last.find("plan") is None:
        raise AssertionError("traced run left no span tree with a plan span")

    obs.disable()
    obs.reset()
    clear_compiled_cache()
    return data


def rows(data: dict) -> list:
    """The reference's rows of a payload."""
    n_queries = data["config"]["n_queries"]
    problems = data["prometheus_lint_problems"]
    return [
        ("obs_wall_off_ms", data["wall_off_s"] * 1e3,
         f"{n_queries} queries (per-query medians), tracing off"),
        ("obs_wall_on_ms", data["wall_on_s"] * 1e3, "same stream, metrics+tracing on"),
        ("obs_enabled_overhead_pct", data["enabled_overhead_pct"],
         f"bound {MAX_ENABLED_OVERHEAD_PCT}%"),
        ("obs_disabled_site_ns", data["disabled_site_cost_ns"],
         f"implied {data['implied_disabled_overhead_pct']:.3f}%/query (bound "
         f"{MAX_DISABLED_OVERHEAD_PCT}%)"),
        ("obs_drift_samples", int(data["drift_samples"]), "predicted-vs-measured observations"),
        ("obs_prom_lint_problems", len(problems),
         "; ".join(problems) if problems else "scrape-clean"),
        ("bench_obs_json", 1, str(OUT_PATH)),
        ("bench_obs_trace_jsonl", 1, data["trace_artifact"]),
    ]


def contracts(data: dict) -> list:
    """The reference's time contracts (``obs_bench.py``'s smoke asserts),
    each with its value, its limit, whether it holds and the reference's
    message."""
    on, off = data["enabled_overhead_pct"], data["implied_disabled_overhead_pct"]
    return [
        {"contract": "enabled_overhead_pct", "value": on,
         "limit": f"< {MAX_ENABLED_OVERHEAD_PCT}", "ok": on < MAX_ENABLED_OVERHEAD_PCT,
         "message": f"metrics+tracing cost {on:.2f}% (bound {MAX_ENABLED_OVERHEAD_PCT}%)"},
        {"contract": "implied_disabled_overhead_pct", "value": off,
         "limit": f"< {MAX_DISABLED_OVERHEAD_PCT}", "ok": off < MAX_DISABLED_OVERHEAD_PCT,
         "message": f"disabled instrumentation implies {off:.3f}% "
                    f"(bound {MAX_DISABLED_OVERHEAD_PCT}%)"},
    ]


def check_contracts(data: dict) -> None:
    """Raise ``AssertionError`` with the reference's message for the first
    contract that misses."""
    for c in contracts(data):
        if not c["ok"]:
            raise AssertionError(c["message"])


def run(smoke: bool = True, device=None):
    data = collect(smoke, device)
    OUT_PATH.parent.mkdir(parents=True, exist_ok=True)
    OUT_PATH.write_text(json.dumps(data, indent=2, sort_keys=True))
    if smoke:
        check_contracts(data)
    return rows(data)


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    args = parse_args(smoke=True)
    for name, val, extra in run(smoke=args.smoke, device=args.device):
        print(f"{name},{val if isinstance(val, int) else round(float(val), 3)},{extra}")
