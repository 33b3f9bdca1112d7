"""Serving-throughput benchmark: the coalescing front-end vs per-query loops.

Synthetic multi-tenant workload: K logical clients concurrently submit
requests drawn (zipf-weighted) from a shared pool of hot queries -- the
abstract's "on sale in 2 to 10 stores" shape plus thresholds/composites
over store subsets -- against one :class:`repro_torch.serve.QueryServer`.
The headline number is queries/second, not single-query wall time:

  * **sequential baseline** -- the identical request stream executed one
    ``idx.execute`` at a time (what a naive per-request handler does; it
    still enjoys the compiled-circuit cache and plan memo);
  * **coalesced front-end** -- the same stream through ``QueryServer``:
    shape-bucketed micro-batches, semantic dedup, the version-keyed
    result cache, calibration feedback.

The port's counterpart of ``benchmarks/serve_bench.py``, on ``device``
(default: the CUDA card; the server's batcher thread launches there).
Each sequential execute ends in a synchronise of the device, where the
reference's ends in ``block_until_ready``.  Every wait is bounded by
``WAIT_S`` (a client's futures, its thread, the server's stop): a hang
fails the run.  ``run`` writes ``artifacts/pt_bench/BENCH_serve.json``:
QPS per client count, p50/p95/p99 request latency and queue wait (from the
server's metrics-registry histograms), batch-size histogram, cache-hit /
dedup / shed rates, plan-memo counters, measured calibration constants,
and an oracle spot-check flag (every distinct pool query served
bit-identical to direct execution).  The smoke config holds the
reference's contracts (``check_contracts``): the coalesced front-end
clears >= 3x sequential QPS at >= 8 clients and p99 latency is finite and
reported.

    PYTHONPATH=src:. python benchmarks/pt_serve_bench.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import math
import pathlib
import threading
import time

import numpy as np

from benchmarks.pt_common import sync
from repro_torch.device import resolve_device, to_numpy_u32

OUT_PATH = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "pt_bench" / \
    "BENCH_serve.json"

SMOKE = dict(n_cols=16, n_words=2048, clients=(1, 2, 4, 8), per_client=40,
             pool_size=12, repeats=1)
FULL = dict(n_cols=24, n_words=4096, clients=(1, 2, 4, 8, 16), per_client=200,
            pool_size=16, repeats=3)

MIN_SPEEDUP_AT_8 = 3.0
WAIT_S = 60.0  # the most any wait of the bench may take (the reference's f.result(60))


def _build_index(n_cols: int, n_words: int, seed: int = 0, device=None):
    from repro_torch.stream import StreamingIndex

    rng = np.random.default_rng(seed)
    r = n_words * 32
    dens = rng.uniform(0.02, 0.4, n_cols)
    bits = rng.random((n_cols, r)) < dens[:, None]
    # clean territory so the tiled path is a real planner candidate
    bits[: n_cols // 3, : r // 2] = False
    names = [f"store{i}" for i in range(n_cols)]
    return StreamingIndex.from_dense(bits, names=names, device=device), names


def _query_pool(names, pool_size: int, seed: int = 1):
    from repro_torch.query import And, AndNot, Col, Interval, Not, Threshold

    rng = np.random.default_rng(seed)
    pool = [Interval(2, 10)]  # the abstract's query, over every store
    while len(pool) < pool_size:
        k = int(rng.integers(3, min(8, len(names))))
        members = tuple(rng.choice(names, size=k, replace=False))
        t = int(rng.integers(1, k + 1))
        q = Threshold(t, over=members)
        style = len(pool) % 3
        if style == 1:
            q = And(q, Not(Col(str(rng.choice(names)))))
        elif style == 2:
            q = AndNot(Interval(1, max(1, k - 1), over=members), Col(str(rng.choice(names))))
        pool.append(q)
    return pool


def _request_streams(pool, clients: int, per_client: int, seed: int = 2):
    """Per-client request lists, zipf-weighted over the hot pool."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, len(pool) + 1)
    w /= w.sum()
    return [
        [pool[i] for i in rng.choice(len(pool), size=per_client, p=w)]
        for _ in range(clients)
    ]


def _sequential_qps(stream_idx, requests, repeats: int) -> float:
    idx = stream_idx.index()
    dev = idx.device
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        for q in requests:
            idx.execute(q)
            sync(dev)
        wall = time.perf_counter() - t0
        best = max(best, len(requests) / wall)
    return best


def _run_clients(streams, server) -> tuple:
    """Each stream submitted from a thread of its own; ``(wall seconds,
    results)``.  A client's exception, a future unresolved after
    ``WAIT_S`` or a thread left running fails the run."""
    results: list = [None] * len(streams)
    errors: list = []

    def client(ci: int) -> None:
        try:
            futs = [server.submit(q) for q in streams[ci]]
            results[ci] = [f.result(WAIT_S) for f in futs]
        except BaseException as e:  # noqa: BLE001 - raised again below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(len(streams))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a client did not finish within {WAIT_S} s")
    if errors:
        raise errors[0]
    return wall, results


def _stop_server(server) -> None:
    """``server.stop()`` within ``WAIT_S``; its batcher thread must be gone."""
    batcher = server._thread
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    stopper.join(WAIT_S)
    if stopper.is_alive() or (batcher is not None and batcher.is_alive()):
        raise AssertionError(f"the server did not stop within {WAIT_S} s")


def _coalesced_qps(stream_idx, streams, repeats: int, window: float):
    from repro_torch.serve import QueryServer

    best = None
    for _ in range(repeats):
        server = QueryServer(stream_idx, window=window, max_pending=4096)
        server.start()
        wall, _ = _run_clients(streams, server)
        _stop_server(server)
        n = sum(len(s) for s in streams)
        qps = n / wall
        if best is None or qps > best[0]:
            best = (qps, server.info())
    return best


def _oracle_check(stream_idx, pool) -> bool:
    """Every distinct pool query served through the front-end must be
    bit-identical to direct execution."""
    from repro_torch.serve import QueryServer

    idx = stream_idx.index()
    server = QueryServer(stream_idx, window=0)
    futs = [server.submit(q) for q in pool]
    while server.pump():
        pass
    for q, f in zip(pool, futs):
        got = to_numpy_u32(f.result(0))
        ref = to_numpy_u32(idx.execute(q))
        if not np.array_equal(got, ref):
            return False
    return True


def collect(smoke: bool = True, device=None) -> dict:
    """The measurements of ``run``, without its artifact and contracts.

    Installs a calibration measured on ``device`` for the sweep; ends, as
    the reference's ``run`` does, with none installed and the compiled
    cache cleared."""
    from repro_torch.core.calibration import measure_calibration, set_calibration
    from repro_torch.query import clear_compiled_cache, plan_memo_info

    dev = resolve_device(device)
    cfg = SMOKE if smoke else FULL
    stream_idx, names = _build_index(cfg["n_cols"], cfg["n_words"], device=dev)
    pool = _query_pool(names, cfg["pool_size"])

    # measured words->us constants steer every plan below and land in the
    # artifact; the 'repeats' keep the pass cheap
    calib = measure_calibration(repeats=2, n_words=min(cfg["n_words"], 1024), device=dev)
    set_calibration(calib)

    # absorb compilation for both paths: each distinct query runs once
    idx = stream_idx.index()
    for q in pool:
        idx.execute(q)
        sync(dev)

    data = {
        "device": str(dev),
        "config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg.items()},
        "calibration": calib.to_obj(),
        "sweep": [],
    }

    oracle_ok = _oracle_check(stream_idx, pool)
    data["oracle_bit_identical"] = bool(oracle_ok)
    if not oracle_ok:
        raise AssertionError("served results diverged from direct execution")

    for clients in cfg["clients"]:
        streams = _request_streams(pool, clients, cfg["per_client"])
        flat = [q for s in streams for q in s]
        if "sequential_qps" not in data:  # request mix is identical per client count
            data["sequential_qps"] = _sequential_qps(stream_idx, flat, cfg["repeats"])
        seq_qps = data["sequential_qps"]
        qps, info = _coalesced_qps(
            stream_idx, streams, cfg["repeats"], window=0.001
        )
        served = max(1, info["served"])
        data["sweep"].append({
            "clients": clients,
            "offered": len(flat),
            "qps": qps,
            "speedup_vs_sequential": qps / seq_qps,
            "cache_hit_rate": info["cache_hits"] / served,
            "dedup_rate": info["dedup_hits"] / served,
            "shed": info["shed"],
            "executed": info["executed"],
            "batches": info["batches"],
            "batch_size_hist": info["batch_size_hist"],
            "plan_memo": info["plan_memo"],
            # request latency + queue wait from the server's metrics
            # registry histograms (exact-merge log-bucketed percentiles)
            "latency_s": info["latency"],
            "queue_wait_s": info["queue_wait"],
        })

    data["plan_memo"] = plan_memo_info()
    set_calibration(None)
    clear_compiled_cache()
    return data


def rows(data: dict) -> list:
    """The reference's rows of a payload (without the artifact's row)."""
    seq_qps = data["sequential_qps"]
    out = [("serve_sequential_qps", seq_qps, "per-query execute loop")]
    for point in data["sweep"]:
        clients, qps = point["clients"], point["qps"]
        lat, qw = point["latency_s"], point["queue_wait_s"]
        out.append(
            (
                f"serve_qps_c{clients}",
                qps,
                f"{qps / seq_qps:.1f}x seq; cache {point['cache_hit_rate']:.0%} "
                f"dedup {point['dedup_rate']:.0%} exec {point['executed']} "
                f"p99 {lat['p99_s'] * 1e3:.2f}ms",
            )
        )
        out.append(
            (
                f"serve_p99_ms_c{clients}",
                lat["p99_s"] * 1e3,
                f"p50 {lat['p50_s'] * 1e3:.2f}ms queue-wait p99 "
                f"{qw['p99_s'] * 1e3:.2f}ms",
            )
        )
    return out


def contracts(data: dict) -> list:
    """The reference's time contracts (``serve_bench.py``'s smoke asserts),
    each with its value, its limit, whether it holds and the reference's
    message."""
    out = []
    at_8 = [p for p in data["sweep"] if p["clients"] >= 8]
    if at_8:
        speedup = at_8[0]["speedup_vs_sequential"]
        out.append({
            "contract": "speedup_vs_sequential_at_8_clients", "value": speedup,
            "limit": f">= {MIN_SPEEDUP_AT_8}", "ok": speedup >= MIN_SPEEDUP_AT_8,
            "message": f"coalesced front-end only {speedup:.2f}x sequential at >=8 "
                       f"clients (need >= {MIN_SPEEDUP_AT_8}x)"})
    for point in data["sweep"]:
        p99 = point["latency_s"]["p99_s"]
        out.append({
            "contract": f"p99_finite_c{point['clients']}", "value": p99, "limit": "> 0, finite",
            "ok": math.isfinite(p99) and p99 > 0,
            "message": f"p99 latency not finite at {point['clients']} clients: {p99}"})
        count = point["latency_s"]["count"]
        out.append({
            "contract": f"latency_count_c{point['clients']}", "value": count, "limit": "> 0",
            "ok": count > 0, "message": "latency histogram empty"})
    return out


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
    out = rows(data) + [("bench_serve_json", 1, str(OUT_PATH))]
    if smoke:
        check_contracts(data)
    return out


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    args = parse_args(smoke=True)
    for name, val, extra in run(smoke=args.smoke, device=args.device):
        print(f"{name},{val if isinstance(val, int) else round(float(val), 3)},{extra}")
