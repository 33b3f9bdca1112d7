"""A live index: one caller runs the recurring templates on a
``StreamingIndex`` in a closed loop while one writer thread applies update
batches on a fixed schedule (an open loop).

The index is not safe for concurrent mutation and reading, so one lock
covers ``update`` and the start of each query: ``StreamingIndex.index()``,
which snapshots base and delta into an overlay index.  The query then runs
on that snapshot outside the lock, as ``StreamingIndex.execute`` does, and
sees every update acknowledged before it started.  An update's latency runs
from the time it was due to its return."""
from __future__ import annotations

import math
import threading
import time

from bench import templates
from bench.common import quantile, time_call
from bench.loops import embedded


def _apply(run, batch) -> None:
    col, sets, clears = batch
    name = run.names[col]
    run.stream.update(sets={name: sets}, clears={name: clears})


def setup(run) -> None:
    p = run.program
    u = run.traffic["updates"]
    run.names = p.column_names(run.n_cols)
    run.stream = p.streaming_index(p.build_index(run.columns, run.cfg, run.device))
    run.stream_lock = threading.Lock()
    warm = int(u["warm_batches"])
    count = warm + math.ceil(run.seconds / float(u["period_s"])) + 2
    run.updates = templates.updates(run.traffic, run.r, run.n_cols, run.seed, count)
    for batch in run.updates[:warm]:
        _apply(run, batch)
    run.applied = warm
    run.specs = templates.recurring(run.traffic, run.n_cols, run.seed)
    run.make_query = lambda spec: p.to_query(spec, run.names)
    run.queries = [run.make_query(s) for s in run.specs]
    embedded.warm(run, run.stream.execute)
    run.notes["plans"] = [p.route(run.stream, q) for q in run.queries]
    run.layer["delta_words"] = []
    run.tracer.hooks_on.append(
        lambda: run.layer.__setitem__("compactions_on", run.stream.delta_stats()["compactions"]))
    run.tracer.hooks_off.append(
        lambda: run.layer.__setitem__("compactions_off", run.stream.delta_stats()["compactions"]))


def window(run) -> None:
    period = float(run.traffic["updates"]["period_s"])
    lateness = []

    def writer(t_open: float, t_close: float) -> None:
        i = 1
        while True:
            due = t_open + i * period
            if due >= t_close:
                return
            time.sleep(max(0.0, due - time.perf_counter()))
            t_call = time.perf_counter()
            with run.stream_lock:
                _apply(run, run.updates[run.applied])
                run.applied += 1
            run.update_latencies.append(time.perf_counter() - due)
            lateness.append(t_call - due)
            i += 1

    def execute(q):
        with run.stream_lock:
            idx = run.stream.index()
            version = run.applied
            if run.tracer.state == "on":
                run.layer["delta_words"].append(run.stream.delta_words)
        return time_call(idx.execute, q), version

    threads = []

    def on_open(t_open: float, t_close: float) -> None:
        threads.append(threading.Thread(target=writer, args=(t_open, t_close), name="bench-writer"))
        threads[0].start()

    try:
        embedded.closed_loop(run, execute, on_open)
    finally:
        for w in threads:
            w.join(timeout=600)
    if threads and threads[0].is_alive():
        raise RuntimeError("the writer did not finish")
    run.notes["writer_late_ms_max"] = 1e3 * max(lateness, default=0.0)
    if run.update_latencies:
        run.notes["update_p95_ms"] = 1e3 * quantile(run.update_latencies, 0.95)
    run.notes["delta_words_end"] = run.stream.delta_words
    run.notes["compactions_window"] = run.stream.delta_stats()["compactions"]


def teardown(run) -> None:
    run.stream = None
