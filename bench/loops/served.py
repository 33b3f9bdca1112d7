"""Served use: client threads, each in a closed loop, submit ad-hoc queries
to a ``QueryServer`` over the index and wait for each reply.  A reply's
future resolves only after the server's stream synchronise
(``QueryServer._dispatch``), so the result is on the device when a client
reads its clock."""
from __future__ import annotations

import itertools
import threading
import time

from bench import templates
from bench.common import Sampler

REPLY_TIMEOUT_S = 120.0
WARM_ROUNDS = 2
#: requests a client has ready before the window opens, as a multiple of
#: what it sends in a window at the cell's measured rate; past them it
#: draws more as it goes
READY_PER_CLIENT_S = 60.0


def setup(run) -> None:
    p = run.program
    s = run.traffic["server"]
    run.index = p.build_index(run.columns, run.cfg, run.device)
    run.server = p.query_server(run.index, window=float(s["window_s"]),
                                max_batch=int(s["max_batch"]),
                                cache_entries=int(s["cache_entries"]))
    names = p.column_names(run.n_cols)
    run.make_query = lambda spec: p.to_query(spec, names)
    warm_up(run)
    ready = int(READY_PER_CLIENT_S * run.seconds)
    run.streams = []
    for i in range(int(run.traffic["clients"])):
        gen = templates.adhoc(run.traffic, run.n_cols, run.seed, f"client{i}")
        specs = [next(gen) for _ in range(ready)]
        run.streams.append(([(s, run.make_query(s)) for s in specs], gen))
    run.tracer.hooks_on.append(lambda: run.layer.__setitem__("server_on", run.server.info()))
    run.tracer.hooks_off.append(lambda: run.layer.__setitem__("server_off", run.server.info()))


def warm_up(run) -> None:
    warm = templates.adhoc(run.traffic, run.n_cols, run.seed, "warm")
    per_round = int(run.traffic["clients"]) * len(templates.pairs(run.traffic))
    for _ in range(WARM_ROUNDS):
        futs = [run.server.submit(run.make_query(next(warm))) for _ in range(per_round)]
        for f in futs:
            f.result(timeout=REPLY_TIMEOUT_S)


def window(run) -> None:
    clients = int(run.traffic["clients"])
    k = max(1, int(run.traffic["check_sample"]) // clients)
    samplers = [Sampler(k, run.seed, f"sample{i}") for i in range(clients)]
    t_close = run.open_window()

    def client(i: int) -> None:
        ready, gen = run.streams[i]
        for k in itertools.count():
            if k < len(ready):
                spec, q = ready[k]
            else:
                spec = next(gen)
                q = run.make_query(spec)
            t0 = time.perf_counter()
            if t0 >= t_close:
                return
            with run.lock:
                run.attempted += 1
            try:
                with run.tracer.annotate("bench.submit_and_wait"):
                    out = run.server.submit(q).result(timeout=REPLY_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                run.fail(e)
                continue
            run.record(t0, time.perf_counter(), spec)
            samplers[i].offer((spec, out, None))

    threads = [threading.Thread(target=client, args=(i,), name=f"bench-client-{i}")
               for i in range(clients)]
    for t in threads:
        t.start()
    while time.perf_counter() < t_close:
        run.tracer.poll()
        time.sleep(0.002)
    run.tracer.finish()
    for t in threads:
        t.join(timeout=REPLY_TIMEOUT_S + 60)
        if t.is_alive():
            raise RuntimeError(f"{t.name} did not finish")
    run.samples = [item for s in samplers for item in s.items]


def teardown(run) -> None:
    run.streams = None
    run.server.stop()
    run.server = None
    run.index = None
