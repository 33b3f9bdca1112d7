"""Embedded use: one caller runs the recurring templates through
``BitmapIndex.execute`` in a closed loop, each call followed by a device
synchronise, so a latency is the time to the result on the device."""
from __future__ import annotations

import time

from bench import templates
from bench.common import Sampler, quantile, time_call


def warm(run, execute) -> None:
    """One pass over the templates: it fills the plan memo, the compile
    cache and the tiled plans.  ``first_ms`` (notes) is each template's
    first request of the window, to set beside its median."""
    for q in run.queries:
        time_call(execute, q)


def setup(run) -> None:
    p = run.program
    run.index = p.build_index(run.columns, run.cfg, run.device)
    run.specs = templates.recurring(run.traffic, run.n_cols, run.seed)
    names = p.column_names(run.n_cols)
    run.make_query = lambda spec: p.to_query(spec, names)
    run.queries = [run.make_query(s) for s in run.specs]
    warm(run, run.index.execute)
    run.notes["plans"] = [p.route(run.index, q) for q in run.queries]


def closed_loop(run, execute, on_open=None) -> None:
    """Requests until the window closes.  ``execute(query)`` returns the
    result and the index version it answered at (None: a fixed index);
    ``on_open(t_open, t_close)`` runs as the window opens."""
    sampler = Sampler(int(run.traffic["check_sample"]), run.seed, "sample")
    firsts: dict = {}
    per_template: dict = {}
    order = templates.order(len(run.queries), run.seed)
    t_close = run.open_window()
    if on_open is not None:
        on_open(run.t_open, t_close)
    while True:
        t0 = time.perf_counter()
        if t0 >= t_close:
            break
        run.tracer.poll(t0)
        j = next(order)
        run.attempted += 1
        try:
            with run.tracer.annotate("bench.execute"):
                out, v = execute(run.queries[j])
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
            run.fail(e)
            continue
        t1 = time.perf_counter()
        run.record(t0, t1, run.specs[j])
        per_template.setdefault(j, []).append(t1 - t0)
        item = (run.specs[j], out, v)
        if j not in firsts:
            firsts[j] = item
        else:
            sampler.offer(item)
    run.samples = list(firsts.values()) + sampler.items
    run.notes["per_template_ms"] = [
        [s["kind"], len(templates.columns_read(s)), round(1e3 * quantile(per_template[j], 0.5), 3),
         len(per_template[j]), round(1e3 * per_template[j][0], 3)]
        for j, s in enumerate(run.specs) if j in per_template]
    run.notes["per_template_ms_columns"] = ["kind", "columns read", "median", "requests", "first"]


def window(run) -> None:
    closed_loop(run, lambda q: (time_call(run.index.execute, q), None))


def teardown(run) -> None:
    run.index = None
