"""`QueryServer`: a coalescing, caching multi-client query front-end.

The port of the reference's ``repro.serve.frontend`` (same public surface,
event and metric names); results are int32 word tensors on the index's
device, and a micro-batch counts as done only once the device has finished
it (see :meth:`QueryServer._dispatch`).

The paper's closing argument -- threshold results "can be further
processed within a bitmap index" -- only pays off if the index serves many
such queries cheaply under real load.  The execution machinery is already
shaped for it (``execute_many`` batches independent queries into one
kernel launch; the scan engine makes steady-state queries dispatch-only),
but a per-query loop still pays planning, compile-cache probing and a full
execution per request.  This front-end turns that machinery into a
throughput engine:

  * **micro-batching** -- in-flight requests from any number of logical
    clients coalesce into *shape-bucketed* micro-batches, one
    ``execute_many`` call per bucket.  A bucket groups queries with the
    same structural skeleton and sorts them by canonical key, so a hot
    workload's recurring query mix produces recurring batch compositions
    and the compiled-circuit cache converges to compile-once-run-many
    (the same economics as stacking identical scan layers);
  * **request deduplication** -- identical in-flight queries (by
    *semantic* canonical key: member order, And/Or child order etc.
    normalised away) collapse to ONE execution fanned out to every
    waiter;
  * **result caching** -- completed results live in an LRU keyed by
    ``(canonical key, per-column version vector)``.  Version vectors come
    from :attr:`~repro_torch.stream.StreamingIndex.column_versions`, so a
    mutation invalidates exactly the entries reading a touched column
    (materialized-view columns cascade); everything else keeps hitting.
    Materialized views + this cache are the server-side cache tier for
    repeated hot queries;
  * **admission control** -- the pending set is bounded; past the bound,
    :meth:`submit` sheds the request with an explicit :class:`Overloaded`
    signal instead of growing latency without bound;
  * **planner feedback** -- each micro-batch's measured wall time feeds
    the active words→µs calibration (``core.calibration``), and plans come
    through the per-store memo (``BitmapIndex.explain``), so steady-state
    requests skip planning entirely.

Two driving modes: :meth:`start` spawns a background batcher thread that
sleeps a coalescing window and dispatches (the serving deployment), while
:meth:`pump` processes one micro-batch synchronously (deterministic tests,
single-threaded embedding).  ``submit`` returns a
:class:`concurrent.futures.Future` either way.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, defaultdict
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import lru_cache

import torch

import repro_torch.obs as _obs
from repro_torch.core.calibration import get_calibration
from repro_torch.obs import trace as _trace
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.query import plan_memo_info
from repro_torch.query.expr import (
    And,
    AndNot,
    Col,
    Not,
    Or,
    Query,
    Weighted,
    _SymmetricLeaf,
    as_query,
    bind_members,
    canonical_key,
    column_refs,
)

__all__ = ["Overloaded", "QueryServer", "shape_bucket"]


# Serving lifecycle counter events (one labelled family, not nine names:
# merges across servers/shards stay a single schema).
_EVENT_NAMES = (
    "requests", "served", "cache_hits", "dedup_hits", "shed",
    "executed", "batches", "invalidations", "errors",
)

# Mirrors on the process-wide registry: no-ops until ``repro_torch.obs.enable()``.
# The server also keeps its OWN always-enabled registry (``QueryServer.obs``)
# so ``info()`` counters and latency percentiles work regardless of the
# global observability switch.
_G_EVENTS = _obs.REGISTRY.counter(
    "repro_serve_events_total", "QueryServer lifecycle events", ("event",),
)
_G_BATCH = _obs.REGISTRY.counter(
    "repro_serve_batch_size_total", "Micro-batch occurrences by exact size",
    ("size",),
)
_G_QWAIT = _obs.REGISTRY.histogram(
    "repro_serve_queue_wait_seconds", "submit -> micro-batch dispatch wait",
)
_G_LAT = _obs.REGISTRY.histogram(
    "repro_serve_request_latency_seconds", "submit -> result resolution",
)


class Overloaded(RuntimeError):
    """Admission control rejected the request: the pending queue is full.

    Deliberate backpressure -- the client should retry later or against a
    replica; queueing it anyway would grow tail latency without bound."""


@lru_cache(maxsize=8192)
def _analyze(query, names: tuple):
    """Bind + canonicalise + support extraction, memoized.

    Pure in (query, schema): queries are frozen dataclasses, so a hot
    workload's recurring requests make ``submit`` a couple of dict probes
    instead of a tree walk."""
    q = bind_members(as_query(query), names)
    ckey = canonical_key(q)
    cols = column_refs(q)
    return q, ckey, frozenset(names) if cols is None else cols


def shape_bucket(q: Query) -> tuple:
    """The micro-batch bucket key: a query's structural skeleton.

    Member names and thresholds are dropped (two thresholds over different
    store subsets batch together); arity is kept (the compiled circuit's
    adder width follows it).  Queries in one bucket ride one
    ``execute_many`` call."""
    q = as_query(q)
    if type(q) is Col:
        return ("col",)
    if isinstance(q, _SymmetricLeaf):
        tag = type(q).__name__.lower()
        return (tag, None if q.over is None else len(q.over))
    if isinstance(q, Weighted):
        return ("weighted", None if q.over is None else len(q.over))
    if isinstance(q, (And, Or)):
        tag = "and" if isinstance(q, And) else "or"
        return (tag,) + tuple(shape_bucket(c) for c in q.children)
    if isinstance(q, Not):
        return ("not", shape_bucket(q.child))
    if isinstance(q, AndNot):
        return ("andnot", shape_bucket(q.keep), shape_bucket(q.drop))
    raise TypeError(f"unknown query node {type(q).__name__}")


@dataclass
class _Pending:
    """One distinct in-flight query and everyone waiting on it.

    ``futures`` holds ``(future, t_submit)`` pairs so resolution can
    observe each waiter's end-to-end latency; ``t_submit`` is the first
    waiter's enqueue time (the queue-wait clock)."""

    query: Query  # member-bound expression
    ckey: tuple
    backend: str | None
    cols: frozenset  # support column names (cache version vector domain)
    futures: list = field(default_factory=list)  # [(Future, t_submit), ...]
    t_submit: float = 0.0


class _ResultCache:
    """LRU of finished results keyed (canonical key, backend, version
    vector), with a column→keys reverse index for exact invalidation."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._od: OrderedDict = OrderedDict()  # key -> (cols, result)
        self._by_col: dict = defaultdict(set)  # name -> set of keys

    def __len__(self) -> int:
        return len(self._od)

    def get(self, key):
        got = self._od.get(key)
        if got is None:
            return None
        self._od.move_to_end(key)
        return got[1]

    def put(self, key, cols, value) -> None:
        if key in self._od:
            self._od.move_to_end(key)
            return
        self._od[key] = (cols, value)
        for c in cols:
            self._by_col[c].add(key)
        while len(self._od) > self.cap:
            self._drop(next(iter(self._od)))

    def _drop(self, key) -> None:
        cols, _ = self._od.pop(key)
        for c in cols:
            keys = self._by_col.get(c)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_col[c]

    def invalidate(self, names) -> int:
        """Evict every entry reading any of ``names``; returns the count.
        (Version-vector keys make stale hits impossible regardless -- this
        reclaims the memory and feeds the invalidation counters.)"""
        stale = set()
        for n in names:
            stale |= self._by_col.get(n, set())
        for key in stale:
            self._drop(key)
        return len(stale)

    def clear(self) -> None:
        self._od.clear()
        self._by_col.clear()


class QueryServer:
    """Serve query expressions to many logical clients over one index.

    ``index`` is a :class:`~repro_torch.stream.StreamingIndex` (mutations
    flow, cache invalidation is wired to its version bumps) or a plain
    :class:`~repro_torch.query.BitmapIndex` (immutable: every cache entry
    lives until evicted).  The server runs on the index's device; cached
    results stay there (a result is ``4 * n_words`` bytes).  Each request
    resolves to a tensor of its own (a copy of the cached or fanned-out
    result), so a client may modify its result in place.

    Parameters
    ----------
    max_pending:
        Admission bound on *distinct* in-flight queries; past it
        :meth:`submit` raises :class:`Overloaded` (deduped waiters on
        already-admitted queries are always accepted).
    max_batch:
        Most distinct queries one :meth:`pump` drains (micro-batch size
        cap; one pump may still dispatch several shape buckets).
    window:
        Batcher-thread coalescing window in seconds: after waking on a
        submission it sleeps this long so concurrent clients pile into the
        same micro-batch.
    cache_entries:
        Result-cache LRU capacity (0 disables result caching).
    backend:
        Default backend override passed to every execution (None: planner).
    calibration:
        A :class:`~repro_torch.core.calibration.Calibration` to feed measured
        batch wall times back into (defaults to the process-active one, if
        installed).
    """

    def __init__(self, index, *, max_pending: int = 1024, max_batch: int = 64,
                 window: float = 0.002, cache_entries: int = 4096,
                 backend: str | None = None, calibration=None):
        from repro_torch.stream import StreamingIndex

        self._streaming = isinstance(index, StreamingIndex)
        self._src = index
        self.max_pending = int(max_pending)
        self.max_batch = int(max_batch)
        self.window = float(window)
        self.backend = backend
        self.calibration = calibration if calibration is not None else get_calibration()
        self._cache = _ResultCache(cache_entries) if cache_entries else None
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: OrderedDict = OrderedDict()  # (ckey, backend) -> _Pending
        self._inflight: dict = {}  # same keys, currently executing
        self._thread: threading.Thread | None = None
        self._stop = False
        #: the server's own always-enabled metrics registry: ``info()``
        #: counters and latency percentiles hold whether or not the
        #: process-wide ``repro_torch.obs`` switch is on; every mutation is
        #: mirrored onto the global registry (a no-op when disabled)
        self.obs = MetricsRegistry(enabled=True)
        self._events = self.obs.counter(
            "repro_serve_events_total", "QueryServer lifecycle events",
            ("event",),
        )
        self._batch_hist = self.obs.counter(
            "repro_serve_batch_size_total",
            "Micro-batch occurrences by exact size", ("size",),
        )
        self._queue_wait = self.obs.histogram(
            "repro_serve_queue_wait_seconds",
            "submit -> micro-batch dispatch wait",
        )
        self._latency = self.obs.histogram(
            "repro_serve_request_latency_seconds",
            "submit -> result resolution",
        )
        if self._streaming:
            self._src.subscribe(self._on_version_bump)

    # -- index plumbing ----------------------------------------------------
    def _names(self) -> tuple:
        return tuple(self._src.names)

    def _index(self):
        """The executable index of NOW (overlay + refreshed views when
        streaming)."""
        return self._src.index() if self._streaming else self._src

    def _versions(self) -> dict:
        return self._src.column_versions if self._streaming else {}

    def _device(self) -> torch.device:
        return torch.device(self._src.device)

    def _vkey(self, cols: frozenset, versions: dict) -> tuple:
        return tuple(sorted((c, versions.get(c, 0)) for c in cols))

    def _on_version_bump(self, version: int, names: frozenset) -> None:
        if self._cache is None:
            return
        with self._lock:
            self._count("invalidations", self._cache.invalidate(names))

    # -- metrics plumbing --------------------------------------------------
    def _count(self, event: str, n: int = 1) -> None:
        """One lifecycle event: server registry always, global mirror when
        observability is enabled."""
        self._events.inc(n, event=event)
        _G_EVENTS.inc(n, event=event)

    def _observe_latency(self, seconds: float) -> None:
        self._latency.observe(seconds)
        _G_LAT.observe(seconds)

    def _observe_queue_wait(self, seconds: float) -> None:
        self._queue_wait.observe(seconds)
        _G_QWAIT.observe(seconds)

    # -- client surface ----------------------------------------------------
    def submit(self, query, *, backend: str | None = None) -> Future:
        """Enqueue one query; returns a Future of the packed result bitmap,
        a tensor that no other request or the cache shares.

        Fast paths resolve before any queueing: a result-cache hit
        completes immediately; a semantically identical in-flight query
        adds this caller to its waiter list.  Otherwise the query joins
        the pending set -- unless that set is full, in which case the
        request is shed with :class:`Overloaded`.
        """
        backend = backend or self.backend
        t_sub = time.perf_counter()
        try:
            q, ckey, cols = _analyze(query, self._names())
        except TypeError:  # unhashable query: skip the memo
            q = bind_members(as_query(query), self._names())
            ckey = canonical_key(q)
            cols = column_refs(q) or frozenset(self._names())
        fut: Future = Future()
        with self._lock:
            self._count("requests")
            hit = None
            if self._cache is not None:
                hit = self._cache.get((ckey, backend, self._vkey(cols, self._versions())))
            if hit is not None:
                self._count("cache_hits")
                self._count("served")
            else:
                key = (ckey, backend)
                inflight = self._pending.get(key) or self._inflight.get(key)
                if inflight is not None:
                    self._count("dedup_hits")
                    inflight.futures.append((fut, t_sub))
                    return fut
                if len(self._pending) >= self.max_pending:
                    self._count("shed")
                    raise Overloaded(
                        f"pending queue full ({self.max_pending} distinct queries "
                        "in flight); retry later"
                    )
                self._pending[key] = _Pending(
                    query=q, ckey=ckey, backend=backend, cols=cols,
                    futures=[(fut, t_sub)], t_submit=t_sub,
                )
                self._work.notify()
                return fut
        # a cache hit: copied outside the lock, the cached tensor stays the server's
        fut.set_result(hit.clone())
        self._observe_latency(time.perf_counter() - t_sub)
        return fut

    def serve_many(self, queries, *, backend: str | None = None,
                   timeout: float | None = 30.0) -> list:
        """Submit a batch and wait for all results (pumping inline when no
        batcher thread is running).  Convenience for synchronous callers."""
        futs = [self.submit(q, backend=backend) for q in queries]
        if self._thread is None:
            while any(not f.done() for f in futs):
                if self.pump() == 0 and any(not f.done() for f in futs):
                    raise RuntimeError("pending futures but nothing to pump")
        return [f.result(timeout=timeout) for f in futs]

    # -- dispatch ----------------------------------------------------------
    def pump(self) -> int:
        """Drain one micro-batch synchronously; returns requests served.

        Takes up to ``max_batch`` distinct pending queries (FIFO), groups
        them into shape buckets, and dispatches each bucket as ONE
        ``execute_many`` call.  The batcher thread calls this in a loop;
        tests and single-threaded embeddings call it directly.
        """
        with self._lock:
            take = []
            while self._pending and len(take) < self.max_batch:
                p = self._pending.popitem(last=False)[1]
                # stays dedup-visible while executing: late identical
                # submissions join the fan-out instead of re-running
                self._inflight[(p.ckey, p.backend)] = p
                take.append(p)
        if not take:
            return 0
        try:
            idx = self._index()
            versions = self._versions()
        except Exception as e:  # noqa: BLE001 - refresh/overlay failure
            self._fail(take, e)
            return 0
        buckets: dict = defaultdict(list)
        for p in take:
            buckets[(shape_bucket(p.query), p.backend)].append(p)
        served = 0
        for (_, backend), items in buckets.items():
            # deterministic batch composition: recurring hot sets hit the
            # compiled-circuit cache with the same key every time
            items.sort(key=lambda p: repr(p.ckey))
            served += self._dispatch(idx, versions, items, backend)
        return served

    def _fail(self, items, exc) -> None:
        """Retire ``items`` with ``exc`` (pops them from the in-flight map
        first so waiter lists are final when we resolve them)."""
        with self._lock:
            self._count("errors", len(items))
            futures = []
            for p in items:
                self._inflight.pop((p.ckey, p.backend), None)
                futures.extend(f for f, _t in p.futures)
        for f in futures:
            f.set_exception(exc)

    def _dispatch(self, idx, versions, items, backend) -> int:
        t0 = time.perf_counter()
        for p in items:
            self._observe_queue_wait(max(0.0, t0 - p.t_submit))
        try:
            with _trace.span(
                "serve_batch", batch=len(items),
                backend=backend if backend is not None else "planner",
            ):
                outs = idx.execute_many([p.query for p in items], backend=backend)
                # the kernels are only enqueued: wait for the device before
                # the wall time is read and any waiter sees a result (a
                # device fault then fails this bucket like any other error)
                dev = self._device()
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
        except Exception as e:  # noqa: BLE001 - one bucket fails as a unit
            self._fail(items, e)
            return 0
        wall = time.perf_counter() - t0
        if self.calibration is not None and backend is None and hasattr(idx, "explain"):
            share = wall / len(items)
            for p in items:
                plan = idx.explain(p.query)  # memoized: a dict probe when hot
                self.calibration.observe(plan.algorithm, plan.cost, share)
        served = 0
        resolved = []
        with self._lock:
            self._count("batches")
            self._count("executed", len(items))
            self._batch_hist.inc(1, size=len(items))
            _G_BATCH.inc(1, size=len(items))
            for p, out in zip(items, outs):
                if self._cache is not None:
                    self._cache.put(
                        (p.ckey, p.backend, self._vkey(p.cols, versions)),
                        p.cols, out,
                    )
                # cache filled, THEN drop from the in-flight map: a racing
                # submit either joins the fan-out or hits the cache, never
                # re-executes; after the pop the waiter list is final
                self._inflight.pop((p.ckey, p.backend), None)
                resolved.append((list(p.futures), out))
                served += len(p.futures)
                self._count("served", len(p.futures))
        # every waiter gets a tensor of its own: results are mutable, so one
        # client's in-place op must reach neither another waiter nor the
        # cache.  Only a lone waiter of an uncached result takes it as is.
        given = [(f, t_sub, out if i == 0 and self._cache is None else out.clone())
                 for futures, out in resolved for i, (f, t_sub) in enumerate(futures)]
        copied = self._cache is not None or len(given) > len(resolved)
        if dev.type == "cuda" and copied:
            torch.cuda.current_stream(dev).synchronize()  # the copies, before any waiter reads
        t_done = time.perf_counter()
        for f, t_sub, out in given:
            f.set_result(out)
            self._observe_latency(max(0.0, t_done - t_sub))
        return served

    # -- batcher thread ----------------------------------------------------
    def start(self) -> "QueryServer":
        """Spawn the background batcher: wake on submissions, sleep the
        coalescing window, pump.  Idempotent; returns self for chaining."""
        if self._thread is not None:
            return self
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="query-server-batcher", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        dev = self._device()
        # launches from this thread go to the index's device, on its current
        # stream there, which _dispatch synchronises
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            while True:
                with self._work:
                    while not self._pending and not self._stop:
                        self._work.wait(timeout=0.1)
                    if self._stop and not self._pending:
                        return
                if self.window > 0:
                    time.sleep(self.window)  # let concurrent clients pile in
                while self.pump():  # drain every accumulated micro-batch before
                    pass            # sleeping another window

    def stop(self) -> None:
        """Drain remaining work and join the batcher thread."""
        if self._thread is None:
            return
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._thread.join()
        self._thread = None
        while self.pump():  # anything submitted during shutdown
            pass

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection -----------------------------------------------------
    def info(self) -> dict:
        """Serving counters: requests/served/cache_hits/dedup_hits/shed/
        executed/batches/invalidations/errors, the batch-size histogram,
        cache + pending occupancy, latency/queue-wait percentiles,
        plan-memo counters, and the calibration constants currently
        steering the planner.

        A view over the server's metrics registry (:attr:`obs`): the same
        numbers export as Prometheus text via ``server.obs``, and mirror
        onto the process-wide ``repro_torch.obs.REGISTRY`` when enabled."""
        with self._lock:
            out = {e: int(self._events.value(event=e)) for e in _EVENT_NAMES}
            out["pending"] = len(self._pending)
            out["cache_entries"] = len(self._cache) if self._cache else 0
            out["batch_size_hist"] = dict(sorted(
                (int(key[0]), int(v))
                for key, v in self._batch_hist.series().items()
            ))
        lat, qw = self._latency.state(), self._queue_wait.state()
        out["latency"] = {
            "count": lat.count,
            "p50_s": lat.quantile(0.5),
            "p95_s": lat.quantile(0.95),
            "p99_s": lat.quantile(0.99),
        }
        out["queue_wait"] = {
            "count": qw.count,
            "p50_s": qw.quantile(0.5),
            "p95_s": qw.quantile(0.95),
            "p99_s": qw.quantile(0.99),
        }
        out["plan_memo"] = plan_memo_info()
        calib = self.calibration
        out["calibration"] = None if calib is None else {
            "device": calib.device,
            "backends": sorted(calib.us_per_kword),
            "samples": sum(calib.samples.values()),
        }
        return out
