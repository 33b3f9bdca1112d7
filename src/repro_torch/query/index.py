"""`BitmapIndex`: a TileStore + statistics + planner-driven execution.

The index wraps a :class:`repro_torch.storage.TileStore` -- the
tile-classified column store; the dense ``int32[N, n_words]`` view lives on
the index's device and is what the dense backends read
(``store.densify()``).  Per-column cardinality / density / runcount /
clean-fraction statistics are computed once at build time by the store, so
the planner is *always* data-aware:

  * :meth:`execute` plans a query expression (``core.planner.plan_query``
    with real member-subset tile statistics) and routes it -- bare
    thresholds to the specialised backends, everything else through ONE
    compiled circuit evaluated in one kernel launch -- or, on clean-heavy
    data, through ``tiled_fused``, which folds clean tiles to constants and
    runs the rest in at most two dispatches;
  * :meth:`execute_many` compiles independent circuit-family queries into a
    single multi-output circuit: one sweep over the inputs (or one tiled
    dispatch) for all of them;
  * results are packed bitmaps (tail-masked to the universe size), so they
    can be fed back in as virtual columns with :meth:`add_column` -- the
    paper's "the result ... can be further processed within a bitmap index".

Indexes are immutable: :meth:`add_column` / :meth:`replace_column` return a
NEW index sharing the untouched columns' storage, so stale references keep
planning and executing correctly against their own schema.

**Device**: ``device=None`` means the CUDA card and raises without one;
``device="cpu"`` runs the plain versions (see :mod:`repro_torch.device`).

Compiled circuits are cached per process by (query shape, column names);
their encoded programs are cached by circuit *structure* underneath
(``kernels.threshold_ssum``).  Data never enters either key, so every
index with the same schema shares both layers.  :meth:`save` /
:meth:`load` write and read the reference's ``.bmsnap`` snapshots
(:mod:`repro_torch.persist`); :meth:`shard` partitions the row space
(:mod:`repro_torch.dist`).

**Observability**: with :mod:`repro_torch.obs` enabled, ``execute`` /
``execute_many`` emit the reference's span trees (plan / compile /
dispatch / decode) and one calibration-drift record per execution.  Span
wall times are host time around the enqueue: nothing here synchronises
with the card, so a span never measures the kernel.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
import weakref
from collections import OrderedDict

import numpy as np
import torch

import repro_torch.obs as _obs
from repro_torch.core.bitmaps import cardinality, pack, packed_tail_mask
from repro_torch.core.planner import CIRCUIT_BACKENDS, Plan, plan_query
from repro_torch.device import resolve_device, to_words
from repro_torch.obs import trace as _trace
from repro_torch.storage import TileStore, run_tiled_circuit

from .compile import build_query_circuit
from .expr import Col, Query, Threshold, as_query, canonical_key
from .executors import ShardContext, run_plan

__all__ = [
    "BitmapIndex",
    "IndexStats",
    "execute",
    "circuit_for",
    "compiled_cache_info",
    "clear_compiled_cache",
    "plan_memo_info",
]

# ---------------------------------------------------------------------------
# Per-process compiled-circuit cache.  Two layers: query shape -> Circuit
# here, circuit structure -> encoded program in kernels.threshold_ssum
# (run_circuit_cached) -- so query shapes that compile to the same gate DAG
# also share one uploaded program.
# ---------------------------------------------------------------------------

_CIRCUITS: dict[tuple, object] = {}  # (qkeys, names) -> Circuit
_CACHE_INFO = {"hits": 0, "misses": 0}

# bare thresholds whose backend is itself a circuit join multi-query batches
_BATCHABLE = CIRCUIT_BACKENDS + ("ssum", "treeadd", "srtckt", "sopckt")


def compiled_cache_info() -> dict:
    """Hits/misses/size of the per-process compiled-circuit cache."""
    return {"size": len(_CIRCUITS), **_CACHE_INFO}


def clear_compiled_cache() -> None:
    from repro_torch.kernels.threshold_ssum import clear_circuit_runners
    from repro_torch.kernels.tiled_scan import clear_scan_runners

    _CIRCUITS.clear()
    clear_circuit_runners()
    clear_scan_runners()
    _CACHE_INFO["hits"] = 0
    _CACHE_INFO["misses"] = 0
    _PLAN_MEMOS.clear()
    _PLAN_MEMO_INFO["hits"] = 0
    _PLAN_MEMO_INFO["misses"] = 0


# ---------------------------------------------------------------------------
# Plan memoization.  Hot serving paths ask the same questions of the same
# store forever; memoize ``explain``'s answer per store (weakly -- a dropped
# store drops its memo) keyed by the SEMANTIC query key and a coarse bucket
# of the member statistics.  The bucket deliberately quantises (5% clean
# fraction, decade density, pow2 dirty words): stats that land in one
# bucket get one plan, trading exactness the planner never had for a
# dict-lookup fast path that skips cost-model evaluation entirely.
# ---------------------------------------------------------------------------

_PLAN_MEMO_CAP = 512  # per store
_PLAN_MEMOS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PLAN_MEMO_INFO = {"hits": 0, "misses": 0}


def plan_memo_info() -> dict:
    """Process-wide hit/miss counters + live size of the per-store plan
    memo."""
    return {
        "stores": len(_PLAN_MEMOS),
        "entries": sum(len(v) for v in _PLAN_MEMOS.values()),
        **_PLAN_MEMO_INFO,
    }


def _stats_bucket(stats) -> tuple:
    """Quantise member statistics so equivalent stores share plan entries."""
    dens = float(stats.density)
    dens_band = 99 if dens <= 0 else min(12, max(0, int(-math.log10(max(dens, 1e-12)))))
    return (
        stats.n,
        stats.n_words,
        stats.tile_words,
        int(round(stats.clean_fraction * 20)),
        dens_band,
        int(stats.dirty_words).bit_length(),
        int(getattr(stats, "compressed_words", 0) or 0).bit_length(),
    )


def _plan_memo_for(store) -> OrderedDict:
    memo = _PLAN_MEMOS.get(store)
    if memo is None:
        memo = _PLAN_MEMOS[store] = OrderedDict()
    return memo


def member_slots(q: Query, slot: dict):
    """Column slots a bare-threshold query actually reads (None: all)."""
    if type(q) is Threshold and q.over is not None and all(
        type(m) is Col for m in q.over
    ):
        for m in q.over:
            if m.name not in slot:
                raise KeyError(
                    f"unknown column {m.name!r}; index has {sorted(slot)[:8]}..."
                )
        return [slot[m.name] for m in q.over]
    return None


def bare_slots(q: Query, slot: dict):
    """(member slots | None, t) when q is a Threshold over plain columns
    (None slots: every column), else None."""
    if type(q) is not Threshold:
        return None
    if q.over is None:
        return None, q.t
    slots = member_slots(q, slot)
    if slots is None:
        return None
    return tuple(slots), q.t


def circuit_for(qs: tuple, n: int, names: tuple):
    """The (process-cached) multi-output circuit compiling ``qs`` over a
    schema: ONE circuit per query shape, whatever index asks."""
    key = (tuple(q.key() for q in qs), tuple(names))
    circ = _CIRCUITS.get(key)
    if circ is not None:
        _CACHE_INFO["hits"] += 1
        if _trace.enabled:
            # steady-state hit: annotate the open span instead of paying a
            # zero-duration child span per request
            _trace.current_span().set(compile_cache="hit")
        return circ
    _CACHE_INFO["misses"] += 1
    with _trace.span("compile", cache="miss") as sp:
        circ = build_query_circuit(qs, n, names)
        sp.set(n_outputs=len(getattr(circ, "outputs", ())) or len(qs))
    _CIRCUITS[key] = circ
    return circ


def _annotate_dispatch(sp, info: dict) -> None:
    """Copy an ExecInfo's dispatch + decode accounting onto the span tree:
    the dispatch span carries the engine / launch / case-split numbers, a
    child ``decode`` span the container-decode traffic (decode happens
    inside the block kernel, so its span carries words rather than time).
    Backends that never decode containers (dense / host paths) carry their
    word accounting directly on the dispatch span instead."""
    sp.set(
        engine=info.get("engine"),
        launches=info.get("launches"),
        case3_tiles=info.get("case3_tiles"),
        const_tiles=info.get("const_tiles"),
        event_tiles=info.get("event_tiles"),
        measured_words=info.get("words_touched"),
    )
    if info.get("backend") != "tiled_fused":
        sp.set(
            dirty_words_gathered=info.get("dirty_words_gathered"),
            words_by_kind=dict(info.get("words_by_kind") or {}),
        )
        return
    with _trace.span("decode") as dec:
        dec.set(
            decode_words=info.get("decode_words"),
            densified_tiles=info.get("densified_tiles"),
            compressed_words_gathered=info.get("compressed_words_gathered"),
            dirty_words_gathered=info.get("dirty_words_gathered"),
            words_by_kind=dict(info.get("words_by_kind") or {}),
        )


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IndexStats:
    """Per-index statistics (computed at TileStore build time, free to read)."""

    n: int
    n_words: int
    r: int
    cardinalities: tuple
    densities: tuple
    density: float  # mean over columns
    clean_fraction: float  # fraction of (column, tile) pairs that are clean
    tile_words: int
    clean_fractions: tuple = ()  # per column
    runcounts: tuple = ()  # per column (paper's RUNCOUNT)
    dirty_words: int = 0  # words a dense dirty pack would store
    #: (dense, sparse, run) container tile counts across the index
    container_tiles: tuple = (0, 0, 0)
    #: words the container packs actually occupy (<= dirty_words)
    compressed_words: int = 0


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------


class BitmapIndex:
    """A queryable collection of named packed bitmaps over one universe."""

    def __init__(self, columns=None, names=None, *, r: int | None = None,
                 tile_words: int = 64, containers: bool = True, device=None,
                 _store: TileStore | None = None):
        # classification is deferred to first `store` access: a transient
        # index executed with an explicit backend override never pays the
        # device-to-host copy + tile-classification pass
        if _store is not None:
            self._store_cache: TileStore | None = _store
            self._pending = None
            self.device = _store.device
            n, n_words, self.r = _store.n, _store.n_words, _store.r
        else:
            self.device = resolve_device(device)
            cols = to_words(columns, self.device)
            if cols.dim() != 2:
                raise ValueError(f"expected int32[N, n_words], got shape {tuple(cols.shape)}")
            n, n_words = cols.shape
            self._store_cache = None
            self._pending = cols
            self.r = int(r) if r is not None else n_words * 32
        self._tile_words = int(tile_words)
        self._containers = bool(containers)
        self._n, self._n_words = int(n), int(n_words)
        if names is None:
            names = tuple(f"c{i}" for i in range(n))
        else:
            names = tuple(str(x) for x in names)
            if len(names) != n:
                raise ValueError(f"{len(names)} names for {n} columns")
            if len(set(names)) != n:
                raise ValueError("duplicate column names")
        self._names = names
        self._slot = {name: i for i, name in enumerate(names)}
        if self.r > n_words * 32 or self.r <= 0:
            raise ValueError(f"universe size {self.r} does not fit {n_words} words")
        self._stats_cache: dict[int, IndexStats] = {}
        #: info dict of the last tiled execution (words gathered, case split)
        self.last_info: dict | None = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dense(cls, bits, names=None, *, tile_words: int = 64,
                   containers: bool = True, device=None) -> "BitmapIndex":
        """Build from a dense boolean/int array [N, r]."""
        dev = resolve_device(device)
        if not isinstance(bits, torch.Tensor):
            bits = np.asarray(bits)
        return cls(pack(bits, dev), names, r=bits.shape[-1], tile_words=tile_words,
                   containers=containers, device=dev)

    @classmethod
    def from_columns(cls, columns: dict, *, r: int | None = None,
                     tile_words: int = 64, device=None) -> "BitmapIndex":
        """Build from a {name: packed int32[n_words]} mapping."""
        if not columns:
            raise ValueError("need at least one column")
        dev = resolve_device(device)
        names = tuple(columns)
        stacked = torch.stack([to_words(columns[k], dev) for k in names])
        return cls(stacked, names, r=r, tile_words=tile_words, device=dev)

    # -- basic accessors ---------------------------------------------------
    @property
    def store(self) -> TileStore:
        """The underlying tile-classified column store (built on demand)."""
        if self._store_cache is None:
            self._store_cache = TileStore.from_packed(
                self._pending, tile_words=self._tile_words, r=self.r,
                containers=self._containers, device=self.device,
            )
            self._pending = None
        return self._store_cache

    @property
    def columns(self) -> torch.Tensor:
        """Dense int32[N, n_words] view on the index's device (cached)."""
        if self._store_cache is None:
            return self._pending
        return self._store_cache.densify()

    @property
    def names(self) -> tuple:
        return self._names

    @property
    def n(self) -> int:
        return self._n

    @property
    def n_words(self) -> int:
        return self._n_words

    def __len__(self) -> int:
        return self.n

    def __contains__(self, name: str) -> bool:
        return name in self._slot

    def __getitem__(self, name: str) -> Col:
        """Sugar: ``idx["a"] & ~idx["b"]`` builds an expression."""
        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}")
        return Col(name)

    def column(self, name: str) -> torch.Tensor:
        if name not in self._slot:
            raise KeyError(
                f"unknown column {name!r}; index has {sorted(self._slot)[:8]}..."
            )
        return self.store.column(self._slot[name])

    def add_column(self, name: str, packed) -> "BitmapIndex":
        """Return a NEW index with a (virtual) column appended -- e.g. a
        previous query result.  Only the new column is classified; untouched
        columns share storage with this index, which keeps working."""
        if name in self._slot:
            raise ValueError(f"column {name!r} already exists")
        return BitmapIndex(
            names=self._names + (name,), _store=self.store.append(packed)
        )

    def replace_column(self, name: str, packed) -> "BitmapIndex":
        """Return a NEW index with one column's data swapped; only that
        column's tiles are reclassified (the slot-mask update path)."""
        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}")
        return BitmapIndex(
            names=self._names, _store=self.store.replace(self._slot[name], packed)
        )

    # -- sharding ----------------------------------------------------------
    def shard(self, n_shards: int | None = None, devices=None):
        """Partition the row space: a
        :class:`repro_torch.dist.query.ShardedBitmapIndex` whose shards are
        contiguous tile ranges, each with its own tile classes, container
        packs and member statistics (sliced, not reclassified; dense views
        are strided views of this index's).  ``execute`` there compiles ONE
        circuit and plans PER SHARD.  With ``devices=None`` the shards run
        host-sequenced (still per-shard-planned); with ``devices`` (one
        torch device per shard, entries may repeat; ``n_shards`` defaults
        to their number), homogeneous dense plans run on the shard-map
        path, one circuit-kernel launch per piece of the word axis."""
        from repro_torch.dist.query import ShardedBitmapIndex

        return ShardedBitmapIndex.from_index(self, devices=devices, n_shards=n_shards)

    @classmethod
    def from_sharded(cls, sharded) -> "BitmapIndex":
        """Gather a :class:`repro_torch.dist.query.ShardedBitmapIndex` back
        into a single-device index (the explicit, paid-for gather -- query
        results never need it, they feed back shard-wise via
        ``add_column``).  The shards' tile classifications are stitched,
        not recomputed."""
        store = TileStore.concat_tiles(
            sharded.store.shards, n_words=sharded.n_words, r=sharded.r
        )
        return cls(names=sharded.names, _store=store)

    # -- persistence -------------------------------------------------------
    def save(self, path) -> dict:
        """Write a ``.bmsnap`` snapshot (``repro_torch.persist``, the
        reference's bytes); returns the manifest.  ``BitmapIndex.load(path)``
        reconstructs the index over ``np.memmap`` views -- no rebuild, no
        classification pass."""
        from repro_torch.persist import save

        return save(self, path)

    @classmethod
    def load(cls, path, *, device=None, to_device: bool = False,
             verify: bool = False) -> "BitmapIndex":
        """Reconstruct a saved index on ``device`` (default: the CUDA card);
        see :func:`repro_torch.persist.load_index`."""
        from repro_torch.persist import load_index

        return load_index(path, device=device, to_device=to_device, verify=verify)

    # -- statistics --------------------------------------------------------
    def stats(self, tile_words: int | None = None, refresh: bool = False) -> IndexStats:
        """Planner statistics at the requested tile granularity.

        Statistics at the store's native granularity are free (computed at
        build time); other granularities reclassify once and are cached PER
        ``tile_words`` -- ``stats(tile_words=128)`` after ``stats(tile_words=64)``
        no longer returns stats computed at the wrong granularity.
        """
        tw = int(tile_words) if tile_words is not None else self.store.tile_words
        cached = self._stats_cache.get(tw)
        if cached is not None and not refresh:
            return cached
        store = self.store.with_tile_words(tw)
        dens = store.densities
        census = store.container_census()
        st = IndexStats(
            n=store.n,
            n_words=store.n_words,
            r=self.r,
            cardinalities=store.cardinalities,
            densities=dens,
            density=float(np.mean(dens)) if dens else 0.0,
            clean_fraction=store.clean_fraction,
            tile_words=tw,
            clean_fractions=tuple(s.clean_fraction for s in store.col_stats),
            runcounts=store.runcounts,
            dirty_words=store.dirty_words,
            container_tiles=(census["dense"], census["sparse"], census["run"]),
            compressed_words=census["storage_words"],
        )
        self._stats_cache[tw] = st
        return st

    # -- planning ----------------------------------------------------------
    def _member_slots(self, q: Query):
        """Column slots a bare-threshold query actually reads (None: all)."""
        return member_slots(q, self._slot)

    def _fused_available(self) -> bool:
        """The fused kernel is what runs when the index lives on a CUDA device."""
        return self.device.type == "cuda"

    def explain(self, query, *, memo: bool = True) -> Plan:
        """The plan :meth:`execute` would run.  Plans carry ``cost`` (the
        estimated words touched) and ``candidates`` (per-backend estimates)
        computed from the member subset's real tile statistics, plus
        ``cost_us``/``candidates_us`` when a planner calibration is
        installed (``core.calibration``).

        Answers are memoized per store, keyed by the query's *semantic* key
        and a coarse bucket of the member statistics, so hot serving paths
        skip planning entirely; ``plan.memo`` reports "hit"/"miss" and
        :func:`plan_memo_info` the process-wide counters.  ``memo=False``
        bypasses (and does not populate) the memo."""
        q = as_query(query)
        with _trace.span("plan") as sp:
            plan = self._explain(q, memo)
            if _trace.enabled:
                sp.set(
                    algorithm=plan.algorithm,
                    memo=plan.memo,
                    predicted_words=plan.cost,
                    predicted_us=plan.cost_us,
                    candidates=plan.candidates or (),
                )
        return plan

    def _explain(self, q: Query, memo: bool) -> Plan:
        fused = self._fused_available()
        stats = self.store.member_stats(self._member_slots(q))
        if not memo:
            return plan_query(q, self.n, stats=stats, fused_available=fused)
        from repro_torch.core.calibration import calibration_generation

        key = (
            canonical_key(q),
            _stats_bucket(stats),
            fused,
            calibration_generation(),
        )
        lru = _plan_memo_for(self.store)
        cached = lru.get(key)
        if cached is not None:
            lru.move_to_end(key)
            _PLAN_MEMO_INFO["hits"] += 1
            return dataclasses.replace(cached, memo="hit")
        _PLAN_MEMO_INFO["misses"] += 1
        plan = plan_query(q, self.n, stats=stats, fused_available=fused)
        plan.memo = "miss"
        lru[key] = plan
        while len(lru) > _PLAN_MEMO_CAP:
            lru.popitem(last=False)
        return plan

    # -- execution ---------------------------------------------------------
    def execute(self, query, *, backend: str | None = None,
                block_words: int | None = None) -> torch.Tensor:
        """Evaluate one expression; returns a packed (tail-masked) bitmap.

        ``block_words`` is kept for parity with the reference's call sites
        and is unused: the CUDA kernel sizes its blocks itself.

        With :mod:`repro_torch.obs` enabled, each call produces a span tree
        (plan / compile / dispatch / decode) carrying the plan's predicted
        words next to the executor's measured words, and records one
        calibration-drift observation; the wall time is the host's (the
        kernels are enqueued, not waited for)."""
        q = as_query(query)
        active = _trace.enabled or _obs.REGISTRY.enabled
        t0 = _time.perf_counter() if active else 0.0
        with _trace.span("execute") as root:
            plan = Plan(backend, "caller override") if backend else self.explain(q)
            out = self._mask(self._run(q, plan.algorithm, block_words))
            if active:
                self._observe(root, plan, self.last_info, _time.perf_counter() - t0)
        return out

    def _observe(self, root, plan, info, wall_s: float) -> None:
        """Annotate the root span with predicted vs measured words and feed
        the drift metric (called with obs tracing or metrics enabled)."""
        measured = info.get("words_touched") if isinstance(info, dict) else None
        if _trace.enabled:
            root.set(
                backend=plan.algorithm,
                predicted_words=plan.cost,
                predicted_us=plan.cost_us,
                measured_words=measured,
            )
        _obs.record_drift(
            str(plan.algorithm), plan.cost, measured if measured is not None else 0, wall_s,
        )

    def execute_many(self, queries, *, backend: str | None = None,
                     block_words: int | None = None) -> list:
        """Evaluate independent queries; circuit-family ones are compiled
        into a single multi-output circuit.  On the tiled path every query
        shares ONE tiled dispatch; on the dense path, one kernel launch."""
        qs = [as_query(q) for q in queries]
        active = _trace.enabled or _obs.REGISTRY.enabled
        with _trace.span("execute_many", n_queries=len(qs)) as root:
            plans = [
                Plan(backend, "caller override") if backend else self.explain(q)
                for q in qs
            ]
            algs = [p.algorithm for p in plans]
            batch: list[int] = []
            # an explicit non-circuit backend override is honoured per query;
            # batching only applies when the circuit family does the work
            if backend is None or backend in CIRCUIT_BACKENDS:
                for i, (q, alg) in enumerate(zip(qs, algs)):
                    if alg in CIRCUIT_BACKENDS or (
                        alg in _BATCHABLE and self._bare_slots(q) is not None
                    ):
                        batch.append(i)
            results: dict[int, torch.Tensor] = {}
            if len(batch) > 1:
                tiled = backend == "tiled_fused" or (
                    backend is None and all(algs[i] == "tiled_fused" for i in batch)
                )
                if tiled:
                    tdisp = _time.perf_counter() if active else 0.0
                    with _trace.span("dispatch", backend="tiled_fused", batched=len(batch)) as sp:
                        circ = self._circuit_for(tuple(qs[i] for i in batch))
                        stacked, info = run_tiled_circuit(
                            self.store, circ, block_words=block_words
                        )
                        if _trace.enabled:
                            _annotate_dispatch(sp, info)
                    self.last_info = info
                    if active:
                        # one drift sample for the shared gather: the batch's
                        # summed prediction vs the one realised gather
                        bc = [plans[i].cost for i in batch]
                        pred = (
                            sum(c for c in bc if c is not None)
                            if any(c is not None for c in bc) else None
                        )
                        _obs.record_drift(
                            "tiled_fused", pred, info["words_touched"],
                            _time.perf_counter() - tdisp,
                        )
                else:
                    cbackend = backend or ("fused" if self._fused_available() else "circuit")
                    with _trace.span("dispatch", backend=cbackend, batched=len(batch)):
                        stacked = self._dense_eval(tuple(qs[i] for i in batch), block_words)
                if stacked.dim() == 1:
                    stacked = stacked[None]
                for j, i in enumerate(batch):
                    results[i] = stacked[j]
            for i, (q, alg) in enumerate(zip(qs, algs)):
                if i not in results:
                    tq = _time.perf_counter() if active else 0.0
                    results[i] = self._run(q, alg, block_words)
                    if active:
                        inf = self.last_info
                        m = inf.get("words_touched") if isinstance(inf, dict) else None
                        _obs.record_drift(
                            str(alg), plans[i].cost, m or 0, _time.perf_counter() - tq,
                        )
            if _trace.enabled:
                costs = [p.cost for p in plans if p.cost is not None]
                info = self.last_info
                root.set(
                    backends=sorted(set(map(str, algs))),
                    predicted_words=sum(costs) if costs else None,
                    measured_words=(
                        info.get("words_touched") if isinstance(info, dict) else None
                    ),
                )
        return [self._mask(results[i]) for i in range(len(qs))]

    def count(self, query, **kw) -> int:
        """Cardinality of the query result."""
        return int(cardinality(self.execute(query, **kw)))

    # -- internals ---------------------------------------------------------
    def _bare_slots(self, q: Query):
        """(member slots | None, t) when q is a bare threshold, else None."""
        return bare_slots(q, self._slot)

    def _shard_ctx(self, q: Query, block_words) -> ShardContext:
        """This index's whole row space as one executor shard."""
        return ShardContext(
            n=self.n,
            dense=lambda: self.columns,
            store=lambda: self.store,
            circuit=lambda: self._circuit_for((q,)),
            bare=self._bare_slots(q),
            column=self._slot[q.name] if type(q) is Col else None,
            block_words=block_words,
        )

    def _run(self, q: Query, alg: str, block_words) -> torch.Tensor:
        try:
            with _trace.span("dispatch", backend=alg) as sp:
                out, info = run_plan(self._shard_ctx(q, block_words), alg)
                if _trace.enabled and isinstance(info, dict):
                    _annotate_dispatch(sp, info)
        except ValueError as e:
            if "only executes bare Threshold" in str(e):
                raise ValueError(
                    f"backend {alg!r} only executes bare Threshold queries; "
                    f"use 'circuit', 'fused' or 'tiled_fused' for {type(q).__name__}"
                ) from None
            raise
        if info is not None:
            self.last_info = info
        return out

    def _circuit_for(self, qs: tuple):
        """The (cached) multi-output circuit compiling ``qs`` over this schema."""
        return circuit_for(qs, self.n, self._names)

    def _dense_eval(self, qs: tuple, block_words) -> torch.Tensor:
        """Compile ``qs`` and evaluate over the dense column view."""
        from repro_torch.kernels.threshold_ssum import run_circuit_cached

        return run_circuit_cached(
            self.columns, self._circuit_for(qs), block_words=block_words
        )

    def _mask(self, out: torch.Tensor) -> torch.Tensor:
        mask = packed_tail_mask(self.r, self.n_words, self.device)
        return out if mask is None else torch.bitwise_and(out, mask)


def execute(bitmaps, query, *, r: int | None = None, backend: str | None = None,
            block_words: int | None = None, device=None) -> torch.Tensor:
    """One-shot functional form: execute ``query`` over packed bitmaps.

    Builds a transient default-named :class:`BitmapIndex` on ``device``
    (default: the CUDA card), so the data gets tile-classified and planned;
    the compiled cache is keyed by schema, so repeated calls with the same
    shape reuse compilations.
    """
    idx = BitmapIndex(bitmaps, r=r, device=device)
    return idx.execute(query, backend=backend, block_words=block_words)
