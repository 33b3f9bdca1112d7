"""Row-sharded execution engine for BitmapIndex queries.

The paper's algorithms assume one machine; Roaring's container-per-chunk
design shows the row space is the natural unit of both compression and
parallelism, and threshold / symmetric functions are computed *pointwise*
per row position -- so a row-range shard of every column is a complete,
independent sub-problem whose result is again a bitmap shard.  That is
exactly what composes: sharded results feed back as sharded columns via
``add_column`` with no gather.

  * :class:`ShardedTileStore` partitions a :class:`~repro_torch.storage.TileStore`
    into contiguous tile ranges.  Slicing shares the classified tiles and
    container packs (no reclassification) and, where the parent has its
    dense view on the device, each shard's dense view is a strided column
    slice of it (no copy); each shard carries its own tile classes, offset
    tables and member statistics.
  * :class:`ShardedBitmapIndex` compiles ONE circuit per query shape
    (shared through the process-wide compiled cache) and plans PER SHARD:
    the planner's words-touched cost model runs on each shard's local
    statistics, so a mostly-clean shard takes ``tiled_fused`` while a dense
    shard takes the circuit path -- heterogeneous backends behind one
    ``execute`` call, each dispatched through the same
    :func:`repro_torch.query.executors.run_plan` entrypoint.
  * When every shard's plan is dense-circuit-evaluable and ``devices`` (one
    torch device per shard; entries may repeat) is given, the whole query
    runs on the shard-map path: the word axis is split evenly into one
    piece per device and the circuit kernel (K1) is launched once per
    piece, every launch enqueued before any synchronisation; otherwise
    shards run host-sequenced, each on its own representation.

This runs in one process: ``devices`` is a plain list, not a
``torch.distributed`` group.  Pieces on distinct cards are moved there and
the results come back to the shards' device.
"""
from __future__ import annotations

import dataclasses
import time as _time

import torch

import repro_torch.obs as _obs
from repro_torch.core.bitmaps import cardinality, packed_tail_mask
from repro_torch.core.planner import Plan, plan_query
from repro_torch.device import to_words
from repro_torch.obs import trace as _trace
from repro_torch.storage import TileStore

__all__ = [
    "ShardedTileStore",
    "ShardedBitmapIndex",
    "ShardedResult",
    "ShardedPlan",
    "shard_boundaries",
]

# Backends whose result is exactly "evaluate the compiled circuit" -- under
# the shard-map path the one shared circuit is evaluated in-place of any of
# them (bit-identical: every backend computes the same Boolean function).
# The tile-skipping / host-list backends stay shard-local, and so do the
# scancount executors: they are chosen precisely when N is too large to
# tabulate a per-(N, T) circuit, so substituting circuit evaluation there
# would compile the very adder the plan is avoiding.
_SPMD_BACKENDS = frozenset(
    (
        "circuit", "fused", "ssum", "treeadd", "srtckt", "sopckt", "csvckt",
        "wide_or", "wide_and", "looped",
    )
)


def shard_boundaries(n_tiles: int, n_shards: int) -> tuple:
    """Contiguous tile ranges [(t0, t1), ...], as even as possible."""
    n_shards = max(1, min(int(n_shards), int(n_tiles)))
    base, extra = divmod(n_tiles, n_shards)
    bounds, t0 = [], 0
    for i in range(n_shards):
        t1 = t0 + base + (1 if i < extra else 0)
        bounds.append((t0, t1))
        t0 = t1
    return tuple(bounds)


def _as_devices(devices) -> tuple | None:
    if devices is None:
        return None
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("devices must name at least one device")
    return devs


class ShardedTileStore:
    """A TileStore partitioned into row-range shards.

    Each shard is itself a :class:`~repro_torch.storage.TileStore` over its
    tile range: its own classes, container packs, offset tables, and
    (lazily built) member statistics.  Stores stay immutable -- ``append`` /
    ``replace`` return a new sharded store whose shards share the untouched
    columns.  ``devices`` (one per shard, or None) is where the shard-map
    path puts each piece of the word axis.
    """

    def __init__(self, shards: tuple, tile_bounds: tuple, *, n_words: int,
                 r: int, devices=None):
        self.shards: tuple = tuple(shards)
        self.tile_bounds = tuple(tile_bounds)
        self.n_words = int(n_words)
        self.r = int(r)
        self.devices = _as_devices(devices)
        if self.devices is not None and len(self.devices) != len(self.shards):
            raise ValueError(f"{len(self.devices)} devices for {len(self.shards)} shards")
        self.tile_words = self.shards[0].tile_words
        #: word offset of each shard's first word in the global row space
        self.word_offsets = tuple(t0 * self.tile_words for t0, _ in self.tile_bounds)
        self._dense_cache = None
        self._spmd_cache: dict = {}  # devices -> the word axis split in pieces

    @classmethod
    def from_store(cls, store: TileStore, *, n_shards: int | None = None,
                   devices=None) -> "ShardedTileStore":
        devices = _as_devices(devices)
        if n_shards is None:
            n_shards = len(devices) if devices is not None else 1
        bounds = shard_boundaries(store.n_tiles, n_shards)
        if devices is not None and len(devices) != len(bounds):
            raise ValueError(
                f"{len(devices)} devices for {len(bounds)} shards of {store.n_tiles} tiles"
            )
        shards = tuple(store.slice_tiles(t0, t1) for t0, t1 in bounds)
        out = cls(shards, bounds, n_words=store.n_words, r=store.r, devices=devices)
        # the shards' dense views are slices of the parent's: keep it as the
        # global view, so neither path gathers what is already there
        out._dense_cache = store._dense
        return out

    # -- accessors ---------------------------------------------------------
    @property
    def n(self) -> int:
        return self.shards[0].n

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def densify(self) -> torch.Tensor:
        """Global dense int32[N, n_words] view on the first shard's device
        (an explicit gather unless the store was sliced from a resident
        dense view; cached -- the store is immutable)."""
        if self._dense_cache is None:
            dev = self.shards[0].device
            self._dense_cache = torch.cat(
                [s.densify().to(dev) for s in self.shards], dim=1
            )
        return self._dense_cache

    def spmd_pieces(self, devices: tuple) -> list:
        """The word axis split evenly into ``len(devices)`` pieces, piece d
        on ``devices[d]`` (cached per device tuple; columns stay resident
        across queries).  Pieces are views where the split is exact and the
        device is the dense view's: only a ragged last piece is padded."""
        got = self._spmd_cache.get(devices)
        if got is None:
            s = len(devices)
            dense = self.densify()
            nw = dense.shape[1]
            w = -(-nw // s)  # equal per-device width
            got = []
            for d, dev in enumerate(devices):
                piece = dense[:, d * w : min((d + 1) * w, nw)]
                if piece.shape[1] != w:
                    piece = torch.nn.functional.pad(piece, (0, w - piece.shape[1]))
                got.append(piece.to(dev))
            self._spmd_cache[devices] = got
        return got

    def member_stats(self, slots=None) -> tuple:
        """Per-shard planner statistics of a member subset."""
        return tuple(s.member_stats(slots) for s in self.shards)

    def with_shards(self, shards) -> "ShardedTileStore":
        """New sharded store with the shard stores swapped out -- the
        streaming engine's per-shard overlay/compaction constructor
        (``repro_torch.stream``).  Accepts TileStore-shaped objects (e.g.
        ``OverlayStore`` read views); tile bounds are recomputed from the
        shards' own sizes, so growth in the LAST shard (``append_rows``
        extending the universe) is reflected without resharding.  Interior
        shards hold only whole tiles, so their boundaries cannot move."""
        shards = tuple(shards)
        if len(shards) != self.n_shards:
            raise ValueError(f"{len(shards)} shards for {self.n_shards}")
        bounds, t0 = [], 0
        for s in shards:
            bounds.append((t0, t0 + s.n_tiles))
            t0 = bounds[-1][1]
        off_words = bounds[-1][0] * self.tile_words
        return ShardedTileStore(
            shards, bounds,
            n_words=off_words + shards[-1].n_words,
            r=off_words * 32 + shards[-1].r,
            devices=self.devices,
        )

    # -- immutable updates -------------------------------------------------
    def split(self, packed) -> tuple:
        """Split a global packed row int32[n_words] into per-shard parts."""
        row = to_words(packed, self.shards[0].device)
        if tuple(row.shape) != (self.n_words,):
            raise ValueError(f"expected shape ({self.n_words},), got {tuple(row.shape)}")
        parts, off = [], list(self.word_offsets) + [self.n_words]
        for i in range(self.n_shards):
            parts.append(row[off[i] : off[i + 1]])
        return tuple(parts)

    def _as_parts(self, packed_or_parts) -> tuple:
        if isinstance(packed_or_parts, (tuple, list)):
            parts = tuple(packed_or_parts)
            if len(parts) != self.n_shards:
                raise ValueError(
                    f"{len(parts)} parts for {self.n_shards} shards"
                )
            return parts
        return self.split(packed_or_parts)

    def append(self, packed_or_parts) -> "ShardedTileStore":
        """New sharded store with one more column.  Accepts per-shard parts
        (a query result's shards -- NO gather) or a global packed row."""
        parts = self._as_parts(packed_or_parts)
        return ShardedTileStore(
            tuple(s.append(p) for s, p in zip(self.shards, parts)),
            self.tile_bounds, n_words=self.n_words, r=self.r,
            devices=self.devices,
        )

    def replace(self, i: int, packed_or_parts) -> "ShardedTileStore":
        """New sharded store with column ``i`` swapped (shard-wise)."""
        parts = self._as_parts(packed_or_parts)
        return ShardedTileStore(
            tuple(s.replace(i, p) for s, p in zip(self.shards, parts)),
            self.tile_bounds, n_words=self.n_words, r=self.r,
            devices=self.devices,
        )


@dataclasses.dataclass(frozen=True)
class ShardedResult:
    """A query result that never left its shards: one packed bitmap piece
    per shard (already tail-masked to the shard's universe slice).  Feed it
    straight back via ``ShardedBitmapIndex.add_column`` -- composing results
    is the whole point of keeping them bitmaps (1402.4466), and sharding
    preserves it because symmetric functions are pointwise per row."""

    shards: tuple  # int32[local_words] per shard
    word_offsets: tuple
    n_words: int
    r: int

    def gather(self) -> torch.Tensor:
        """Materialise the global packed bitmap on the first shard's device
        (the one explicit gather)."""
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards])


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """Per-shard plans for one query (the heterogeneous-backend contract)."""

    plans: tuple  # core.planner.Plan per shard

    @property
    def backends(self) -> tuple:
        return tuple(p.algorithm for p in self.plans)

    @property
    def distinct(self) -> tuple:
        return tuple(sorted(set(self.backends)))

    @property
    def cost(self) -> float:
        return float(sum(p.cost or 0.0 for p in self.plans))


def _fused_available(shard) -> bool:
    """The fused kernel is what runs where a shard's data lies on the card."""
    return shard.device.type == "cuda"


class ShardedBitmapIndex:
    """A BitmapIndex whose row space lives in row-range shards.

    ``execute`` compiles ONE circuit (process-wide cache, shared with the
    unsharded engine) and runs a per-shard plan: every shard's backend is a
    shard-local function dispatched through ``run_plan``; with ``devices``
    and all-dense plans the query instead runs on the shard-map path (one
    K1 launch per piece of the word axis).  Results are
    :class:`ShardedResult`s and feed back via :meth:`add_column` without a
    gather.  Like ``BitmapIndex``, instances are immutable --
    ``add_column`` / ``replace_column`` return a NEW index and stale
    references keep executing against their own schema.
    """

    def __init__(self, store: ShardedTileStore, names: tuple):
        self.store = store
        self._names = tuple(names)
        if len(self._names) != store.n:
            raise ValueError(f"{len(self._names)} names for {store.n} columns")
        self._slot = {name: i for i, name in enumerate(self._names)}
        self.r = store.r
        self.n_words = store.n_words
        #: merged info of the last execution (per-shard backends + accounting)
        self.last_info: dict | None = None

    @classmethod
    def from_index(cls, index, *, devices=None,
                   n_shards: int | None = None) -> "ShardedBitmapIndex":
        store = ShardedTileStore.from_store(
            index.store, n_shards=n_shards, devices=devices
        )
        return cls(store, index.names)

    # -- accessors ---------------------------------------------------------
    @property
    def names(self) -> tuple:
        return self._names

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def n_shards(self) -> int:
        return self.store.n_shards

    @property
    def devices(self):
        return self.store.devices

    @property
    def device(self) -> torch.device:
        """Where the shards' data (and every result) lives."""
        return self.store.shards[0].device

    def __contains__(self, name: str) -> bool:
        return name in self._slot

    def __getitem__(self, name: str):
        from repro_torch.query.expr import Col

        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}")
        return Col(name)

    def column(self, name: str) -> torch.Tensor:
        """Gathered dense view of one column (for host-side comparisons)."""
        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}")
        i = self._slot[name]
        return torch.cat([s.densify()[i].to(self.device) for s in self.store.shards])

    # -- immutable updates -------------------------------------------------
    def add_column(self, name: str, result) -> "ShardedBitmapIndex":
        """New index with a (virtual) column appended shard-wise.  ``result``
        is a :class:`ShardedResult`, per-shard parts, or a global packed row;
        sharded results are consumed with NO gather."""
        if name in self._slot:
            raise ValueError(f"column {name!r} already exists")
        parts = result.shards if isinstance(result, ShardedResult) else result
        return ShardedBitmapIndex(
            self.store.append(parts), self._names + (name,)
        )

    def replace_column(self, name: str, result) -> "ShardedBitmapIndex":
        """New index with one column's shards swapped; untouched columns
        share storage, stale references keep working."""
        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}")
        parts = result.shards if isinstance(result, ShardedResult) else result
        return ShardedBitmapIndex(
            self.store.replace(self._slot[name], parts), self._names
        )

    # -- planning ----------------------------------------------------------
    def _member_slots(self, q):
        from repro_torch.query.index import member_slots

        return member_slots(q, self._slot)

    def _bare_slots(self, q):
        from repro_torch.query.index import bare_slots

        return bare_slots(q, self._slot)

    def plan(self, query) -> ShardedPlan:
        """Per-shard plans from each shard's LOCAL member statistics -- a
        mostly-clean shard gets ``tiled_fused`` while a dense shard gets the
        circuit path, behind the same query call."""
        from repro_torch.query.expr import as_query

        q = as_query(query)
        slots = self._member_slots(q)
        return ShardedPlan(
            tuple(
                plan_query(q, self.n, stats=shard.member_stats(slots),
                           fused_available=_fused_available(shard))
                for shard in self.store.shards
            )
        )

    # -- execution ---------------------------------------------------------
    def execute(self, query, *, backend: str | None = None,
                block_words: int | None = None) -> ShardedResult:
        """Evaluate one expression across every shard.  Returns a
        :class:`ShardedResult` (per-shard packed bitmaps, tail-masked)."""
        from repro_torch.query.expr import as_query

        q = as_query(query)
        outs = self._execute_circuit((q,), [q], backend, block_words)
        return outs[0]

    def execute_many(self, queries, *, backend: str | None = None,
                     block_words: int | None = None) -> list:
        """Evaluate independent queries: ONE multi-output circuit, one
        per-shard plan, one tiled dispatch (tiled shards) or one evaluation
        sweep (dense shards) shared by all of them."""
        from repro_torch.query.expr import as_query

        qs = [as_query(x) for x in queries]
        return self._execute_circuit(tuple(qs), qs, backend, block_words)

    # -- internals ---------------------------------------------------------
    def _circuit_fn(self, qs: tuple):
        from repro_torch.query.index import circuit_for

        return lambda: circuit_for(qs, self.n, self._names)

    def _execute_circuit(self, qs: tuple, qlist, backend, block_words) -> list:
        active = _trace.enabled or _obs.REGISTRY.enabled
        t0 = _time.perf_counter() if active else 0.0
        with _trace.span(
            "execute_sharded", n_shards=self.n_shards, n_queries=len(qlist)
        ) as root:
            out = self._execute_circuit_inner(
                qs, qlist, backend, block_words
            )
            if active:
                self._observe(root, _time.perf_counter() - t0)
        return out

    def _observe(self, root, wall_s: float) -> None:
        """Predicted-vs-measured accounting for the whole sharded call."""
        info = self.last_info or {}
        measured = info.get("words_touched")
        plans = getattr(self, "_last_plans", None)
        costs = [
            p.cost for p in (plans.plans if plans else ())
            if getattr(p, "cost", None) is not None
        ]
        backends = sorted(set(info.get("backends", ())))
        label = backends[0] if len(backends) == 1 else "mixed"
        root.set(
            mode=info.get("mode"),
            backends=backends,
            predicted_words=sum(costs) if costs else None,
            measured_words=measured,
        )
        if measured is not None:
            _obs.record_drift(
                label, sum(costs) if costs else None, measured, wall_s
            )

    def _execute_circuit_inner(self, qs: tuple, qlist, backend, block_words) -> list:
        circ_fn = self._circuit_fn(qs)
        if backend is not None:
            plans = ShardedPlan(
                tuple(Plan(backend, "caller override") for _ in self.store.shards)
            )
        elif len(qlist) == 1:
            plans = self.plan(qlist[0])
        else:
            # multi-query: plan each shard once over all columns; any shard
            # whose stats favour skipping runs the whole batch tiled, the
            # rest evaluate the multi-output circuit (only circuit-family
            # backends can produce k outputs in one pass)
            shard_plans = []
            for shard in self.store.shards:
                fused = _fused_available(shard)
                p = plan_query(qlist[0], self.n, stats=shard.member_stats(None),
                               fused_available=fused)
                if p.algorithm != "tiled_fused":
                    p = Plan("fused" if fused else "circuit",
                             f"multi-query batch (shard plan was {p.algorithm})",
                             cost=p.cost, candidates=p.candidates)
                shard_plans.append(p)
            plans = ShardedPlan(tuple(shard_plans))
        self._last_plans = plans
        k = len(qlist)
        if self.devices is not None and all(b in _SPMD_BACKENDS for b in plans.backends):
            stacked = self._run_spmd(circ_fn(), k)
            self.last_info = {
                "mode": "shard_map",
                "backends": plans.backends,
                "n_shards": self.n_shards,
            }
        else:
            stacked = self._run_per_shard(circ_fn, qlist, plans, block_words)
        results = []
        for j in range(k):
            results.append(
                ShardedResult(
                    shards=tuple(stacked[i][j] for i in range(self.n_shards)),
                    word_offsets=self.store.word_offsets,
                    n_words=self.n_words,
                    r=self.r,
                )
            )
        return results

    def _run_spmd(self, circuit, k: int) -> list:
        """The shard-map path: every device evaluates the same compiled
        circuit on its piece of the word axis (threshold / symmetric
        functions are pointwise per row position, so the split is exact).
        One K1 launch per piece (its plain version for pieces on the CPU),
        all enqueued before anything waits; the encoded program is cached
        by circuit structure and uploaded once per device."""
        from repro_torch.kernels.threshold_ssum import run_circuit_cached

        pieces = self.store.spmd_pieces(self.devices)
        outs = [run_circuit_cached(p, circuit) for p in pieces]
        dev = self.device
        out = torch.cat(
            [(o[None] if o.dim() == 1 else o).to(dev) for o in outs], dim=1
        )[:, : self.n_words]
        # re-slice the global result at the store's real shard boundaries
        per_shard = []
        off = list(self.store.word_offsets) + [self.n_words]
        for i in range(self.n_shards):
            piece = out[:, off[i] : off[i + 1]]
            per_shard.append([self._mask_shard(piece[j], i) for j in range(k)])
        return per_shard

    def _run_per_shard(self, circ_fn, qlist, plans: ShardedPlan, block_words) -> list:
        """Heterogeneous path: each shard's plan dispatches through the one
        run_plan entrypoint against that shard's local representation."""
        from repro_torch.query.execinfo import merge_exec_infos
        from repro_torch.query.executors import ShardContext, run_plan
        from repro_torch.query.expr import Col
        from repro_torch.query.index import _annotate_dispatch

        bare = self._bare_slots(qlist[0]) if len(qlist) == 1 else None
        colslot = (
            self._slot.get(qlist[0].name)
            if len(qlist) == 1 and type(qlist[0]) is Col
            else None
        )
        k = len(qlist)
        per_shard, infos = [], []
        for i, (shard, plan) in enumerate(zip(self.store.shards, plans.plans)):
            ctx = ShardContext(
                n=self.n,
                dense=shard.densify,
                store=lambda s=shard: s,
                circuit=circ_fn,
                bare=bare if k == 1 else None,
                column=colslot,
                block_words=block_words,
            )
            with _trace.span(
                "shard", shard=i, backend=getattr(plan, "algorithm", plan)
            ) as sp:
                out, info = run_plan(ctx, plan)
                if _trace.enabled and isinstance(info, dict):
                    _annotate_dispatch(sp, info)
            infos.append(info)
            if out.dim() == 1:
                out = out[None]
            # results stay on the shard's device; only the tiled path's
            # plan is host-orchestrated
            per_shard.append(
                [self._mask_shard(out[j], i) for j in range(k)]
            )
        # schema-driven merge (repro_torch.query.execinfo): EVERY ExecInfo
        # key is folded by its registered rule -- counters sum, word-kind
        # dicts add key-wise, labels collect
        self.last_info = {
            **merge_exec_infos(infos),
            "mode": "per_shard",
            "backends": plans.backends,
            "n_shards": self.n_shards,
            "per_shard": infos,
        }
        return per_shard

    def _mask_shard(self, out: torch.Tensor, i: int) -> torch.Tensor:
        """Tail-mask a shard's result to its slice of the universe."""
        shard = self.store.shards[i]
        mask = packed_tail_mask(shard.r, shard.n_words, out.device)
        return out if mask is None else torch.bitwise_and(out, mask)

    def count(self, query, **kw) -> int:
        res = self.execute(query, **kw)
        return int(sum(int(cardinality(s)) for s in res.shards))

    # -- persistence -------------------------------------------------------
    def save(self, dirpath) -> dict:
        """Write one ``.bmsnap`` per shard plus the shard map
        (``repro_torch.persist.shards``, the reference's bytes); returns the
        shard-map metadata.  Each device can later load ONLY its own file
        via :func:`repro_torch.persist.load_shard`."""
        from repro_torch.persist import save_sharded

        return save_sharded(self, dirpath)

    @classmethod
    def load(cls, dirpath, *, device=None, devices=None, to_device: bool = False,
             verify: bool = False) -> "ShardedBitmapIndex":
        """Rebuild a saved sharded index, shard files mapped in place --
        no gather, no reclassification.  See
        :func:`repro_torch.persist.load_sharded`."""
        from repro_torch.persist import load_sharded

        return load_sharded(dirpath, device=device, devices=devices,
                            to_device=to_device, verify=verify)
