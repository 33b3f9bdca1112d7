"""`StreamingIndex`: an updatable bitmap index with incrementally-maintained
query results.

The paper's headline property -- a threshold/symmetric result *is again a
bitmap which can be further processed within a bitmap index* -- only pays
off in a serving system if the index absorbs writes without rebuilds.
``StreamingIndex`` wraps an immutable :class:`~repro_torch.query.BitmapIndex`
(or a :class:`~repro_torch.dist.query.ShardedBitmapIndex`) and adds:

  * **mutations**: ``set_bits`` / ``clear_bits`` / batched ``update`` /
    row-space ``append_rows`` accumulate in per-shard
    :class:`~repro_torch.stream.delta.DeltaStore` buffers (host numpy) --
    the base store is never touched, so every stale reference keeps
    working;
  * **overlay reads**: queries run against an
    :class:`~repro_torch.stream.overlay.OverlayStore` view, so every
    planner backend answers ``base ⊕ delta`` bit-identically to a
    from-scratch rebuild; the overlay's dense route runs the circuit
    kernel (K1) over a dense view patched on the device, and its tiled
    route runs the ``merge`` engine, whose groups launch K1 too;
  * **tile-granular compaction**: :meth:`compact` folds the delta into a
    new base via ``TileStore.apply_tile_updates`` -- only touched tiles
    reclassify, cardinality moves by popcount deltas -- auto-triggered by
    a :class:`CompactionPolicy` size/ratio threshold.  The compacted base
    has its pack surface again, so its tiled queries take the ``scan``
    engine (the block kernel, K2);
  * **materialized views**: :meth:`materialize` registers a query whose
    result lives as a real index column, refreshed by re-running its
    support-specialised compiled circuit (``circuit_for`` +
    ``Circuit.specialize``, both process-cached) through K1 ONLY over
    tiles whose input columns changed, with counts maintained by per-tile
    popcount deltas.  ``view_info(name)["words_touched"]`` reports the
    refresh work;
  * **durability** (:mod:`repro_torch.persist`): ``durable_dir`` logs
    every mutation batch to a write-ahead log before applying it;
    :meth:`checkpoint` writes a snapshot, :meth:`recover` replays.

Under a sharded base, every mutation routes to the owning row shard's
delta, refresh and compaction run per shard, and nothing ever gathers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitmaps import cardinality
from repro_torch.device import to_numpy_u32, to_words
from repro_torch.obs import REGISTRY as _OBS
from repro_torch.query.expr import Col, Query, as_query, bind_members
from repro_torch.query.index import BitmapIndex, circuit_for

from .delta import DeltaStore, base_tile_batch
from .overlay import OverlayStore

__all__ = ["CompactionPolicy", "MaterializedView", "StreamingIndex"]

# Streaming-path accounting on the process-wide registry (no-ops until
# ``repro_torch.obs.enable()``).  Mutation batches, view refresh work and
# compactions are the three knobs the overlay cost story turns on.
_MUTATIONS = _OBS.counter(
    "repro_stream_mutations_total", "Mutation batches applied", ("kind",),
)
_MUTATED_POSITIONS = _OBS.counter(
    "repro_stream_mutated_positions_total", "Individual bit mutations applied",
)
_REFRESHES = _OBS.counter(
    "repro_stream_view_refreshes_total", "Materialized-view tile refreshes",
)
_REFRESH_WORDS = _OBS.counter(
    "repro_stream_view_refresh_words_total",
    "Words touched refreshing materialized views",
)
_COMPACTIONS = _OBS.counter(
    "repro_stream_compactions_total", "Delta-into-base compactions",
)
_COMPACTED_WORDS = _OBS.histogram(
    "repro_stream_compaction_delta_words", "Delta words folded per compaction",
)


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When :meth:`StreamingIndex.compact` fires automatically.

    The delta is folded into the base once its buffered words exceed
    ``max(min_delta_words, max_delta_ratio * base_working_set)`` where the
    base working set is the base store's dirty words plus one output pass
    -- i.e. compaction triggers when overlay bookkeeping starts to rival
    the work a query actually does.  ``auto=False`` leaves compaction
    fully manual.
    """

    min_delta_words: int = 4096
    max_delta_ratio: float = 0.25
    auto: bool = True

    def should_compact(self, delta_words: int, base_words: int) -> bool:
        if delta_words <= 0:
            return False
        return delta_words >= max(
            self.min_delta_words, self.max_delta_ratio * base_words
        )


@dataclasses.dataclass
class MaterializedView:
    """A registered query kept fresh as a real index column."""

    name: str
    query: Query
    slot: int
    support: frozenset  # column slots the compiled circuit actually reads
    cardinality: int
    #: support-order input slots + the circuit specialised to them (every
    #: non-support input folded to CONST0) -- the refresh evaluator
    kept: tuple = ()
    residual: object = None  # None when the query folded to a constant
    const: int | None = None  # that constant, when it did
    pending: set = dataclasses.field(default_factory=set)  # global tile ids
    last_refresh_info: dict | None = None


class StreamingIndex:
    """An updatable view over a (Sharded)BitmapIndex plus delta buffers."""

    def __init__(self, index, *, policy: CompactionPolicy | None = None,
                 durable_dir=None):
        from repro_torch.dist.query import ShardedBitmapIndex

        self.policy = policy or CompactionPolicy()
        self._sharded = isinstance(index, ShardedBitmapIndex)
        self._base = index
        self._names = tuple(index.names)
        self._slot = {name: i for i, name in enumerate(self._names)}
        self._views: dict[str, MaterializedView] = {}
        self._version = 0
        self._overlay_cache: tuple | None = None  # (version, index)
        self.compactions = 0
        #: per-column mutation versions: the index version at which each
        #: column's *contents* last changed (compaction bumps the index
        #: version but changes no contents, so column versions hold still).
        #: A materialized view's version bumps when any support column is
        #: mutated -- at mutation time, not at its lazy refresh -- so a
        #: version vector read after a bump never covers stale view bits.
        self._col_versions: dict[str, int] = {n: 0 for n in self._names}
        #: invalidation subscribers: fn(version, frozenset[column names])
        #: called once per mutation batch with every column whose contents
        #: changed (views cascaded).
        self._subscribers: list = []
        #: durability state: a WAL every mutation batch appends to before
        #: applying, plus the directory checkpoints land in.  ``None``
        #: keeps the index purely in-memory (the default).
        self._wal = None
        self._dir = None
        self._replaying = False  # True while recover() re-applies the log
        self._reset_deltas()
        if durable_dir is not None:
            self.attach_durable(durable_dir)

    def attach_durable(self, path) -> None:
        """Start logging every mutation batch to ``path/wal.bmwal``.

        A directory with no checkpoint yet gets one immediately, so
        recovery always has a base snapshot to replay the WAL against."""
        from pathlib import Path

        from repro_torch.persist.wal import WriteAheadLog

        self._dir = Path(path)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._wal = WriteAheadLog(self._dir / "wal.bmwal")
        if not (self._dir / "index.json").exists():
            self.checkpoint()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dense(cls, bits, names=None, *, tile_words: int = 64,
                   policy: CompactionPolicy | None = None,
                   device=None) -> "StreamingIndex":
        """Build over a dense boolean/int array [N, r] on ``device``
        (default: the CUDA card)."""
        return cls(BitmapIndex.from_dense(bits, names, tile_words=tile_words,
                                          device=device),
                   policy=policy)

    @classmethod
    def from_columns(cls, columns: dict, *, r: int | None = None,
                     tile_words: int = 64,
                     policy: CompactionPolicy | None = None,
                     device=None) -> "StreamingIndex":
        """Build over a {name: packed words} mapping on ``device``
        (default: the CUDA card)."""
        return cls(
            BitmapIndex.from_columns(columns, r=r, tile_words=tile_words,
                                     device=device),
            policy=policy,
        )

    def _reset_deltas(self) -> None:
        if self._sharded:
            self._deltas = [DeltaStore(s) for s in self._base.store.shards]
        else:
            self._deltas = [DeltaStore(self._base.store)]

    # -- accessors ---------------------------------------------------------
    @property
    def names(self) -> tuple:
        return self._names

    @property
    def n(self) -> int:
        return len(self._names)

    @property
    def is_sharded(self) -> bool:
        return self._sharded

    @property
    def device(self):
        return self._base.device

    @property
    def tile_words(self) -> int:
        return self._deltas[0].tile_words

    @property
    def r(self) -> int:
        if self._sharded:
            return self._bit_offsets()[-1] + self._deltas[-1].r
        return self._deltas[0].r

    @property
    def delta_words(self) -> int:
        return sum(d.delta_words for d in self._deltas)

    @property
    def views(self) -> tuple:
        return tuple(self._views)

    def __contains__(self, name: str) -> bool:
        return name in self._slot

    def __getitem__(self, name: str) -> Col:
        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}")
        return Col(name)

    def delta_stats(self) -> dict:
        return {
            "patched_tiles": sum(d.patched_tiles for d in self._deltas),
            "delta_words": self.delta_words,
            "compactions": self.compactions,
            "pending_view_tiles": sum(len(v.pending) for v in self._views.values()),
        }

    # -- shard routing -----------------------------------------------------
    def _bit_offsets(self) -> list:
        if not self._sharded:
            return [0]
        return [w * 32 for w in self._base.store.word_offsets]

    def _tile_offsets(self) -> list:
        """Global tile id of each shard's first tile (growth-aware)."""
        offs, t0 = [], 0
        for d in self._deltas:
            offs.append(t0)
            t0 += d.n_tiles
        return offs

    def _route_index(self, pos: np.ndarray) -> list:
        """[(shard, selector into the batch)] for global bit positions."""
        if not self._sharded:
            return [(0, np.arange(pos.size))]
        offs = np.asarray(self._bit_offsets())
        shard_of = np.searchsorted(offs, pos, side="right") - 1
        return [
            (int(s), np.nonzero(shard_of == s)[0])
            for s in np.unique(shard_of).tolist()
        ]

    # -- mutations ---------------------------------------------------------
    def _data_slot(self, name: str) -> int:
        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}; index has {sorted(self._slot)[:8]}...")
        if name in self._views:
            raise ValueError(
                f"column {name!r} is a materialized view; mutate its inputs instead"
            )
        return self._slot[name]

    def set_bits(self, name: str, positions) -> None:
        self.update(sets={name: positions})

    def clear_bits(self, name: str, positions) -> None:
        self.update(clears={name: positions})

    def update(self, sets: dict | None = None, clears: dict | None = None) -> None:
        """Apply a batch of set/clear mutations as ONE index update (one
        version bump, one auto-compaction check).  The whole batch flattens
        into a single vectorised ``DeltaStore.apply_batch`` per owning shard;
        set masks apply before clear masks."""
        parts = []  # (slot, positions, on)
        for mapping, on in ((sets, True), (clears, False)):
            for name, positions in (mapping or {}).items():
                slot = self._data_slot(name)
                pos = np.atleast_1d(np.asarray(positions, dtype=np.int64))
                if pos.size:
                    parts.append((slot, pos, on))
        if not parts:
            return
        sizes = [p.size for _, p, _ in parts]
        cols = np.repeat(np.asarray([s for s, _, _ in parts], np.int64), sizes)
        pos = np.concatenate([p for _, p, _ in parts])
        on = np.repeat(np.asarray([o for _, _, o in parts], bool), sizes)
        if self._wal is not None and not self._replaying:
            self._wal.append_update(cols, pos, on)
        self._apply_update_arrays(cols, pos, on)

    def _apply_update_arrays(self, cols: np.ndarray, pos: np.ndarray,
                             on: np.ndarray) -> None:
        """Route one validated (cols, pos, on) batch to the owning shards
        -- the shared tail of :meth:`update` and WAL replay."""
        if _OBS.enabled:
            _MUTATIONS.inc(1, kind="update")
            _MUTATED_POSITIONS.inc(int(pos.size))
        touched: dict[int, set] = {}
        toffs = self._tile_offsets()
        boffs = self._bit_offsets()
        for shard, sel in self._route_index(pos):
            per_col = self._deltas[shard].apply_batch(
                cols[sel], pos[sel] - boffs[shard], on[sel]
            )
            for slot, tiles in per_col.items():
                touched.setdefault(slot, set()).update(
                    toffs[shard] + t for t in tiles
                )
        if touched:
            self._after_mutation(touched)

    def append_rows(self, bits) -> tuple:
        """Append new row positions (products) to the universe: dense bool
        ``[n_data_columns, k]`` in column-name order (materialized views
        excluded -- their appended bits are computed, not supplied), or a
        ``{name: bits}`` mapping (absent columns default to all-zero).
        Under sharding the appended range extends the LAST shard -- no
        resharding, no gather.  Returns the appended global row range
        ``(start, stop)``."""
        start = self.r
        data_slots = [
            i for i, nm in enumerate(self._names) if nm not in self._views
        ]
        if isinstance(bits, dict):
            k = None
            for v in bits.values():
                k = np.atleast_1d(np.asarray(v)).shape[-1]
                break
            if k is None:
                return (start, start)
            arr = np.zeros((self.n, k), bool)
            for name, row in bits.items():
                arr[self._data_slot(name)] = np.asarray(row, bool)
        else:
            given = np.asarray(bits, bool)
            if given.ndim != 2 or given.shape[0] != len(data_slots):
                raise ValueError(
                    f"expected bool[{len(data_slots)}, k] over the data "
                    f"columns, got {given.shape}"
                )
            arr = np.zeros((self.n, given.shape[1]), bool)
            arr[data_slots] = given
        if self._wal is not None and not self._replaying:
            # log only the data-column rows: the view columns' appended
            # bits are recomputed on replay exactly like they were live
            self._wal.append_rows(arr[data_slots])
        if _OBS.enabled:
            _MUTATIONS.inc(1, kind="append")
            _MUTATED_POSITIONS.inc(int(arr.sum()))
        toffs = self._tile_offsets()
        shard = len(self._deltas) - 1
        tiles = self._deltas[shard].append_rows(arr)
        gtiles = {toffs[shard] + t for t in tiles}
        # every column's consumers see the appended range change -- and so
        # does EVERY view, support or not: a view whose query folded to a
        # constant (empty circuit support) still owes its constant over the
        # new rows
        self._after_mutation(
            {slot: set(gtiles) for slot in range(self.n)}, appended=gtiles
        )
        return (start, start + arr.shape[1])

    def add_data_column(self, name: str, packed=None) -> None:
        """Grow the schema with a new data column (default all-zero).

        The delta is compacted first -- column growth lands in the base
        store, whose ``add_column`` shares every untouched column's storage
        -- and only the new column is classified.  Refused on a durable
        index: the WAL format has no schema-growth record, so replay could
        not reproduce the column.
        """
        if name in self._slot:
            raise ValueError(f"column {name!r} already exists")
        if self._wal is not None:
            raise RuntimeError(
                "add_data_column is not supported on a durable index: the "
                "WAL cannot replay schema growth; checkpoint into a fresh "
                "index instead"
            )
        self.refresh()
        self.compact(force=True)
        if packed is None:
            packed = np.zeros(self._base.n_words, np.uint32)
        _MUTATIONS.inc(1, kind="add_column")
        self._base = self._base.add_column(name, packed)
        self._names = tuple(self._base.names)
        self._slot = {n: i for i, n in enumerate(self._names)}
        self._reset_deltas()
        self._overlay_cache = None
        self._version += 1
        self._col_versions[name] = self._version
        self._notify(frozenset((name,)))

    def _after_mutation(self, touched: dict, appended: set | None = None) -> None:
        self._version += 1
        for view in self._views.values():
            for slot, tiles in touched.items():
                if slot in view.support:
                    view.pending.update(tiles)
            if appended:
                view.pending.update(appended)
        # column-version bookkeeping + invalidation fan-out: the mutated
        # columns change now, and every view (transitively) reading one of
        # them WILL change at its next refresh -- bump both at mutation
        # time so version vectors read later are never stale
        changed = set(touched)
        for _ in range(len(self._views) + 1):
            grew = {
                v.slot
                for v in self._views.values()
                if v.slot not in changed and (appended or v.support & changed)
            }
            if not grew:
                break
            changed |= grew
        for slot in changed:
            self._col_versions[self._names[slot]] = self._version
        self._notify(frozenset(self._names[s] for s in changed))
        if self.policy.auto:
            base_words = self._base_working_words()
            if self.policy.should_compact(self.delta_words, base_words):
                self.compact()

    # -- version / invalidation surface ------------------------------------
    @property
    def version(self) -> int:
        """Monotone index version (one bump per mutation batch / refresh /
        compaction)."""
        return self._version

    @property
    def column_versions(self) -> dict:
        """{name: version its contents last changed}."""
        return dict(self._col_versions)

    def column_version(self, name: str) -> int:
        if name not in self._slot:
            raise KeyError(f"unknown column {name!r}")
        return self._col_versions.get(name, 0)

    def subscribe(self, fn) -> None:
        """Register ``fn(version, touched_names)`` to run after every
        mutation batch; ``touched_names`` is a frozenset of every column
        whose contents changed, materialized views cascaded in."""
        self._subscribers.append(fn)

    def unsubscribe(self, fn) -> None:
        self._subscribers.remove(fn)

    def _notify(self, names: frozenset) -> None:
        if not names:
            return
        for fn in list(self._subscribers):
            fn(self._version, names)

    def _base_working_words(self) -> int:
        if self._sharded:
            return sum(s.dirty_words + s.n_words for s in self._base.store.shards)
        return self._base.store.dirty_words + self._base.store.n_words

    # -- overlay read path -------------------------------------------------
    def index(self):
        """The queryable (Sharded)BitmapIndex over ``base ⊕ delta``, with
        every materialized view refreshed.  Cached per mutation version."""
        self.refresh()
        return self._overlay_index()

    def _overlay_index(self):
        if all(d.empty for d in self._deltas):
            return self._base
        if self._overlay_cache is not None and self._overlay_cache[0] == self._version:
            return self._overlay_cache[1]
        if self._sharded:
            from repro_torch.dist.query import ShardedBitmapIndex

            shards = tuple(
                s if d.empty else OverlayStore(s, d)
                for s, d in zip(self._base.store.shards, self._deltas)
            )
            idx = ShardedBitmapIndex(
                self._base.store.with_shards(shards), self._names
            )
        else:
            idx = BitmapIndex(
                names=self._names,
                _store=OverlayStore(self._base.store, self._deltas[0]),
            )
        self._overlay_cache = (self._version, idx)
        return idx

    # -- queries -----------------------------------------------------------
    def execute(self, query, **kw):
        return self.index().execute(query, **kw)

    def execute_many(self, queries, **kw):
        return self.index().execute_many(queries, **kw)

    def explain(self, query):
        """The plan (unsharded) or per-shard plans (sharded) the next
        execute would run, computed from the OVERLAID statistics."""
        idx = self.index()
        return idx.plan(query) if self._sharded else idx.explain(query)

    def column(self, name: str):
        return self.index().column(name)

    def count(self, query) -> int:
        """Result cardinality; a bare view column reads the incrementally
        maintained count -- no execution, no popcount."""
        q = as_query(query)
        if type(q) is Col and q.name in self._views:
            self.refresh()
            return self._views[q.name].cardinality
        return int(self.index().count(q))

    # -- materialized views ------------------------------------------------
    def materialize(self, name: str, query) -> MaterializedView:
        """Register ``query`` as a maintained result column ``name``.

        The result is computed once and added as a real column of the base
        index (the delta is compacted first so the new column's tile
        classification lands in the base).  From then on, every mutation of
        a column in the query's support marks the touched tiles, and the
        next read refreshes ONLY those tiles by re-running the compiled
        circuit over them.
        """
        from repro_torch.core.circuits import CONST0

        if name in self._slot:
            raise ValueError(f"column {name!r} already exists")
        # implicit "all columns" member sets bind to the columns of NOW:
        # the view must keep meaning what it meant when registered, even
        # after more (view) columns join the schema
        q = bind_members(as_query(query), self._names)
        _MUTATIONS.inc(1, kind="materialize")
        if self._wal is not None and not self._replaying:
            self._wal.append_materialize(name, q)
        self.refresh()
        self.compact(force=True)
        res = self._base.execute(q)
        if self._sharded:
            card = sum(int(cardinality(s)) for s in res.shards)
        else:
            card = int(cardinality(res))
        self._base = self._base.add_column(name, res)
        self._names = tuple(self._base.names)
        self._slot = {n: i for i, n in enumerate(self._names)}
        self._reset_deltas()
        circ = circuit_for((q,), self.n, self._names)
        support = circ.support()
        const, residual, kept = circ.specialize(
            {i: CONST0 for i in range(self.n) if i not in support}
        )
        view = MaterializedView(
            name=name,
            query=q,
            slot=self._slot[name],
            support=frozenset(support),
            cardinality=card,
            kept=tuple(kept),
            residual=residual,
            const=const[0],
        )
        self._views[name] = view
        self._version += 1
        self._col_versions[name] = self._version  # the column just appeared
        self._notify(frozenset((name,)))
        return view

    def view_info(self, name: str) -> dict | None:
        """tiles_refreshed / words_touched accounting of the last refresh."""
        return self._views[name].last_refresh_info

    def refresh(self) -> None:
        """Bring every materialized view up to date (tile-granular)."""
        if not self._views:
            return
        for _ in range(len(self._views) + 1):
            dirty = [v for v in self._views.values() if v.pending]
            if not dirty:
                return
            for view in dirty:
                self._refresh_view(view)
        raise RuntimeError("materialized views failed to converge")  # pragma: no cover

    def _gather_support_tiles(self, shard: int, kept: tuple,
                              tiles: np.ndarray) -> np.ndarray:
        """Current (base ⊕ delta) words of the support columns restricted to
        one shard's local ``tiles`` -- host uint32[s, T, tile_words], one
        vectorised base pass plus the delta's patched-tile overrides."""
        d = self._deltas[shard]
        tw = d.tile_words
        s, T = len(kept), int(tiles.size)
        cc = np.repeat(np.asarray(kept, np.int64), T)
        tt = np.tile(tiles, s)
        arr = base_tile_batch(d.base, cc, tt).reshape(s, T, tw)
        tlist = tiles.tolist()
        for j, c in enumerate(kept):
            tmap = d._tiles.get(c)
            if tmap:
                for i, t in enumerate(tlist):
                    got = tmap.get(t)
                    if got is not None:
                        arr[j, i] = got
        return arr

    def _refresh_view(self, view: MaterializedView) -> None:
        """Re-run the view's support-specialised circuit over ONLY the
        pending tiles (per owning shard) and patch the results into the
        view column's delta; counts move by per-tile popcount deltas.

        Each shard's gathered ``[s, T * tile_words]`` words go to the
        index's device in one upload and through ``run_circuit_cached``
        (the circuit kernel on the card, its plain version on the CPU); the
        result comes back in one copy."""
        from repro_torch.kernels.threshold_ssum import run_circuit_cached

        tiles = np.asarray(sorted(view.pending), dtype=np.int64)
        view.pending.clear()
        toffs = self._tile_offsets()
        words_touched = 0
        gathered = 0
        delta_card = 0
        refreshed_tiles = set()
        for shard, (t0, d) in enumerate(zip(toffs, self._deltas)):
            local = tiles[(tiles >= t0) & (tiles < t0 + d.n_tiles)] - t0
            if local.size == 0:
                continue
            tw = d.tile_words
            if view.residual is None:
                out = np.full((local.size, tw), 0xFFFFFFFF if view.const else 0,
                              np.uint32)
            else:
                arr = self._gather_support_tiles(shard, view.kept, local)
                gathered += arr.size
                words_touched += arr.size
                got = run_circuit_cached(
                    to_words(arr.reshape(len(view.kept), -1), self.device),
                    view.residual,
                )
                out = np.array(to_numpy_u32(got), np.uint32).reshape(
                    local.size, tw
                )
            words_touched += local.size * tw
            span = tw * 32
            for li, t in enumerate(local.tolist()):
                # the universe may end inside this tile: a truth table with
                # f(0)=1 would otherwise set padding bits past r, corrupting
                # the popcount-delta count
                end = d.r - t * span
                if end < span:
                    w = out[li]
                    fw, rem = end // 32, end % 32
                    if rem:
                        w[fw] &= np.uint32((1 << rem) - 1)
                        w[fw + 1 :] = 0
                    else:
                        w[fw:] = 0
                delta_card += d.patch_tile(view.slot, int(t), out[li])
            refreshed_tiles.update((t0 + local).tolist())
        view.cardinality += delta_card
        if _OBS.enabled:
            _REFRESHES.inc(1)
            _REFRESH_WORDS.inc(int(words_touched))
        view.last_refresh_info = {
            "tiles_refreshed": int(tiles.size),
            "words_gathered": int(gathered),
            "words_touched": int(words_touched),
            "cardinality_delta": int(delta_card),
        }
        self._version += 1
        # a view is an input to any later view that references it
        for other in self._views.values():
            if other is not view and view.slot in other.support:
                other.pending.update(refreshed_tiles)

    # -- compaction --------------------------------------------------------
    def compact(self, force: bool = True) -> bool:
        """Fold the delta into a new base store, tile-granularly.

        Only touched tiles reclassify (``TileStore.apply_tile_updates``);
        under sharding each shard compacts its own delta locally.  Returns
        True when a merge actually happened.  ``force=False``
        applies the :class:`CompactionPolicy` threshold instead of
        compacting unconditionally.
        """
        self.refresh()
        if all(d.empty for d in self._deltas):
            return False
        if not force and not self.policy.should_compact(
            self.delta_words, self._base_working_words()
        ):
            return False
        if _OBS.enabled:
            _COMPACTIONS.inc(1)
            _COMPACTED_WORDS.observe(float(self.delta_words))
        if self._sharded:
            from repro_torch.dist.query import ShardedBitmapIndex

            shards = tuple(
                s if d.empty else s.apply_tile_updates(d.updates(), r=d.r)
                for s, d in zip(self._base.store.shards, self._deltas)
            )
            self._base = ShardedBitmapIndex(
                self._base.store.with_shards(shards), self._names
            )
        else:
            store = self._base.store.apply_tile_updates(
                self._deltas[0].updates(), r=self._deltas[0].r
            )
            self._base = BitmapIndex(names=self._names, _store=store)
        self._reset_deltas()
        self._overlay_cache = None
        self._version += 1
        self.compactions += 1
        return True

    # -- durability (repro_torch.persist) ----------------------------------
    @property
    def durable_dir(self):
        return self._dir

    @property
    def wal_version(self) -> int:
        """Version of the last logged mutation batch (0 when not durable)."""
        return self._wal.last_version if self._wal is not None else 0

    def checkpoint(self) -> dict:
        """Fold the delta and write a fresh snapshot + rotate the WAL.

        After the checkpoint the directory alone reproduces the index:
        the snapshot holds every column (materialized views included, as
        real columns), ``index.json`` holds the view definitions and the
        WAL version the snapshot covers, and the WAL is emptied (its
        version counter stays monotone so later records sort after the
        snapshot).  Requires ``durable_dir``."""
        import json

        if self._dir is None:
            raise RuntimeError(
                "checkpoint() needs a durable index: pass durable_dir= to "
                "StreamingIndex"
            )
        from repro_torch.persist import save, save_sharded
        from repro_torch.persist.wal import query_to_obj

        self.refresh()
        self.compact(force=True)
        views_meta = [
            {"name": v.name, "query": query_to_obj(v.query)}
            for v in self._views.values()  # registration order
        ]
        meta = {
            "sharded": self._sharded,
            "wal_version": int(self._wal.last_version),
            "names": list(self._names),
            "views": views_meta,
        }
        extra = {"wal_version": meta["wal_version"], "views": views_meta}
        if self._sharded:
            save_sharded(self._base, self._dir, extra=extra)
        else:
            save(self._base, self._dir / "snapshot.bmsnap", extra=extra)
        (self._dir / "index.json").write_text(
            json.dumps(meta, indent=2, sort_keys=True)
        )
        self._wal.rotate()
        return meta

    @classmethod
    def recover(cls, path, *, policy: CompactionPolicy | None = None,
                device=None, devices=None) -> "StreamingIndex":
        """Rebuild a durable index from its directory on ``device``
        (default: the CUDA card; a sharded directory's shard ``k`` goes to
        ``devices[k]`` when given): load the snapshot (memmap, no copy),
        re-register the materialized views from the manifest, then replay
        every WAL record after the snapshot's version.  A torn record at
        the log's tail (the crash case) is truncated away; the recovered
        index answers bit-identically to the never-crashed one up to the
        last intact batch."""
        import json
        from pathlib import Path

        from repro_torch.persist import load_index, load_sharded
        from repro_torch.persist.wal import (
            APPEND,
            MATERIALIZE,
            UPDATE,
            WriteAheadLog,
            query_from_obj,
        )

        d = Path(path)
        meta = json.loads((d / "index.json").read_text())
        if meta["sharded"]:
            base = load_sharded(d, device=device, devices=devices)
        else:
            base = load_index(d / "snapshot.bmsnap", device=device)
        self = cls(base, policy=policy)
        self._dir = d
        self._rebuild_views(
            [(v["name"], query_from_obj(v["query"])) for v in meta["views"]]
        )
        wal = WriteAheadLog(d / "wal.bmwal")
        snap_version = int(meta["wal_version"])
        # the rotated log restarts empty; keep new appends sorting after
        # the snapshot even then
        wal.last_version = max(wal.last_version, snap_version)
        self._replaying = True
        try:
            for rec in wal.replay(after_version=snap_version):
                if rec["kind"] == UPDATE:
                    self._apply_update_arrays(rec["cols"], rec["pos"], rec["on"])
                elif rec["kind"] == APPEND:
                    self.append_rows(rec["bits"])
                elif rec["kind"] == MATERIALIZE:
                    self.materialize(rec["name"], rec["query"])
        finally:
            self._replaying = False
        self._wal = wal
        return self

    def _rebuild_views(self, pairs) -> None:
        """Re-register checkpointed views WITHOUT re-executing them: the
        snapshot already holds each view as a real column (bits and
        cardinality), only the refresh machinery (support + specialised
        circuit) needs rebuilding."""
        from repro_torch.core.circuits import CONST0

        for name, q in pairs:
            if name not in self._slot:  # pragma: no cover - corrupt manifest
                raise ValueError(f"view {name!r} missing from snapshot schema")
            slot = self._slot[name]
            if self._sharded:
                card = sum(int(s.cardinalities[slot])
                           for s in self._base.store.shards)
            else:
                card = int(self._base.store.cardinalities[slot])
            circ = circuit_for((q,), self.n, self._names)
            support = circ.support()
            const, residual, kept = circ.specialize(
                {i: CONST0 for i in range(self.n) if i not in support}
            )
            self._views[name] = MaterializedView(
                name=name,
                query=q,
                slot=slot,
                support=frozenset(support),
                cardinality=card,
                kept=tuple(kept),
                residual=residual,
                const=const[0],
            )
