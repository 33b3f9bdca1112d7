"""Sliding-window and time-decayed analytics as streaming bitmap views.

The port of the reference's ``repro.search.window``: the same rows, counts
and refresh accounting, with the stream on ``device`` (default: the CUDA
card).

The motivating query family ("products on sale in 2-10 stores over the
last hour") is a threshold query over an APPEND-HEAVY row space: every
event (a product going on sale at a store) is a row, attribute columns
mark which series the event belongs to, and a ``__live__`` column marks
rows still inside the window.  :class:`WindowedStream` wires that onto
:class:`~repro_torch.stream.StreamingIndex`:

* **append-only ingest** -- each event batch is one ``append_rows`` call;
  the universe only ever grows at the tail (no resharding, no rebuild);
* **expiry is a mutation, not a rebuild** -- :meth:`advance` clears the
  expired rows' bits in one batched ``update``, so a materialized window
  count (:meth:`watch`) refreshes tile-granularly: the refresh touches
  only the tiles the expiry/append batch touched, with the words-touched
  accounting exposed via :meth:`refresh_info` (asserted in tests and
  ``benchmarks/search_bench.py`` against the touched-tiles bound);
* **retention compaction** -- expired rows accumulate as dead all-zero
  row slots; a :class:`WindowRetentionPolicy` decides when to retire
  them, which is the ONLY operation that rewrites the row space;
* **time decay** -- :meth:`decayed_count` folds an exponential decay
  over the live rows of one series (half-life weighting), reading the
  bitmap for membership and host timestamps for weights.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.device import resolve_device, to_numpy_u32
from repro_torch.obs import REGISTRY as _OBS
from repro_torch.obs import trace as _trace
from repro_torch.query.expr import And, Col, as_query
from repro_torch.stream import CompactionPolicy, StreamingIndex

__all__ = ["WindowRetentionPolicy", "WindowedStream"]

_EVENTS = _OBS.counter(
    "repro_search_window_events_total", "Events ingested into windowed streams",
)
_EXPIRED = _OBS.counter(
    "repro_search_window_expired_total", "Events expired out of the window",
)
_RETIRES = _OBS.counter(
    "repro_search_window_retires_total", "Row-space retention compactions",
)


@dataclasses.dataclass(frozen=True)
class WindowRetentionPolicy(CompactionPolicy):
    """When expired row slots are physically retired.

    Expiry only CLEARS bits -- cheap, tile-granular -- leaving dead
    all-zero rows behind.  Those are harmless to correctness (they match
    no query through ``__live__``) but grow the universe forever, so once
    ``dead / total`` exceeds ``max_dead_ratio`` (and at least
    ``min_dead_rows`` are dead) the stream rewrites the row space with
    only live rows.  Inherits the delta-compaction knobs of
    :class:`~repro_torch.stream.CompactionPolicy`.
    """

    min_dead_rows: int = 4096
    max_dead_ratio: float = 0.5

    def should_retire(self, dead_rows: int, total_rows: int) -> bool:
        if dead_rows < self.min_dead_rows:
            return False
        return dead_rows >= self.max_dead_ratio * max(total_rows, 1)


class WindowedStream:
    """Events over named series columns, windowed by timestamp."""

    LIVE = "__live__"

    def __init__(self, columns, *, window: float, tile_words: int = 8,
                 policy: WindowRetentionPolicy | None = None,
                 now: float = 0.0, device=None):
        names = tuple(str(c) for c in columns)
        if not names:
            raise ValueError("need at least one series column")
        if self.LIVE in names:
            raise ValueError(f"{self.LIVE!r} is reserved")
        self.window = float(window)
        if self.window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.policy = policy or WindowRetentionPolicy()
        self.device = resolve_device(device)
        self._columns = names
        self.now = float(now)
        #: (ts, row, cols) per live event, append order == timestamp order
        self._events: deque = deque()
        self._dead_rows = 0
        self._watches: dict[str, object] = {}
        self._stream = self._seed_stream(tile_words)

    def _seed_stream(self, tile_words: int) -> StreamingIndex:
        # the universe cannot be empty, so seed with one all-zero word of
        # row slots; they are never live, so they never match anything
        dense = np.zeros((len(self._columns) + 1, 32), dtype=bool)
        self._dead_rows = 32
        return StreamingIndex.from_dense(
            dense, self._columns + (self.LIVE,), tile_words=tile_words,
            policy=self.policy, device=self.device,
        )

    # -- accessors ---------------------------------------------------------
    @property
    def stream(self) -> StreamingIndex:
        return self._stream

    @property
    def columns(self) -> tuple:
        return self._columns

    @property
    def live_events(self) -> int:
        return len(self._events)

    @property
    def dead_rows(self) -> int:
        return self._dead_rows

    @property
    def total_rows(self) -> int:
        return self._stream.r

    # -- ingest ------------------------------------------------------------
    def append(self, events, *, now: float | None = None) -> tuple:
        """Ingest a batch of ``(timestamp, columns)`` events (one row
        each); timestamps must be non-decreasing across the stream's life.
        Advances the clock to ``now`` (default: the batch's last
        timestamp) and expires accordingly.  Returns the (start, stop)
        row range of the batch."""
        batch = [(float(ts), tuple(str(c) for c in cols)) for ts, cols in events]
        if not batch:
            if now is not None:
                self.advance(now)
            return (self.total_rows, self.total_rows)
        last_ts = self._events[-1][0] if self._events else self.now
        if any(b[0] < last_ts for b in batch) or any(
            b2[0] < b1[0] for b1, b2 in zip(batch, batch[1:])
        ):
            raise ValueError("event timestamps must be non-decreasing")
        k = len(batch)
        bits = {self.LIVE: np.ones(k, dtype=bool)}
        for name in {c for _, cols in batch for c in cols}:
            if name not in self._columns:
                raise KeyError(
                    f"unknown series column {name!r}; stream has "
                    f"{self._columns[:8]}..."
                )
            bits[name] = np.array([name in cols for _, cols in batch], bool)
        with _trace.span("window_append", n_events=k):
            start, stop = self._stream.append_rows(bits)
        _EVENTS.inc(k)
        for (ts, cols), row in zip(batch, range(start, stop)):
            self._events.append((ts, row, cols))
        self.advance(batch[-1][0] if now is None else now)
        return (start, stop)

    # -- expiry ------------------------------------------------------------
    def advance(self, now: float) -> int:
        """Move the clock forward; expire events older than ``now -
        window`` by clearing their bits in ONE batched update.  Returns
        the number of events expired."""
        if now < self.now:
            raise ValueError(f"clock cannot move backwards ({now} < {self.now})")
        self.now = float(now)
        horizon = self.now - self.window
        expired = []
        while self._events and self._events[0][0] <= horizon:
            expired.append(self._events.popleft())
        if expired:
            clears: dict[str, list] = {self.LIVE: []}
            for ts, row, cols in expired:
                clears[self.LIVE].append(row)
                for c in cols:
                    clears.setdefault(c, []).append(row)
            with _trace.span("window_expire", n_events=len(expired)):
                self._stream.update(clears=clears)
            _EXPIRED.inc(len(expired))
            self._dead_rows += len(expired)
        if self.policy.auto and self.policy.should_retire(
            self._dead_rows, self.total_rows
        ):
            self.retire()
        return len(expired)

    def retire(self) -> int:
        """Rewrite the row space with only live events (the retention
        compaction).  Watches are re-registered over the new rows; row
        ids change, so callers must not hold onto old positions.  Returns
        the number of dead row slots dropped."""
        dropped = self._dead_rows
        with _trace.span("window_retire", dead_rows=dropped,
                         live=len(self._events)):
            _RETIRES.inc(1)
            events = list(self._events)
            tile_words = self._stream.tile_words
            watches = {
                name: self._watches[name] for name in self._watches
            }
            self._events.clear()
            self._stream = self._seed_stream(tile_words)
            if events:
                # re-ingest live events with fresh row ids (one batch)
                k = len(events)
                bits = {self.LIVE: np.ones(k, dtype=bool)}
                for name in {c for _, _, cols in events for c in cols}:
                    bits[name] = np.array(
                        [name in cols for _, _, cols in events], bool
                    )
                start, _ = self._stream.append_rows(bits)
                for (ts, _, cols), row in zip(events, range(start, start + k)):
                    self._events.append((ts, row, cols))
            for name, query in watches.items():
                self._watches[name] = query
                self._stream.materialize(name, And(as_query(query), Col(self.LIVE)))
        return dropped

    # -- windowed queries --------------------------------------------------
    def watch(self, name: str, query) -> None:
        """Materialize ``query AND __live__`` as a maintained view column:
        its count stays fresh under append/expiry with tile-granular
        refresh work (:meth:`refresh_info`), never a rebuild."""
        q = as_query(query)
        self._watches[name] = q
        self._stream.materialize(name, And(q, Col(self.LIVE)))

    def count(self, name_or_query) -> int:
        """Current in-window count: a watched name reads the maintained
        cardinality (no execution); an ad-hoc query executes over
        ``query AND __live__``."""
        if isinstance(name_or_query, str) and name_or_query in self._watches:
            return self._stream.count(Col(name_or_query))
        q = as_query(name_or_query)
        return self._stream.count(And(q, Col(self.LIVE)))

    def ids(self, name_or_query) -> np.ndarray:
        """Row positions currently matching (watched views included)."""
        if isinstance(name_or_query, str) and name_or_query in self._watches:
            q = Col(name_or_query)
        else:
            q = And(as_query(name_or_query), Col(self.LIVE))
        words = to_numpy_u32(self._stream.execute(q))
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        return np.nonzero(bits)[0]

    def refresh_info(self, name: str) -> dict | None:
        """Words-touched accounting of the watch's last refresh (the
        no-rebuild evidence: bounded by touched tiles, not the universe)."""
        self._stream.refresh()
        return self._stream.view_info(name)

    def decayed_count(self, query, *, half_life: float,
                      now: float | None = None) -> float:
        """Exponentially time-decayed count of live rows matching
        ``query``: each contributes ``2 ** (-(now - ts) / half_life)``.
        Membership comes from the bitmap, weights from host timestamps."""
        if half_life <= 0:
            raise ValueError(f"half_life must be > 0, got {half_life}")
        t = self.now if now is None else float(now)
        rows = set(self.ids(query).tolist())
        if not rows:
            return 0.0
        return float(
            sum(
                2.0 ** (-(t - ts) / half_life)
                for ts, row, _ in self._events
                if row in rows
            )
        )
