"""Approximate string similarity search over tokenizer bitmap columns.

The port of the reference's ``repro.search.similarity``: the same columns,
bits, thresholds and answers, with the index on ``device`` (default: the
CUDA card) and the candidate bitmaps read back as host numpy ``uint32``.
Sharded indexes (``n_shards``) wait for ``ROADMAP.md`` Queue 1 item 10.

The paper frames threshold queries as T-occurrence queries -- the core of
approximate string/set similarity search.  :class:`SimilarityIndex` makes
that a first-class workload: a :class:`~repro_torch.stream.StreamingIndex` whose
columns are q-gram (and optionally length and minhash-band) token bitmaps
over a string corpus, with

* **exact candidate generation** (:meth:`SimilarityIndex.candidates`):
  the Sarawagi-Kirpal threshold ``T = n_grams - k*q`` with the vacuous
  case handled correctly -- ``T <= 0`` means the q-gram filter can exclude
  NOTHING and yields the all-rows bitmap, never "shares >= 1 gram" (the
  historical ``max(1, T)`` clamp silently dropped every true match sharing
  zero grams with the query);
* **adaptive top-k** (:meth:`SimilarityIndex.topk`): start at the exact
  bound and relax stepwise (``T, T-q, T-2q, ...``), each step paying only
  the NEW candidate band -- ``theta(T_j) \\ theta(T_{j-1})`` -- with the
  intermediate bitmaps fed back into the index as columns
  (``add_column``), so verification work is strictly the per-step delta
  and the vacuous tail is a complement of what is already materialized;
* **incremental appends** (:meth:`SimilarityIndex.append`): new records
  ride ``StreamingIndex.append_rows``; newly-seen grams grow the
  vocabulary via ``add_data_column`` -- no rebuild.

Every execution goes through the planner (or an explicit ``backend=``
override), so candidate generation runs on any ``ALGORITHMS`` backend
bit-identically.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.device import to_numpy_u32
from repro_torch.obs import REGISTRY as _OBS
from repro_torch.obs import trace as _trace
from repro_torch.query.expr import Col, Interval, Threshold
from repro_torch.query.index import BitmapIndex
from repro_torch.stream import StreamingIndex
from repro_torch.stream.index import _SHARDED

from .tokenize import MinHashParams, band_buckets, minhash_signature, qgrams, sk_threshold

__all__ = [
    "Candidates",
    "Matches",
    "TopK",
    "SimilarityIndex",
    "build_qgram_index",
    "edit_distance",
]

#: backends that execute arbitrary circuits (vs bare thresholds only)
from repro_torch.core.planner import CIRCUIT_BACKENDS  # noqa: E402

# -- observability (no-ops until repro_torch.obs.enable()) ------------------
_CANDIDATES = _OBS.counter(
    "repro_search_candidates_total", "Candidate rows generated", ("family",),
)
_VERIFICATIONS = _OBS.counter(
    "repro_search_verifications_total", "Edit-distance verifications run",
)
_RELAXATIONS = _OBS.counter(
    "repro_search_relaxations_total", "Top-k threshold relaxation steps",
)
_VACUOUS = _OBS.counter(
    "repro_search_vacuous_total", "Vacuous-threshold bypasses (T <= 0)",
)


def edit_distance(a: str, b: str, bound: int | None = None) -> int:
    """Levenshtein distance; with ``bound``, returns ``bound + 1`` as soon
    as the true distance provably exceeds it (banded early exit)."""
    if a == b:
        return 0
    if bound is not None and abs(len(a) - len(b)) > bound:
        return bound + 1
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, dp[0] = dp[0], i
        best = dp[0]
        for j, cb in enumerate(b, 1):
            prev, dp[j] = dp[j], min(dp[j] + 1, dp[j - 1] + 1, prev + (ca != cb))
            best = min(best, dp[j])
        if bound is not None and best > bound:
            return bound + 1
    return dp[-1]


# ---------------------------------------------------------------------------
# Result records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidates:
    """One candidate-generation answer (a host bitmap + its provenance)."""

    bitmap: np.ndarray  # packed uint32[n_words]
    ids: np.ndarray  # sorted row positions
    t: int  # the exact Sarawagi-Kirpal bound (may be <= 0)
    vacuous: bool  # T <= 0: the q-gram filter excluded nothing
    n_grams: int  # distinct q-grams of the query
    n_present: int  # of those, columns present in the index

    def __len__(self) -> int:
        return int(self.ids.size)


@dataclasses.dataclass(frozen=True)
class Matches:
    """Verified approximate matches (``search``)."""

    ids: np.ndarray
    distances: np.ndarray
    candidates: Candidates


@dataclasses.dataclass(frozen=True)
class TopK:
    """Adaptive top-k answer (``topk``)."""

    ids: np.ndarray
    distances: np.ndarray
    relaxations: int  # threshold bands executed/considered
    verified: int  # edit-distance computations spent
    vacuous: bool  # the loop had to fall through to the all-rows band


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------


def _positions(bitmap: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(bitmap.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0]


class SimilarityIndex:
    """q-gram (+ length, + minhash-band) bitmap columns over a corpus."""

    GRAM = "g:"
    LEN = "len:"
    MH = "mh:"

    def __init__(self, strings, *, q: int = 2, lengths: bool = True,
                 minhash: MinHashParams | None = None, tile_words: int = 8,
                 n_shards: int | None = None, device=None):
        if n_shards is not None:
            raise NotImplementedError(_SHARDED)
        self.q = int(q)
        self.lengths = bool(lengths)
        self.minhash = minhash
        self._strings: list[str] = [str(s) for s in strings]
        if not self._strings:
            raise ValueError("need at least one record to build an index")
        t0 = time.perf_counter()
        rows = [self._record_columns(s) for s in self._strings]
        names = sorted(set().union(*rows))
        t1 = time.perf_counter()
        words = _pack_rows(rows, names)
        base = BitmapIndex(words, names, r=len(rows), tile_words=tile_words,
                           device=device)
        t2 = time.perf_counter()
        self._stream = StreamingIndex(base)  # classifies the base's tiles
        #: host seconds of the three build steps: ``tokenize`` (the column
        #: names of every record), ``pack`` (the packed words, uploaded) and
        #: ``classify`` (the tile classification of the new store)
        self.build_seconds = {"tokenize": t1 - t0, "pack": t2 - t1,
                              "classify": time.perf_counter() - t2}

    # -- tokenization ------------------------------------------------------
    def grams(self, s: str) -> frozenset:
        return qgrams(s, self.q)

    def _record_columns(self, s: str) -> set:
        cols = {self.GRAM + g for g in self.grams(s)}
        if self.lengths:
            cols.add(f"{self.LEN}{len(s)}")
        if self.minhash is not None:
            sig = minhash_signature(self.grams(s), self.minhash)
            cols.update(
                f"{self.MH}{band}:{bucket}"
                for band, bucket in enumerate(band_buckets(sig, self.minhash))
            )
        return cols

    # -- accessors ---------------------------------------------------------
    @property
    def stream(self) -> StreamingIndex:
        """The underlying streaming index (materialize/serve against it)."""
        return self._stream

    @property
    def index(self):
        """The queryable BitmapIndex snapshot, deltas overlaid."""
        return self._stream.index()

    @property
    def r(self) -> int:
        return len(self._strings)

    def __len__(self) -> int:
        return len(self._strings)

    def record(self, rid: int) -> str:
        return self._strings[rid]

    def _present_grams(self, s: str) -> tuple:
        """Gram column names of the query that exist in the vocabulary.

        A record can only share grams that some record contains, so
        counting over the present columns equals counting over all of the
        query's grams -- absent grams contribute zero everywhere."""
        return tuple(
            sorted(self.GRAM + g for g in self.grams(s) if self.GRAM + g in self._stream)
        )

    def posting_lists(self, s: str) -> list:
        """Sorted row-id lists of the query's present gram columns -- the
        integer-list view the host competitors (``core.listalgos``) merge."""
        idx = self.index
        return [
            _positions(to_numpy_u32(idx.column(nm)))
            for nm in self._present_grams(s)
        ]

    # -- bitmap helpers ----------------------------------------------------
    def _n_words(self) -> int:
        return (self.r + 31) // 32

    def _all_rows(self) -> np.ndarray:
        out = np.full(self._n_words(), 0xFFFFFFFF, dtype=np.uint32)
        rem = self.r % 32
        if rem:
            out[-1] = np.uint32((1 << rem) - 1)
        return out

    def _empty(self) -> np.ndarray:
        return np.zeros(self._n_words(), dtype=np.uint32)

    def _pad_words(self, bm: np.ndarray) -> np.ndarray:
        """Grow a host bitmap to the store's word width (the store may hold
        trailing partial-tile words past ceil(r/32))."""
        want = getattr(self.index, "n_words", bm.size)
        if bm.size < want:
            bm = np.concatenate([bm, np.zeros(want - bm.size, np.uint32)])
        return bm

    # -- candidate generation (the bugfix surface) -------------------------
    def candidates(self, s: str, k: int, *, backend: str | None = None,
                   length_filter: bool = False) -> Candidates:
        """Rows that *can* be within edit distance ``k`` of ``s``, by the
        exact Sarawagi-Kirpal gram-count bound.

        ``T <= 0`` is the vacuous case: the filter excludes nothing and the
        answer is the ALL-ROWS bitmap (optionally cut down by the cheap
        length filter, which remains exact: ``|len(r) - len(s)| <= k`` is
        necessary for distance ``k``).  No clamping, ever."""
        grams = self._present_grams(s)
        n_grams = len(self.grams(s))
        t = sk_threshold(n_grams, self.q, k)
        with _trace.span("search_candidates", t=t, n_grams=n_grams) as sp:
            if t <= 0:
                _VACUOUS.inc(1)
                bm = self._all_rows()
                vacuous = True
            elif t > len(grams):
                # fewer present grams than the bound requires: no record can
                # reach T (absent grams occur in no record)
                bm = self._empty()
                vacuous = False
            else:
                res = self.index.execute(
                    Threshold(t, over=[Col(g) for g in grams]), backend=backend
                )
                bm = to_numpy_u32(res)[: self._n_words()]
                vacuous = False
            if length_filter and self.lengths:
                bm = bm & self._length_filter(len(s), k, backend=backend)
            ids = _positions(bm)
            _CANDIDATES.inc(int(ids.size), family="qgram")
            if _trace.enabled:
                sp.set(vacuous=vacuous, n_candidates=int(ids.size))
        return Candidates(
            bitmap=bm, ids=ids, t=t, vacuous=vacuous,
            n_grams=n_grams, n_present=len(grams),
        )

    def _length_filter(self, qlen: int, k: int, *, backend: str | None = None) -> np.ndarray:
        """Bitmap of rows whose length is within ``k`` of ``qlen``."""
        cols = [
            f"{self.LEN}{L}"
            for L in range(max(0, qlen - k), qlen + k + 1)
            if f"{self.LEN}{L}" in self._stream
        ]
        if not cols:
            return self._empty()
        res = self.index.execute(
            Threshold(1, over=[Col(c) for c in cols]), backend=backend
        )
        return to_numpy_u32(res)[: self._n_words()]

    def minhash_candidates(self, s: str, *, min_bands: int = 1,
                           backend: str | None = None) -> Candidates:
        """Rows sharing at least ``min_bands`` minhash bands with ``s``
        (Jaccard-style screening; probabilistic, unlike the q-gram bound)."""
        if self.minhash is None:
            raise ValueError("index built without a minhash column family")
        sig = minhash_signature(self.grams(s), self.minhash)
        cols = [
            f"{self.MH}{band}:{bucket}"
            for band, bucket in enumerate(band_buckets(sig, self.minhash))
            if f"{self.MH}{band}:{bucket}" in self._stream
        ]
        if len(cols) < min_bands:
            bm = self._empty()
        else:
            res = self.index.execute(
                Threshold(min_bands, over=[Col(c) for c in cols]), backend=backend
            )
            bm = to_numpy_u32(res)[: self._n_words()]
        ids = _positions(bm)
        _CANDIDATES.inc(int(ids.size), family="minhash")
        return Candidates(
            bitmap=bm, ids=ids, t=min_bands, vacuous=False,
            n_grams=self.minhash.bands, n_present=len(cols),
        )

    # -- verified search ---------------------------------------------------
    def search(self, s: str, k: int, *, backend: str | None = None,
               length_filter: bool = False) -> Matches:
        """All records within edit distance ``k``: candidates, then exact
        verification on candidates only (the paper's screening pattern)."""
        cand = self.candidates(s, k, backend=backend, length_filter=length_filter)
        with _trace.span("search_verify", n=len(cand)):
            _VERIFICATIONS.inc(len(cand))
            hits = [
                (rid, d)
                for rid in cand.ids.tolist()
                if (d := edit_distance(s, self._strings[rid], bound=k)) <= k
            ]
        ids = np.array([r for r, _ in hits], dtype=np.int64)
        return Matches(
            ids=ids,
            distances=np.array([d for _, d in hits], dtype=np.int64),
            candidates=cand,
        )

    # -- adaptive top-k ----------------------------------------------------
    def topk(self, s: str, k: int, *, backend: str | None = None,
             max_edits: int | None = None) -> TopK:
        """The ``k`` nearest records by edit distance (ties broken by row
        id), found by stepwise threshold relaxation.

        Step ``j`` (edit budget ``j``) uses ``T_j = n_grams - j*q``.  The
        candidate sets are nested (``theta(T_j)`` grows as ``T`` falls), so
        each step verifies only the NEW band: on circuit backends the band
        is one ``Interval(max(T_j, 0), T_{j-1} - 1)`` execution; on
        bare-threshold backends it is ``theta(T_j)`` minus the previous
        step's materialized bitmap.  Either way the intermediate result is
        fed back into the index as a column (``add_column``) for the next
        step to build on.  When ``T_j <= 0`` the filter is vacuous and the
        final band is the complement of everything already materialized --
        at that point every row has been verified and the answer is exact
        unconditionally.

        Guarantee: a record within distance ``j`` shares ``>= T_j`` grams,
        so once ``k`` verified records have distance ``<= j``, no unseen
        record can displace them -- the loop stops with the exact top-k.
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        grams = self._present_grams(s)
        gram_cols = [Col(g) for g in grams]
        n_grams = len(self.grams(s))
        n_present = len(grams)
        circuit = backend is None or backend in CIRCUIT_BACKENDS
        # add_column feedback needs a solid base: overlay stores (pending
        # appends) are read views and refuse schema growth
        self._stream.compact(force=True)
        idx = self.index
        verified: dict[int, int] = {}
        seen = self._empty()  # union of all bands materialized so far
        hi_next = n_present  # highest count not yet covered by a band
        relaxations = 0
        hit_vacuous = False
        with _trace.span("search_topk", k=k, n_grams=n_grams) as root:
            j = 0
            while True:
                t = sk_threshold(n_grams, self.q, j)
                band, theta = self._relax_band(
                    idx, gram_cols, t, hi_next, seen, circuit, backend,
                )
                if band is not None:
                    relaxations += 1
                    _RELAXATIONS.inc(1)
                    if t <= 0:
                        hit_vacuous = True
                        _VACUOUS.inc(1)
                    new_ids = _positions(band)
                    with _trace.span("search_verify", n=int(new_ids.size), t=t):
                        _VERIFICATIONS.inc(int(new_ids.size))
                        for rid in new_ids.tolist():
                            verified[rid] = edit_distance(s, self._strings[rid])
                    seen = seen | band
                    if theta is not None and t >= 1:
                        # feed the materialized intermediate back as a column:
                        # the next relaxation (and any caller) composes with it
                        idx = idx.add_column(
                            f"_cand:{t}", self._pad_words(theta)
                        )
                        hi_next = max(t, 1) - 1
                    elif t <= 0:
                        hi_next = -1
                if t <= 0:
                    # every row is verified: the sort below is globally exact
                    break
                matches = [(d, rid) for rid, d in verified.items() if d <= j]
                if len(matches) >= k:
                    break
                if max_edits is not None and j >= max_edits:
                    break
                j += 1
            if t <= 0:
                ranked = sorted((d, rid) for rid, d in verified.items())
            else:
                ranked = sorted((d, rid) for rid, d in verified.items() if d <= j)
            ranked = ranked[:k]
            if _trace.enabled:
                root.set(relaxations=relaxations, verified=len(verified),
                         vacuous=hit_vacuous)
        return TopK(
            ids=np.array([rid for _, rid in ranked], dtype=np.int64),
            distances=np.array([d for d, _ in ranked], dtype=np.int64),
            relaxations=relaxations,
            verified=len(verified),
            vacuous=hit_vacuous,
        )

    def _relax_band(self, idx, gram_cols, t: int, hi_next: int,
                    seen: np.ndarray, circuit: bool, backend):
        """One relaxation band: (band bitmap | None when empty, theta(t)
        bitmap | None).  ``hi_next`` is the highest shared-gram count not
        yet claimed by an earlier band (-1: nothing left)."""
        n_present = len(gram_cols)
        if hi_next < 0:
            return None, None
        if t > n_present:
            # the bound exceeds what any record can share: provably empty,
            # nothing to execute
            return None, None
        if not gram_cols:
            # no query gram exists in the vocabulary: counts are all zero
            if t >= 1:
                return None, None
            return self._all_rows() & ~seen, None
        if t <= 0:
            # vacuous: the complement of everything already materialized
            return self._all_rows() & ~seen, None
        if circuit:
            lo = t
            q = (
                Threshold(lo, over=gram_cols)
                if hi_next >= n_present
                else Interval(lo, hi_next, over=gram_cols)
            )
            band = to_numpy_u32(idx.execute(q, backend=backend))[: self._n_words()]
            return band, seen | band
        # the degenerate reductions only express theta(1) / theta(N); other
        # relaxation steps fall back to the planner's choice
        use = backend
        if (backend == "wide_or" and t != 1) or (
            backend == "wide_and" and t != n_present
        ):
            use = None
        theta = to_numpy_u32(
            idx.execute(Threshold(t, over=gram_cols), backend=use)
        )[: self._n_words()]
        return theta & ~seen, theta

    # -- incremental appends -----------------------------------------------
    def append(self, strings) -> tuple:
        """Append new records; newly-seen tokens grow the vocabulary as
        fresh all-zero columns first (``StreamingIndex.add_data_column``),
        then the rows ride one ``append_rows`` batch.  Returns the appended
        (start, stop) row range."""
        new = [str(s) for s in strings]
        if not new:
            return (self.r, self.r)
        rows = [self._record_columns(s) for s in new]
        for nm in sorted(set().union(*rows)):
            if nm not in self._stream:
                self._stream.add_data_column(nm)
        bits = {
            nm: np.array([nm in cols for cols in rows], dtype=bool)
            for nm in set().union(*rows)
        }
        start, stop = self._stream.append_rows(bits)
        self._strings.extend(new)
        return (start, stop)


def _pack_rows(rows: list, names: list) -> np.ndarray:
    """uint32[len(names), ceil(len(rows) / 32)]: bit ``rid`` of row
    ``slot[nm]`` is set for every column name ``nm`` of record ``rid``.

    The (column, record) pairs are distinct, so summing each word's bits
    is their OR; ``bincount`` sums in float64, exact below 2**53."""
    slot = {nm: i for i, nm in enumerate(names)}
    sizes = np.fromiter((len(cols) for cols in rows), np.int64, len(rows))
    cols = np.fromiter((slot[nm] for c in rows for nm in c), np.int64, int(sizes.sum()))
    rids = np.repeat(np.arange(len(rows), dtype=np.int64), sizes)
    n_words = (len(rows) + 31) // 32
    sums = np.bincount(cols * n_words + rids // 32,
                       weights=np.left_shift(1, rids % 32).astype(np.float64),
                       minlength=len(names) * n_words)
    return sums.astype(np.uint64).astype(np.uint32).reshape(len(names), n_words)


def build_qgram_index(strings, q: int = 2, *, lengths: bool = True,
                      minhash: MinHashParams | None = None,
                      tile_words: int = 8,
                      n_shards: int | None = None, device=None) -> SimilarityIndex:
    """Build a :class:`SimilarityIndex` over ``strings`` (q-gram columns,
    plus length columns and optionally a minhash-band family) on ``device``
    (default: the CUDA card)."""
    return SimilarityIndex(
        strings, q=q, lengths=lengths, minhash=minhash,
        tile_words=tile_words, n_shards=n_shards, device=device,
    )
