"""The port's similarity search and windowed analytics (``repro_torch.search``)
against the reference.

The same seeded corpora and event streams go to the reference's
``repro.search`` and to the port's (``device="cpu"``).  Tokenizer output
(grams, hashes, signatures, buckets) is held equal value for value;
candidate bitmaps word for word (``np.array_equal`` on ``uint32``), with
their ids, ``t`` and ``vacuous``; search matches, top-k order, relaxation
and verification counts; window counts, ids and refresh accounting.  The
tolerance is none, except ``decayed_count`` (a float sum): relative 1e-12.
These are the cases of ``tests/test_search.py``, each on every backend
where the case takes one; the sharded top-k and append cases run over
row-sharded indexes (``n_shards``) in both packages.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.obs as RO
import repro.search as RS
import repro_torch.obs as TO
import repro_torch.search as TS
from _torch_port import u32
from repro import query as RQ
from repro_torch import query as TQ
from repro_torch.core.threshold import ALGORITHMS

ALPHA = list("abcdef")
BACKENDS = (None,) + ALGORITHMS


def _corpus(n, lo=3, hi=9, seed=3):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHA, size=rng.integers(lo, hi))) for _ in range(n)]


def _brute_topk(strings, q, k):
    return sorted((TS.edit_distance(q, s), i) for i, s in enumerate(strings))[:k]


def _pair(corpus, **kw):
    return (RS.build_qgram_index(corpus, **kw),
            TS.build_qgram_index(corpus, device="cpu", **kw))


def _both(fn, ref, tor):
    """``fn(ref)`` and ``fn(tor)``; when one raises, the other must raise
    the same exception type (returned as ``None, None``)."""
    try:
        want = fn(ref)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(e)):
            fn(tor)
        return None, None
    return want, fn(tor)


def _same_candidates(want, got):
    assert np.array_equal(u32(got.bitmap), u32(want.bitmap))
    assert got.ids.tolist() == want.ids.tolist()
    assert (got.t, got.vacuous, got.n_grams, got.n_present) == \
        (want.t, want.vacuous, want.n_grams, want.n_present)


def _same_topk(want, got):
    assert got.ids.tolist() == want.ids.tolist()
    assert got.distances.tolist() == want.distances.tolist()
    assert (got.relaxations, got.verified, got.vacuous) == \
        (want.relaxations, want.verified, want.vacuous)


# ---------------------------------------------------------------------------
# Tokenization: byte for byte
# ---------------------------------------------------------------------------

STRINGS = ["", "a", "ab", "aaa", "hello", "chateau margaux 1982", "naïve café",
           "東京都", "emoji 🙂🙃", "#$#$", "x" * 40] + _corpus(20, seed=5)


@pytest.mark.parametrize("q", [1, 2, 3, 4])
def test_qgrams_equal(q):
    for s in STRINGS:
        assert TS.qgrams(s, q) == RS.qgrams(s, q), (s, q)
    assert TS.qgrams("ab", 2) == {"#a", "ab", "b$"}
    with pytest.raises(ValueError):
        TS.qgrams("x", 0)


def test_sk_threshold_equal_and_raw():
    for n in range(0, 20):
        for q in (1, 2, 3):
            for k in range(0, 5):
                assert TS.sk_threshold(n, q, k) == RS.sk_threshold(n, q, k)
    assert TS.sk_threshold(3, 2, 2) == -1  # raw: T <= 0 is the vacuous signal


@pytest.mark.parametrize("params", [(16, 4, 32, 0), (8, 4, 16, 0), (8, 2, 64, 7), (12, 3, 5, 1)])
def test_minhash_equal(params):
    tp, rp = TS.MinHashParams(*params), RS.MinHashParams(*params)
    assert tp.rows_per_band == rp.rows_per_band
    for s in STRINGS:
        grams = TS.qgrams(s, 2)
        th, rh = TS.token_hashes(grams), RS.token_hashes(grams)
        assert th.dtype == rh.dtype == np.uint64 and np.array_equal(th, rh)
        ts, rs = TS.minhash_signature(grams, tp), RS.minhash_signature(grams, rp)
        assert ts.dtype == np.uint64 and ts.tobytes() == rs.tobytes()
        assert TS.band_buckets(ts, tp) == RS.band_buckets(rs, rp)
    empty = TS.minhash_signature((), tp)
    assert (empty == np.iinfo(np.uint64).max).all()
    assert empty.tobytes() == RS.minhash_signature((), rp).tobytes()
    with pytest.raises(ValueError):
        TS.band_buckets(np.zeros(tp.n_hashes + 1, np.uint64), tp)
    with pytest.raises(ValueError):
        TS.MinHashParams(n_hashes=7, bands=4)


# ---------------------------------------------------------------------------
# Candidate generation, on every backend
# ---------------------------------------------------------------------------

def _vacuous_corpus():
    return _corpus(40) + ["qz"]


CANDIDATE_CASES = {
    # 'zq' shares no bigram with 'qz': T <= 0, all rows (the clamp regression)
    "vacuous": (_vacuous_corpus, "zq", 3, False),
    "no_clamp": (_vacuous_corpus, "zq", 0, False),
    "exact_bound": (lambda: _corpus(60, seed=9), _corpus(60, seed=9)[7][:-1] + "x", 1, False),
    "absent_grams": (lambda: ["aaaa", "bbbb"], "zxq", 0, False),
    "length_filter_off": (lambda: _corpus(50, seed=4) + ["abcdef"], "abcdxf", 1, False),
    "length_filter_on": (lambda: _corpus(50, seed=4) + ["abcdef"], "abcdxf", 1, True),
    "vacuous_length_filter": (lambda: ["a", "ab", "abcdefgh", "x"], "ab", 2, True),
}


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b or "planner")
@pytest.mark.parametrize("case", list(CANDIDATE_CASES))
def test_candidates_equal(case, backend):
    make, q, k, lf = CANDIDATE_CASES[case]
    corpus = make()
    ref, tor = _pair(corpus, q=2)
    want, got = _both(lambda i: i.candidates(q, k, backend=backend, length_filter=lf), ref, tor)
    if want is None:
        return
    _same_candidates(want, got)
    grams = TS.qgrams(q)
    if not lf and not got.vacuous:  # the gram-count oracle
        assert got.ids.tolist() == [i for i, s in enumerate(corpus)
                                    if len(grams & TS.qgrams(s)) >= got.t]
    if case == "vacuous":
        assert got.vacuous and len(got) == len(corpus)
    want_m, got_m = _both(lambda i: i.search(q, k, backend=backend, length_filter=lf), ref, tor)
    assert got_m.ids.tolist() == want_m.ids.tolist()
    assert got_m.distances.tolist() == want_m.distances.tolist()
    assert got_m.ids.tolist() == [i for i, s in enumerate(corpus)
                                  if TS.edit_distance(q, s) <= k]


@pytest.mark.parametrize("backend", [None, "fused", "tiled_fused", "scancount", "dsk"],
                         ids=lambda b: b or "planner")
def test_minhash_candidates_equal(backend):
    corpus = _corpus(30, seed=5) + ["hello"]
    params = dict(n_hashes=8, bands=4, buckets=64)
    ref = RS.build_qgram_index(corpus, q=2, minhash=RS.MinHashParams(**params))
    tor = TS.build_qgram_index(corpus, q=2, minhash=TS.MinHashParams(**params), device="cpu")
    assert tor.stream.names == ref.stream.names
    for s, bands in (("hello", 4), ("hello", 1), ("hellp", 2), ("zzz", 1)):
        want = ref.minhash_candidates(s, min_bands=bands, backend=backend)
        got = tor.minhash_candidates(s, min_bands=bands, backend=backend)
        _same_candidates(want, got)
    assert len(corpus) - 1 in tor.minhash_candidates("hello", min_bands=4).ids.tolist()
    with pytest.raises(ValueError):
        TS.build_qgram_index(corpus, q=2, device="cpu").minhash_candidates("hello")


@pytest.mark.parametrize("q", [1, 2, 3])
def test_index_columns_and_posting_lists_equal(q):
    corpus = _corpus(25, seed=6) + ["naïve", "東京"]
    ref, tor = _pair(corpus, q=q)
    assert tor.stream.names == ref.stream.names
    for name in tor.stream.names:
        assert np.array_equal(u32(tor.index.column(name)), u32(ref.index.column(name)))
    for s in (corpus[3], "zzz", "naïf", ""):
        want, got = ref.posting_lists(s), tor.posting_lists(s)
        assert [x.tolist() for x in got] == [x.tolist() for x in want]
    assert set(tor.build_seconds) == {"tokenize", "pack", "classify"}


# ---------------------------------------------------------------------------
# Adaptive top-k: oracle parity on every backend
# ---------------------------------------------------------------------------

TOPK_CORPUS = _corpus(36, seed=12) + ["hello", "hellp", "zq"]


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b or "planner")
def test_topk_equal_every_backend(backend):
    ref, tor = _pair(TOPK_CORPUS, q=2)
    for q, k in (("hello", 3), ("zq", 5)):
        want, got = ref.topk(q, k, backend=backend), tor.topk(q, k, backend=backend)
        _same_topk(want, got)
        assert list(zip(got.distances.tolist(), got.ids.tolist())) == \
            _brute_topk(TOPK_CORPUS, q, k)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b or "planner")
def test_topk_equal_every_backend_sharded(backend):
    """``tests/test_search.py:180``, sharded: 3 row shards in both packages
    (one-word tiles, so that the corpus spans more than one tile); the
    candidates of each query are held equal word for word too."""
    corpus = _corpus(100, seed=12) + ["hello", "hellp", "zq"]
    ref, tor = _pair(corpus, q=2, n_shards=3, tile_words=1)
    assert tor.index.n_shards == ref.index.n_shards == 3
    for q, k in (("hello", 3), ("zq", 5)):
        want, got = ref.topk(q, k, backend=backend), tor.topk(q, k, backend=backend)
        _same_topk(want, got)
        assert list(zip(got.distances.tolist(), got.ids.tolist())) == \
            _brute_topk(corpus, q, k)
        want, got = _both(lambda idx: idx.candidates(q, 1, backend=backend), ref, tor)
        if want is not None:  # wide_or / wide_and refuse other thresholds alike
            _same_candidates(want, got)


TOPK_CASES = {
    "vacuous": (lambda: _corpus(20, seed=8) + ["qz"], "zq", 21, {}),
    "relaxation_bands": (lambda: _corpus(200, seed=13) + ["hello", "hellp"], "hello", 2, {}),
    "max_edits": (lambda: _corpus(15, seed=14), "zzzzzzzz", 10, {"max_edits": 1}),
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_cases_equal(case):
    make, q, k, kw = TOPK_CASES[case]
    corpus = make()
    ref, tor = _pair(corpus, q=2)
    want, got = ref.topk(q, k, **kw), tor.topk(q, k, **kw)
    _same_topk(want, got)
    if case == "vacuous":
        assert got.vacuous
        assert list(zip(got.distances.tolist(), got.ids.tolist())) == _brute_topk(corpus, q, k)
    if case == "relaxation_bands":
        assert got.distances.tolist() == [0, 1] and got.verified < len(corpus) // 2
    if case == "max_edits":
        assert all(d <= 1 for d in got.distances.tolist())


def test_topk_k_validation():
    tor = TS.build_qgram_index(["ab"], q=2, device="cpu")
    with pytest.raises(ValueError):
        tor.topk("ab", 0)


# ---------------------------------------------------------------------------
# Incremental appends (rows AND vocabulary)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "fused", "tiled_fused", "looped"],
                         ids=lambda b: b or "planner")
def test_append_with_new_grams_equal(backend):
    corpus = _corpus(30, seed=21)
    ref, tor = _pair(corpus, q=2)
    extra = ["zzzyx", corpus[0], "naïve"]  # never-seen grams, a duplicate, non-ASCII
    assert tor.append(extra) == ref.append(extra) == (30, 33)
    assert tor.r == 33 and tor.record(30) == "zzzyx"
    assert tor.stream.names == ref.stream.names
    full = corpus + extra
    for s, k in (("zzzyx", 1), ("naive", 1), (corpus[0], 0)):
        _same_candidates(ref.candidates(s, k, backend=backend),
                         tor.candidates(s, k, backend=backend))
        assert tor.search(s, k, backend=backend).ids.tolist() == \
            ref.search(s, k, backend=backend).ids.tolist()
    for s, k in (("zzzyx", 2), (corpus[0], 3)):
        want, got = ref.topk(s, k, backend=backend), tor.topk(s, k, backend=backend)
        _same_topk(want, got)
        assert list(zip(got.distances.tolist(), got.ids.tolist())) == _brute_topk(full, s, k)


@pytest.mark.parametrize("backend", [None, "fused", "tiled_fused"],
                         ids=lambda b: b or "planner")
def test_append_with_new_grams_equal_sharded(backend):
    """``tests/test_search.py:228``, sharded: the appended rows extend the
    last of 2 shards, the new grams become new columns of every shard."""
    corpus = _corpus(64, seed=21)
    ref, tor = _pair(corpus, q=2, n_shards=2, tile_words=1)
    assert tor.index.n_shards == ref.index.n_shards == 2
    extra = ["zzzyx", corpus[0], "naïve"]
    assert tor.append(extra) == ref.append(extra) == (64, 67)
    assert tor.stream.names == ref.stream.names and tor.stream.is_sharded
    full = corpus + extra
    for s, k in (("zzzyx", 1), ("naive", 1), (corpus[0], 0)):
        _same_candidates(ref.candidates(s, k, backend=backend),
                         tor.candidates(s, k, backend=backend))
        assert tor.search(s, k, backend=backend).ids.tolist() == \
            ref.search(s, k, backend=backend).ids.tolist()
    for s, k in (("zzzyx", 2), (corpus[0], 3)):
        want, got = ref.topk(s, k, backend=backend), tor.topk(s, k, backend=backend)
        _same_topk(want, got)
        assert list(zip(got.distances.tolist(), got.ids.tolist())) == _brute_topk(full, s, k)


def test_empty_append_is_noop():
    tor = TS.build_qgram_index(["abc"], q=2, device="cpu")
    assert tor.append([]) == (1, 1) and tor.r == 1


def test_device_none_is_the_card():
    """``device=None`` means the CUDA card: without one, building raises."""
    import torch

    if torch.cuda.is_available():  # decided inside the test, not at import
        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.build_qgram_index(["ab", "cd"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.WindowedStream(["a"], window=1.0)


# ---------------------------------------------------------------------------
# Windowed analytics: one seeded event stream through both packages
# ---------------------------------------------------------------------------

def _window_pair(stores, **kw):
    policy = kw.pop("policy", {})
    ref = RS.WindowedStream(stores, policy=RS.WindowRetentionPolicy(**policy), **kw)
    tor = TS.WindowedStream(stores, policy=TS.WindowRetentionPolicy(**policy),
                            device="cpu", **kw)
    return ref, tor


def _same_window(ref, tor, names, ad_hoc):
    assert (tor.live_events, tor.dead_rows, tor.total_rows, tor.now) == \
        (ref.live_events, ref.dead_rows, ref.total_rows, ref.now)
    for name in names:
        assert tor.count(name) == ref.count(name)
        assert tor.ids(name).tolist() == ref.ids(name).tolist()
        assert tor.refresh_info(name) == ref.refresh_info(name)
    for make in ad_hoc:
        assert tor.count(make(TQ)) == ref.count(make(RQ))
        assert tor.ids(make(TQ)).tolist() == ref.ids(make(RQ)).tolist()


def _events(stores, n, seed, lo=1.0, hi=10.0):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += float(rng.uniform(lo, hi))
        out.append((t, [str(c) for c in rng.choice(stores, size=rng.integers(1, min(5, len(stores) + 1)),
                                                   replace=False)]))
    return out


@pytest.mark.parametrize("tile_words", [1, 8, 64])
def test_window_counts_track_expiry_equal(tile_words):
    stores = [f"store:{i}" for i in range(6)]
    ref, tor = _window_pair(stores, window=100.0, tile_words=tile_words,
                            policy={"auto": False})
    for ws, M in ((ref, RQ), (tor, TQ)):
        ws.watch("hot", M.Threshold(2, over=[M.Col(s) for s in stores]))
        ws.watch("pair", M.And(M.Col("store:0"), M.Col("store:1")))
    events = _events(stores, 60, seed=31)
    ad_hoc = [lambda M: M.Interval(1, 2, over=[M.Col(s) for s in stores[:3]]),
              lambda M: M.Col("store:5")]
    for lo, hi in ((0, 20), (20, 45), (45, 60)):
        assert tor.append(events[lo:hi]) == ref.append(events[lo:hi])
        _same_window(ref, tor, ("hot", "pair"), ad_hoc)
    t = events[-1][0]
    for now in (t + 20, t + 60, t + 101):
        assert tor.advance(now) == ref.advance(now)
        _same_window(ref, tor, ("hot", "pair"), ad_hoc)
        want = sum(1 for ts, cs in events if ts > now - 100.0 and len(cs) >= 2)
        assert tor.count("hot") == want
    assert tor.count("hot") == 0 and tor.live_events == 0


def test_window_refresh_is_tile_granular_equal():
    stores = [f"s{i}" for i in range(3)]
    ref, tor = _window_pair(stores, window=1e6, tile_words=8, policy={"auto": False})
    for ws, M in ((ref, RQ), (tor, TQ)):
        ws.watch("any", M.Threshold(1, over=[M.Col(s) for s in stores]))
        ws.append([(float(i), ["s0"]) for i in range(4000)])
        assert ws.count("any") == 4000  # refreshed: the next batch alone is pending
        ws.append([(4000.0, ["s1", "s2"])])
    _same_window(ref, tor, ("any",), [])
    info = tor.refresh_info("any")
    tw = tor.stream.tile_words
    assert info["words_touched"] <= info["tiles_refreshed"] * tw * (1 + len(stores) + 1)
    n_tiles = (tor.total_rows + tw * 32 - 1) // (tw * 32)
    assert info["tiles_refreshed"] <= 2 < n_tiles


def test_window_retire_equal():
    stores = ["a", "b"]
    ref, tor = _window_pair(stores, window=10.0,
                            policy={"auto": False, "min_dead_rows": 1, "max_dead_ratio": 0.0})
    for ws, M in ((ref, RQ), (tor, TQ)):
        ws.watch("either", M.Threshold(1, over=[M.Col("a"), M.Col("b")]))
        ws.append([(float(i), ["a"] if i % 2 else ["b"]) for i in range(50)])
        ws.advance(50.0)
    _same_window(ref, tor, ("either",), [])
    assert tor.dead_rows > 0
    rows_before, count_before = tor.total_rows, tor.count("either")
    assert tor.retire() == ref.retire() > 0
    assert tor.total_rows < rows_before and tor.count("either") == count_before
    _same_window(ref, tor, ("either",), [])
    for ws in (ref, tor):
        ws.append([(50.0, ["a", "b"])])
    _same_window(ref, tor, ("either",), [lambda M: M.Col("a")])
    assert tor.count("either") == count_before + 1


def test_window_auto_retention_equal():
    ref, tor = _window_pair(["x"], window=5.0,
                            policy={"min_dead_rows": 64, "max_dead_ratio": 0.3})
    for i in range(300):
        assert tor.append([(float(i), ["x"])]) == ref.append([(float(i), ["x"])])
    _same_window(ref, tor, (), [lambda M: M.Col("x")])
    assert tor.dead_rows < 300 and tor.count(TQ.Col("x")) == tor.live_events


def test_window_decayed_count_equal():
    stores = ["x", "y", "z"]
    ref, tor = _window_pair(stores, window=1000.0)
    events = _events(stores, 80, seed=17, lo=0.5, hi=3.0)
    for ws in (ref, tor):
        ws.append(events)
    for half_life in (1.0, 10.0, 123.4):
        for now in (None, events[-1][0] + 7.5):
            for make in (lambda M: M.Col("x"), lambda M: M.Threshold(2, over=("x", "y", "z"))):
                want = ref.decayed_count(make(RQ), half_life=half_life, now=now)
                got = tor.decayed_count(make(TQ), half_life=half_life, now=now)
                assert got == pytest.approx(want, rel=1e-12, abs=0.0)
    small = TS.WindowedStream(["x", "y"], window=1000.0, device="cpu")
    small.append([(0.0, ["x"]), (10.0, ["x", "y"]), (20.0, ["y"])])
    assert small.decayed_count(TQ.Col("x"), half_life=10.0, now=20.0) == \
        pytest.approx(2.0 ** -2 + 2.0 ** -1, rel=1e-12)
    with pytest.raises(ValueError):
        small.decayed_count(TQ.Col("x"), half_life=0.0)


def test_window_validation():
    with pytest.raises(ValueError):
        TS.WindowedStream([], window=10, device="cpu")
    with pytest.raises(ValueError):
        TS.WindowedStream(["a"], window=0, device="cpu")
    with pytest.raises(ValueError):
        TS.WindowedStream(["a", "__live__"], window=1, device="cpu")
    ws = TS.WindowedStream(["a"], window=10, device="cpu")
    with pytest.raises(KeyError):
        ws.append([(0.0, ["nope"])])
    with pytest.raises(ValueError):
        ws.append([(5.0, ["a"]), (1.0, ["a"])])
    ws.append([(5.0, ["a"])])
    with pytest.raises(ValueError):
        ws.advance(1.0)


# ---------------------------------------------------------------------------
# Observability: the reference's counter and span names, equal values
# ---------------------------------------------------------------------------

def _search_samples(obs) -> dict:
    snap = obs.REGISTRY.snapshot()
    return {k: v["samples"] for k, v in snap.items() if k.startswith("repro_search_")}


def _span_names(sp) -> tuple:
    return (sp.name, tuple(_span_names(c) for c in sp.children))


def test_search_counters_and_spans_equal():
    corpus = _corpus(20, seed=33) + ["qz"]
    ref, tor = _pair(corpus, q=2)
    trees = {}
    for obs, idx in ((RO, ref), (TO, tor)):
        obs.reset()
        obs.enable()
        try:
            idx.search("zq", k=3)
            idx.topk("zq", k=2)
            trees[obs] = _span_names(obs.last_trace())
            ws = (RS if obs is RO else TS).WindowedStream(
                ["a"], window=5.0, **({} if obs is RO else {"device": "cpu"}))
            ws.append([(0.0, ["a"]), (1.0, ["a"])])
            ws.advance(10.0)
            samples = _search_samples(obs)
        finally:
            obs.disable()
            obs.reset()
        trees[obs, "samples"] = samples
    assert trees[TO] == trees[RO] and trees[TO][0] == "search_topk"
    got, want = trees[TO, "samples"], trees[RO, "samples"]
    assert got == want
    assert got["repro_search_candidates_total"]["qgram"] > 0
    assert got["repro_search_vacuous_total"][""] >= 2
    assert got["repro_search_window_events_total"][""] == 2
    assert got["repro_search_window_expired_total"][""] == 2
