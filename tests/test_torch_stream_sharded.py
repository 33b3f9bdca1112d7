"""The port's streaming engine over a sharded base, against the reference.

The same numpy-seeded bits and mutation batches go to a reference
``StreamingIndex`` over a ``ShardedBitmapIndex`` and to the port's
(``device="cpu"``).  Every answer is gathered and held equal word for word
(``np.array_equal`` on ``uint32``), with the per-shard plans, the merged
``last_info``, ``view_info``, versions and delta statistics equal too.  The
tolerance is none.  These are the ``n_shards`` cases of
``tests/test_stream.py`` (the 1k-update sweep, sharded view freshness,
schema growth), plus batches that straddle shard boundaries, a view whose
refresh gathers support tiles from two shards' deltas, appended rows in the
last shard, per-shard compaction and a stale sharded overlay.
"""
import numpy as np
import pytest

from _torch_port import gathered, same_answer, stream_pair, t_words, u32
from repro import query as RQ
from repro_torch import query as TQ
from repro_torch.core.bitmaps import unpack
from repro_torch.core.threshold import ALGORITHMS
from repro_torch.dist import ShardedBitmapIndex
from repro_torch.stream import OverlayStore

SPAN = 64 * 32


def _bits(n, r, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, r)) < density


def _t_for(alg, n):
    return {"wide_or": 1, "wide_and": n}.get(alg, 3)


def _oracle_words(bits, make):
    idx = TQ.BitmapIndex.from_dense(bits, [f"c{i}" for i in range(bits.shape[0])],
                                    device="cpu")
    return u32(idx.execute(make(TQ)))


def _same_state(ref, tor):
    assert tor.version == ref.version and tor.r == ref.r
    assert tor.delta_stats() == ref.delta_stats()
    assert tor.column_versions == ref.column_versions


def _both(ref, tor, fn):
    for s, M in ((ref, RQ), (tor, TQ)):
        fn(s, M)


def _boundary_bits(s):
    """Global bit offset of every shard boundary of a sharded stream."""
    return [w * 32 for w in s.index().store.word_offsets[1:]]


# ---------------------------------------------------------------------------
# test_stream.py:159 -- 1k random updates, every backend, pre/post compaction
# ---------------------------------------------------------------------------


def test_1k_random_updates_every_backend_matches_reference():
    n, r = 6, 8 * SPAN + 321
    bits = _bits(n, r, seed=11)
    ref, tor = stream_pair(bits, n_shards=4)
    assert tor.is_sharded and ref.is_sharded
    rng = np.random.default_rng(12)
    mut = bits.copy()
    cols = rng.integers(0, n, 1000)
    pos = rng.integers(0, r, 1000)
    on = rng.random(1000) < 0.5
    last = {(int(c), int(p)): bool(o) for c, p, o in zip(cols, pos, on)}
    sets, clears = {}, {}
    for (c, p), o in last.items():
        (sets if o else clears).setdefault(f"c{c}", []).append(p)
        mut[c, p] = o
    for s in (ref, tor):
        s.update(sets=sets, clears=clears)
    _same_state(ref, tor)

    def check(tag):
        for alg in ALGORITHMS:
            t = _t_for(alg, n)
            got = same_answer(ref, tor, lambda M: M.Threshold(t), backend=alg)
            assert np.array_equal(got, _oracle_words(mut, lambda M: M.Threshold(t))), (tag, alg)
        got = same_answer(ref, tor, lambda M: M.Threshold(3))
        assert tor.index().last_info["mode"] == "per_shard"
        assert tor.count(TQ.Threshold(3)) == ref.count(RQ.Threshold(3))
        assert np.array_equal(got, _oracle_words(mut, lambda M: M.Threshold(3)))

    check("pre-compaction")
    assert isinstance(tor.index(), ShardedBitmapIndex)
    assert any(isinstance(sh, OverlayStore) for sh in tor.index().store.shards)
    assert ref.compact() is True and tor.compact() is True
    _same_state(ref, tor)
    assert not any(isinstance(sh, OverlayStore) for sh in tor.index().store.shards)
    check("post-compaction")


# ---------------------------------------------------------------------------
# Batches across shard boundaries, appended rows, per-shard compaction
# ---------------------------------------------------------------------------


def test_batch_straddling_every_shard_boundary():
    n, r = 5, 9 * SPAN + 77
    bits = _bits(n, r, seed=31)
    ref, tor = stream_pair(bits, n_shards=4)
    mut = bits.copy()
    sets, clears = {}, {}
    for b in _boundary_bits(tor):
        for c in range(n):
            for p in (b - 2, b - 1, b, b + 1):
                (sets if (c + p) % 2 else clears).setdefault(f"c{c}", []).append(p)
                mut[c, p] = bool((c + p) % 2)
    for s in (ref, tor):
        s.update(sets=sets, clears=clears)
    _same_state(ref, tor)
    for make in (lambda M: M.Threshold(2), lambda M: M.Interval(1, 3),
                 lambda M: M.And(M.Col("c0"), M.Not(M.Col("c4")))):
        got = same_answer(ref, tor, make)
        assert np.array_equal(got, _oracle_words(mut, make))
    touched = tor.delta_stats()["patched_tiles"]
    assert touched == ref.delta_stats()["patched_tiles"] and touched >= 2 * 3 * n


def test_append_rows_extend_the_last_shard_and_compact_per_shard():
    n, r = 4, 6 * SPAN + 500
    bits = _bits(n, r, seed=33)
    ref, tor = stream_pair(bits, n_shards=3)
    app = _bits(n, SPAN + 40, density=0.5, seed=34)
    got_range = [s.append_rows(app) for s in (ref, tor)]
    assert got_range[0] == got_range[1] == (r, r + app.shape[1])
    mut = np.concatenate([bits, app], axis=1)
    for s in (ref, tor):
        s.set_bits("c1", [5, r + 3])
    mut[1, [5, r + 3]] = True
    _same_state(ref, tor)
    bounds = tor.index().store.tile_bounds
    assert bounds == ref.index().store.tile_bounds and bounds[:-1] == tuple(
        tor._base.store.tile_bounds[:-1])
    for make in (lambda M: M.Threshold(2), lambda M: M.Parity()):
        got = same_answer(ref, tor, make)
        assert np.array_equal(got, _oracle_words(mut, make))
    base_shards = tor._base.store.shards
    assert ref.compact() is True and tor.compact() is True
    # an untouched shard is carried over as it was: compaction is per shard
    assert tor._base.store.shards[1] is base_shards[1]
    _same_state(ref, tor)
    for rs, ts in zip(ref._base.store.shards, tor._base.store.shards):
        np.testing.assert_array_equal(ts.classes_word, rs.classes_word)
        np.testing.assert_array_equal(ts.container_kinds, rs.container_kinds)
        assert ts.cardinalities == rs.cardinalities
    got = same_answer(ref, tor, lambda M: M.Threshold(2))
    assert np.array_equal(got, _oracle_words(mut, lambda M: M.Threshold(2)))


def test_stale_sharded_overlay_is_a_consistent_snapshot():
    bits = _bits(4, 5 * SPAN + 99, seed=41)
    ref, tor = stream_pair(bits, n_shards=2)
    for s in (ref, tor):
        s.set_bits("c0", [7, 4 * SPAN + 1])
    stale_r, stale_t = ref.index(), tor.index()
    want = u32(gathered(stale_t.execute(TQ.Threshold(1))))
    for s in (ref, tor):
        s.clear_bits("c0", [7, 4 * SPAN + 1])
        s.set_bits("c1", [8])
    for alg in ("fused", "circuit", "tiled_fused", "scancount"):
        got = u32(gathered(stale_t.execute(TQ.Threshold(1), backend=alg)))
        assert np.array_equal(got, want), alg
        assert np.array_equal(got, np.asarray(stale_r.execute(RQ.Threshold(1), backend=alg).gather()))


# ---------------------------------------------------------------------------
# test_stream.py:362 -- sharded view freshness; refresh across two shards
# ---------------------------------------------------------------------------

VN, VR = 6, 6 * SPAN + 123


def _same_view(ref, tor, name, want=None):
    got = u32(tor.column(name))
    assert np.array_equal(got, u32(ref.column(name))), name
    assert tor.count(name) == ref.count(name)
    assert tor.view_info(name) == ref.view_info(name)
    _same_state(ref, tor)
    if want is not None:
        assert np.array_equal(unpack(tor.column(name), tor.r).numpy(), want)
        assert tor.count(name) == int(want.sum())


def test_sharded_view_freshness():
    bits = _bits(VN, VR, seed=27)
    ref, tor = stream_pair(bits, n_shards=3)
    _both(ref, tor, lambda s, M: s.materialize("mid", M.Interval(2, 4)))
    mut = bits.copy()
    rng = np.random.default_rng(28)
    pos = rng.integers(0, VR, 64)
    for s in (ref, tor):
        s.set_bits("c4", pos)
    mut[4, pos] = True
    counts = mut.sum(0)
    _same_view(ref, tor, "mid", (counts >= 2) & (counts <= 4))
    info = tor.view_info("mid")
    assert info["tiles_refreshed"] <= np.unique(pos // SPAN).size


def test_view_refresh_gathers_tiles_from_two_shards():
    """One batch touches the last tile of shard 0 and the first of shard 1:
    the refresh patches both shards' view columns, a view over the view
    follows, and compaction keeps both."""
    bits = _bits(VN, VR, seed=29)
    ref, tor = stream_pair(bits, n_shards=3)
    _both(ref, tor, lambda s, M: s.materialize("mid", M.Interval(2, 4)))
    _both(ref, tor, lambda s, M: s.materialize("hot", M.Or(M.Col("mid"), M.Col("c0"))))
    b = _boundary_bits(tor)[0]
    mut = bits.copy()
    for s in (ref, tor):
        s.update(sets={"c2": [b - 1, b], "c3": [b - 5, b + 9]}, clears={"c1": [b - 1, b]})
    mut[2, [b - 1, b]] = True
    mut[3, [b - 5, b + 9]] = True
    mut[1, [b - 1, b]] = False
    counts = mut.sum(0)
    mid = (counts >= 2) & (counts <= 4)
    _same_view(ref, tor, "mid", mid)
    assert tor.view_info("mid")["tiles_refreshed"] == 2
    _same_view(ref, tor, "hot", mid | mut[0])
    assert ref.compact() is True and tor.compact() is True
    _same_view(ref, tor, "mid", mid)
    _same_view(ref, tor, "hot", mid | mut[0])


# ---------------------------------------------------------------------------
# test_stream.py:431 -- schema growth on a sharded base
# ---------------------------------------------------------------------------


def test_add_data_column_then_mutate_sharded():
    bits = _bits(4, 2 * SPAN + 100, seed=17)
    ref, tor = stream_pair(bits, n_shards=3)
    for s in (ref, tor):
        assert "c9" not in s
        s.add_data_column("c9")
        assert "c9" in s
    assert tor.count(TQ.Col("c9")) == ref.count(RQ.Col("c9")) == 0
    rows = [0, SPAN + 5, tor.r - 1]
    for s in (ref, tor):
        s.update(sets={"c9": rows})
    got = same_answer(ref, tor, lambda M: M.Col("c9"))
    assert unpack(t_words(got), tor.r).numpy().nonzero()[0].tolist() == rows
    oracle = np.concatenate([bits, np.zeros((1, bits.shape[1]), bool)])
    oracle[4, rows] = True
    got = same_answer(ref, tor, lambda M: M.Threshold(2, over=[M.Col("c0"), M.Col("c1"), M.Col("c9")]))
    want = _oracle_words(oracle, lambda M: M.Threshold(2, over=[M.Col("c0"), M.Col("c1"), M.Col("c4")]))
    assert np.array_equal(got, want)
    _same_state(ref, tor)


@pytest.mark.parametrize("n_shards", [1, 2, 5])
def test_mutation_kinds_at_shard_counts(n_shards):
    """Set, clear and set-then-clear at 1, 2 and 5 shards (the last holding
    the partial final tile), before and after compaction."""
    n, r = 5, 5 * SPAN + 517
    bits = _bits(n, r, seed=50 + n_shards)
    ref, tor = stream_pair(bits, n_shards=n_shards)
    mut = bits.copy()
    pos = [0, 31, 32, SPAN - 1, SPAN, 3 * SPAN + 7, r - 17, r - 1]
    for s in (ref, tor):
        s.set_bits("c1", pos)
        s.clear_bits("c2", np.arange(100, r, 97))
        s.set_bits("c0", [5, 2 * SPAN + 3])
        s.clear_bits("c0", [5, 2 * SPAN + 3])
    mut[1, pos] = True
    mut[2, np.arange(100, r, 97)] = False
    mut[0, [5, 2 * SPAN + 3]] = False
    for tag in ("overlay", "compacted"):
        _same_state(ref, tor)
        for make in (lambda M: M.Threshold(2), lambda M: M.Interval(1, 3)):
            got = same_answer(ref, tor, make)
            assert np.array_equal(got, _oracle_words(mut, make)), tag
        if tag == "overlay":
            assert ref.compact() is True and tor.compact() is True
