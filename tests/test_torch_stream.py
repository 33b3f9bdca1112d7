"""The port's streaming engine (``repro_torch.stream``) against the reference.

The same numpy-seeded bits and the same mutation batches go to a reference
``StreamingIndex`` and to the port's (``device="cpu"``); every answer is
held equal word for word (``np.array_equal`` on ``uint32``), with the plan,
``last_info``, versions and exception types equal too.  The tolerance is
none.  These are the unsharded cases of ``tests/test_stream.py``; the
views, schema growth and the overlay's own surfaces are in
``tests/test_torch_stream_views.py``.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from _torch_port import same_answer, stream_pair, u32
from repro import query as RQ
from repro.core.threshold import ALGORITHMS as R_ALGORITHMS
from repro.stream import DeltaStore as RDelta
from repro_torch import query as TQ
from repro_torch.core.bitmaps import unpack
from repro_torch.core.threshold import ALGORITHMS
from repro_torch.stream import DeltaStore as TDelta

SPAN = 64 * 32  # bits per tile at the default granularity


def _bits(n, r, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, r)) < density


QUERIES = {
    "threshold_2": lambda M: M.Threshold(2),
    "interval_1_3": lambda M: M.Interval(1, 3),
    "and_not": lambda M: M.And(M.Threshold(1), M.Not(M.Col("c0"))),
}


def _parity(ref, tor, oracle_bits=None):
    for make in QUERIES.values():
        got = same_answer(ref, tor, make)
        if oracle_bits is not None:
            assert np.array_equal(got, u32(_oracle_words(oracle_bits, make)))
    assert tor.version == ref.version
    assert tor.r == ref.r and tor.delta_words == ref.delta_words
    assert tor.delta_stats() == ref.delta_stats()


def _oracle_words(bits, make):
    """The query over a port BitmapIndex rebuilt from the mutated bits."""
    idx = TQ.BitmapIndex.from_dense(bits, [f"c{i}" for i in range(bits.shape[0])],
                                    device="cpu")
    return idx.execute(make(TQ))


# ---------------------------------------------------------------------------
# Update semantics, per mutation kind
# ---------------------------------------------------------------------------

N, R = 5, 4 * SPAN + 517  # partial final tile by construction


def _set_bits(s, mut):
    pos = [0, 31, 32, SPAN - 1, SPAN, R - 1]
    s.set_bits("c1", pos)
    mut[1, pos] = True


def _clear_bits(s, mut):
    pos = np.arange(100, 4000, 7)
    s.clear_bits("c2", pos)
    mut[2, pos] = False


def _set_then_clear(s, mut):
    pos = [5, 77, SPAN + 3, 3 * SPAN + 100]
    for _ in range(2):
        s.set_bits("c0", pos)
        s.clear_bits("c0", pos)
    mut[0, pos] = False


def _partial_final_tile(s, mut):
    s.set_bits("c4", [R - 1, R - 17])
    mut[4, [R - 1, R - 17]] = True


MUTATIONS = {
    "set_bits": _set_bits,
    "clear_bits": _clear_bits,
    "set_then_clear": _set_then_clear,
    "partial_final_tile": _partial_final_tile,
}


@pytest.mark.parametrize("kind", sorted(MUTATIONS))
def test_mutation_kind_matches_reference_and_rebuild(kind):
    bits = _bits(N, R, seed=sorted(MUTATIONS).index(kind) + 1)
    ref, tor = stream_pair(bits)
    mut = bits.copy()
    for s in (ref, tor):
        MUTATIONS[kind](s, mut)
    _parity(ref, tor, mut)


def test_update_inside_all_zero_and_all_one_tile():
    bits = _bits(N, R, seed=4)
    bits[3, :SPAN] = False
    bits[3, SPAN:2 * SPAN] = True
    ref, tor = stream_pair(bits)
    for s in (ref, tor):
        s.set_bits("c3", [10])
        s.clear_bits("c3", [SPAN + 10])
    mut = bits.copy()
    mut[3, 10] = True
    mut[3, SPAN + 10] = False
    _parity(ref, tor, mut)
    for s in (ref, tor):
        s.clear_bits("c3", [10])
        s.set_bits("c3", [SPAN + 10])
    _parity(ref, tor, bits)


def test_position_outside_the_universe_raises_the_same():
    ref, tor = stream_pair(_bits(N, R, seed=7))
    errors = []
    for s in (ref, tor):
        with pytest.raises(ValueError) as e:
            s.set_bits("c4", [R])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    for s in (ref, tor):
        with pytest.raises(KeyError):
            s.set_bits("nope", [0])


def test_append_rows_crossing_tile_boundary():
    bits = _bits(N, R, seed=5)
    ref, tor = stream_pair(bits)
    k = (SPAN - R % SPAN) + SPAN // 2
    app = _bits(N, k, density=0.4, seed=6)
    assert ref.append_rows(app) == tor.append_rows(app) == (R, R + k)
    assert tor.r == R + k
    _parity(ref, tor, np.concatenate([bits, app], axis=1))


def test_compaction_is_tile_granular_and_matches_reference():
    bits = _bits(N, R, seed=8)
    ref, tor = stream_pair(bits)
    for s in (ref, tor):
        s.set_bits("c0", [3, SPAN + 3])
    mut = bits.copy()
    mut[0, [3, SPAN + 3]] = True
    before = same_answer(ref, tor, QUERIES["threshold_2"])
    base_store = tor._base.store
    assert ref.compact() is True and tor.compact() is True
    assert tor._base.store._cols[1] is base_store._cols[1]
    assert tor.delta_words == 0 and tor.compactions == ref.compactions == 1
    assert np.array_equal(same_answer(ref, tor, QUERIES["threshold_2"]), before)
    rs, ts = ref._base.store, tor._base.store
    for name in ("classes_word", "container_kinds", "storage_words_cell"):
        assert np.array_equal(getattr(ts, name), getattr(rs, name)), name
    assert ts.cardinalities == rs.cardinalities
    for key, arr in rs.packs.items():
        assert np.array_equal(ts.packs[key], arr), key
    _parity(ref, tor, mut)
    assert ref.compact() is False and tor.compact() is False


# ---------------------------------------------------------------------------
# 1k random single-bit updates, every backend, pre/post compaction
# ---------------------------------------------------------------------------


def _t_for(alg, n):
    return {"wide_or": 1, "wide_and": n}.get(alg, 3)


def test_1k_random_updates_every_backend_matches_reference():
    assert ALGORITHMS == R_ALGORITHMS
    n, r = 6, 8 * SPAN + 321
    bits = _bits(n, r, seed=11)
    ref, tor = stream_pair(bits)
    rng = np.random.default_rng(12)
    mut = bits.copy()
    cols = rng.integers(0, n, 1000)
    pos = rng.integers(0, r, 1000)
    on = rng.random(1000) < 0.5
    last = {(int(c), int(p)): bool(o) for c, p, o in zip(cols, pos, on)}
    sets: dict = {}
    clears: dict = {}
    for (c, p), o in last.items():
        (sets if o else clears).setdefault(f"c{c}", []).append(p)
        mut[c, p] = o
    for s in (ref, tor):
        s.update(sets=sets, clears=clears)

    def check(tag):
        for alg in ALGORITHMS:
            t = _t_for(alg, n)
            got = same_answer(ref, tor, lambda M: M.Threshold(t), backend=alg)
            want = mut.sum(0) >= t
            assert np.array_equal(unpack(torch.from_numpy(got.view(np.int32)), r).numpy(),
                                  want), (tag, alg)

    check("pre-compaction")
    assert ref.compact() is True and tor.compact() is True
    check("post-compaction")


def test_stale_overlay_index_is_a_consistent_snapshot():
    bits = _bits(4, 3 * SPAN + 99, seed=41)
    ref, tor = stream_pair(bits)
    for s in (ref, tor):
        s.set_bits("c0", [7])
    stale_r, stale_t = ref.index(), tor.index()
    for s in (ref, tor):
        s.clear_bits("c1", np.arange(0, 2000))
    mut_then = bits.copy()
    mut_then[0, 7] = True
    for backend in ("fused", "tiled_fused", "ssum", "scancount"):
        got = same_answer(stale_r, stale_t, lambda M: M.Threshold(2), backend=backend)
        assert np.array_equal(got, u32(_oracle_words(mut_then, lambda M: M.Threshold(2))))
    assert stale_t.store.cardinalities == stale_r.store.cardinalities


def test_overlay_planner_sees_mutated_stats():
    bits = np.zeros((4, 8 * SPAN), bool)
    bits[:, :7] = True
    ref, tor = stream_pair(bits)
    clean = tor.index().store.member_stats(None)
    assert asdict(clean) == asdict(ref.index().store.member_stats(None))
    rng = np.random.default_rng(0)
    for c in range(4):
        pos = rng.integers(0, 8 * SPAN, 2000)
        for s in (ref, tor):
            s.set_bits(f"c{c}", pos)
    dirty = tor.index().store.member_stats(None)
    assert asdict(dirty) == asdict(ref.index().store.member_stats(None))
    assert dirty.clean_fraction < clean.clean_fraction
    assert dirty.dirty_words > clean.dirty_words
    rp, tp = ref.explain(RQ.Threshold(2)), tor.explain(TQ.Threshold(2))
    assert (tp.algorithm, tp.cost, tp.candidates) == (rp.algorithm, rp.cost, rp.candidates)
    same_answer(ref, tor, lambda M: M.Threshold(2))


# ---------------------------------------------------------------------------
# Compaction policy, DeltaStore unit behaviour, subscribers
# ---------------------------------------------------------------------------


def test_auto_compaction_policy_triggers_like_the_reference():
    bits = _bits(4, 8 * SPAN, density=0.01, seed=31)
    ref, tor = stream_pair(bits, policy={"min_delta_words": 2 * 64, "max_delta_ratio": 0.0})
    for s in (ref, tor):
        s.set_bits("c0", [0])
    assert tor.compactions == ref.compactions == 0 and tor.delta_words > 0
    for s in (ref, tor):
        s.set_bits("c1", [0, SPAN, 2 * SPAN])
    assert tor.compactions == ref.compactions == 1
    assert tor.delta_words == ref.delta_words == 0
    assert tor.version == ref.version
    _parity(ref, tor)


def test_default_policy_versions_and_subscribers_match():
    bits = _bits(5, 6 * SPAN + 11, density=0.05, seed=33)
    ref, tor = stream_pair(bits, policy={})
    seen = {"r": [], "t": []}
    ref.subscribe(lambda v, names: seen["r"].append((v, sorted(names))))
    tor.subscribe(lambda v, names: seen["t"].append((v, sorted(names))))
    rng = np.random.default_rng(34)
    for _ in range(4):
        pos = rng.integers(0, bits.shape[1], 300)
        for s in (ref, tor):
            s.update(sets={"c1": pos[:150]}, clears={"c3": pos[150:]})
    assert seen["t"] == seen["r"] and seen["t"]
    assert tor.compactions == ref.compactions
    assert tor.column_versions == ref.column_versions
    _parity(ref, tor)


def test_delta_store_patch_and_popcount_delta():
    bits = np.zeros((2, 2 * SPAN), bool)
    bits[1, :SPAN] = True
    rd = RDelta(RQ.BitmapIndex.from_dense(bits, ["a", "b"]).store)
    td = TDelta(TQ.BitmapIndex.from_dense(bits, ["a", "b"], device="cpu").store)
    words = np.zeros(64, np.uint32)
    words[0] = 0b1
    for d in (rd, td):
        assert d.empty
        assert d.set_bits(0, [3, 35]) == [0] and not d.empty
        assert d.card_delta(0) == 2
        assert d.patch_tile(0, 0, words) == -1
        assert d.card_delta(0) == 1
        d.clear_bits(1, [7])
        assert d.card_delta(1) == -1
        assert d.delta_words == 2 * 64
    for (rc, rt), (tc, tt) in zip(sorted(rd.updates().items()), sorted(td.updates().items())):
        assert rc == tc and sorted(rt) == sorted(tt)
        for t in rt:
            assert np.array_equal(tt[t], rt[t])


def test_delta_apply_batch_matches_reference():
    rng = np.random.default_rng(36)
    bits = _bits(4, 5 * SPAN + 77, seed=35)
    rd = RDelta(RQ.BitmapIndex.from_dense(bits, [f"c{i}" for i in range(4)]).store)
    td = TDelta(TQ.BitmapIndex.from_dense(bits, [f"c{i}" for i in range(4)], device="cpu").store)
    for _ in range(3):
        cols = rng.integers(0, 4, 500)
        pos = rng.integers(0, bits.shape[1], 500)
        on = rng.random(500) < 0.5
        assert td.apply_batch(cols, pos, on) == rd.apply_batch(cols, pos, on)
    app = rng.random((4, 900)) < 0.3
    assert td.append_rows(app) == rd.append_rows(app)
    rs, ts = rd.snapshot(), td.snapshot()
    assert sorted(rs) == sorted(ts)
    for c in rs:
        assert sorted(rs[c]) == sorted(ts[c])
        for t in rs[c]:
            assert np.array_equal(ts[c][t], rs[c][t])
    for d in (rd, td):
        with pytest.raises(ValueError):
            d.apply_batch([0, 1], [0], [True])
        with pytest.raises(ValueError):
            d.apply_batch([9], [0], [True])
