"""storage.TileStore statistics and core.planner plans of the port against
the reference: same bits in, every statistic and every plan equal."""
import dataclasses
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TILE_BITS, clean_fraction_bits, container_mix_bits, u32
from repro import persist as RPersist
from repro.core import planner as RP
from repro.query import BitmapIndex as RIndex
from repro.query import expr as RE
from repro.storage import TileStore as RStore
from repro.storage import containers as RCont
from repro_torch import obs
from repro_torch import persist as TPersist
from repro_torch.core import calibration as TCal
from repro_torch.core import planner as TP
from repro_torch.query import BitmapIndex as TIndex
from repro_torch.query import expr as TE
from repro_torch.storage import TileStore as TStore
from repro_torch.storage import containers as TCont
from repro_torch.storage import tilestore as TTile

FIXTURES = {
    "cf0.0": lambda: clean_fraction_bits(10, 0.0, seed=2),
    "cf0.5": lambda: clean_fraction_bits(10, 0.5, seed=7),
    "cf0.95": lambda: clean_fraction_bits(10, 0.95, seed=11),
    "mix": lambda: container_mix_bits(9, seed=5),
}


def stores(name, **kw):
    bits = FIXTURES[name]()
    return bits, RStore.from_dense(jnp.asarray(bits), **kw), TStore.from_dense(bits, device="cpu", **kw)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_classification_and_statistics_equal_reference(name):
    bits, ref, tor = stores(name)
    assert (tor.n, tor.n_words, tor.r, tor.n_tiles, tor.tile_words) == \
        (ref.n, ref.n_words, ref.r, ref.n_tiles, ref.tile_words)
    assert np.array_equal(tor.classes_word, ref.classes_word)
    assert np.array_equal(tor.classes, ref.classes)
    assert np.array_equal(tor.container_kinds, ref.container_kinds)
    assert np.array_equal(tor.storage_words_cell, ref.storage_words_cell)
    assert np.array_equal(tor.dirty_index, ref.dirty_index)
    assert tor.cardinalities == ref.cardinalities == tuple(int(x) for x in bits.sum(1))
    assert tor.densities == ref.densities
    assert tor.runcounts == ref.runcounts
    assert [dataclasses.astuple(s) for s in tor.col_stats] == \
        [dataclasses.astuple(s) for s in ref.col_stats]
    assert tor.clean_fraction == ref.clean_fraction
    assert tor.dirty_words == ref.dirty_words
    assert tor.storage_words() == ref.storage_words()
    assert tor.container_census() == ref.container_census()
    assert tor.container_census(slots=[0, 3]) == ref.container_census(slots=[0, 3])
    dense = tor.densify()
    assert dense.dtype == torch.int32 and np.array_equal(u32(dense), np.asarray(ref.densify()))
    assert np.array_equal(u32(tor.column(2)), np.asarray(ref.column(2)))


def member_kinds_bits(seed=3, n_tiles=5, tail_bits=700):
    """Ten columns over five full tiles and a partial one: 0-2 dirty in every
    tile, 3-5 and 9 clean in some tiles, 6-8 clean in every tile (all zero;
    ones in full tiles only; zero and one tiles in turn)."""
    rng = np.random.default_rng(seed)
    r = n_tiles * TILE_BITS + tail_bits
    bits = rng.random((10, r)) < 0.35
    bits[6:9] = False
    for tj in range(n_tiles):
        lo, hi = tj * TILE_BITS, (tj + 1) * TILE_BITS
        bits[7, lo:hi] = True
        bits[8, lo:hi] = tj % 2 == 1
        for i, clean in ((3, tj in (1, 4)), (4, tj == 2), (5, tj in (0, 2)), (9, tj == 3)):
            if clean:
                bits[i, lo:hi] = (i + tj) % 2 == 1
    bits[4, 5 * TILE_BITS:] = False  # a clean partial final tile
    return bits


def _kinds_pair(**kw):
    bits = member_kinds_bits()
    return RStore.from_dense(jnp.asarray(bits), **kw), TStore.from_dense(bits, device="cpu", **kw)


def _updated_pair():
    """Tile updates that clean a dirty tile, dirty a clean one and grow the
    universe by whole zero tiles and a partial one."""
    ref, tor = _kinds_pair()
    rng = np.random.default_rng(4)
    updates = {
        0: {1: np.zeros(64, np.uint32), 3: np.full(64, 0xFFFFFFFF, np.uint32)},
        6: {2: rng.integers(0, 2**32, 64, dtype=np.uint32)},
        3: {1: rng.integers(0, 2**32, 64, dtype=np.uint32)},
    }
    r = tor.r + 2 * TILE_BITS + 100
    return ref.apply_tile_updates(updates, r=r), tor.apply_tile_updates(updates, r=r)


def _concat_pair():
    ref, tor = _kinds_pair()
    cut = [(0, 2), (2, tor.n_tiles)]
    return (RStore.concat_tiles([ref.slice_tiles(*c) for c in cut]),
            TStore.concat_tiles([tor.slice_tiles(*c) for c in cut]))


def _loaded_pair(tmp):
    ref, tor = _kinds_pair()
    RPersist.snapshot.save(ref, tmp / "ref.bmsnap")
    TPersist.snapshot.save(tor, tmp / "tor.bmsnap")
    return (RPersist.snapshot.load(tmp / "ref.bmsnap"),
            TPersist.snapshot.load(tmp / "tor.bmsnap", device="cpu"))


#: stores whose member statistics are held to the reference's and to the
#: full signature pass: the parity fixtures, then every way a store is made
MEMBER_STORES = {
    **{name: (lambda name=name: stores(name)[1:]) for name in FIXTURES},
    "kinds": _kinds_pair,
    "kinds-tw16": lambda: _kinds_pair(tile_words=16),
    "kinds-tw128": lambda: _kinds_pair(tile_words=128),
    "kinds-nocont": lambda: _kinds_pair(containers=False),
    "kinds-updated": _updated_pair,
    "kinds-retiled": lambda: tuple(s.with_tile_words(16) for s in _kinds_pair()),
    "kinds-concat": _concat_pair,
    "kinds-loaded": _loaded_pair,
}
_BUILT: dict = {}


def member_stores(name, tmp_path_factory):
    if name not in _BUILT:
        build = MEMBER_STORES[name]
        _BUILT[name] = build(tmp_path_factory.mktemp(name)) if name == "kinds-loaded" else build()
    return _BUILT[name]


def plain_member_stats(store, slots):
    """The full signature pass over every tile of the subset: the planner's
    statistics as the reference computes them."""
    idx = np.arange(store.n) if slots is None else np.asarray(list(slots))
    if idx.size == 0:
        return TTile.MemberStats(0, store.n_words, store.tile_words, 1.0, 0.0, 0, 0)
    cls = store.classes_word[idx]
    dirty_tiles = int((cls >= TTile.TILE_DIRTY).sum())
    sigs, counts = TTile._signature_counts(cls)
    kinds = store.container_kinds[idx]
    return TTile.MemberStats(
        n=int(idx.size),
        n_words=store.n_words,
        tile_words=store.tile_words,
        clean_fraction=1.0 - dirty_tiles / max(cls.size, 1),
        density=float(np.mean([store.cardinalities[i] / max(store.r, 1) for i in idx])),
        dirty_words=dirty_tiles * store.tile_words,
        case3_tiles=int(((cls >= TTile.TILE_DIRTY).any(axis=0)).sum()),
        signatures=tuple(
            (int(cnt), int((sig == TTile.TILE_ONE).sum()), int((sig >= TTile.TILE_DIRTY).sum()))
            for sig, cnt in zip(sigs, counts)
        ),
        container_tiles=tuple(int((kinds == k).sum()) for k in (
            TCont.CONT_DENSE, TCont.CONT_SPARSE, TCont.CONT_RUN)),
        compressed_words=int(store.storage_words_cell[idx].sum()),
    )


#: subsets: every column, one column, two mixed sets, then (on ``kinds``) all
#: dirty, dirty and partly clean members, all clean, permuted with repeats,
#: and empty
MEMBER_SLOTS = [None, (0,), (1, 4, 7), (8, 2, 5, 3),
                (0, 1, 2), (0, 4, 5), (6, 7, 8), (5, 3, 5, 0, 3), ()]


@pytest.mark.parametrize("name", list(MEMBER_STORES))
@pytest.mark.parametrize("slots", MEMBER_SLOTS)
def test_member_stats_equal_reference(name, slots, tmp_path_factory):
    ref, tor = member_stores(name, tmp_path_factory)
    a, b = tor.member_stats(slots), ref.member_stats(slots)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a) == dataclasses.asdict(plain_member_stats(tor, slots))
    assert tor.member_stats(slots) is a  # cached per subset


def _stats_counters() -> tuple:
    snap = obs.REGISTRY.snapshot()
    tiles = snap["repro_plan_stats_tiles_scanned_total"]["samples"]
    passes = snap["repro_plan_stats_total"]["samples"]
    return (sum(tiles.values()), passes.get("summary", 0), passes.get("scan", 0))


def test_member_stats_counters_count_the_tiles_scanned():
    """A subset of dirty columns is answered from the summaries alone; a
    subset with clean tiles scans the union of its members' clean tiles;
    a cache hit counts nothing."""
    _ref, tor = _kinds_pair()
    mixed = (0, 4, 5)
    union = int((tor.classes_word[list(mixed)] <= TTile.TILE_ONE).any(axis=0).sum())
    assert 0 < union < tor.n_tiles
    obs.disable()
    obs.reset()
    obs.enable()
    try:
        tor.member_stats((2, 0, 1))
        assert _stats_counters() == (0, 1, 0)
        tor.member_stats(mixed)
        assert _stats_counters() == (union, 1, 1)
        tor.member_stats((2, 0, 1))
        tor.member_stats(mixed)
        assert _stats_counters() == (union, 1, 1)
    finally:
        obs.disable()
        obs.reset()


def test_containers_off_and_other_tile_sizes():
    for kw in ({"containers": False}, {"tile_words": 16}, {"tile_words": 128}):
        _bits, ref, tor = stores("mix", **kw)
        assert np.array_equal(tor.container_kinds, ref.container_kinds)
        assert dataclasses.asdict(tor.member_stats(None)) == dataclasses.asdict(ref.member_stats(None))
    _bits, ref, tor = stores("mix")
    t2, r2 = tor.with_tile_words(32), ref.with_tile_words(32)
    assert np.array_equal(t2.classes_word, r2.classes_word)
    assert tor.with_tile_words(64) is tor


def test_container_codecs_equal_reference():
    bits = container_mix_bits(4, seed=9)
    tiles = np.asarray(RStore.from_dense(jnp.asarray(bits))._dirty_np)
    got = TCont.compress_tiles(tiles, 64)
    want = RCont.compress_tiles(tiles, 64)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    kinds, dense, spos, soff, runs, roff = got
    assert np.array_equal(TCont.words_from_sparse(spos, soff, 64), tiles[kinds == TCont.CONT_SPARSE])
    assert np.array_equal(TCont.words_from_runs(runs, roff, 64), tiles[kinds == TCont.CONT_RUN])
    assert TCont.sparse_max_positions(64) == RCont.sparse_max_positions(64)
    assert TCont.run_max_intervals(64) == RCont.run_max_intervals(64)
    assert np.array_equal(TCont.concat_ranges(np.array([3, 10]), np.array([5, 14])),
                          RCont.concat_ranges(np.array([3, 10]), np.array([5, 14])))


def test_append_replace_return_new_stores():
    bits, ref, tor = stores("cf0.5")
    row = np.asarray(ref.column(3)) ^ np.uint32(0x80000001)
    t2, r2 = tor.append(row), ref.append(jnp.asarray(row))
    assert t2.n == tor.n + 1 and np.array_equal(u32(t2.densify()), np.asarray(r2.densify()))
    assert np.array_equal(t2.classes_word, r2.classes_word)
    t3, r3 = tor.replace(1, row), ref.replace(1, jnp.asarray(row))
    assert np.array_equal(u32(t3.densify()), np.asarray(r3.densify()))
    assert dataclasses.asdict(t3.member_stats(None)) == dataclasses.asdict(r3.member_stats(None))
    # the old store is untouched, hashable by identity and weak-referenceable
    assert np.array_equal(u32(tor.densify()), np.asarray(ref.densify()))
    assert weakref.ref(tor)() is tor and hash(tor) == hash(tor) and tor != t3
    with pytest.raises(ValueError):
        tor.append(row[:-1])


def test_densify_rebuilds_from_tiles_when_no_tensor_is_kept():
    bits, ref, tor = stores("mix")
    rebuilt = TStore(list(tor._cols), tile_words=tor.tile_words, n_words=tor.n_words, r=tor.r,
                     device="cpu")
    assert np.array_equal(u32(rebuilt.densify()), np.asarray(ref.densify()))


def _queries(E, names):
    return [
        E.Interval(2, 6), E.Threshold(1), E.Threshold(2), E.Threshold(5), E.Threshold(len(names)),
        E.Threshold(len(names) + 3), E.Threshold(0), E.Parity(), E.Majority(), E.Exactly(3),
        E.Col(names[1]), E.Threshold(2, over=names[:4]), E.Threshold(3, over=(names[0], names[5], names[7])),
        E.Weighted(tuple(range(1, len(names) + 1)), 9),
        (E.Threshold(2, over=names[:4]) & ~E.Col(names[4])) | E.Parity(over=names[5:8]),
        E.Interval(1, 3) - E.Col(names[0]),
    ]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_explain_equals_reference(name):
    bits = FIXTURES[name]()
    names = [f"s{i}" for i in range(bits.shape[0])]
    ref = RIndex.from_dense(jnp.asarray(bits), names=names)
    tor = TIndex.from_dense(bits, names=names, device="cpu")
    seen = set()
    for rq, tq in zip(_queries(RE, names), _queries(TE, names)):
        assert tq.key() == rq.key() and TE.canonical_key(tq) == RE.canonical_key(rq)
        a, b = tor.explain(tq), ref.explain(rq)
        assert (a.algorithm, a.cost, a.candidates, a.cost_us, a.candidates_us) == \
            (b.algorithm, b.cost, b.candidates, b.cost_us, b.candidates_us), (name, tq)
        assert tor.explain(tq, memo=False).algorithm == a.algorithm
        assert tor.explain(tq).memo == "hit"
        seen.add(a.algorithm)
    if name == "cf0.95":
        assert "tiled_fused" in seen
    st_t, st_r = tor.stats(), ref.stats()
    assert dataclasses.asdict(st_t) == dataclasses.asdict(st_r)


@pytest.mark.parametrize("n,t,kw", [
    (16, 1, {}), (16, 16, {}), (16, 8, {"clean_fraction": 0.9}), (4096, 100, {}),
    (16, 15, {"density": 1e-4, "on_device": False}), (16, 2, {}), (16, 8, {}),
    (16, 8, {"fused_available": False}),
])
def test_scalar_rule_plans_equal_reference(n, t, kw):
    a, b = TP.plan_threshold(n, t, **kw), RP.plan_threshold(n, t, **kw)
    assert (a.algorithm, a.cost, a.candidates) == (b.algorithm, b.cost, b.candidates)
    for backend in ("fused", "ssum", "looped", "wide_or", "scancount_streaming", "dsk", "tiled_fused"):
        assert TP.estimate_words_touched(backend, n, t, n_words=100, density=0.01) == \
            RP.estimate_words_touched(backend, n, t, n_words=100, density=0.01)


def test_calibration_prices_plans_and_names_the_device():
    bits = FIXTURES["cf0.0"]()
    tor = TIndex.from_dense(bits, device="cpu")
    try:
        TCal.set_calibration(TCal.Calibration.identity())
        p = tor.explain(TE.Threshold(4), memo=False)
        assert p.cost_us is not None and p.candidates_us
    finally:
        TCal.clear_calibration()
    assert tor.explain(TE.Threshold(4), memo=False).cost_us is None
    assert TCal.device_signature("cpu") == "cpux1"
    stale = TCal.Calibration(device="tpux8", us_per_kword={"fused": 1.0})
    assert stale.is_stale(TCal.device_signature("cpu"))
