"""storage.TileStore statistics and core.planner plans of the port against
the reference: same bits in, every statistic and every plan equal."""
import dataclasses
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import clean_fraction_bits, container_mix_bits, u32
from repro.core import planner as RP
from repro.query import BitmapIndex as RIndex
from repro.query import expr as RE
from repro.storage import TileStore as RStore
from repro.storage import containers as RCont
from repro_torch.core import calibration as TCal
from repro_torch.core import planner as TP
from repro_torch.query import BitmapIndex as TIndex
from repro_torch.query import expr as TE
from repro_torch.storage import TileStore as TStore
from repro_torch.storage import containers as TCont

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


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("slots", [None, (0,), (1, 4, 7), (8, 2, 5, 3)])
def test_member_stats_equal_reference(name, slots):
    _bits, ref, tor = stores(name)
    a, b = tor.member_stats(slots), ref.member_stats(slots)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tor.member_stats(slots) is a  # cached per subset


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
