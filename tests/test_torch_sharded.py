"""The port's row-sharded engine (``repro_torch.dist``) against the reference.

The same numpy-seeded bits go to a reference ``ShardedBitmapIndex`` and to
the port's (``device="cpu"``); every result is gathered and held equal word
for word (``np.array_equal`` on ``uint32``), with the per-shard plans and
the merged ``last_info`` equal too.  The tolerance is none.  These are the
cases of ``tests/test_sharded.py`` (less the model-serving one), the slice
and sharded-container cases of ``tests/test_storage.py`` and
``tests/test_containers_fuzz.py``, and the sharded cases of
``tests/test_obs.py``.  The reference's mesh cases become the port's
``devices=["cpu"] * 8`` (the shard-map path, one plain-version K1 call per
piece), held against the unsharded reference in process.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as robs
import repro_torch.obs as obs
from _torch_port import TILE_BITS, container_mix_bits, reference_view, t_words, u32
from repro import query as RQ
from repro.core.threshold import ALGORITHMS as R_ALGORITHMS
from repro.dist.query import shard_boundaries as r_shard_boundaries
from repro.storage import TileStore as RTileStore
from repro_torch import query as TQ
from repro_torch.core.bitmaps import unpack
from repro_torch.core.threshold import ALGORITHMS
from repro_torch.dist import ShardedBitmapIndex, ShardedResult, shard_boundaries
from repro_torch.query.execinfo import EXEC_INFO_SCHEMA
from repro_torch.storage import TileStore

N_SHARDS = 8
TILES_PER_SHARD = 2


def _names(n):
    return [f"c{i}" for i in range(n)]


def _mixed_bits(n=10, seed=0, tail_bits=700):
    """The reference's ``tests/test_sharded.py::_mixed_bits``: 8 shards of
    about 2 tiles and a partial final tile; shard 0 all zero, shards 1-3
    clean-heavy, shards 4-7 dense."""
    rng = np.random.default_rng(seed)
    n_tiles = N_SHARDS * TILES_PER_SHARD
    r = n_tiles * TILE_BITS + tail_bits
    total_tiles = n_tiles + 1
    bounds = shard_boundaries(total_tiles, N_SHARDS)
    shard_of = {tj: s for s, (t0, t1) in enumerate(bounds) for tj in range(t0, t1)}
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for tj in range(total_tiles):
            lo, hi = tj * TILE_BITS, min((tj + 1) * TILE_BITS, r)
            shard = shard_of[tj]
            if shard == 0:
                continue
            if shard < 4:
                u = rng.random()
                if u < 0.5:
                    pass
                elif u < 0.95:
                    bits[i, lo:hi] = True
                else:
                    bits[i, lo:hi] = rng.random(hi - lo) < 0.35
            else:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.35
    return bits


def _pair(bits, **kw):
    names = _names(bits.shape[0])
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits), names, **kw)
    tor = TQ.BitmapIndex.from_dense(bits, names, device="cpu", **kw)
    return ref, tor


@pytest.fixture(scope="module")
def mixed():
    bits = _mixed_bits()
    ref, tor = _pair(bits)
    return bits, ref, ref.shard(n_shards=N_SHARDS), tor, tor.shard(n_shards=N_SHARDS)


def _same_plans(rp, tp):
    assert tp.backends == rp.backends
    assert [(p.cost, p.candidates) for p in tp.plans] == [
        (p.cost, p.candidates) for p in rp.plans
    ]


def _same(rs, ts, make, **kw) -> np.ndarray:
    """Execute ``make(module)`` on a reference and a port sharded index;
    hold the gathered words, ``last_info`` and (planner-routed) the
    per-shard plans equal.  Returns the words."""
    rq, tq = make(RQ), make(TQ)
    res = ts.execute(tq, **kw)
    assert isinstance(res, ShardedResult) and len(res.shards) == ts.n_shards
    got = u32(res.gather())
    want = np.asarray(rs.execute(rq, **kw).gather())
    assert np.array_equal(got, want), (rq, kw)
    assert ts.last_info == rs.last_info, (rq, kw)
    if "backend" not in kw:
        _same_plans(rs.plan(rq), ts.plan(tq))
    return got


def _t_for(alg, n):
    return {"wide_or": 1, "wide_and": n, "sopckt": 2}.get(alg, 4)


# ---------------------------------------------------------------------------
# tests/test_sharded.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_tiles,n_shards", [(17, 8), (5, 8), (64, 7), (1, 3), (16, 16)])
def test_shard_boundaries_equal_reference(n_tiles, n_shards):
    assert shard_boundaries(n_tiles, n_shards) == r_shard_boundaries(n_tiles, n_shards)


def test_shard_layout(mixed):
    bits, ref, rs, tor, ts = mixed
    assert ts.n_shards == N_SHARDS
    last = ts.store.shards[-1]
    assert last.n_words < last.n_tiles * last.tile_words
    assert last.r < last.n_words * 32
    assert ts.store.shards[0].dirty_words == 0
    offs = list(ts.store.word_offsets) + [tor.n_words]
    assert offs[0] == 0 and all(a < b for a, b in zip(offs, offs[1:]))
    assert ts.store.tile_bounds == rs.store.tile_bounds
    assert ts.store.word_offsets == rs.store.word_offsets
    for a, b in zip(ts.store.shards, rs.store.shards):
        assert (a.n_words, a.r, a.n_tiles, a.dirty_words) == (b.n_words, b.r, b.n_tiles, b.dirty_words)
        np.testing.assert_array_equal(a.classes_word, b.classes_word)
        np.testing.assert_array_equal(a.container_kinds, b.container_kinds)
        assert a.cardinalities == b.cardinalities
        # the shard's dense view is a strided view of the parent's
        assert a.densify().data_ptr() != 0 and a.densify().stride(0) == tor.n_words
        assert a.device == tor.device


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_every_backend_sharded_matches_reference(mixed, alg):
    """Each backend, forced on every shard, equals the reference's sharded
    run, the port's unsharded run and the scancount oracle."""
    bits, ref, rs, tor, ts = mixed
    assert alg in R_ALGORITHMS
    n, r = bits.shape
    t = _t_for(alg, n)
    got = _same(rs, ts, lambda M: M.Threshold(t), backend=alg)
    assert np.array_equal(got, u32(tor.execute(TQ.Threshold(t), backend=alg)))
    np.testing.assert_array_equal(unpack(t_words(got), r).numpy(), bits.sum(0) >= t)


def test_mixed_density_heterogeneous_plan(mixed):
    bits, ref, rs, tor, ts = mixed
    plan = ts.plan(TQ.Threshold(4))
    assert len(plan.distinct) >= 2 and "tiled_fused" in plan.distinct, plan.backends
    got = _same(rs, ts, lambda M: M.Threshold(4))
    assert np.array_equal(got, u32(tor.execute(TQ.Threshold(4), backend="ssum")))
    info = ts.last_info
    assert info["mode"] == "per_shard" and info["backends"] == plan.backends
    assert info["dirty_words_gathered"] < bits.shape[0] * tor.n_words
    assert plan.cost == rs.plan(RQ.Threshold(4)).cost


def test_composite_query_sharded(mixed):
    bits, ref, rs, tor, ts = mixed
    got = _same(rs, ts, lambda M: M.And(M.Interval(2, 6), M.Not(M.Threshold(9))))
    want = tor.execute(TQ.And(TQ.Interval(2, 6), TQ.Not(TQ.Threshold(9))), backend="circuit")
    assert np.array_equal(got, u32(want))


def test_execute_many_sharded(mixed):
    bits, ref, rs, tor, ts = mixed
    for backend in (None, "circuit"):
        kw = {} if backend is None else {"backend": backend}
        got = ts.execute_many([TQ.Threshold(2), TQ.Threshold(8), TQ.Interval(1, 3)], **kw)
        want = rs.execute_many([RQ.Threshold(2), RQ.Threshold(8), RQ.Interval(1, 3)], **kw)
        for g, w in zip(got, want):
            assert np.array_equal(u32(g.gather()), np.asarray(w.gather()))
        assert ts.last_info == rs.last_info
    for q, g in zip([TQ.Threshold(2), TQ.Threshold(8), TQ.Interval(1, 3)], got):
        assert np.array_equal(u32(g.gather()), u32(tor.execute(q, backend="circuit")))


def test_add_column_shard_wise_no_gather(mixed):
    bits, ref, rs, tor, ts = mixed
    res = ts.execute(TQ.Threshold(4))
    ts2 = ts.add_column("hot", res)
    rs2 = rs.add_column("hot", rs.execute(RQ.Threshold(4)))
    assert "hot" in ts2 and "hot" not in ts and ts2.n == ts.n + 1
    for a, b in zip(ts2.store.shards, rs2.store.shards):
        np.testing.assert_array_equal(a.container_kinds, b.container_kinds)
    got = _same(rs2, ts2, lambda M: M.And(M.Col("hot"), M.Threshold(2)))
    tor2 = tor.add_column("hot", tor.execute(TQ.Threshold(4), backend="ssum"))
    want = tor2.execute(TQ.And(TQ.Col("hot"), TQ.Threshold(2)), backend="circuit")
    assert np.array_equal(got, u32(want))
    # the old sharded index still executes against its own schema
    _same(rs, ts, lambda M: M.Threshold(4))


def test_replace_column_immutable(mixed):
    bits, ref, rs, tor, ts = mixed
    flipped = ~bits[0]
    from repro_torch.core.bitmaps import pack

    new = pack(flipped[None], "cpu")[0]
    ts2 = ts.replace_column("c0", ts.store.split(new))
    rs2 = rs.replace_column("c0", rs.store.split(np.asarray(u32(new))))
    got0, got1 = u32(ts.column("c0")), u32(ts2.column("c0"))
    assert not np.array_equal(got0, got1)
    np.testing.assert_array_equal(got0, u32(tor.column("c0")))
    np.testing.assert_array_equal(got1, np.asarray(rs2.column("c0")))
    _same(rs2, ts2, lambda M: M.Threshold(3))


def test_from_sharded_round_trip(mixed):
    bits, ref, rs, tor, ts = mixed
    back = TQ.BitmapIndex.from_sharded(ts)
    rback = RQ.BitmapIndex.from_sharded(rs)
    assert back.names == tor.names and back.r == tor.r
    np.testing.assert_array_equal(u32(back.columns), u32(tor.columns))
    np.testing.assert_array_equal(back.store.classes_word, rback.store.classes_word)
    np.testing.assert_array_equal(back.store.container_kinds, rback.store.container_kinds)
    assert back.store.cardinalities == rback.store.cardinalities


def test_single_shard_degenerates_to_unsharded(mixed):
    bits, ref, rs, tor, ts = mixed
    s1 = tor.shard(n_shards=1)
    assert s1.n_shards == 1
    got = _same(ref.shard(n_shards=1), s1, lambda M: M.Threshold(4))
    assert np.array_equal(got, u32(tor.execute(TQ.Threshold(4), backend="ssum")))


@pytest.mark.parametrize("n_shards", [8, 7])
def test_shard_map_path_in_process(n_shards):
    """The reference's mesh case: devices given and every plan dense, so the
    query runs as one K1 call a piece (the plain version on the CPU); at 7
    shards the split is padded."""
    bits = np.random.default_rng(5).random((10, 16 * TILE_BITS + 300)) < 0.3
    ref, tor = _pair(bits)
    sidx = tor.shard(devices=["cpu"] * n_shards)
    assert sidx.n_shards == n_shards
    assert sidx.devices == (torch.device("cpu"),) * n_shards
    pieces = sidx.store.spmd_pieces(sidx.devices)
    w = -(-tor.n_words // n_shards)
    assert all(p.shape == (10, w) for p in pieces)
    if n_shards * w == tor.n_words:
        assert all(p.data_ptr() == tor.columns[:, d * w:].data_ptr() for d, p in enumerate(pieces))
    q = TQ.And(TQ.Interval(2, 6), TQ.Not(TQ.Threshold(9)))
    res = sidx.execute(q)
    assert sidx.last_info["mode"] == "shard_map"
    want = np.asarray(ref.execute(RQ.And(RQ.Interval(2, 6), RQ.Not(RQ.Threshold(9))),
                                  backend="circuit"))
    assert np.array_equal(u32(res.gather()), want)
    # the same keys as the reference's mesh branch
    assert set(sidx.last_info) == {"mode", "backends", "n_shards"}
    assert sidx.last_info["backends"] == ref.shard(n_shards=n_shards).plan(
        RQ.And(RQ.Interval(2, 6), RQ.Not(RQ.Threshold(9)))).backends
    many = sidx.execute_many([TQ.Threshold(2), TQ.Interval(3, 5)])
    for g, rq in zip(many, [RQ.Threshold(2), RQ.Interval(3, 5)]):
        assert np.array_equal(u32(g.gather()), np.asarray(ref.execute(rq, backend="circuit")))


def test_shard_map_acceptance():
    """The reference's 8-device acceptance script, in process: mixed density
    plans per shard (a tiled shard keeps the per-shard path), a dense index
    runs on the shard-map path."""
    rng = np.random.default_rng(0)
    n, n_tiles = 10, 16
    r = n_tiles * TILE_BITS + 700
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for tj in range(n_tiles + 1):
            lo, hi = tj * TILE_BITS, min((tj + 1) * TILE_BITS, r)
            if tj < n_tiles // 2:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.35
            else:
                u = rng.random()
                if u < 0.475:
                    pass
                elif u < 0.95:
                    bits[i, lo:hi] = True
                else:
                    bits[i, lo:hi] = rng.random(hi - lo) < 0.35
    ref, tor = _pair(bits)
    sidx = tor.shard(devices=["cpu"] * 8)
    rs = ref.shard(n_shards=8)
    plan = sidx.plan(TQ.Threshold(5))
    assert len(plan.distinct) >= 2, plan.backends
    _same_plans(rs.plan(RQ.Threshold(5)), plan)
    got = u32(sidx.execute(TQ.Threshold(5)).gather())
    assert sidx.last_info["mode"] == "per_shard"
    assert np.array_equal(got, np.asarray(ref.execute(RQ.Threshold(5), backend="ssum")))

    dense = np.random.default_rng(1).random((8, 8 * TILE_BITS)) < 0.4
    dref, dtor = _pair(dense)
    sdense = dtor.shard(devices=["cpu"] * 8)
    res = sdense.execute(TQ.Threshold(4))
    assert sdense.last_info["mode"] == "shard_map", sdense.last_info
    assert np.array_equal(u32(res.gather()),
                          np.asarray(dref.execute(RQ.Threshold(4), backend="ssum")))


def test_devices_must_match_the_shards():
    bits = np.random.default_rng(2).random((3, 4 * TILE_BITS)) < 0.5
    _, tor = _pair(bits)
    with pytest.raises(ValueError):
        tor.shard(n_shards=2, devices=["cpu"] * 3)
    assert tor.shard(devices=["cpu"] * 3).n_shards == 3
    assert tor.shard().n_shards == 1 and tor.shard().devices is None


# ---------------------------------------------------------------------------
# tests/test_storage.py: slicing and the sharded container differential
# ---------------------------------------------------------------------------

TW8 = 8
SPAN8 = TW8 * 32


def _store_pair(bits, containers=True, tile_words=TW8):
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits), tile_words=tile_words,
                                    containers=containers).store
    tor = TQ.BitmapIndex.from_dense(bits, tile_words=tile_words, containers=containers,
                                    device="cpu").store
    return ref, tor


def _same_store(a, b):
    """``a`` a port store, ``b`` a reference store: every surface equal."""
    assert (a.n, a.n_words, a.r, a.n_tiles) == (b.n, b.n_words, b.r, b.n_tiles)
    np.testing.assert_array_equal(a.classes_word, b.classes_word)
    np.testing.assert_array_equal(a.container_kinds, b.container_kinds)
    assert tuple(a.cardinalities) == tuple(b.cardinalities)
    for key, arr in b.packs.items():
        np.testing.assert_array_equal(a.packs[key], np.asarray(arr), err_msg=key)
    np.testing.assert_array_equal(u32(a.densify()), np.asarray(b.densify()))


def _every_kind_bits(seed=3):
    """Tile 0 runny, tile 1 sparse, tile 2 dense, tile 3 all-one, tile 4
    sparse again, a partial tail: a shard boundary after each kind."""
    rng = np.random.default_rng(seed)
    r = 6 * SPAN8 + 45
    bits = np.zeros((4, r), bool)
    for i in range(4):
        bits[i, 10 + i : 200 + 7 * i] = True  # a run in tile 0
        bits[i, SPAN8 + rng.choice(SPAN8, 3 + i, replace=False)] = True  # sparse
        bits[i, 2 * SPAN8 : 3 * SPAN8] = rng.random(SPAN8) < 0.5  # dense
        bits[i, 3 * SPAN8 : 4 * SPAN8] = True  # all one
        bits[i, 4 * SPAN8 + rng.choice(SPAN8, 2, replace=False)] = True  # sparse
        bits[i, 5 * SPAN8 + 40 : 5 * SPAN8 + 90] = True  # run in the partial tail
    return bits


@pytest.mark.parametrize("containers", [True, False])
def test_slice_concat_round_trip_every_container_kind(containers):
    """``slice(0,1) + slice(1,4) + slice(4,end)`` and every single-tile
    slice equal the reference's slices (offset tables rebased by the right
    origin), and stitch back to the whole store."""
    rstore, tstore = _store_pair(_every_kind_bits(), containers=containers)
    if containers:
        kinds = set(np.unique(tstore.container_kinds).tolist())
        assert {1, 2, 3} <= kinds, kinds  # dense, sparse and run containers
    cuts = [(0, 1), (1, 4), (4, tstore.n_tiles)]
    cuts += [(t, t + 1) for t in range(tstore.n_tiles)] + [(2, 5), (3, tstore.n_tiles)]
    for t0, t1 in cuts:
        sliced = tstore.slice_tiles(t0, t1)
        _same_store(sliced, rstore.slice_tiles(t0, t1))
        np.testing.assert_array_equal(
            u32(sliced.densify()),
            u32(tstore.densify())[:, t0 * TW8 : min(t1 * TW8, tstore.n_words)],
        )
        for a, b in zip(sliced.device_packs(), TileStore.from_packed(
                sliced.densify().contiguous(), tile_words=TW8, r=sliced.r,
                containers=containers, device="cpu").device_packs()):
            assert np.array_equal(a.numpy(), b.numpy())
    parts = [tstore.slice_tiles(t0, t1) for t0, t1 in cuts[:3]]
    back = TileStore.concat_tiles(parts, n_words=tstore.n_words, r=tstore.r)
    rback = RTileStore.concat_tiles([rstore.slice_tiles(t0, t1) for t0, t1 in cuts[:3]],
                                    n_words=rstore.n_words, r=rstore.r)
    _same_store(back, rback)
    _same_store(back, rstore)
    with pytest.raises(ValueError):
        tstore.slice_tiles(3, 3)


def test_slicing_reclassifies_nothing(monkeypatch):
    from repro_torch.storage import tilestore as TS

    _, tstore = _store_pair(_every_kind_bits())
    calls = []
    monkeypatch.setattr(TS, "_classify_column", lambda *a, **k: calls.append(1))
    sidx = TQ.BitmapIndex(names=_names(tstore.n), _store=tstore).shard(n_shards=3)
    assert sidx.n_shards == 3 and calls == []


def test_container_native_execution_differential_sharded():
    """The sharded half of ``test_container_native_execution_differential``:
    mixed column kinds, every backend on bare thresholds and the composite
    on the circuit family, containers and legacy, 3 shards."""
    rng = np.random.default_rng(17)
    n, r = 5, 4 * SPAN8 + 37
    bits = np.zeros((n, r), bool)
    bits[0, ::131] = True
    bits[1, 40:500] = True
    bits[2] = rng.random(r) < 0.5
    bits[3, :SPAN8] = True
    bits[4, ::2] = True
    counts = bits.sum(0)
    for containers in (True, False):
        ref, tor = _pair(bits, tile_words=TW8, containers=containers)
        rs, ts = ref.shard(n_shards=3), tor.shard(n_shards=3)
        for t in (1, 2, n):
            for alg in ALGORITHMS:
                if alg == "wide_or" and t != 1 or alg == "wide_and" and t != n:
                    continue
                got = _same(rs, ts, lambda M: M.Threshold(t), backend=alg)
                np.testing.assert_array_equal(unpack(t_words(got), r).numpy(), counts >= t)

        def q(M):
            return M.Or(M.And(M.Interval(2, 4), M.Not(M.Col("c1"))),
                        M.Parity(over=(M.Col("c0"), M.Col("c2"))))

        expect = ((counts >= 2) & (counts <= 4) & ~bits[1]) | (bits[0] ^ bits[2])
        for backend in (None, "circuit", "tiled_fused"):
            kw = {} if backend is None else {"backend": backend}
            got = _same(rs, ts, q, **kw)
            np.testing.assert_array_equal(unpack(t_words(got), r).numpy(), expect)


# ---------------------------------------------------------------------------
# tests/test_containers_fuzz.py: the sharded variants
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import test_containers_fuzz as fuzz  # noqa: E402

FUZZ = dict(max_examples=8, deadline=None)


def _to_port(q):
    """A reference query tree rebuilt from ``repro_torch.query``'s classes."""
    from repro.query import expr as RE

    def rb(x):
        return None if x is None else tuple(_to_port(m) for m in x)

    if isinstance(q, RE.Col):
        return TQ.Col(q.name)
    if isinstance(q, RE.Threshold):
        return TQ.Threshold(q.t, over=rb(q.over))
    if isinstance(q, RE.Interval):
        return TQ.Interval(q.lo, q.hi, over=rb(q.over))
    if isinstance(q, RE.Parity):
        return TQ.Parity(over=rb(q.over))
    if isinstance(q, RE.Weighted):
        return TQ.Weighted(q.weights, q.t, over=rb(q.over))
    if isinstance(q, RE.And):
        return TQ.And(*[_to_port(c) for c in q.children])
    if isinstance(q, RE.Or):
        return TQ.Or(*[_to_port(c) for c in q.children])
    if isinstance(q, RE.Not):
        return TQ.Not(_to_port(q.child))
    if isinstance(q, RE.AndNot):
        return TQ.AndNot(_to_port(q.keep), _to_port(q.drop))
    raise TypeError(type(q))


def _fuzz_pairs(bits):
    out = []
    for containers in (True, False):
        ref, tor = _pair(bits, tile_words=fuzz.TW, containers=containers)
        k = min(3, tor.store.n_tiles)
        out.append((containers, ref.shard(n_shards=k), tor.shard(n_shards=k)))
    return out


@given(fuzz.column_mix(), st.data())
@settings(**FUZZ)
def test_expression_trees_differential_sharded(mix, data):
    bits, _kinds = mix
    n, r = bits.shape
    rq = data.draw(fuzz.expression(n))
    tq = _to_port(rq)
    assert tq.key() == rq.key()
    expect = fuzz.oracle(rq, bits)
    for containers, rs, ts in _fuzz_pairs(bits):
        for backend in (None, "circuit", "tiled_fused"):
            kw = {} if backend is None else {"backend": backend}
            got = u32(ts.execute(tq, **kw).gather())
            np.testing.assert_array_equal(unpack(t_words(got), r).numpy(), expect,
                                          err_msg=f"{containers} {backend} {rq.key()}")
            if backend is None:
                want = np.asarray(rs.execute(rq).gather())
                assert np.array_equal(got, want) and ts.last_info == rs.last_info


@given(fuzz.column_mix(), st.data())
@settings(**FUZZ)
def test_every_algorithm_bare_threshold_differential_sharded(mix, data):
    bits, _kinds = mix
    n, r = bits.shape
    t = data.draw(st.integers(1, n))
    expect = bits.sum(0) >= t
    containers, rs, ts = _fuzz_pairs(bits)[0]
    for alg in ALGORITHMS:
        if alg == "wide_or" and t != 1 or alg == "wide_and" and t != n:
            continue
        got = u32(ts.execute(TQ.Threshold(t), backend=alg).gather())
        np.testing.assert_array_equal(unpack(t_words(got), r).numpy(), expect,
                                      err_msg=f"alg={alg} t={t}")
    assert np.array_equal(got, np.asarray(rs.execute(RQ.Threshold(t), backend=alg).gather()))
    assert ts.last_info == rs.last_info


@given(fuzz.column_mix(), st.data())
@settings(**FUZZ)
def test_scan_engine_differential_sharded(mix, data):
    import os

    bits, _kinds = mix
    n, r = bits.shape
    rq = data.draw(fuzz.expression(n))
    tq = _to_port(rq)
    expect = fuzz.oracle(rq, bits)
    for containers, rs, ts in _fuzz_pairs(bits):
        for engine in ("scan", "merge"):
            os.environ["REPRO_TILED_ENGINE"] = engine
            try:
                got = u32(ts.execute(tq, backend="tiled_fused").gather())
                info = ts.last_info
            finally:
                del os.environ["REPRO_TILED_ENGINE"]
            np.testing.assert_array_equal(unpack(t_words(got), r).numpy(), expect,
                                          err_msg=f"{containers} engine={engine} {rq.key()}")
            assert info["mode"] == "per_shard"
            assert all(i["engine"] == engine for i in info["per_shard"]), info["engine"]


# ---------------------------------------------------------------------------
# tests/test_obs.py: the sharded span trees and the 8-shard ExecInfo sum
# ---------------------------------------------------------------------------

OBS_N = 10
OBS_R = 8 * TILE_BITS + 700


@pytest.fixture(scope="module")
def obs_pair():
    rng = np.random.default_rng(0)
    bits = rng.random((OBS_N, OBS_R)) < 0.3
    bits[: OBS_N // 3, : OBS_R // 2] = False
    names = [f"s{i}" for i in range(OBS_N)]
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits), names)
    tor = TQ.BitmapIndex.from_dense(bits, names, device="cpu")
    return bits, ref, tor


@pytest.fixture()
def _obs_clean():
    for o in (obs, robs):
        o.disable()
        o.reset()
    yield
    for o in (obs, robs):
        o.disable()
        o.reset()


def _untimed(sp) -> tuple:
    return (sp.name, dict(sp.attrs), [_untimed(c) for c in sp.children])


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_span_words_match_exec_info_every_backend_sharded(obs_pair, _obs_clean, alg):
    bits, ref, tor = obs_pair
    sidx = ShardedBitmapIndex.from_index(tor, n_shards=4)
    t = {"wide_or": 1, "wide_and": OBS_N, "sopckt": 2}.get(alg, 4)
    obs.enable()
    res = sidx.execute(TQ.Threshold(t), backend=alg)
    obs.disable()
    np.testing.assert_array_equal(unpack(res.gather(), sidx.r).numpy(), bits.sum(0) >= t)
    root = obs.last_trace()
    assert root is not None and root.name == "execute_sharded", alg
    merged = sidx.last_info
    assert root.attrs["measured_words"] == merged["words_touched"], alg
    shard_spans = [s for s in root.iter() if s.name == "shard"]
    assert len(shard_spans) == 4
    assert sum(s.attrs["measured_words"] for s in shard_spans) == merged["words_touched"]


#: the port-only spans (``_torch_port.PORT_ONLY_SPANS``) each backend's tree holds
SHARDED_PORT_SPANS = {None: {"program", "launch"}, "tiled_fused": {"block"},
                      "circuit": {"program", "launch"}, "looped": set()}


@pytest.mark.parametrize("backend", list(SHARDED_PORT_SPANS))
def test_sharded_span_trees_and_drift_equal_reference(obs_pair, _obs_clean, backend):
    """Equal trees once the port-only spans are folded out."""
    bits, ref, tor = obs_pair
    rs, ts = ref.shard(n_shards=4), tor.shard(n_shards=4)
    for cold in (True, False):
        if cold:
            RQ.clear_compiled_cache()
            TQ.clear_compiled_cache()
        robs.enable()
        obs.enable()
        want = rs.execute(RQ.Threshold(4), backend=backend)
        got = ts.execute(TQ.Threshold(4), backend=backend)
        robs.disable()
        obs.disable()
        assert np.array_equal(u32(got.gather()), np.asarray(want.gather()))
        folded = set()
        got_tree = reference_view(obs.last_trace(), folded)
        assert got_tree == _untimed(robs.last_trace()), (backend, cold)
        assert folded == SHARDED_PORT_SPANS[backend], (backend, cold)
        assert obs.drift_samples() == robs.drift_samples()


def test_exec_info_schema_sum_at_8_shards(obs_pair, _obs_clean):
    bits, ref, tor = obs_pair
    sidx = ShardedBitmapIndex.from_index(tor, n_shards=8)
    obs.enable()
    res = sidx.execute(TQ.Threshold(4))
    obs.disable()
    merged = sidx.last_info
    assert set(EXEC_INFO_SCHEMA) <= set(merged)
    shard_spans = [s for s in obs.last_trace().iter() if s.name == "shard"]
    assert len(shard_spans) == 8
    for key in ("measured_words", "launches"):
        skey = "words_touched" if key == "measured_words" else key
        assert sum(s.attrs[key] or 0 for s in shard_spans) == merged[skey], key
    np.testing.assert_array_equal(u32(res.gather()), u32(tor.execute(TQ.Threshold(4))))
    rs = ref.shard(n_shards=8)
    rs.execute(RQ.Threshold(4))
    assert merged == rs.last_info


def test_container_mix_sharded_equals_reference():
    """Sparse, runny and dense containers across 5 shards, planner-routed
    and on the tiled route."""
    bits = container_mix_bits(6, seed=9)
    ref, tor = _pair(bits)
    rs, ts = ref.shard(n_shards=5), tor.shard(n_shards=5)
    for make in (lambda M: M.Threshold(2), lambda M: M.Interval(1, 3),
                 lambda M: M.And(M.Col("c0"), M.Not(M.Col("c3")))):
        _same(rs, ts, make)
        _same(rs, ts, make, backend="tiled_fused")
