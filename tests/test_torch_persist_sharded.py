"""The port's sharded snapshot directories (``repro_torch.persist.shards``)
against the reference.

A sharded index persists as ``sharded.json`` plus one ``shard-NNNN.bmsnap``
per shard.  The same bits sharded the same way and saved by both packages
give byte-identical files; a directory written by either loads in the
other; a loaded index re-saves to the same bytes; ``load_shard`` reads one
shard alone with its tile bounds.  Query words are compared with
``np.array_equal`` (no tolerance).  These are ``tests/test_persist.py``'s
sharded round trip and sharded durability cases and
``tests/test_persist_fuzz.py``'s sharded snapshot differential.
"""
import numpy as np
import pytest

from _torch_port import container_mix_bits, gathered, same_answer, stream_pair, t_words, u32
from repro import persist as RPer
from repro import query as RQ
from repro import stream as RSt
from repro.dist.query import ShardedBitmapIndex as RSharded
from repro_torch import persist as TPer
from repro_torch import query as TQ
from repro_torch import stream as TSt
from repro_torch.core.bitmaps import unpack
from repro_torch.dist import ShardedBitmapIndex, ShardedTileStore

TW = 8
SPAN = TW * 32


def _mixed_bits(n=6, n_tiles=5, tail=17, seed=0):
    """The reference's ``tests/test_persist.py::_mixed_bits``."""
    r = n_tiles * SPAN + tail
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, r), bool)
    bits[0, :] = True
    bits[2, rng.choice(r, r // 40, replace=False)] = True
    bits[3, r // 8 : r // 2] = True
    bits[4 % n] = rng.random(r) < 0.4
    if n > 5:
        bits[5, : r // 3] = rng.random(r // 3) < 0.6
    return bits


def _pair(bits, containers=True, n_shards=None):
    names = [f"c{i}" for i in range(bits.shape[0])]
    ref = RQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers)
    tor = TQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers,
                                    device="cpu")
    return ref.shard(n_shards=n_shards), tor.shard(n_shards=n_shards)


def _files(d):
    return sorted(p.name for p in d.iterdir())


def _same_dirs(a, b):
    assert _files(a) == _files(b)
    for name in _files(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _same_sharded(rs, ts, makes):
    for make in makes:
        want = np.asarray(rs.execute(make(RQ)).gather())
        got = u32(ts.execute(make(TQ)).gather())
        assert np.array_equal(got, want)
        assert ts.last_info == rs.last_info


QUERIES = (
    lambda M: M.Threshold(2),
    lambda M: M.And(M.Col("c0"), M.Col("c4")),
    lambda M: M.Interval(1, 3),
    lambda M: M.Parity(),
)


# -- test_persist.py:193 -----------------------------------------------------

@pytest.mark.parametrize("n_shards", [None, 2, 3])
def test_sharded_round_trip_bytes_equal_both_ways(tmp_path, n_shards):
    rs, ts = _pair(_mixed_bits(n=5, n_tiles=6, tail=0, seed=11), n_shards=n_shards)
    rd, td = tmp_path / "ref", tmp_path / "tor"
    assert ts.save(td) == rs.save(rd)
    _same_dirs(rd, td)
    m = TPer.read_shard_map(td)
    assert m == RPer.read_shard_map(rd) and m["n_shards"] == ts.n_shards
    assert sorted(x.name for x in td.glob("shard-*.bmsnap")) == [
        f"shard-{k:04d}.bmsnap" for k in range(m["n_shards"])]
    # each package loads the other's directory
    back = ShardedBitmapIndex.load(rd, device="cpu", verify=True)
    rback = RSharded.load(td, verify=True)
    assert isinstance(back, ShardedBitmapIndex) and back.store.tile_bounds == rs.store.tile_bounds
    _same_sharded(rback, back, QUERIES)
    _same_sharded(rs, back, QUERIES)
    # a loaded index re-saves to the same bytes
    back.save(tmp_path / "again")
    _same_dirs(rd, tmp_path / "again")
    # one shard loads alone, with its tile bounds
    store0, bounds = TPer.load_shard(td, 0, device="cpu")
    rstore0, rbounds = RPer.load_shard(td, 0)
    assert bounds == rbounds and len(bounds) == 2 and bounds[0] == 0
    assert store0.n == 5 and store0.device.type == "cpu"
    np.testing.assert_array_equal(u32(store0.densify()), np.asarray(rstore0.densify()))
    k = ts.n_shards - 1
    storek, boundsk = TPer.load_shard(td, k, device="cpu")
    assert boundsk == ts.store.tile_bounds[k]
    np.testing.assert_array_equal(u32(storek.densify()), u32(ts.store.shards[k].densify()))


def test_load_sharded_places_shards_and_takes_the_shard_map_path(tmp_path):
    rng = np.random.default_rng(3)
    bits = rng.random((6, 7 * SPAN + 9)) < 0.4
    rs, ts = _pair(bits, n_shards=3)
    ts.save(tmp_path / "d")
    back = TPer.load_sharded(tmp_path / "d", devices=["cpu"] * 3, to_device=True)
    assert back.devices is not None and len(back.devices) == 3
    res = back.execute(TQ.Interval(2, 4), backend="fused")
    assert back.last_info["mode"] == "shard_map"
    assert np.array_equal(u32(res.gather()),
                          np.asarray(rs.execute(RQ.Interval(2, 4), backend="fused").gather()))
    with pytest.raises(ValueError):
        TPer.load_sharded(tmp_path / "d", devices=["cpu"] * 2)
    # a map without names is a bare sharded store
    TPer.save_sharded(ts.store, tmp_path / "bare")
    RPer.save_sharded(rs.store, tmp_path / "rbare")
    _same_dirs(tmp_path / "bare", tmp_path / "rbare")
    assert isinstance(TPer.load_sharded(tmp_path / "bare", device="cpu"), ShardedTileStore)


def test_container_mix_directory_bytes_equal(tmp_path):
    bits = container_mix_bits(5, seed=13)
    names = [f"c{i}" for i in range(5)]
    rs = RQ.BitmapIndex.from_dense(bits, names).shard(n_shards=4)
    ts = TQ.BitmapIndex.from_dense(bits, names, device="cpu").shard(n_shards=4)
    rs.save(tmp_path / "r")
    ts.save(tmp_path / "t")
    _same_dirs(tmp_path / "r", tmp_path / "t")


# -- test_persist.py:354 -----------------------------------------------------

def test_stream_sharded_durability(tmp_path):
    bits = _mixed_bits(n=4, n_tiles=6, tail=0, seed=29)
    rd, td = tmp_path / "r", tmp_path / "t"
    ref, tor = stream_pair(bits, tile_words=TW, durable=(rd, td), n_shards=3)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("pair", M.Interval(2, 3))
        s.update(sets={"c1": [44, 2 * SPAN + 1]})
        s.checkpoint()
        s.update(clears={"c1": [44]})
        s.append_rows(np.ones((4, 40), bool))
    assert (td / "sharded.json").exists()
    for name in ("sharded.json", "index.json", "wal.bmwal", "shard-0000.bmsnap",
                 "shard-0002.bmsnap"):
        assert (td / name).read_bytes() == (rd / name).read_bytes(), name
    rec = TSt.StreamingIndex.recover(td, device="cpu")
    rrec = RSt.StreamingIndex.recover(rd)
    assert rec.is_sharded and rec.version == rrec.version and rec.r == tor.r
    for make in (lambda M: M.Threshold(2), lambda M: M.Col("pair")):
        same_answer(rrec, rec, make)
        assert np.array_equal(u32(gathered(rec.execute(make(TQ)))),
                              u32(gathered(tor.execute(make(TQ)))))
    # each package recovers the other's directory
    cross = TSt.StreamingIndex.recover(rd, devices=["cpu"] * 3)
    rcross = RSt.StreamingIndex.recover(td)
    same_answer(rcross, cross, lambda M: M.Col("pair"))
    assert cross.index().devices is not None


# -- test_persist_fuzz.py:107 ------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import test_torch_persist_fuzz as tfuzz  # noqa: E402


@given(tfuzz.column_mix(), st.booleans(), st.data())
@settings(max_examples=6, deadline=None)
def test_sharded_snapshot_differential(tmp_path_factory, mix, containers, data):
    bits = mix
    n, r = bits.shape
    t = data.draw(st.integers(1, n))
    names = [f"c{i}" for i in range(n)]
    tidx = TQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers,
                                     device="cpu")
    ridx = RQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers)
    k = min(3, tidx.store.n_tiles)
    ts, rs = tidx.shard(n_shards=k), ridx.shard(n_shards=k)
    root = tmp_path_factory.mktemp("fuzz")
    ts.save(root / "t")
    rs.save(root / "r")
    _same_dirs(root / "t", root / "r")
    back = type(ts).load(root / "r", device="cpu")
    rback = type(rs).load(root / "t")
    expect = bits.sum(0) >= t
    for make in (lambda M: M.Threshold(t), lambda M: M.Interval(1, max(1, n - 1))):
        a = u32(tidx.execute(make(TQ)))
        b = u32(back.execute(make(TQ)).gather())
        assert np.array_equal(a, b)
        assert np.array_equal(b, np.asarray(rback.execute(make(RQ)).gather()))
        assert back.last_info == rback.last_info
    got = u32(back.execute(TQ.Threshold(t)).gather())
    np.testing.assert_array_equal(unpack(t_words(got), r).numpy(), expect)
