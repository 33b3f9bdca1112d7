"""The port's write-ahead log and the durable streaming index
(``repro_torch.persist.wal``, ``StreamingIndex.checkpoint`` / ``recover``)
against the reference.

The ``.bmwal`` records are the reference's byte for byte, so a log and a
checkpoint directory written by the reference recover in the port.  Words
are compared with ``np.array_equal``, versions and ``index.json`` with
``==``; the tolerance is none.  These are the unsharded cases of
``tests/test_persist.py``.
"""
import json

import numpy as np
import pytest

from _torch_port import stream_pair, u32
from repro import persist as RPer
from repro import query as RQ
from repro.persist import wal as RWal
from repro.stream import StreamingIndex as RStream
from repro_torch import persist as TPer
from repro_torch import query as TQ
from repro_torch.persist import wal as TWal
from repro_torch.stream import StreamingIndex as TStream

TW = 8
SPAN = TW * 32


def _mixed_bits(n=6, n_tiles=5, tail=17, seed=0):
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


def _same(a, b, make):
    """Words of ``make(module)`` on two streaming indexes, port first."""
    got = u32(a.execute(make(TQ if isinstance(a, TStream) else RQ)))
    want = u32(b.execute(make(TQ if isinstance(b, TStream) else RQ)))
    assert np.array_equal(got, want), make(TQ)
    return got


def _queries():
    return (lambda M: M.Threshold(2), lambda M: M.Col("hot"), lambda M: M.Interval(1, 3))


# -- the log -------------------------------------------------------------------

def test_wal_versions_survive_rotation(tmp_path):
    p = tmp_path / "wal.bmwal"
    with TPer.WriteAheadLog(p) as wal:
        assert wal.append_update([0], [3], [True]) == 1
        assert wal.append_rows(np.ones((1, 4), bool)) == 2
        wal.rotate()
        assert wal.records == 0
        assert wal.append_materialize("m", TQ.Threshold(2)) == 3
    with TPer.WriteAheadLog(p) as wal2:
        recs = list(wal2.replay())
        assert [r["version"] for r in recs] == [3]
        assert recs[0]["name"] == "m" and recs[0]["query"] == TQ.Threshold(2)


def test_wal_truncated_tail_is_dropped(tmp_path):
    p = tmp_path / "wal.bmwal"
    with TPer.WriteAheadLog(p) as wal:
        wal.append_update([0, 1], [3, 9], [True, False])
        wal.append_update([2], [5], [True])
    raw = p.read_bytes()
    p.write_bytes(raw[:-3])
    with TPer.WriteAheadLog(p) as wal:
        assert wal.records == 1 and wal.last_version == 1
        recs = list(wal.replay())
        assert len(recs) == 1
        np.testing.assert_array_equal(recs[0]["cols"], [0, 1])
        np.testing.assert_array_equal(recs[0]["on"], [True, False])
    flip = bytearray(p.read_bytes())
    flip[TWal._HEADER + 8] ^= 0xFF
    p.write_bytes(flip)
    with TPer.WriteAheadLog(p) as wal:
        assert wal.records == 0 and wal.last_version == 0
    (tmp_path / "bad.bmwal").write_bytes(b"NOTAWAL!" + bytes(8))
    for W in (RWal, TWal):
        with pytest.raises(W.WalError):
            W.WriteAheadLog(tmp_path / "bad.bmwal")


def _codec_queries(M):
    return [
        M.Threshold(2), M.Threshold(1, over=(M.Col("a"), M.Col("b"))),
        M.Interval(1, 3), M.Exactly(2), M.Parity(), M.Majority(),
        M.Sym((False, True, True, False)),
        M.Weighted((1, 2, 3), 4),
        M.And(M.Col("a"), M.Col("b")), M.Or(M.Col("a"), M.Parity()),
        M.Not(M.Col("a")), M.AndNot(M.Col("a"), M.Col("b")),
    ]


@pytest.mark.parametrize("i", range(12))
def test_query_codec_round_trips_every_node_as_the_reference(i):
    tq, rq = _codec_queries(TQ)[i], _codec_queries(RQ)[i]
    obj = TPer.query_to_obj(tq)
    assert obj == RPer.query_to_obj(rq)
    assert TPer.query_from_obj(obj) == tq
    assert TPer.query_from_obj(RPer.query_to_obj(rq)) == tq
    assert json.dumps(obj, sort_keys=True) == json.dumps(RPer.query_to_obj(rq), sort_keys=True)


def test_query_codec_refuses_unknown_nodes():
    with pytest.raises(TWal.WalError):
        TPer.query_from_obj({"op": "nand"})
    with pytest.raises(TypeError):
        TPer.query_to_obj(object())


def test_wal_records_are_byte_identical_to_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    cols, pos, on = rng.integers(0, 6, 50), rng.integers(0, 10**6, 50), rng.random(50) < 0.5
    bits = rng.random((6, 77)) < 0.4
    for W, name in ((RWal, "r"), (TWal, "t")):
        with W.WriteAheadLog(tmp_path / f"{name}.bmwal") as wal:
            wal.append_update(cols, pos, on)
            wal.append_rows(bits)
            q = (RQ if W is RWal else TQ).Interval(2, 4, over=("c0", "c3"))
            wal.append_materialize("v", q)
            wal.rotate()
            wal.append_update([1], [2], [False])
    assert (tmp_path / "t.bmwal").read_bytes() == (tmp_path / "r.bmwal").read_bytes()
    with TPer.WriteAheadLog(tmp_path / "r.bmwal") as wal:
        assert wal.last_version == 4 and wal.records == 1


def test_reference_wal_replays_in_the_port(tmp_path):
    rng = np.random.default_rng(4)
    bits = rng.random((3, 40)) < 0.5
    with RPer.WriteAheadLog(tmp_path / "wal.bmwal") as wal:
        wal.append_update([0, 2], [5, 9], [True, False])
        wal.append_rows(bits)
        wal.append_materialize("v", RQ.Threshold(2))
    want = list(RPer.WriteAheadLog(tmp_path / "wal.bmwal").replay())
    got = list(TPer.WriteAheadLog(tmp_path / "wal.bmwal").replay(after_version=0))
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert g["version"] == w["version"]
        for key in ("cols", "pos", "on", "bits"):
            if key in w:
                np.testing.assert_array_equal(g[key], w[key])
    assert got[2]["query"] == TQ.Threshold(2) and got[2]["name"] == "v"


# -- the durable streaming index ---------------------------------------------

def test_stream_checkpoint_recover_round_trip_and_index_json(tmp_path):
    bits = _mixed_bits(seed=13)
    ref, tor = stream_pair(bits, tile_words=TW,
                           durable=(tmp_path / "r", tmp_path / "t"))
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("hot", M.Interval(2, 4))
        s.update(sets={"c1": [5, 77]}, clears={"c0": [3]})
        assert s.checkpoint() is not None
        s.update(sets={"c2": [200]}, clears={"c1": [5]})
    assert json.loads((tmp_path / "t" / "index.json").read_text()) == \
        json.loads((tmp_path / "r" / "index.json").read_text())
    assert (tmp_path / "t" / "index.json").read_text() == (tmp_path / "r" / "index.json").read_text()
    for name in ("snapshot.bmsnap", "wal.bmwal"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "r" / name).read_bytes(), name
    rec = TStream.recover(tmp_path / "t", device="cpu")
    assert rec.wal_version == tor.wal_version == ref.wal_version
    assert rec.names == tor.names and rec.views == tor.views == ("hot",)
    for make in _queries():
        _same(rec, tor, make)
        _same(rec, ref, make)
    assert rec.count("hot") == tor.count("hot") == ref.count("hot")
    for t in (tor, rec):
        t.update(sets={"c3": [9]})
    rec2 = TStream.recover(tmp_path / "t", device="cpu")
    _same(rec2, tor, lambda M: M.Threshold(2))
    assert rec2.durable_dir == tmp_path / "t"


def test_reference_directory_recovers_in_the_port(tmp_path):
    """A checkpoint + WAL tail written by the reference recovers in the
    port: same views, same wal version, same answers."""
    bits = _mixed_bits(seed=14)
    names = [f"c{i}" for i in range(bits.shape[0])]
    ref = RStream(RQ.BitmapIndex.from_dense(bits, names, tile_words=TW),
                  durable_dir=tmp_path / "d")
    ref.materialize("hot", RQ.Interval(2, 4))
    ref.update(sets={"c1": [5, 77]}, clears={"c0": [3]})
    ref.checkpoint()
    ref.update(sets={"c2": [200]}, clears={"c1": [5]})
    ref.append_rows(np.random.default_rng(15).random((6, 300)) < 0.3)
    ref.materialize("low", RQ.Threshold(5))
    ref.update(clears={"c4": [1, 2, 3]})
    rec = TStream.recover(tmp_path / "d", device="cpu")
    assert rec.wal_version == ref.wal_version and rec.r == ref.r
    assert rec.views == ref.views == ("hot", "low")
    for make in _queries() + (lambda M: M.Col("low"),):
        _same(rec, ref, make)
    assert rec.count("hot") == ref.count("hot") and rec.count("low") == ref.count("low")


def test_stream_crash_recovery_truncated_wal(tmp_path):
    bits = _mixed_bits(seed=17)
    ref, tor = stream_pair(bits, tile_words=TW, durable=(None, tmp_path / "d"))
    tor.checkpoint()
    tor.update(sets={"c1": [10]})
    tor.update(sets={"c2": [20]})
    wal_path = tmp_path / "d" / "wal.bmwal"
    wal_path.write_bytes(wal_path.read_bytes()[:-5])
    rec = TStream.recover(tmp_path / "d", device="cpu")
    ref.update(sets={"c1": [10]})
    for make in (lambda M: M.Threshold(1), lambda M: M.Col("c2")):
        _same(rec, ref, make)
    assert rec.wal_version == 1


def test_stream_append_rows_recovers(tmp_path):
    bits = _mixed_bits(seed=19)
    _, tor = stream_pair(bits, tile_words=TW, durable=(None, tmp_path / "d"))
    tor.checkpoint()
    extra = np.zeros((bits.shape[0], 40), bool)
    extra[0, ::3] = True
    extra[2, 5] = True
    tor.append_rows(extra)
    rec = TStream.recover(tmp_path / "d", device="cpu")
    assert rec.r == tor.r
    _same(rec, tor, lambda M: M.Threshold(2))


def test_stream_checkpoint_folds_wal(tmp_path):
    bits = _mixed_bits(seed=23)
    _, tor = stream_pair(bits, tile_words=TW, durable=(None, tmp_path / "d"))
    tor.update(sets={"c0": [1]})
    v = tor.wal_version
    tor.checkpoint()
    assert (tmp_path / "d" / "wal.bmwal").stat().st_size == TWal._HEADER
    rec = TStream.recover(tmp_path / "d", device="cpu")
    assert rec.wal_version == v
    _same(rec, tor, lambda M: M.Threshold(1))


def test_durable_index_refuses_schema_growth_and_needs_a_dir(tmp_path):
    bits = _mixed_bits(seed=29)
    ref, tor = stream_pair(bits, tile_words=TW, durable=(tmp_path / "r", tmp_path / "t"))
    for s in (ref, tor):
        with pytest.raises(RuntimeError):
            s.add_data_column("late")
    plain = TStream(TQ.BitmapIndex.from_dense(bits, tile_words=TW, device="cpu"))
    with pytest.raises(RuntimeError):
        plain.checkpoint()
    assert plain.wal_version == 0 and plain.durable_dir is None
