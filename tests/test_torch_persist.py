"""The port's snapshot format and paged tier (``repro_torch.persist``)
against the reference, and the device rule of every new entry point.

The ``.bmsnap`` bytes are the contract: the same bits saved by both
packages give the same file, a file written by either loads in the other,
and the committed golden fixture loads, queries and re-saves to its own
bytes in the port.  Query words are compared with ``np.array_equal``; the
tolerance is none.  These are the unsharded cases of
``tests/test_persist.py``.
"""
import importlib.util
import mmap
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import u32
from repro import persist as RPer
from repro import query as RQ
from repro_torch import persist as TPer
from repro_torch import query as TQ
from repro_torch.core.bitmaps import unpack

TW = 8
SPAN = TW * 32

_golden_spec = importlib.util.spec_from_file_location(
    "make_golden", Path(__file__).parent / "data" / "make_golden.py"
)
make_golden = importlib.util.module_from_spec(_golden_spec)
_golden_spec.loader.exec_module(make_golden)


def _mixed_bits(n=6, n_tiles=5, tail=17, seed=0):
    """Columns covering every container kind, partial final tile (the
    reference's ``tests/test_persist.py::_mixed_bits``)."""
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


def _pair(bits, containers=True):
    names = [f"c{i}" for i in range(bits.shape[0])]
    ref = RQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers)
    tor = TQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers,
                                    device="cpu")
    return ref, tor


def _assert_same_store(a, b):
    """``a`` a port store, ``b`` a reference (or port) store."""
    assert (a.r, a.n_words, a.tile_words, a.n) == (b.r, b.n_words, b.tile_words, b.n)
    np.testing.assert_array_equal(a.classes_word, b.classes_word)
    np.testing.assert_array_equal(a.container_kinds, b.container_kinds)
    assert tuple(a.cardinalities) == tuple(b.cardinalities)
    np.testing.assert_array_equal(u32(a.densify()), u32(b.densify()))


QUERIES = (
    lambda M: M.Threshold(2),
    lambda M: M.Interval(1, 3),
    lambda M: M.Parity(),
    lambda M: M.And(M.Col("c0"), M.Not(M.Col("c2"))),
)


# -- format framing ----------------------------------------------------------

def test_rejects_bad_magic_and_version(tmp_path):
    p = tmp_path / "x.bmsnap"
    TPer.save(_pair(_mixed_bits())[1], p)
    raw = bytearray(p.read_bytes())
    (tmp_path / "bad_magic.bmsnap").write_bytes(b"NOTMAGIC" + raw[8:])
    bad_ver = bytearray(raw)
    bad_ver[8:12] = (99).to_bytes(4, "little")
    (tmp_path / "bad_ver.bmsnap").write_bytes(bad_ver)
    for name in ("bad_magic", "bad_ver"):
        for P in (RPer, TPer):
            with pytest.raises(P.FormatError) as e:
                P.read_manifest(tmp_path / f"{name}.bmsnap")
            assert "bmsnap" in str(e.value) or "version" in str(e.value)


def test_rejects_truncation_and_section_corruption(tmp_path):
    p = tmp_path / "x.bmsnap"
    TPer.save(_pair(_mixed_bits())[1], p)
    raw = p.read_bytes()
    (tmp_path / "trunc.bmsnap").write_bytes(raw[: len(raw) // 2])
    manifest = TPer.read_manifest(p)
    off = manifest["sections"][0]["offset"]
    corrupt = bytearray(raw)
    corrupt[off] ^= 0xFF
    (tmp_path / "corrupt.bmsnap").write_bytes(corrupt)
    for P in (RPer, TPer):
        with pytest.raises(P.FormatError):
            P.read_manifest(tmp_path / "trunc.bmsnap")
        P.read_manifest(tmp_path / "corrupt.bmsnap")  # framing intact
        with pytest.raises(P.FormatError):
            P.verify_snapshot(tmp_path / "corrupt.bmsnap")
    with pytest.raises(TPer.FormatError):
        TPer.load(tmp_path / "corrupt.bmsnap", device="cpu", verify=True)


def test_snapshot_info_and_schema_digest(tmp_path):
    ref, tor = _pair(_mixed_bits())
    RPer.save(ref, tmp_path / "r.bmsnap")
    TPer.save(tor, tmp_path / "t.bmsnap")
    ri, ti = RPer.snapshot_info(tmp_path / "r.bmsnap"), TPer.snapshot_info(tmp_path / "t.bmsnap")
    assert ti == ri
    assert ti["kind"] == "tilestore" and ti["n_columns"] == 6
    assert ti["file_bytes"] == os.path.getsize(tmp_path / "t.bmsnap")
    assert ti["schema_digest"] == TPer.schema_digest(tor.names, tor.store.r, TW) \
        == RPer.schema_digest(ref.names, ref.store.r, TW)


def test_extra_meta_keys_reserved(tmp_path):
    _, tor = _pair(_mixed_bits())
    for key in ("r", "format", "sections"):
        with pytest.raises(ValueError):
            TPer.save(tor, tmp_path / "x.bmsnap", extra={key: 1})


# -- bytes across the packages -----------------------------------------------

@pytest.mark.parametrize("containers", [True, False])
def test_port_save_is_byte_identical_to_the_reference(tmp_path, containers):
    ref, tor = _pair(_mixed_bits(seed=3), containers=containers)
    rm = RPer.save(ref, tmp_path / "r.bmsnap")
    tm = tor.save(tmp_path / "t.bmsnap")
    assert tm == rm
    assert (tmp_path / "t.bmsnap").read_bytes() == (tmp_path / "r.bmsnap").read_bytes()
    # a bare store (no names) too
    RPer.save(ref.store, tmp_path / "rb.bmsnap")
    TPer.save(tor.store, tmp_path / "tb.bmsnap")
    assert (tmp_path / "tb.bmsnap").read_bytes() == (tmp_path / "rb.bmsnap").read_bytes()


@pytest.mark.parametrize("containers", [True, False])
def test_round_trip_and_cross_load(tmp_path, containers):
    """Port save -> port load, and reference save -> port load: the same
    store, the same answers, and every save of a load gives the same bytes."""
    ref, tor = _pair(_mixed_bits(seed=3), containers=containers)
    RPer.save(ref, tmp_path / "r.bmsnap")
    tor.save(tmp_path / "t.bmsnap")
    for src in ("r", "t"):
        loaded = TQ.BitmapIndex.load(tmp_path / f"{src}.bmsnap", device="cpu", verify=True)
        assert loaded.names == tor.names
        _assert_same_store(loaded.store, ref.store)
        for make in QUERIES:
            got = u32(loaded.execute(make(TQ)))
            assert np.array_equal(got, u32(ref.execute(make(RQ))))
            assert loaded.last_info == ref.last_info
        loaded.save(tmp_path / f"{src}2.bmsnap")
        assert (tmp_path / f"{src}2.bmsnap").read_bytes() == (tmp_path / "r.bmsnap").read_bytes()
    # the reference loads the port's file to the same store
    back = RPer.load_index(tmp_path / "t.bmsnap", verify=True)
    np.testing.assert_array_equal(np.asarray(back.store.densify()), u32(tor.store.densify()))


def test_save_is_byte_deterministic(tmp_path):
    _, tor = _pair(_mixed_bits(seed=5))
    p1, p2, p3 = (tmp_path / f"{i}.bmsnap" for i in range(3))
    TPer.save(tor, p1)
    TPer.save(tor, p2)
    assert p1.read_bytes() == p2.read_bytes()
    TPer.save(TPer.load_index(p1, device="cpu"), p3)
    assert p3.read_bytes() == p1.read_bytes()


def test_load_is_zero_copy(tmp_path):
    p = tmp_path / "x.bmsnap"
    TPer.save(_pair(_mixed_bits())[1], p)
    store = TPer.load(p, device="cpu")
    for name in ("dense_pack", "sparse_pack", "run_pack"):
        arr = store.packs[name]
        assert not arr.flags.owndata, name
        base = arr
        while not isinstance(base, (np.memmap, mmap.mmap)):
            base = base.base
            assert base is not None, name
    # the all-dense layout adopts the mapped dense pack as the dirty surface
    _, legacy = _pair(_mixed_bits(), containers=False)
    TPer.save(legacy, tmp_path / "legacy.bmsnap")
    lstore = TPer.load(tmp_path / "legacy.bmsnap", device="cpu")
    assert lstore._dirty_np is lstore.packs["dense_pack"]


def test_load_to_device_and_bare_store(tmp_path):
    ref, tor = _pair(_mixed_bits(seed=7))
    p = tmp_path / "bare.bmsnap"
    TPer.save(tor.store, p)
    loaded = TPer.load(p, device="cpu", to_device=True)
    assert loaded._dirty_dev is not None and loaded.device == torch.device("cpu")
    np.testing.assert_array_equal(u32(loaded.densify()), u32(tor.store.densify()))
    for P, kw in ((RPer, {}), (TPer, {"device": "cpu"})):
        with pytest.raises(ValueError):
            P.load_index(p, **kw)


# -- the golden fixture ------------------------------------------------------

def test_golden_fixture_loads_queries_and_resaves_to_its_bytes(tmp_path):
    idx = TQ.BitmapIndex.load(make_golden.FIXTURE, device="cpu", verify=True)
    bits = make_golden.golden_bits()
    r = bits.shape[1]
    assert idx.names == make_golden.NAMES and idx.store.r == r
    dense = np.stack([unpack(idx.store.column(i), r).numpy()
                      for i in range(len(make_golden.NAMES))])
    np.testing.assert_array_equal(dense, bits)
    ref = RPer.load_index(make_golden.FIXTURE)
    for rq, tq, exp in (
        (RQ.Threshold(2), TQ.Threshold(2), bits.sum(0) >= 2),
        (RQ.Interval(1, 3), TQ.Interval(1, 3), (bits.sum(0) >= 1) & (bits.sum(0) <= 3)),
        (RQ.And(RQ.Col("alpha"), RQ.Not(RQ.Col("delta"))),
         TQ.And(TQ.Col("alpha"), TQ.Not(TQ.Col("delta"))), bits[0] & ~bits[3]),
    ):
        got = idx.execute(tq)
        np.testing.assert_array_equal(unpack(got, r).numpy(), exp)
        assert np.array_equal(u32(got), u32(ref.execute(rq)))
        assert idx.last_info == ref.last_info
    idx.save(tmp_path / "resaved.bmsnap")
    assert (tmp_path / "resaved.bmsnap").read_bytes() == Path(make_golden.FIXTURE).read_bytes()


def test_golden_recipe_saved_by_the_port_gives_the_fixture(tmp_path):
    idx = TQ.BitmapIndex.from_dense(make_golden.golden_bits(), make_golden.NAMES,
                                    tile_words=make_golden.TILE_WORDS, containers=True,
                                    device="cpu")
    idx.save(tmp_path / "regen.bmsnap")
    assert (tmp_path / "regen.bmsnap").read_bytes() == Path(make_golden.FIXTURE).read_bytes()


# -- paged tier ----------------------------------------------------------------

def test_paged_store_bit_identical(tmp_path):
    ref, tor = _pair(_mixed_bits(seed=31))
    p = tmp_path / "x.bmsnap"
    TPer.save(tor, p)
    RPer.save(ref, tmp_path / "r.bmsnap")
    tpaged = TPer.PagedTileStore(TPer.load(p, device="cpu"), capacity_tiles=4)
    rpaged = RPer.PagedTileStore(RPer.load(tmp_path / "r.bmsnap"), capacity_tiles=4)
    tidx = TQ.BitmapIndex(names=tor.names, _store=tpaged)
    ridx = RQ.BitmapIndex(names=ref.names, _store=rpaged)
    assert tidx.device == tpaged.device == torch.device("cpu")
    for make in QUERIES[:3]:
        got = u32(tidx.execute(make(TQ)))
        assert np.array_equal(got, u32(ref.execute(make(RQ))))
        assert np.array_equal(got, u32(ridx.execute(make(RQ))))
        assert tidx.last_info == ridx.last_info
    assert len(tpaged._cache) <= 4
    assert tpaged.cache_info() == rpaged.cache_info()


def test_paged_cache_counters_and_merge_engine(tmp_path):
    rng = np.random.default_rng(37)
    bits = rng.random((4, 6 * SPAN)) < 0.3  # dense dirty tiles
    ref, tor = _pair(bits)
    TPer.save(tor, tmp_path / "t.bmsnap")
    RPer.save(ref, tmp_path / "r.bmsnap")
    tpaged = TPer.PagedTileStore(TPer.load(tmp_path / "t.bmsnap", device="cpu"),
                                 capacity_tiles=64)
    rpaged = RPer.PagedTileStore(RPer.load(tmp_path / "r.bmsnap"), capacity_tiles=64)
    tidx = TQ.BitmapIndex(names=tor.names, _store=tpaged)
    ridx = RQ.BitmapIndex(names=ref.names, _store=rpaged)
    for t in (2, 3):
        got = u32(tidx.execute(TQ.Threshold(t), backend="tiled_fused"))
        assert np.array_equal(got, u32(ridx.execute(RQ.Threshold(t), backend="tiled_fused")))
        assert np.array_equal(got, u32(tor.execute(TQ.Threshold(t), backend="tiled_fused")))
        assert tidx.last_info == ridx.last_info and tidx.last_info["engine"] == "merge"
        assert tpaged.cache_info() == rpaged.cache_info()
    info = tpaged.cache_info()
    assert info["misses"] > 0 and info["hits"] > 0 and info["full_materializations"] == 0
    tpaged.densify()
    assert tpaged.cache_info()["full_materializations"] == 1


# -- the device rule -----------------------------------------------------------

def test_new_entry_points_refuse_device_none_without_cuda(tmp_path, monkeypatch):
    """``device=None`` means the CUDA card: without one, every new entry
    point raises RuntimeError instead of running on the CPU."""
    from repro_torch.storage import TileStore
    from repro_torch.stream import StreamingIndex

    bits = _mixed_bits()
    _, tor = _pair(bits)
    p = tmp_path / "x.bmsnap"
    tor.save(p)
    s = StreamingIndex(tor, durable_dir=tmp_path / "durable")
    s.update(sets={"c1": [3]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = [f"c{i}" for i in range(bits.shape[0])]
    calls = {
        "StreamingIndex.from_dense": lambda: StreamingIndex.from_dense(bits, names),
        "StreamingIndex.from_columns": lambda: StreamingIndex.from_columns(
            {"a": np.zeros(4, np.uint32)}),
        "StreamingIndex.recover": lambda: StreamingIndex.recover(tmp_path / "durable"),
        "persist.load": lambda: TPer.load(p),
        "persist.load_index": lambda: TPer.load_index(p),
        "BitmapIndex.load": lambda: TQ.BitmapIndex.load(p),
        "TileStore.from_arrays": lambda: TileStore.from_arrays(
            tor.store.packs | {"classes": tor.store.classes_word,
                               "kinds": tor.store.container_kinds,
                               "cardinalities": np.asarray(tor.store.cardinalities)},
            tile_words=TW, n_words=tor.store.n_words, r=tor.store.r),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
