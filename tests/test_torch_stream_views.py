"""Materialized views, schema growth and the overlay's own surfaces of the
port's streaming engine, against the reference.

Same bits, same mutations in both packages (the port on ``device="cpu"``);
view words, ``count``, ``last_refresh_info`` (``view_info``), versions and
the overlay's dense view are held equal; ``TileStore.apply_tile_updates``
is held against a ``TileStore.from_packed`` rebuild of the mutated words.
The tolerance is none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import container_mix_bits, same_answer, stream_pair, u32
from repro import query as RQ
from repro.core.bitmaps import pack as r_pack
from repro.storage import TileStore as RStore
from repro_torch import query as TQ
from repro_torch.core.bitmaps import unpack
from repro_torch.storage import TileStore as TStore

SPAN = 64 * 32


def _bits(n, r, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, r)) < density


def _view_bits(s, name):
    return unpack(s.column(name), s.r).numpy()


def _same_view(ref, tor, name, want=None):
    got = u32(tor.column(name))
    assert np.array_equal(got, u32(ref.column(name))), name
    assert tor.count(name) == ref.count(name)
    assert tor.view_info(name) == ref.view_info(name)
    assert tor.version == ref.version and tor.column_versions == ref.column_versions
    if want is not None:
        assert np.array_equal(_view_bits(tor, name), want)
        assert tor.count(name) == int(want.sum())


# ---------------------------------------------------------------------------
# Materialized views
# ---------------------------------------------------------------------------

N, R = 6, 6 * SPAN + 123


def test_view_freshness_after_each_mutation_kind():
    bits = _bits(N, R, seed=21)
    ref, tor = stream_pair(bits)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("mid", M.Interval(2, 4))
    mut = bits.copy()

    def fresh():
        counts = mut.sum(0)
        _same_view(ref, tor, "mid", (counts >= 2) & (counts <= 4))

    fresh()
    cleared = np.arange(0, 2000, 3)
    for s in (ref, tor):
        s.set_bits("c0", [9, SPAN + 9])
    mut[0, [9, SPAN + 9]] = True
    fresh()
    for s in (ref, tor):
        s.clear_bits("c1", cleared)
    mut[1, cleared] = False
    fresh()
    for s in (ref, tor):
        s.set_bits("c2", [42])
        s.clear_bits("c2", [42])
    mut[2, 42] = False
    fresh()
    app = _bits(N, SPAN, density=0.5, seed=22)
    for s in (ref, tor):
        s.append_rows(app)
    mut = np.concatenate([mut, app], axis=1)
    fresh()
    assert ref.compact() is True and tor.compact() is True
    fresh()


def test_refresh_touches_only_mutated_tiles():
    bits = _bits(N, R, seed=23)
    ref, tor = stream_pair(bits)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("mid", M.Interval(2, 4))
    for s in (ref, tor):
        s.set_bits("c3", [2 * SPAN + 5])
        s.refresh()
    info = tor.view_info("mid")
    assert info == ref.view_info("mid")
    assert info["tiles_refreshed"] == 1
    assert info["words_touched"] <= (N + 1) * tor.tile_words
    for s in (ref, tor):
        s.refresh()
    assert tor.view_info("mid") == ref.view_info("mid")


def test_view_binds_member_set_at_registration():
    bits = _bits(3, 2 * SPAN, seed=24)
    ref, tor = stream_pair(bits)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("two", M.Threshold(2))
        s.materialize("any", M.Threshold(1))
    counts = bits.sum(0)
    _same_view(ref, tor, "two", counts >= 2)
    _same_view(ref, tor, "any", counts >= 1)
    assert tor.views == ref.views == ("two", "any")


def test_view_over_view_chains():
    bits = _bits(4, 2 * SPAN + 77, seed=25)
    ref, tor = stream_pair(bits)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("two", M.Threshold(2))
        s.materialize("promo", M.And(M.Col("two"), M.Col("c0")))
    mut = bits.copy()
    for s in (ref, tor):
        s.set_bits("c1", [5, SPAN + 5])
    mut[1, [5, SPAN + 5]] = True
    counts = mut.sum(0)
    _same_view(ref, tor, "promo", (counts >= 2) & mut[0])
    _same_view(ref, tor, "two", counts >= 2)


def test_view_with_true_at_zero_weight_masks_padding():
    r = SPAN + 100
    bits = _bits(3, r, seed=29)
    ref, tor = stream_pair(bits)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("mid", M.Interval(0, 1))
    mut = bits.copy()
    for s in (ref, tor):
        s.set_bits("c0", [r - 1])
    mut[0, r - 1] = True
    _same_view(ref, tor, "mid", mut.sum(0) <= 1)


def test_constant_view_extends_over_appended_rows():
    r = SPAN + 40
    bits = _bits(3, r, seed=30)
    ref, tor = stream_pair(bits)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("always", M.Threshold(0))
    assert tor.count("always") == ref.count("always") == r
    app = _bits(3, 60, seed=31)
    for s in (ref, tor):
        s.append_rows(app)
    _same_view(ref, tor, "always", np.ones(r + 60, bool))
    for s in (ref, tor):
        s.compact()
    _same_view(ref, tor, "always", np.ones(r + 60, bool))


def test_views_cannot_be_mutated_directly():
    ref, tor = stream_pair(_bits(3, SPAN, seed=26))
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("mid", M.Interval(1, 2))
        with pytest.raises(ValueError):
            s.set_bits("mid", [0])
        with pytest.raises(ValueError):
            s.materialize("mid", M.Threshold(1))


def test_views_refresh_through_the_overlay_queries():
    """A query that reads a view column sees the refreshed words, and the
    overlay's plan and last_info equal the reference's."""
    bits = _bits(5, 5 * SPAN + 9, seed=27)
    ref, tor = stream_pair(bits)
    for s, M in ((ref, RQ), (tor, TQ)):
        s.materialize("mid", M.Interval(2, 4))
    rng = np.random.default_rng(28)
    pos = rng.integers(0, bits.shape[1], 64)
    for s in (ref, tor):
        s.set_bits("c4", pos)
    same_answer(ref, tor, lambda M: M.And(M.Col("mid"), M.Not(M.Col("c0"))))
    same_answer(ref, tor, lambda M: M.Col("mid"))
    assert tor.view_info("mid") == ref.view_info("mid")
    assert tor.view_info("mid")["tiles_refreshed"] <= np.unique(pos // SPAN).size


# ---------------------------------------------------------------------------
# Schema growth and row ranges
# ---------------------------------------------------------------------------


def test_add_data_column_then_mutate():
    bits = _bits(4, 2 * SPAN + 100, seed=17)
    ref, tor = stream_pair(bits)
    for s in (ref, tor):
        assert "c9" not in s
        s.add_data_column("c9")
        assert "c9" in s
    assert tor.count(TQ.Col("c9")) == ref.count(RQ.Col("c9")) == 0
    rows = [0, SPAN + 5, tor.r - 1]
    for s in (ref, tor):
        s.update(sets={"c9": rows})
    same_answer(ref, tor, lambda M: M.Col("c9"))
    assert unpack(tor.execute(TQ.Col("c9")), tor.r).numpy().nonzero()[0].tolist() == sorted(rows)
    oracle = np.concatenate([bits, np.zeros((1, bits.shape[1]), bool)])
    oracle[4, rows] = True
    got = same_answer(ref, tor, lambda M: M.Threshold(2, over=["c0", "c1", "c9"]))
    assert np.array_equal(unpack(torch.from_numpy(got.view(np.int32)), tor.r)
                          .numpy(), oracle[[0, 1, 4]].sum(0) >= 2)
    assert tor.version == ref.version and tor.names == ref.names


def test_add_data_column_with_payload_and_validation():
    bits = _bits(3, SPAN + 40, seed=18)
    ref, tor = stream_pair(bits)
    payload = np.zeros(tor.index().n_words, np.uint32)
    payload[0] = 0b1011
    for s in (ref, tor):
        s.add_data_column("extra", payload)
        with pytest.raises(ValueError):
            s.add_data_column("c0")
    assert tor.count(TQ.Col("extra")) == ref.count(RQ.Col("extra")) == 3
    same_answer(ref, tor, lambda M: M.Col("extra"))


def test_add_data_column_flushes_pending_appends():
    bits = _bits(3, 300, seed=20)
    ref, tor = stream_pair(bits)
    for s in (ref, tor):
        s.append_rows({"c0": np.ones(40, bool)})
        s.add_data_column("late")
    assert tor.r == ref.r == 340
    assert tor.count(TQ.Col("c0")) == ref.count(RQ.Col("c0")) == int(bits[0].sum()) + 40
    assert tor.count(TQ.Col("late")) == 0 and tor.compactions == ref.compactions


def test_append_rows_returns_row_range():
    bits = _bits(2, 150, seed=21)
    ref, tor = stream_pair(bits)
    for args, want in (({}, (150, 150)), ({"c1": np.array([True, False, True])}, (150, 153)),
                       ({"c0": np.ones(5, bool)}, (153, 158))):
        assert ref.append_rows(args) == tor.append_rows(args) == want
    same_answer(ref, tor, lambda M: M.Col("c1"))
    same_answer(ref, tor, lambda M: M.Threshold(1))


# ---------------------------------------------------------------------------
# The overlay's dense view, compaction against a rebuild, the engine choice
# ---------------------------------------------------------------------------


def test_overlay_densify_equals_the_reference():
    """The port patches the dense view on the device; the reference builds
    it on the host.  A patched partial last tile, appended tiles past the
    base's range, an all-one tile cleared and an all-zero tile set."""
    r = 3 * SPAN + 700
    bits = _bits(4, r, seed=50)
    bits[2, SPAN:2 * SPAN] = True  # an all-one tile
    bits[3, :SPAN] = False  # an all-zero tile
    ref, tor = stream_pair(bits)
    for s in (ref, tor):
        s.set_bits("c0", [r - 1, r - 33])  # the partial last tile
        s.clear_bits("c2", np.arange(SPAN, 2 * SPAN))  # all-one -> all-zero
        s.set_bits("c3", [5])
    dense_r = np.asarray(ref.index().store.densify(), np.uint32)
    dense_t = u32(tor.index().store.densify())
    assert dense_t.shape == dense_r.shape and np.array_equal(dense_t, dense_r)
    app = _bits(4, 2 * SPAN + 77, density=0.3, seed=51)
    for s in (ref, tor):
        s.append_rows(app)
    dense_r = np.asarray(ref.index().store.densify(), np.uint32)
    dense_t = u32(tor.index().store.densify())
    assert dense_t.shape == dense_r.shape == (4, (r + app.shape[1] + 31) // 32)
    assert np.array_equal(dense_t, dense_r)
    same_answer(ref, tor, lambda M: M.Threshold(2), backend="fused")


@pytest.mark.parametrize("tile_words", [8, 64])
def test_apply_tile_updates_equals_a_rebuild(tile_words):
    """Reclassified tiles, container kinds, packs and cardinalities of the
    tile-granular merge equal a from-scratch classification of the mutated
    words -- and the reference's merge."""
    bits = container_mix_bits(5, seed=52, n_tiles=6, tail_bits=333)
    r = bits.shape[1]
    rng = np.random.default_rng(53)
    packed = np.asarray(r_pack(jnp.asarray(bits)), np.uint32)
    tstore = TStore.from_packed(packed, tile_words=tile_words, r=r, device="cpu")
    rstore = RStore.from_packed(jnp.asarray(packed), tile_words=tile_words, r=r)
    r_new = r + 3 * tile_words * 32 + 5
    nw_new = (r_new + 31) // 32
    mutated = np.zeros((5, -(-nw_new // tile_words) * tile_words), np.uint32)
    mutated[:, :packed.shape[1]] = packed
    n_tiles_new = mutated.shape[1] // tile_words
    updates: dict = {}
    for col in range(4):  # column 4 stays untouched
        for t in rng.choice(n_tiles_new, 4, replace=False).tolist():
            words = rng.integers(0, 2**32, tile_words, dtype=np.uint32)
            kind = rng.integers(0, 4)
            if kind == 0:
                words[:] = 0
            elif kind == 1:
                words[:] = 0xFFFFFFFF
            elif kind == 2:
                words &= rng.integers(0, 2**32, tile_words, dtype=np.uint32) & \
                    np.uint32(0x00010001)
            lo = t * tile_words
            valid = np.clip(nw_new - lo, 0, tile_words)
            words[valid:] = 0
            if lo + valid == nw_new and r_new % 32:
                words[valid - 1] &= np.uint32((1 << (r_new % 32)) - 1)
            updates.setdefault(col, {})[t] = words
            mutated[col, lo:lo + tile_words] = words
    got = tstore.apply_tile_updates(updates, r=r_new)
    rebuilt = TStore.from_packed(mutated[:, :nw_new], tile_words=tile_words, r=r_new,
                                 device="cpu")
    ref = rstore.apply_tile_updates(updates, r=r_new)
    assert got._cols[4].classes is not tstore._cols[4].classes  # grew
    for want in (rebuilt, ref):
        for name in ("classes_word", "container_kinds", "storage_words_cell"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), name
        assert got.cardinalities == want.cardinalities
        for key, arr in want.packs.items():
            assert np.array_equal(got.packs[key], arr), key
    assert np.array_equal(u32(got.densify()), mutated[:, :nw_new])
    same = tstore.apply_tile_updates({0: {0: tstore.gather_cells([0], [0])[0]}})
    assert same._cols[1] is tstore._cols[1]
    with pytest.raises(ValueError):
        tstore.apply_tile_updates({}, r=r - 1)
    with pytest.raises(ValueError):
        tstore.apply_tile_updates({0: {n_tiles_new + 5: np.zeros(tile_words, np.uint32)}})


def test_engine_choice_merge_on_the_overlay_scan_after_compaction():
    bits = np.zeros((4, 8 * SPAN + 50), bool)
    rng = np.random.default_rng(54)
    bits[:, :SPAN] = rng.random((4, SPAN)) < 0.3
    bits[1, 3 * SPAN:5 * SPAN] = True
    ref, tor = stream_pair(bits)
    for s in (ref, tor):
        s.set_bits("c2", [4 * SPAN + 1, 7 * SPAN + 3])
    same_answer(ref, tor, lambda M: M.Threshold(2), backend="tiled_fused")
    assert tor.index().last_info["engine"] == "merge"
    assert not hasattr(tor.index().store, "device_packs")
    for s in (ref, tor):
        s.compact()
    same_answer(ref, tor, lambda M: M.Threshold(2), backend="tiled_fused")
    assert tor.index().last_info["engine"] == "scan"
