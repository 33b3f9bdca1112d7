"""The tile-skipping ``tiled_fused`` route of the port against the reference.

The same numpy-seeded bits go into both packages; the reference runs as its
own tests run it on the CPU (XLA scan, and its Pallas grid under
``tiled_scan.FORCE_PALLAS_INTERPRET`` for one case), the port on
``device="cpu"``, where the block stage runs the block kernel's plain
version.  Results are bitmaps, so the tolerance is none: ``np.array_equal``
on ``uint32`` words, and every ``ExecInfo`` field equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import clean_fraction_bits, container_mix_bits, u32
from repro import query as RQ
from repro.core import circuits as RC
from repro.core.bitmaps import pack as r_pack
from repro.kernels import tiled_scan as RK
from repro.query.executors import run_threshold_backend as r_threshold_backend
from repro.storage import TileStore as RStore
from repro.storage import containers as RCont
from repro.storage import run_tiled_circuit as r_run
from repro_torch import query as TQ
from repro_torch.core import circuits as TC
from repro_torch.core.bytecode import OP_LOAD, ProgramTable, compile_circuit, encode_program_table
from repro_torch.convert import index_from_reference_arrays
from repro_torch.kernels import tiled_scan as TK
from repro_torch.kernels.threshold_ssum import _run_program_plain
from repro_torch.storage import TileStore as TStore
from repro_torch.storage import containers as TCont
from repro_torch.storage import run_tiled_circuit as t_run


def mixed_bits(seed=29):
    """Dense / sparse / run / all-zero / all-one / partial-tile mix at 8-word
    tiles (the reference's ``tests/test_storage.py::_mixed_bits``)."""
    rng = np.random.default_rng(seed)
    span8 = 8 * 32
    n, r = 6, 5 * span8 + 41
    bits = np.zeros((n, r), bool)
    bits[0, ::97] = True
    bits[1, 30:700] = True
    bits[2] = rng.random(r) < 0.5
    bits[3, :span8] = True
    bits[4, ::2] = True
    bits[5, span8:2 * span8] = rng.random(span8) < 0.1
    return bits


FIXTURES = {
    "mixed": lambda: mixed_bits(),
    "clean": lambda: clean_fraction_bits(6, 0.8, seed=7),
    "containers": lambda: container_mix_bits(6, seed=11),
    "sparse": lambda: np.random.default_rng(23).random((6, 16 * 2048)) < 20 / 2048,
}


def store_pair(bits, tile_words, containers=True):
    packed = np.asarray(r_pack(jnp.asarray(bits)))
    r = bits.shape[1]
    ref = RStore.from_packed(jnp.asarray(packed), tile_words=tile_words, r=r, containers=containers)
    tor = TStore.from_packed(packed, tile_words=tile_words, r=r, containers=containers, device="cpu")
    return ref, tor


def circuit_pair(kind, n):
    """The same circuit built by each package's own builders."""
    out = []
    for C in (RC, TC):
        if kind == "threshold":
            out.append(C.build_threshold_circuit(n, 2, "ssum"))
        elif kind == "interval":
            out.append(C.build_interval_circuit(n, 2, 4))
        else:  # three outputs: two thresholds and a parity
            c = C.Circuit(n, [], [])
            w = C.sideways_sum_bits(c, list(range(n)))
            c.outputs = [C.ge_const(c, w, 1), C.ge_const(c, w, 3), w[0]]
            out.append(c.optimized())
    return out


# every fixture x tile width x containers on/off with a single- and a
# multi-output circuit; the interval circuit on the mixed fixture only
CASES = [
    (fixture, tw, containers, kind)
    for fixture in sorted(FIXTURES)
    for tw in (8, 64)
    for containers in (True, False)
    for kind in ("threshold", "interval", "multi")
    if kind != "interval" or (fixture == "mixed" and containers)
]


@pytest.mark.parametrize("fixture,tw,containers,kind", CASES)
def test_run_tiled_circuit_scan_merge_reference(fixture, tw, containers, kind):
    bits = FIXTURES[fixture]()
    ref, tor = store_pair(bits, tw, containers)
    rc, tc = circuit_pair(kind, bits.shape[0])
    want, want_info = r_run(ref, rc, engine="scan")
    want = np.asarray(want)
    for engine in ("scan", "merge"):
        got, info = t_run(tor, tc, engine=engine)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(u32(got), want), engine
        assert info["launches"] <= 2 or engine == "merge"
        if engine == "scan":
            assert info == want_info
        else:
            _out, ref_merge = r_run(ref, rc, engine="merge")
            assert info == ref_merge
    # a cached scan plan replays with the same info
    again, info = t_run(tor, tc, engine="scan")
    assert np.array_equal(u32(again), want) and info == want_info
    # restricted evaluation, the partial last tile included
    tiles = np.unique([0, tor.n_tiles // 2, tor.n_tiles - 1])
    want_r, want_ri = r_run(ref, rc, tiles=tiles, engine="scan")
    for engine in ("scan", "merge"):
        got_r, ri = t_run(tor, tc, tiles=tiles, engine=engine)
        assert tuple(got_r.shape) == (len(tc.outputs), tiles.size, tw)
        assert np.array_equal(u32(got_r), np.asarray(want_r, np.uint32)), engine
        if engine == "scan":
            assert ri == want_ri


def test_scan_engine_covers_both_stages_and_every_kind():
    """The fixtures above do reach the event stage, the block stage, and
    all three container kinds in the block decode."""
    ref, tor = store_pair(FIXTURES["containers"](), 64)
    rc, tc = circuit_pair("threshold", 6)
    _out, info = t_run(tor, tc, engine="scan")
    assert info["event_tiles"] > 0 and info["densified_tiles"] > 0 and info["launches"] == 2
    assert all(info["words_by_kind"][k] > 0 for k in ("dense", "sparse", "run"))
    assert info == r_run(ref, rc, engine="scan")[1]


def test_block_stage_through_the_reference_pallas_grid():
    """The reference's Pallas grid kernel (interpret mode) against the port."""
    bits = mixed_bits(seed=31)
    ref, tor = store_pair(bits, 8)
    rc, tc = (C.build_threshold_circuit(6, 3, "ssum") for C in (RC, TC))
    RK.FORCE_PALLAS_INTERPRET = True
    RK.clear_scan_runners()
    try:
        want, _ = r_run(ref, rc, engine="scan")
    finally:
        RK.FORCE_PALLAS_INTERPRET = False
        RK.clear_scan_runners()
    got, _ = t_run(tor, tc, engine="scan")
    assert np.array_equal(u32(got), np.asarray(want))


# ---------------------------------------------------------------------------
# a seeded port of tests/test_containers_fuzz.py::test_scan_engine_differential
# ---------------------------------------------------------------------------

FUZZ_TW = 8
FUZZ_SPAN = FUZZ_TW * 32
KINDS = ("dense", "sparse", "runny", "all_zero", "all_one", "mixed")


def _fuzz_column(rng, kind, r):
    bits = np.zeros(r, bool)
    if kind == "all_one":
        bits[:] = True
    elif kind == "dense":
        bits[:] = rng.random(r) < 0.5
    elif kind == "sparse":
        k = int(rng.integers(1, max(2, r // 64)))
        bits[rng.choice(r, min(k, r), replace=False)] = True
    elif kind == "runny":
        for _ in range(int(rng.integers(1, 5))):
            a = int(rng.integers(0, r))
            bits[a:int(rng.integers(a + 1, r + 1))] = True
    elif kind == "mixed":
        for t0 in range(0, r, FUZZ_SPAN):
            bits[t0:t0 + FUZZ_SPAN] = _fuzz_column(
                rng, KINDS[int(rng.integers(0, 4))], min(FUZZ_SPAN, r - t0))
    return bits


def _fuzz_expr(rng, Q, n, depth=2):
    """A random query tree over c0..c{n-1}, drawn from ``rng``; ``Q`` is
    either package's query module (same draws give the same tree)."""
    if depth == 0 or rng.random() < 0.5:
        over = None
        if rng.random() < 0.5:
            k = int(rng.integers(1, n + 1))
            over = tuple(Q.Col(f"c{i}") for i in sorted(rng.permutation(n)[:k]))
        m = len(over) if over is not None else n
        leaf = int(rng.integers(0, 4))
        if leaf == 0:
            return Q.Threshold(int(rng.integers(0, m + 2)), over=over)
        if leaf == 1:
            lo = int(rng.integers(0, m + 1))
            return Q.Interval(lo, int(rng.integers(lo, m + 2)), over=over)
        if leaf == 2:
            return Q.Parity(over=over)
        ws = tuple(int(x) for x in rng.integers(0, 5, m))
        if not any(ws):
            ws = (1,) + ws[1:]
        return Q.Weighted(ws, int(rng.integers(1, sum(ws) + 2)), over=over)
    op = int(rng.integers(0, 4))
    a = _fuzz_expr(rng, Q, n, depth - 1)
    if op == 2:
        return ~a
    b = _fuzz_expr(rng, Q, n, depth - 1)
    return (a & b, a | b, None, a - b)[op]


def _oracle(q, bits):
    def members(over):
        return bits if over is None else np.stack([_oracle(m, bits) for m in over])

    if isinstance(q, TQ.Col):
        return bits[int(q.name[1:])]
    if isinstance(q, TQ.Threshold):
        return members(q.over).sum(0) >= q.t
    if isinstance(q, TQ.Interval):
        c = members(q.over).sum(0)
        return (c >= q.lo) & (c <= q.hi)
    if isinstance(q, TQ.Parity):
        return members(q.over).sum(0) % 2 == 1
    if isinstance(q, TQ.Weighted):
        return (members(q.over) * np.asarray(q.weights)[:, None]).sum(0) >= q.t
    if isinstance(q, TQ.And):
        return np.logical_and.reduce([_oracle(c, bits) for c in q.children])
    if isinstance(q, TQ.Or):
        return np.logical_or.reduce([_oracle(c, bits) for c in q.children])
    if isinstance(q, TQ.Not):
        return ~_oracle(q.child, bits)
    if isinstance(q, TQ.AndNot):
        return _oracle(q.keep, bits) & ~_oracle(q.drop, bits)
    raise TypeError(type(q))


@pytest.mark.parametrize("seed", range(12))
def test_scan_engine_differential_seeded(seed, monkeypatch):
    from repro.query.index import circuit_for as r_circuit_for
    from repro_torch.core.bitmaps import unpack
    from repro_torch.query.index import circuit_for as t_circuit_for

    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    n_tiles = int(rng.integers(1, 5))
    tail = int(rng.choice([0, 1, 37, FUZZ_SPAN // 2]))
    r = n_tiles * FUZZ_SPAN + tail
    bits = np.stack([_fuzz_column(rng, KINDS[int(rng.integers(0, 6))], r) for _ in range(n)])
    qseed = int(rng.integers(0, 2**31))
    rq = _fuzz_expr(np.random.default_rng(qseed), RQ, n)
    tq = _fuzz_expr(np.random.default_rng(qseed), TQ, n)
    assert rq.key() == tq.key()
    expect = _oracle(tq, bits)
    names = tuple(f"c{i}" for i in range(n))
    for containers in (True, False):
        ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits), tile_words=FUZZ_TW, containers=containers)
        tor = index_from_reference_arrays(np.asarray(ref.columns), names, r, tile_words=FUZZ_TW,
                                          containers=containers, device="cpu")
        want = np.asarray(ref.execute(rq, backend="tiled_fused"))
        want_info = ref.last_info
        for engine in ("scan", "merge"):
            monkeypatch.setenv("REPRO_TILED_ENGINE", engine)  # the override both packages read
            got = tor.execute(tq, backend="tiled_fused")
            monkeypatch.delenv("REPRO_TILED_ENGINE")
            assert np.array_equal(unpack(got, r).numpy(), expect), (containers, engine, tq.key())
            assert np.array_equal(u32(got), want)
            if engine == "scan":
                assert tor.last_info == want_info
        store = tor.store
        tiles = np.asarray(sorted(set(rng.integers(0, store.n_tiles, store.n_tiles).tolist())))
        rc = r_circuit_for((rq,), n, names)
        tc = t_circuit_for((tq,), n, names)
        out_s, info_s = t_run(store, tc, tiles=tiles, engine="scan")
        out_m, _ = t_run(store, tc, tiles=tiles, engine="merge")
        want_r, want_ri = r_run(ref.store, rc, tiles=tiles, engine="scan")
        assert np.array_equal(u32(out_s), u32(out_m))
        assert np.array_equal(u32(out_s), np.asarray(want_r, np.uint32))
        assert info_s == want_ri and info_s["launches"] <= 2


# ---------------------------------------------------------------------------
# the pieces: event stage, prefix-XOR, packs and gathers, program table
# ---------------------------------------------------------------------------


def test_event_runner_against_the_reference_on_the_same_arrays():
    """The port's event stage (torch ops) and the reference's jitted one run
    on the same host-built plan arrays (the reference's padded layout is
    made from the port's)."""
    ref, tor = store_pair(FIXTURES["sparse"](), 8)
    k = 2
    tc = TC.Circuit(6, [], [])
    w = TC.sideways_sum_bits(tc, list(range(6)))
    tc.outputs = [TC.ge_const(tc, w, 1), TC.ge_const(tc, w, 2)]
    tc = tc.optimized()
    _out, info = t_run(tor, tc, engine="scan")
    assert info["event_tiles"] > 0
    plan, _tmpl = next(iter(tor._scan_plan_cache.values()))
    st = plan["event"]
    n_sel, tw = plan["n_sel"], plan["tw"]
    n_rows = st.gid_row.numel()
    G = st.lut.numel() // (st.k_max * st.mm)
    stride = tw * 32 + 2
    e_pad = RK.next_pow2(st.keys.numel())
    keys = RK.pad_to(st.keys.numpy().astype(np.int32), e_pad, n_rows * stride)
    mask = RK.pad_to(st.mask.numpy().view(np.uint32), e_pad, 0)
    gid_row = np.append(st.gid_row.numpy().astype(np.int32), G)
    lut = np.concatenate([st.lut.numpy(), np.zeros(st.k_max * st.mm, np.uint8)])
    out_dst = np.full((st.k_max, n_rows + 1), n_sel, np.int32)
    src, d = st.out_src.numpy(), st.out_dst.numpy()
    out_dst[src // n_rows, src % n_rows] = (d // n_sel) * (n_sel + 1) + d % n_sel
    fn = RK.event_runner(st.k_max, st.mm, tw)
    want = fn(jnp.zeros((k, n_sel + 1), jnp.uint32), jnp.asarray(keys), jnp.asarray(mask),
              jnp.asarray(gid_row), jnp.asarray(lut), jnp.asarray(out_dst))
    buf = torch.zeros((k, n_sel, tw), dtype=torch.int32)
    TK.event_runner(buf, st)
    assert np.array_equal(u32(buf), np.asarray(want)[:, :n_sel])


@pytest.mark.parametrize("tw", [1, 8, 64])
def test_prefix_xor_words_with_bit_31(tw):
    rng = np.random.default_rng(tw)
    t = rng.integers(0, 2**32, (5, tw + 1), dtype=np.uint32)
    t[:, 0] |= np.uint32(0x80000000)
    got = TK._prefix_xor_words(torch.from_numpy(t.view(np.int32)))
    want = RK._prefix_xor_words(jnp.asarray(t))
    assert np.array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("tw", [8, 64])
def test_packs_and_gathers_equal_reference(tw):
    ref, tor = store_pair(FIXTURES["containers"](), tw)
    rp, tp = ref.packs, tor.packs
    assert sorted(rp) == sorted(tp)
    for key in rp:
        assert np.array_equal(rp[key], tp[key]) and rp[key].dtype == tp[key].dtype, key
    for r_arr, t_arr in zip(ref.device_packs(), tor.device_packs()):
        r_np = np.asarray(r_arr)
        t_np = t_arr.numpy().view(np.uint32) if t_arr.dtype == torch.int32 else t_arr.numpy()
        assert np.array_equal(r_np, t_np) and t_np.dtype == r_np.dtype
    assert tor.device_packs()[0][-1].eq(-1).all() and tor.device_packs()[0][-2].eq(0).all()
    assert np.array_equal(u32(tor.dirty), np.asarray(ref.dirty))
    rng = np.random.default_rng(tw)
    cols = rng.integers(0, tor.n, 200)
    tiles = rng.integers(0, tor.n_tiles + 2, 200)  # past the end reads zero
    assert np.array_equal(tor.gather_cells(cols, tiles), ref.gather_cells(cols, tiles))
    kinds = tor.container_kinds
    cc, tt = np.nonzero((kinds == TCont.CONT_SPARSE) | (kinds == TCont.CONT_RUN))
    for a, b in zip(tor.gather_events(cc, tt), ref.gather_events(cc, tt)):
        assert np.array_equal(a, b)


def test_event_oracle_functions_equal_reference():
    rng = np.random.default_rng(3)
    for n_inputs in (1, 3, 5):
        tt = int(rng.integers(0, 2 ** (1 << n_inputs)))
        assert np.array_equal(TCont.truth_table_bits(tt, n_inputs), RCont.truth_table_bits(tt, n_inputs))
    m, tw, n_inputs = 4, 8, 3
    rows = rng.integers(0, m, 60)
    pos = rng.integers(0, tw * 32 + 1, 60)
    wires = rng.integers(0, n_inputs, 60)
    tables = (0b10010110, 0b11101000)
    assert np.array_equal(
        TCont.evaluate_event_tiles(rows, pos, wires, m, tw, tables, n_inputs),
        RCont.evaluate_event_tiles(rows, pos, wires, m, tw, tables, n_inputs),
    )


@pytest.mark.parametrize("kind", ["threshold", "interval", "multi"])
def test_program_table_runs_preloaded(kind):
    """Residual programs read their inputs from slots 0..m-1 (no LOAD), pad
    missing outputs with a zero slot, and the one plain interpreter runs
    them to the circuit's own values."""
    _rc, c1 = circuit_pair(kind, 7)
    c2 = TC.build_threshold_circuit(4, 2, "ssum")
    k_max = max(len(c1.outputs), len(c2.outputs)) + 1
    table = encode_program_table((c1, c2), k_max)
    assert table.groups.shape == (2, 4) and table.outs.shape == (2, k_max)
    assert not (table.prog[:, 0] == OP_LOAD).any()
    rng = np.random.default_rng(1)
    for g, circ in enumerate((c1, c2)):
        prog, outs, n_regs, m = table.program(g)
        assert m == circ.n_inputs and n_regs >= m
        x = torch.from_numpy(rng.integers(0, 2**32, (m, 33), dtype=np.uint32).view(np.int32))
        got = _run_program_plain(x, prog, outs, n_regs, preloaded=True)
        want = circ.evaluate(list(x))
        for j in range(k_max):
            expect = want[j] if j < len(want) else torch.zeros_like(x[0])
            assert torch.equal(got[j], expect), (g, j)
    assert compile_circuit(c1, preloaded=True).loaded_inputs == ()
    assert TK.program_table((c1, c2), k_max) is TK.program_table((c1, c2), k_max)


def _table(n_registers, m=8, n_rows=40):
    """A one-group program table of that shape (its instructions unused)."""
    return ProgramTable(prog=np.zeros((n_rows, 4), np.int32),
                        groups=np.array([[0, n_rows, n_registers, m]], np.int32),
                        outs=np.zeros((1, 1), np.int32), k_max=1)


def test_pick_tile_block_fits_shared_memory():
    assert TK.pick_tile_block(64, _table(60), 1000) == 4  # 256 words a block
    assert TK.pick_tile_block(8, _table(60), 1000) == 32
    assert TK.pick_tile_block(8, _table(60), 3) == 4  # never wider than a group needs
    assert TK.pick_tile_block(64, _table(200), 1000) == 4
    assert TK.pick_tile_block(64, _table(400), 1000) == 2  # a large register file halves B
    # the staged cell descriptors and program rows count too (at most
    # STAGED_ROWS rows of a program)
    assert TK.block_shared_bytes(4, 64, 214, 8, 40) <= TK.SHARED_BYTES
    assert TK.block_shared_bytes(4, 64, 214, 214, 4000) > TK.SHARED_BYTES
    assert TK.pick_tile_block(64, _table(214, m=8, n_rows=4000), 1000) == 4
    assert TK.pick_tile_block(64, _table(214, m=214, n_rows=4000), 1000) == 2
    with pytest.raises(ValueError, match="n_registers"):
        TK.pick_tile_block(1024, _table(100), 10)


# ---------------------------------------------------------------------------
# through the planner and the executors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clean_pair():
    bits = clean_fraction_bits(8, 0.9, seed=9)
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits))
    tor = index_from_reference_arrays(np.asarray(ref.columns), ref.names, ref.r, device="cpu")
    return bits, ref, tor


def _queries(Q, names):
    return {
        "threshold_3": Q.Threshold(3),
        "interval_2_5": Q.Interval(2, 5),
        "subset": Q.Threshold(2, over=names[1:6]),
        "composite": (Q.Threshold(2, over=names[:4]) & ~Q.Col(names[4])) | Q.Parity(over=names[5:8]),
    }


@pytest.mark.parametrize("name", ["threshold_3", "interval_2_5", "subset", "composite"])
def test_execute_and_count_plan_tiled_fused_like_the_reference(clean_pair, name):
    _bits, ref, tor = clean_pair
    rq, tq = _queries(RQ, ref.names)[name], _queries(TQ, tor.names)[name]
    rp, tp = ref.explain(rq), tor.explain(tq)
    assert (tp.algorithm, tp.cost, tp.candidates) == (rp.algorithm, rp.cost, rp.candidates)
    assert tp.algorithm == "tiled_fused"
    want = np.asarray(ref.execute(rq))
    got = tor.execute(tq)
    assert np.array_equal(u32(got), want)
    assert tor.last_info == ref.last_info and tor.last_info["backend"] == "tiled_fused"
    assert tor.count(tq) == ref.count(rq)


def test_execute_many_batches_one_tiled_dispatch(clean_pair):
    _bits, ref, tor = clean_pair
    rqs = [RQ.Threshold(2), RQ.Threshold(5), RQ.Interval(3, 6)]
    tqs = [TQ.Threshold(2), TQ.Threshold(5), TQ.Interval(3, 6)]
    assert all(tor.explain(q).algorithm == "tiled_fused" for q in tqs)
    want = [np.asarray(x) for x in ref.execute_many(rqs)]
    got = tor.execute_many(tqs)
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), w)
    assert tor.last_info == ref.last_info
    assert tor.last_info["n_outputs"] == 3 and tor.last_info["launches"] <= 2


def test_run_threshold_backend_tiled_fused(clean_pair):
    _bits, ref, tor = clean_pair
    cols = np.asarray(ref.columns)
    for t in (1, 3, 8):
        want = np.asarray(r_threshold_backend(jnp.asarray(cols), t, "tiled_fused"))
        got = TQ.run_threshold_backend(tor.columns, t, "tiled_fused")
        assert np.array_equal(u32(got), want), t
        got = TQ.run_threshold_backend(cols, t, "tiled_fused", device="cpu")
        assert np.array_equal(u32(got), want), t


def test_constant_circuit_touches_no_data(clean_pair):
    _bits, ref, tor = clean_pair
    outs = []
    for C, store, run in ((RC, ref.store, r_run), (TC, tor.store, t_run)):
        c = C.Circuit(store.n, [], [])
        c.outputs = [C.CONST1, C.CONST0]
        out, info = run(store, c)
        assert info["const_tiles"] == store.n_tiles and info["launches"] == 0
        outs.append(u32(out))
    assert np.array_equal(outs[0], outs[1])


def test_tiled_engine_override_reaches_the_merge_oracle(clean_pair):
    _bits, ref, tor = clean_pair
    from repro_torch.query.executors import ShardContext, run_plan

    q = TQ.Interval(2, 5)
    ctx = ShardContext(n=tor.n, dense=lambda: tor.columns, store=lambda: tor.store,
                       circuit=lambda: tor._circuit_for((q,)), tiled_engine="merge")
    out, info = run_plan(ctx, "tiled_fused")
    assert info["engine"] == "merge"
    assert np.array_equal(u32(tor._mask(out)), np.asarray(ref.execute(RQ.Interval(2, 5))))
    with pytest.raises(ValueError, match="engine"):
        t_run(tor.store, tor._circuit_for((q,)), engine="nope")
