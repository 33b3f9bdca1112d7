"""The tiled block stage's plain version on synthetic plans, checked on the CPU.

``tiled_scan.block_plain`` is what runs for CPU tensors and what the block
kernel is held to on the card.  Here it runs on block-stage plans built from
numpy-seeded stores (tile widths 1, 8, 64 and 1,536; 1 to 64 inputs; 1 and 4
outputs; 1 to 3 groups; every cell kind; mostly clean, all-dense and
all-clean blocks; a wide register file; programs longer than the rows a block
stages) and is held against an oracle that shares only the plan with it: each
cell's words are cut from the reference's packing of its column, each group's
circuit is rebuilt in the reference package and evaluated there gate by
gate, and each output goes where ``dst`` says.  On clustered stores the
whole scan engine runs against the reference's ``run_tiled_circuit`` with
every ``ExecInfo`` field equal.  Bitmaps: no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import u32
from repro.core import circuits as RC
from repro.core.bitmaps import pack as r_pack
from repro.storage import run_tiled_circuit as r_run
from repro_torch.core import circuits as TC
from repro_torch.core.bytecode import ProgramTable
from repro_torch.kernels import tiled_scan as TK
from repro_torch.storage import TileStore
from repro_torch.storage import run_tiled_circuit as t_run
from repro_torch.storage.tiled import cell_descriptors
from test_torch_tiled import circuit_pair, store_pair


def mixed_tile_bits(rng, n, n_tiles, tw):
    """bool[n, n_tiles * tw * 32]: each tile of each column all-zero,
    all-one, sparse, a few runs, or dense."""
    span = tw * 32
    bits = np.zeros((n, n_tiles * span), bool)
    for i in range(n):
        for t, kind in enumerate(rng.integers(0, 5, n_tiles)):
            lo, hi = t * span, (t + 1) * span
            if kind == 1:
                bits[i, lo:hi] = True
            elif kind == 2:
                bits[i, rng.integers(lo, hi, int(rng.integers(1, 2 * tw)))] = True
            elif kind == 3:
                for _ in range(int(rng.integers(1, max(2, tw // 4)))):
                    a = int(rng.integers(lo, hi))
                    bits[i, a:min(hi, a + int(rng.integers(1, span // 2)))] = True
            elif kind == 4:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.4
    return bits


def group_circuit(m, k, salt):
    """A residual-like circuit over m inputs with k outputs (a threshold, a
    parity, an OR-like threshold, an AND of two inputs)."""
    c = TC.Circuit(m, [], [])
    w = TC.sideways_sum_bits(c, list(range(m)))
    outs = [TC.ge_const(c, w, max(1, (m + salt) // 2)), w[0], TC.ge_const(c, w, 1),
            c.AND(0, m - 1) if m > 1 else 0]
    c.outputs = outs[:k]
    return c.optimized()


def long_chain_circuit(n_terms):
    """Many program rows over few register slots: a chain of gates over 12
    inputs, each step reading the last."""
    c = TC.Circuit(12, [], [])
    acc = 0
    for i in range(n_terms):
        j = 1 + i % 11
        if i % 2:
            acc = c.XOR(c.AND(acc, j), c.OR(acc, (j * 5 + i // 11) % 12))
        else:
            acc = c.OR(c.ANDNOT(acc, j), c.AND(j, (j + 3) % 12))
    c.outputs = [acc]
    return c.optimized()


class Synthetic:
    """A block-stage plan over random (column, tile) cells of a CPU store
    built from ``bits``, one group per circuit with ``n_tiles[g]`` tiles.
    ``clean_share`` draws that share of each group's cells from clean
    tiles; ``kinds`` keeps only cells of those ``TK.CELL_*`` kinds."""

    def __init__(self, bits, tw, circs, n_tiles, k_max, rng, *, clean_share=None, kinds=None):
        self.bits, self.circs = bits, circs
        store = TileStore.from_packed(np.asarray(r_pack(jnp.asarray(bits))), tile_words=tw,
                                      r=bits.shape[1], device="cpu")
        table = TK.program_table(tuple(circs), k_max)
        B = TK.pick_tile_block(tw, table, max(n_tiles))
        m_max = max(c.n_inputs for c in circs)
        self.n_sel = sum(n_tiles) + 5
        D = store.packs["dense_pack"].shape[0]
        self.cols, self.tiles = (a.reshape(-1) for a in np.meshgrid(
            np.arange(store.n), np.arange(store.n_tiles), indexing="ij"))
        desc = cell_descriptors(store, self.cols, self.tiles)
        pool = np.arange(len(desc))
        if kinds is not None:
            pool = np.nonzero(np.isin(desc[:, 0], kinds))[0]
        clean = np.nonzero(desc[:, 0] <= TK.CELL_ONE)[0]
        gids, cells, dst, self.picks = [], [], [], []
        tile0 = 0
        for g, (circ, ng) in enumerate(zip(circs, n_tiles)):
            m, k = circ.n_inputs, len(circ.outputs)
            nb = -(-ng // B)
            pick = rng.choice(pool, (m, ng))
            if clean_share is not None:
                swap = rng.random((m, ng)) < clean_share
                pick[swap] = rng.choice(clean, int(swap.sum()))
            self.picks.append(pick)
            c = np.zeros((m_max, nb * B, 3), np.int64)
            c[:, :, 1] = D
            c[:m, :ng] = desc[pick]
            cells.append(c.reshape(m_max, nb, B, 3).transpose(1, 0, 2, 3))
            d = np.full((nb, k_max, B), -1, np.int64)
            tpos = np.arange(ng)
            aimed = rng.random(ng) >= 0.1  # the rest go nowhere
            for j in range(k):
                d[tpos[aimed] // B, j, tpos[aimed] % B] = j * self.n_sel + tile0 + tpos[aimed]
            dst.append(d)
            gids.append(np.full(nb, g, np.int32))
            tile0 += ng
        self.st = TK.make_block_stage(table, np.concatenate(gids), np.concatenate(cells),
                                      np.concatenate(dst), store.device_packs(), B, tw)
        self.dst = dst

    def oracle(self, buf0):
        """``buf0`` (uint32[k_max, n_sel, tw]) with every aimed output
        written, computed from the bits by the reference's circuits."""
        tw, B = self.st.tw, self.st.B
        words = np.asarray(r_pack(jnp.asarray(self.bits)))  # [n, n_tiles * tw]
        words = words.reshape(words.shape[0], -1, tw)
        out = buf0.copy().reshape(-1, tw)
        for circ, pick, dst in zip(self.circs, self.picks, self.dst):
            ng = pick.shape[1]
            ins = [words[self.cols[p], self.tiles[p]].reshape(-1) for p in pick]
            rc = RC.Circuit(circ.n_inputs, list(circ.ops), list(circ.outputs))
            ys = rc.evaluate(ins, zeros=np.zeros(ng * tw, np.uint32),
                             ones=np.full(ng * tw, 0xFFFFFFFF, np.uint32))
            for j, y in enumerate(ys):
                y = np.broadcast_to(y, (ng * tw,)).reshape(ng, tw)
                for t in range(ng):
                    row = dst[t // B, j, t % B]
                    if row >= 0:
                        out[row] = y[t]
        return out.reshape(buf0.shape)

    def check(self, seed):
        """Run block_plain into a random buffer; hold it to the oracle."""
        rng = np.random.default_rng(seed)
        buf0 = rng.integers(0, 2**32, (self.st.k_max, self.n_sel, self.st.tw), dtype=np.uint32)
        got = torch.from_numpy(buf0.view(np.int32).copy())
        TK.block_plain(got, self.st)
        want = self.oracle(buf0)
        assert np.array_equal(u32(got), want)
        assert (want != buf0).any()
        return u32(got)


SPECS = {
    "m=1 k_max=1": ([(1, 1, 7)], 1),
    "m=3,5 k_max=4": ([(3, 1, 40), (5, 4, 33)], 4),
    "overflow-style m=64 k_max=1": ([(64, 1, 70)], 1),
    "m=64,12,2 k_max=4": ([(64, 4, 45), (12, 2, 61), (2, 1, 9)], 4),
    "m=16,40 k_max=4": ([(16, 3, 30), (40, 4, 29)], 4),
    "m=8 k_max=1, many blocks": ([(8, 1, 600)], 1),
    "m=2 k_max=1, a block of few words": ([(2, 1, 3)], 1),
}
WIDE = ("m=1 k_max=1", "m=3,5 k_max=4", "m=8 k_max=1, many blocks")  # fit 1,536-word tiles
CASES = [(tw, name, share) for tw in (1, 8, 64, 1536) for name in SPECS
         for share in (None, 0.9) if tw <= 64 or name in WIDE]


@pytest.mark.parametrize("tw,name,clean_share", CASES)
def test_block_plain_on_synthetic_stages(tw, name, clean_share):
    """Every cell kind, with a random mix and with 90 % clean cells."""
    spec, k_max = SPECS[name]
    rng = np.random.default_rng([tw, len(name), 0 if clean_share is None else 1])
    n_tiles = 24 if tw > 64 else 96
    bits = mixed_tile_bits(rng, 8, n_tiles, tw)
    circs = [group_circuit(m, k, g) for g, (m, k, _n) in enumerate(spec)]
    ns = [min(n, 300) if tw > 64 else n for _m, _k, n in spec]
    syn = Synthetic(bits, tw, circs, ns, k_max, rng, clean_share=clean_share)
    syn.check(seed=tw)


@pytest.mark.parametrize("tw", [8, 64])
def test_block_plain_on_all_dense_blocks(tw):
    rng = np.random.default_rng(tw + 1)
    bits = rng.random((6, 8 * tw * 32)) < 0.45
    syn = Synthetic(bits, tw, [group_circuit(6, 2, 0)], [16], 2, rng, kinds=[TK.CELL_DENSE])
    assert (syn.st.cells[..., 0][:, :6] == TK.CELL_DENSE).any()
    syn.check(seed=2)


@pytest.mark.parametrize("tw", [1, 8, 64])
def test_block_plain_on_all_clean_blocks(tw):
    """Only all-zero and all-one cells: every output is a constant of its tile."""
    rng = np.random.default_rng(tw + 2)
    bits = np.zeros((6, 16 * tw * 32), bool)
    bits[:, :: 2 * tw * 32] = True  # a set bit in every other tile: sparse cells
    bits[2:4] = True
    syn = Synthetic(bits, tw, [group_circuit(6, 2, 1), group_circuit(4, 1, 0)], [40, 12], 2, rng,
                    kinds=[TK.CELL_ZERO, TK.CELL_ONE])
    got = syn.check(seed=3)
    rows = got.reshape(-1, tw)
    written = np.concatenate([d[d >= 0] for d in syn.dst])
    assert np.isin(rows[written], (0, 0xFFFFFFFF)).all()


def test_full_adder_with_one_constant_output():
    """sum = a ^ b ^ c, carry = maj(a, b, c) with a = b = 1 clean and c
    dense: the sum is c and OR(carry, z) all ones."""
    tw = 64
    rng = np.random.default_rng(5)
    bits = np.zeros((3, 4 * tw * 32), bool)
    bits[0] = True  # column 0: all ones
    bits[1:] = rng.random((2, bits.shape[1])) < 0.4
    packed = np.asarray(r_pack(jnp.asarray(bits)))
    store = TileStore.from_packed(packed, tile_words=tw, r=bits.shape[1], device="cpu")
    c = TC.Circuit(4, [], [])
    s, carry = c.full_adder(0, 1, 2)
    c.outputs = [s, c.OR(carry, 3)]
    table = TK.program_table((c,), 2)
    cols = np.array([0, 0, 1, 2])  # a = b = the all-ones column, c and z dense
    desc = cell_descriptors(store, np.repeat(cols[:, None], 4, 1), np.tile(np.arange(4), (4, 1)))
    assert (desc[:2, :, 0] == TK.CELL_ONE).all() and (desc[2:, :, 0] == TK.CELL_DENSE).all()
    dst = np.stack([np.arange(4), 4 + np.arange(4)])[None]
    st = TK.make_block_stage(table, np.zeros(1, np.int32), desc[None], dst,
                             store.device_packs(), 4, tw)
    buf = torch.zeros((2, 4, tw), dtype=torch.int32)
    TK.block_plain(buf, st)
    assert np.array_equal(u32(buf)[0], packed[1].reshape(4, tw))
    assert np.array_equal(u32(buf)[1], np.full((4, tw), 0xFFFFFFFF, np.uint32))


@pytest.mark.parametrize("tw", [8, 64])
def test_block_plain_with_a_wide_register_file(tw):
    """A group with 204 register slots (200 terms live at once) beside a
    narrow one, mostly clean cells."""
    rng = np.random.default_rng(tw + 3)
    c = TC.Circuit(16, [], [])
    terms = [c.AND(i % 16, (i * 7 + 1 + i // 16) % 16) for i in range(200)]
    c.outputs = [c.wide_or(terms)]
    syn = Synthetic(mixed_tile_bits(rng, 8, 24, tw), tw, [c, group_circuit(6, 1, 0)], [20, 20], 1,
                    rng, clean_share=0.9)
    assert syn.st.table.groups[0, 2] > 200
    syn.check(seed=4)


@pytest.mark.parametrize("tw", [8, 64, 1536])
def test_block_plain_with_a_program_past_the_staged_rows(tw):
    """The kernel stages STAGED_ROWS program rows and reads the rest where
    they lie; the shared memory it is sized for counts only those."""
    rng = np.random.default_rng(tw + 4)
    syn = Synthetic(mixed_tile_bits(rng, 8, 12, tw), tw, [long_chain_circuit(600)], [30], 1, rng)
    st = syn.st
    n_rows = int(st.table.groups[0, 1])
    assert n_rows > TK.STAGED_ROWS
    assert TK.block_shared_bytes(st.B, tw, st.table.n_registers, st.m_max, n_rows) == \
        TK.block_shared_bytes(st.B, tw, st.table.n_registers, st.m_max, TK.STAGED_ROWS)
    syn.check(seed=5)


def _table(n_registers, m, n_rows):
    """A one-group program table of that shape (its instructions unused)."""
    return ProgramTable(prog=np.zeros((n_rows, 4), np.int32),
                        groups=np.array([[0, n_rows, n_registers, m]], np.int32),
                        outs=np.zeros((1, 1), np.int32), k_max=1)


def test_pick_tile_block_at_1536_words_fits_long_programs():
    """At 1,536-word tiles (one a block) a 30-slot register file takes
    184,320 bytes; a program of any length fits beside it, because only
    STAGED_ROWS rows of it are staged.  37 slots fit, 38 do not."""
    for n_rows in (40, 256, 3000, 100_000):
        assert TK.pick_tile_block(1536, _table(30, 30, n_rows), 10) == 1
        assert TK.block_shared_bytes(1, 1536, 30, 30, n_rows) == \
            368 + min(n_rows, TK.STAGED_ROWS) * 16 + 184_320
    assert TK.pick_tile_block(1536, _table(37, 37, 3000), 10) == 1
    with pytest.raises(ValueError, match="n_registers"):
        TK.pick_tile_block(1536, _table(38, 38, 3000), 10)


def clustered_bits(n, r, seed, noise=3e-4):
    """Columns of runs covering a falling share of the rows (mean run 2,048
    bits) plus uniform noise: most tiles clean, and so many signatures that
    the plan puts most case-3 tiles in its unspecialised overflow group."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, r), bool)
    for i, p in enumerate(np.geomspace(0.5, 0.01, n)):
        gap = 2048 * (1 - p) / p
        edges = np.cumsum(np.stack([rng.geometric(1 / gap, 64), rng.geometric(1 / 2048, 64)],
                                   1).reshape(-1))
        edges = edges[edges < r]
        for a, b in zip(edges[0::2], np.append(edges[1::2], r)):
            bits[i, a:b] = True
        bits[i] |= rng.random(r) < noise
    return bits


@pytest.mark.parametrize("tw", [8, 64])
@pytest.mark.parametrize("kind", ["threshold", "interval", "multi"])
def test_run_tiled_circuit_on_clustered_stores(tw, kind):
    """The scan engine, its block stage run by ``block_plain``, against the
    reference's ``run_tiled_circuit`` on clustered data: same words, same
    info."""
    n = 20
    bits = clustered_bits(n, 160 * 64 * 32 + 300, seed=tw)
    ref, tor = store_pair(bits, tw)
    rc, tc = circuit_pair(kind, n)
    want, want_info = r_run(ref, rc, engine="scan")
    got, info = t_run(tor, tc, engine="scan")
    assert np.array_equal(u32(got), np.asarray(want))
    assert info == want_info
    assert info["densified_tiles"] > 0
