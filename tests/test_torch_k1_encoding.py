"""The circuit kernel's byte code (``core.bytecode``) against the reference.

The program the circuit kernel interprets (and its plain version executes)
computes what the reference's Pallas kernel computes (interpret mode, as its
own tests run it on the CPU), bit for bit, for every circuit family, keeps
the invariants the kernel relies on, and encodes exactly as it did before the
kernel's redesign for the H100 (the kernel changed, its contract did not):
so does the tiled route's program table.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import t_words, u32, words
from repro.core import circuits as RC
from repro.core import weighted as RW
from repro.kernels.threshold_ssum import run_circuit_pallas
from repro_torch.core import bytecode as BC
from repro_torch.core import circuits as TC
from repro_torch.core import weighted as TW
from repro_torch.kernels.threshold_ssum import _run_program_plain


def multi_output(mod):
    c = mod.Circuit(16, [], [])
    bits = mod.sideways_sum_bits(c, list(range(16)))
    c.outputs = [mod.ge_const(c, bits, t) for t in range(1, 5)]
    return c.optimized()


# (port circuit, reference circuit) by family
FAMILIES = {
    "threshold": lambda m: m.build_threshold_circuit(23, 9, "ssum"),
    "threshold 64": lambda m: m.build_threshold_circuit(64, 32, "ssum"),
    "symmetric": lambda m: m.build_symmetric_circuit(11, [(w * 5 + 11) % 3 == 0 for w in range(12)]),
    "interval": lambda m: m.build_interval_circuit(30, 4, 9),
    "treeadd": lambda m: m.build_threshold_circuit(21, 9, "treeadd"),
    "sorter": lambda m: m.build_threshold_circuit(16, 7, "srtckt"),
    "weighted": lambda m: (TW if m is TC else RW).build_weighted_threshold_circuit(
        [1 + (i * 5) % 9 for i in range(40)], 60),
    "multi-output": multi_output,
}


def program(circ):
    bc = BC.compile_circuit(circ)
    prog, outs = BC.encode_program(bc)
    return bc, prog, outs


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("nw", [37, 41, 42, 43])  # 4k+1 .. 4k+3 words: the kernel's ragged ends
def test_program_equals_reference(family, nw):
    tc, rc = FAMILIES[family](TC), FAMILIES[family](RC)
    arr = words(tc.n_inputs, nw, seed=len(family) + nw)
    bc, prog, outs = program(tc)
    got = u32(_run_program_plain(t_words(arr), prog, outs, bc.n_registers))
    pallas = np.asarray(run_circuit_pallas(jnp.asarray(arr), rc, interpret=True)).reshape(got.shape)
    assert np.array_equal(got, pallas)


def edge_circuits():
    """Small circuits with awkward shapes: an output read again, a gate on
    one value twice, both full-adder results read by one gate, a program
    longer than the kernel stages at once, constant and pass-through
    outputs."""
    out = {}
    c = TC.Circuit(8, [], [])
    x = c.XOR(0, 1)
    c.outputs = [x, c.AND(x, 2)]
    out["an output read again"] = c
    c = TC.Circuit(8, [], [])
    x = c.XOR(0, 1)
    c.outputs = [c.OR(c.AND(x, x), 3)]
    out["one value into both operands"] = c
    c = TC.Circuit(8, [], [])
    s, carry = c.full_adder(0, 1, 2)
    c.outputs = [c.XOR(s, carry)]
    out["both full-adder results"] = c
    c = TC.Circuit(8, [], [])
    acc = 0
    for i in range(700):
        acc = c.XOR(acc, 1 + i % 7) if i % 3 else c.AND(acc, c.OR(i % 8, (i + 3) % 8))
    c.outputs = [acc]
    out["longer than a program chunk"] = c
    c = TC.Circuit(8, [], [])
    c.outputs = [TC.CONST1, c.ANDNOT(3, c.XOR(0, 1)), c.XOR(0, 1), TC.CONST0, 7]
    out["constant, pass-through, andnot"] = c
    return out


ALL = {**{f: FAMILIES[f](TC) for f in FAMILIES}, **edge_circuits()}


@pytest.mark.parametrize("name", sorted(edge_circuits()))
def test_edge_circuits_match_gate_by_gate_evaluation(name):
    circ = edge_circuits()[name]
    x = t_words(words(circ.n_inputs, 29, seed=7))
    bc, prog, outs = program(circ)
    want = u32(np.stack([u32(v) for v in circ.evaluate(list(x))]))
    assert np.array_equal(u32(_run_program_plain(x, prog, outs, bc.n_registers)), want)


def walk(prog):
    """(row, operand slots, result slots) of every gate, FA and MAJ, in order."""
    rows = prog.tolist()
    i = 0
    while i < len(rows):
        op, dst, a, b = rows[i]
        if op in (BC.OP_FA, BC.OP_MAJ):
            assert i % BC.PROG_CHUNK != BC.PROG_CHUNK - 1, "a two-word instruction straddles a chunk"
            ext = rows[i + 1]
            assert ext[0] == BC.OP_EXT
            srcs = (a, b, ext[2])
            dsts = (dst, ext[1]) if op == BC.OP_FA else (dst,)
            yield i, srcs, dsts
            i += 2
            continue
        if op <= BC.OPCODES["andnot"]:
            yield i, (a, b), (dst,)
        i += 1


@pytest.mark.parametrize("name", sorted(ALL))
def test_encoder_invariants(name):
    """Every slot an instruction reads was written before, by a LOAD, a
    CONST or an earlier result; no two-word instruction straddles a staged
    chunk; every output slot is written; every input row is loaded once."""
    circ = ALL[name]
    bc, prog, outs = program(circ)
    compute = {c[0]: c for c in walk(prog)}
    written: set = set()
    loaded = []
    for i, (word, dst, a, _b) in enumerate(prog.tolist()):
        if word in (BC.OP_LOAD, BC.OP_CONST):
            written.add(dst)
            if word == BC.OP_LOAD:
                loaded.append(a)
            continue
        if i not in compute:
            continue
        _, srcs, dsts = compute[i]
        for s in srcs:
            assert s in written, f"row {i}: reads slot {s} before it is written"
        written.update(dsts)
        assert max(dsts) < bc.n_registers
    assert set(outs.tolist()) <= written
    assert sorted(loaded) == sorted(set(loaded)) == sorted(bc.loaded_inputs)


def table_digest(table) -> str:
    h = hashlib.sha256()
    for a in (table.prog, table.groups, table.outs):
        h.update(np.ascontiguousarray(a, dtype=np.int32).tobytes())
    return h.hexdigest()


def fixed_circuits():
    return [TC.build_threshold_circuit(16, 5, "ssum"), TC.build_threshold_circuit(21, 9, "treeadd"),
            TC.build_threshold_circuit(9, 4, "srtckt"), TC.build_interval_circuit(12, 3, 7),
            TC.build_symmetric_circuit(9, [(w * 5 + 9) % 3 == 0 for w in range(10)]),
            TW.build_weighted_threshold_circuit([3, 1, 4, 1, 5, 9, 2, 6], 12),
            TC.build_threshold_circuit(64, 32, "ssum"), multi_output(TC)]


def test_program_table_and_k1_encoding_unchanged():
    # digests of the encoder's arrays before the kernel's redesign
    assert table_digest(BC.encode_program_table(fixed_circuits(), 4)) == \
        "7c4bdbe00b3630f4af5195acd9512d63e28da4eecece78bc05f01654c9a4f128"
    h = hashlib.sha256()
    for c in fixed_circuits():
        prog, outs = BC.encode_program(BC.compile_circuit(c))
        h.update(prog.tobytes())
        h.update(outs.tobytes())
    assert h.hexdigest() == "84950981e14f7d50f1ffb91c5657956883823ea1e32a140b7665f241858a1325"
