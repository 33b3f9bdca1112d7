"""core.circuits / core.bytecode / core.weighted of the port against the
reference: equal gate lists, equal keys, and the encoded program (what the
CUDA kernel interprets) equal to ``Circuit.evaluate``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t_words, u32, words
from repro.core import circuits as RC
from repro.core import weighted as RW
from repro_torch.core import bytecode as BC
from repro_torch.core import circuits as TC
from repro_torch.core import weighted as TW
from repro_torch.kernels.threshold_ssum import circuit_structural_key, run_circuit_plain

# the (n, t) grid of tests/test_circuits.py (Tables 7 and 8 of the paper)
GRID = [(4, 2), (4, 3), (5, 2), (5, 3), (43, 30), (85, 12), (120, 105), (323, 14),
        (329, 138), (330, 324), (786, 481), (786, 776)]


def same(a, b):
    assert a.n_inputs == b.n_inputs
    assert list(a.ops) == list(b.ops)
    assert list(a.outputs) == list(b.outputs)


@pytest.mark.parametrize("n,t", GRID)
@pytest.mark.parametrize("kind", ["ssum", "treeadd"])
def test_threshold_circuits_equal_reference(n, t, kind):
    same(TC.build_threshold_circuit(n, t, kind), RC.build_threshold_circuit(n, t, kind))


SMALL = [(4, 2), (4, 3), (5, 3), (9, 1), (9, 9), (9, 0), (9, 10)]


@pytest.mark.parametrize("n,t,kind", [(n, t, "srtckt") for n, t in SMALL + [(16, 7), (33, 12)]]
                         + [(n, t, "sopckt") for n, t in SMALL])  # sum-of-products: tiny N only
def test_sorter_and_sop_circuits_equal_reference(n, t, kind):
    same(TC.build_threshold_circuit(n, t, kind), RC.build_threshold_circuit(n, t, kind))


@pytest.mark.parametrize("n", [2, 4, 7, 8, 16, 32, 43])
def test_weight_interval_symmetric_circuits_equal_reference(n):
    for kind in ("ssum", "treeadd"):
        same(TC.build_weight_circuit(n, kind), RC.build_weight_circuit(n, kind))
        same(TC.build_interval_circuit(n, 1, n // 2, kind), RC.build_interval_circuit(n, 1, n // 2, kind))
    truth = [(w * 5 + n) % 3 == 0 for w in range(n + 1)]
    same(TC.build_symmetric_circuit(n, truth), RC.build_symmetric_circuit(n, truth))
    assert TC.paper_tree_adder_gates(8) == RC.paper_tree_adder_gates(8)
    assert TC.looped_op_count(n, 2) == RC.looped_op_count(n, 2)


@pytest.mark.parametrize("weights,t", [((1, 2, 3), 4), ((5, 1, 1, 9, 2), 7), (tuple(range(1, 20)), 60),
                                       ((1000, 3, 77, 12), 1003), ((2, 2), 0), ((2, 2), 5)])
def test_weighted_circuits_equal_reference(weights, t):
    same(TW.build_weighted_threshold_circuit(list(weights), t),
         RW.build_weighted_threshold_circuit(list(weights), t))
    assert TW.decomposed_gate_cost(weights, t) == RW.decomposed_gate_cost(weights, t)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_specialize_and_semantic_key_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = 12
    t = int(rng.integers(2, n))
    tc, rc = TC.build_threshold_circuit(n, t, "ssum"), RC.build_threshold_circuit(n, t, "ssum")
    assert tc.semantic_key() == rc.semantic_key()
    assert tc.support() == rc.support()
    assign = {int(i): (TC.CONST1 if rng.random() < 0.5 else TC.CONST0)
              for i in rng.choice(n, size=int(rng.integers(1, n)), replace=False)}
    ct, rt, kt = tc.specialize(assign)
    cr, rr, kr = rc.specialize(assign)
    assert ct == cr and kt == kr
    assert (rt is None) == (rr is None)
    if rt is not None:
        same(rt, rr)
        assert rt.semantic_key() == rr.semantic_key()


def _check_program(circ, arr):
    """The encoded program run by the plain version == Circuit.evaluate (port)
    == Circuit.evaluate (reference, jnp)."""
    t = t_words(arr)
    got = run_circuit_plain(t, circ)
    got = got[None] if got.dim() == 1 else got
    want = torch.stack(circ.evaluate([t[i] for i in range(t.shape[0])]))
    assert np.array_equal(u32(got), u32(want))
    ref = RC.Circuit(circ.n_inputs, list(circ.ops), list(circ.outputs)).evaluate(
        [jnp.asarray(arr[i]) for i in range(arr.shape[0])])
    assert np.array_equal(u32(got), np.stack([np.asarray(x) for x in ref]))


@pytest.mark.parametrize("n,t,kind", [(2, 1, "ssum"), (5, 3, "ssum"), (16, 7, "ssum"), (43, 30, "ssum"),
                                      (85, 12, "ssum"), (21, 9, "treeadd"), (16, 5, "srtckt"),
                                      (6, 3, "sopckt"), (9, 0, "ssum"), (9, 10, "ssum")])
def test_encoded_program_equals_evaluate(n, t, kind):
    _check_program(TC.build_threshold_circuit(n, t, kind), words(n, 67, seed=n * 31 + t))


def test_multi_output_constant_and_passthrough_outputs():
    n = 10
    c = TC.Circuit(n, [], [])
    bits = TC.sideways_sum_bits(c, list(range(n)))
    c.outputs = [TC.ge_const(c, bits, t) for t in (1, 3, 5, 11)] + [TC.CONST1, 4, TC.CONST0, c.XOR(0, 9), 4]
    _check_program(c, words(n, 41, seed=7))
    _check_program(c.optimized(), words(n, 41, seed=8))
    bc = BC.compile_circuit(c.optimized())
    assert len(bc.output_regs) == 9 and bc.output_reg == bc.output_regs[0]
    prog, outs = BC.encode_program(bc)
    assert prog.dtype == np.int32 and prog.shape == (len(bc.instructions), 4)
    assert outs.dtype == np.int32 and outs.shape == (9,) and (outs >= 0).all()


@pytest.mark.parametrize("n,t", [(16, 7), (64, 32), (64, 2), (130, 65)])
def test_full_adders_are_fused_and_loads_are_batched(n, t):
    circ = TC.build_threshold_circuit(n, t, "ssum")
    bc = BC.compile_circuit(circ)
    assert bc.n_fused >= n // 2 - 3
    ops = [ins[0] for ins in bc.instructions]
    # fusion saves more instructions than LOAD / COMMIT / WAIT add
    assert len(ops) < len(circ.ops)
    assert ops.count(BC.OP_LOAD) == len(circ.support()) == len(bc.loaded_inputs)
    # every two-word instruction has its second word, inside one chunk
    for i, op in enumerate(ops):
        if op in (BC.OP_FA, BC.OP_MAJ):
            assert ops[i + 1] == BC.OP_EXT and i // BC.PROG_CHUNK == (i + 1) // BC.PROG_CHUNK
    # batches of LOAD_BATCH rows, never more than two in flight, all waited for at the end
    pending = in_batch = 0
    for op, _d, a, _b in bc.instructions:
        if op == BC.OP_LOAD:
            in_batch += 1
        elif op == BC.OP_COMMIT:
            assert 1 <= in_batch <= BC.LOAD_BATCH
            in_batch = 0
            pending += 1
            assert pending <= 2
        elif op == BC.OP_WAIT:
            pending = min(pending, a)
    assert pending == 0 and in_batch == 0
    arr = words(n, 33, seed=n + t)
    t_arr = t_words(arr)
    a = run_circuit_plain(t_arr, circ)
    want, = circ.evaluate([t_arr[i] for i in range(n)])
    assert np.array_equal(u32(a), u32(want))


def test_two_word_instruction_never_straddles_a_chunk():
    # chains of full adders long enough to cross chunk boundaries, at shifted phases
    padded = 0
    for n in range(300, 308):
        circ = TC.build_threshold_circuit(n, n // 2, "ssum")
        bc = BC.compile_circuit(circ)
        ops = [ins[0] for ins in bc.instructions]
        assert len(ops) > BC.PROG_CHUNK
        padded += ops.count(BC.OP_NOP)
        for i, op in enumerate(ops):
            if op in (BC.OP_FA, BC.OP_MAJ):
                assert i % BC.PROG_CHUNK != BC.PROG_CHUNK - 1
    assert padded > 0  # some phase did put a pair on a boundary
    _check_program(circ, words(307, 9, seed=3))


@pytest.mark.parametrize("sum_first", [True, False])
def test_fused_adder_stands_before_the_first_user_of_either_output(sum_first):
    # a user of the sum between the sum and the carry, and the other way round
    c = TC.Circuit(4, [], [])
    s1 = c.XOR(0, 1)
    if sum_first:
        s = c.XOR(s1, 2)
        u = c.AND(s, 3)
        g = c.OR(c.AND(0, 1), c.AND(2, s1))
    else:
        g = c.OR(c.AND(1, 0), c.AND(s1, 2))
        u = c.XOR(g, 3)
        s = c.XOR(2, s1)
    c.outputs = [u, g, s]
    assert BC.compile_circuit(c).n_fused == 1
    _check_program(c, words(4, 21, seed=5))
    # an inner value that something else reads keeps the adder unfused
    c.outputs = [u, g, s, s1]
    assert BC.compile_circuit(c).n_fused == 0
    _check_program(c, words(4, 21, seed=6))


def test_rows_remap_reads_member_subset_in_place():
    arr = words(20, 50, seed=11)
    slots = (17, 3, 8, 0, 12)
    circ = TC.build_threshold_circuit(len(slots), 2, "ssum")
    t = t_words(arr)
    got = run_circuit_plain(t, circ, rows=slots)
    want = run_circuit_plain(t[list(slots)], circ)
    assert np.array_equal(u32(got), u32(want))
    assert circuit_structural_key(circ) == (circ.n_inputs, tuple(circ.ops), tuple(circ.outputs))
    with pytest.raises(ValueError):
        run_circuit_plain(t, circ)  # 20 rows for a 5-input circuit
    with pytest.raises(ValueError):
        run_circuit_plain(t, circ, rows=(0, 1, 2, 3, 20))


def test_python_int_evaluation_matches_reference():
    rng = np.random.default_rng(3)
    n = 9
    ints = [int(rng.integers(0, 2**63)) for _ in range(n)]
    for t in (1, 3, 5, 9):
        a = TC.build_threshold_circuit(n, t, "ssum").evaluate(ints, zeros=0, ones=(1 << 64) - 1)
        b = RC.build_threshold_circuit(n, t, "ssum").evaluate(ints, zeros=0, ones=(1 << 64) - 1)
        assert a == b
