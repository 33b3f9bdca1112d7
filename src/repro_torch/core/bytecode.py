"""Byte-code compilation of circuits (the paper's 4.4.4 third approach).

The paper compiles a gate DAG into straight-line byte code (AND / OR / XOR /
ANDNOT / RECLAIM) executed by a trivial interpreter, with a last-use
analysis so intermediate bitmaps are reclaimed eagerly -- their answer to
the NP-hard Register Sufficiency problem.

In the port this layer is the hot path: ``compile_circuit`` does the
last-use analysis and assigns *register slots*, :func:`encode_program`
lays the result out as the ``int32`` arrays that the CUDA kernel of
``kernels.threshold_ssum`` interprets (and that its plain torch version
executes row by row).  Unlike the reference, every one of the circuit's
``k`` outputs is kept live and reported (``output_regs``).

Two things are done here for the interpreter's sake:

* **Input rows enter the register file through explicit ``LOAD``
  instructions**, scheduled in batches (``LOAD_BATCH`` rows, in order of
  first use) with one batch always in flight ahead of the gates that need
  it: ``COMMIT`` closes a batch, ``WAIT n`` blocks until at most ``n``
  batches are still in flight.  The kernel issues each ``LOAD`` as an
  asynchronous copy; the plain version copies rows and ignores ``COMMIT`` /
  ``WAIT``.  Only inputs the outputs depend on are loaded, and an input's
  slot is reclaimed after its last use like any intermediate.  Loading
  ahead costs slots (a row occupies one from its LOAD on), and slots cost
  blocks per SM: ``LOAD_BATCH`` is the measured compromise.
* **Full adders are fused** (:func:`fuse_adders`): the five gates
  ``s1 = a^b; s = s1^c; carry = (a&b) | (c&s1)`` become one two-word
  instruction ``FA`` (or ``MAJ`` when the sum is dead), because the
  interpreter pays a fixed price per instruction and the paper's adder
  circuits are made of little else.

The tiled route's block kernel (``kernels/csrc/tiled_block.cu``) runs the
same instruction set over a **program table**
(:func:`encode_program_table`): one program per residual group, compiled
with ``preloaded=True`` -- the group's inputs already sit in slots ``0 ..
m - 1``, where the kernel's decode stage writes them, so the program has
no ``LOAD`` -- concatenated, with per-group offset, length, register count
and input count, and ``k_max`` output slots per group.

The register file, program encoding and opcodes are the contract between
this module, the kernel sources ``kernels/csrc/circuit_eval.cu`` and
``kernels/csrc/tiled_block.cu``, and the one plain interpreter in
``kernels/threshold_ssum.py``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from .circuits import CONST0, CONST1, Circuit

__all__ = ["ByteCode", "ProgramTable", "compile_circuit", "encode_program",
           "encode_program_table", "fuse_adders", "OPCODES",
           "OP_LOAD", "OP_COMMIT", "OP_WAIT", "OP_FA", "OP_MAJ", "OP_EXT", "OP_NOP",
           "OP_CONST", "LOAD_BATCH", "PROG_CHUNK"]

OPCODES = {"and": 0, "or": 1, "xor": 2, "andnot": 3}
OP_LOAD = 4  # (4, dst, input row, 0): copy one word of an input row into a slot
OP_COMMIT = 5  # (5, 0, 0, 0): close the batch of LOADs issued since the last one
OP_WAIT = 6  # (6, 0, n, 0): wait until at most n batches are still in flight
OP_FA = 7  # (7, dst_sum, a, b) + (EXT, dst_carry, c, 0): full adder
OP_MAJ = 8  # (8, dst_carry, a, b) + (EXT, 0, c, 0): a full adder's carry alone
OP_EXT = 9  # second word of FA / MAJ
OP_NOP = 10  # padding: keeps a two-word instruction inside one program chunk
OP_CONST = 11  # (11, dst, v, 0): fill a slot with the word v (0, or -1 for all ones)

# Every gate operand and every output source is a register slot: the
# constants a circuit uses get a slot of their own (CONST, never reclaimed),
# so the interpreter fetches operands without looking at their kind.

#: input rows per LOAD batch (two batches are in flight at most)
LOAD_BATCH = 16
#: instructions the kernel stages into shared memory at a time; a two-word
#: instruction never straddles a multiple of it (must equal the kernel's)
PROG_CHUNK = 256


@dataclasses.dataclass
class ByteCode:
    """(op, dst, a, b) quadruples plus the sources of the ``k`` outputs."""

    n_inputs: int
    n_registers: int
    instructions: list  # gates: (opcode, dst, a, b) with a/b register slots;
    #                     LOAD / COMMIT / WAIT / FA / MAJ / CONST as documented above
    output_regs: list  # one register slot per circuit output
    peak_registers: int
    loaded_inputs: tuple = ()  # input rows the program loads, in load order
    n_fused: int = 0  # FA + MAJ instructions

    @property
    def output_reg(self) -> int:
        """Source of the first output (the reference's single-output field)."""
        return self.output_regs[0]


def fuse_adders(circ: Circuit) -> list:
    """The circuit's gates in order, with every full adder collapsed.

    Items are ``("g", gate_index)`` or ``("fa", sum_node | None, carry_node,
    a, b, c)``.  A full adder is recognised as ``carry = OR(AND(a, b),
    AND(c, s1))`` with ``s1 = XOR(a, b)`` and, optionally, ``sum = XOR(s1,
    c)``, where the three inner values feed nothing else and are no outputs.
    The fused item stands where the earlier of ``sum`` and ``carry`` stood:
    all of a, b, c are defined before either.
    """
    n_in, ops = circ.n_inputs, circ.ops
    users: dict[int, list] = defaultdict(list)
    for gi, (_op, a, b) in enumerate(ops):
        users[a].append(gi)
        users[b].append(gi)
    outputs = set(circ.outputs)

    def gate(node: int):
        return ops[node - n_in] if node >= n_in else None

    def inner(node: int, n_users: int) -> bool:
        return node not in outputs and len(users[node]) == n_users

    absorbed: set[int] = set()
    placed: dict[int, tuple] = {}

    def match(gi: int):
        _op, p, q = ops[gi]
        for t1, t2 in ((p, q), (q, p)):
            g1, g2 = gate(t1), gate(t2)
            if t1 == t2 or not (g1 and g2 and g1[0] == "and" and g2[0] == "and"):
                continue
            if not (inner(t1, 1) and inner(t2, 1)):
                continue
            a, b = g1[1], g1[2]
            if a == b:
                continue
            for c, s1 in ((g2[1], g2[2]), (g2[2], g2[1])):
                gs1 = gate(s1)
                if not (gs1 and gs1[0] == "xor" and {gs1[1], gs1[2]} == {a, b}):
                    continue
                if s1 in outputs:
                    continue
                others = [u for u in users[s1] if u != t2 - n_in]
                if not others:
                    s_node = None
                elif len(others) == 1 and ops[others[0]][0] == "xor" and \
                        sorted(ops[others[0]][1:]) == sorted((s1, c)) and s1 != c:
                    s_node = n_in + others[0]
                else:
                    continue
                comps = {t1 - n_in, t2 - n_in, s1 - n_in, gi}
                if s_node is not None:
                    comps.add(s_node - n_in)
                if comps & absorbed:
                    continue
                return comps, ("fa", s_node, n_in + gi, a, b, c)
        return None

    for gi, (op, _a, _b) in enumerate(ops):
        if op != "or" or gi in absorbed:
            continue
        found = match(gi)
        if found is None:
            continue
        comps, item = found
        absorbed |= comps
        pos = gi if item[1] is None else min(gi, item[1] - n_in)
        placed[pos] = item

    items = []
    for gi in range(len(ops)):
        if gi in placed:
            items.append(placed[gi])
        elif gi not in absorbed:
            items.append(("g", gi))
    return items


def compile_circuit(circ: Circuit, *, preloaded: bool = False) -> ByteCode:
    """Register-allocated byte code of ``circ``.

    By default input rows enter through scheduled ``LOAD`` batches.  With
    ``preloaded`` input ``i`` already occupies slot ``i`` when the program
    starts (the tiled block kernel decodes it there): no ``LOAD``,
    ``COMMIT`` or ``WAIT`` is emitted, and an input's slot is reclaimed
    after its last use like any other.
    """
    n_in = circ.n_inputs
    items = fuse_adders(circ)

    def operands(item) -> tuple:
        if item[0] == "g":
            return circ.ops[item[1]][1:]
        return item[3:]

    # last use of every value; first use of every input (outputs live to the end)
    last_use: dict[int, int] = {}
    first_use: dict[int, int] = {}
    for idx, item in enumerate(items):
        for x in operands(item):
            if x >= 0:
                last_use[x] = idx
                if x < n_in:
                    first_use.setdefault(x, idx)
    for o in circ.outputs:
        if o >= 0:
            last_use[o] = len(items)
            if o < n_in:
                first_use.setdefault(o, len(items))

    order = sorted(first_use, key=lambda i: (first_use[i], i))
    batches = [order[j:j + LOAD_BATCH] for j in range(0, len(order), LOAD_BATCH)]
    batch_of = {i: j for j, b in enumerate(batches) for i in b}

    free: list[int] = []
    reg_of: dict[int, int] = {i: i for i in range(n_in)} if preloaded else {}
    n_regs = peak = n_in if preloaded else 0
    instrs: list = []
    issued = ready = 0
    n_fused = 0

    def alloc(x: int) -> int:
        nonlocal n_regs, peak
        if free:
            dst = free.pop()
        else:
            dst = n_regs
            n_regs += 1
        reg_of[x] = dst
        peak = max(peak, len(reg_of))
        return dst

    def make_ready(j: int) -> None:
        """Emit LOAD batches (one ahead of need) and the WAIT that makes batch j usable."""
        nonlocal issued, ready
        while ready <= j:
            while issued < min(len(batches), ready + 2):
                for i in batches[issued]:
                    instrs.append((OP_LOAD, alloc(i), i, 0))
                instrs.append((OP_COMMIT, 0, 0, 0))
                issued += 1
            instrs.append((OP_WAIT, 0, issued - ready - 1, 0))
            ready += 1

    def src(x: int) -> int:
        if x < 0:
            if x not in reg_of:
                instrs.append((OP_CONST, alloc(x), 0 if x == CONST0 else -1, 0))
        elif x < n_in and not preloaded:
            make_ready(batch_of[x])
        return reg_of[x]

    for idx, item in enumerate(items):
        xs = operands(item)
        srcs = [src(x) for x in xs]
        # reclaim operands whose last use is this instruction BEFORE
        # allocating dst, so dst can reuse the slot (in-place style)
        for x in dict.fromkeys(xs):
            if x >= 0 and last_use.get(x) == idx:
                free.append(reg_of.pop(x))
        if item[0] == "g":
            gi = item[1]
            instrs.append((OPCODES[circ.ops[gi][0]], alloc(n_in + gi), srcs[0], srcs[1]))
            continue
        _tag, s_node, c_node = item[:3]
        if len(instrs) % PROG_CHUNK == PROG_CHUNK - 1:
            instrs.append((OP_NOP, 0, 0, 0))
        if s_node is None:
            instrs.append((OP_MAJ, alloc(c_node), srcs[0], srcs[1]))
            instrs.append((OP_EXT, 0, srcs[2], 0))
        else:
            instrs.append((OP_FA, alloc(s_node), srcs[0], srcs[1]))
            instrs.append((OP_EXT, alloc(c_node), srcs[2], 0))
        n_fused += 1
    outs = [src(o) for o in circ.outputs]
    loaded = () if preloaded else tuple(order)
    return ByteCode(n_in, n_regs, instrs, outs, peak, loaded, n_fused)


def encode_program(bc: ByteCode, rows=None):
    """The program as the kernel reads it: ``int32[n_instr, 4]`` rows of
    ``(op, dst, a, b)`` and ``int32[k]`` output sources (numpy, host).

    ``rows`` (optional) maps the circuit's input ``i`` to row ``rows[i]`` of
    the matrix the program will run over: it rewrites the LOADs, so a member
    subset of a larger matrix is read in place.
    """
    prog = np.asarray(bc.instructions, dtype=np.int32).reshape(len(bc.instructions), 4)
    outs = np.asarray(bc.output_regs, dtype=np.int32)
    if rows is not None:
        table = np.asarray(rows, dtype=np.int32)
        loads = prog[:, 0] == OP_LOAD
        prog[loads, 2] = table[prog[loads, 2]]
    return prog, outs


@dataclasses.dataclass
class ProgramTable:
    """The residual programs of one tiled block stage, concatenated.

    ``prog`` int32[total, 4] holds every group's instructions; ``groups``
    int32[G, 4] is ``(offset, length, n_registers, n_inputs)`` per group and
    ``outs`` int32[G, k_max] the slot of each output.  A group with fewer
    than ``k_max`` outputs ends with a ``CONST`` 0 into a slot of its own,
    and its missing outputs point there.  Each program starts at its own
    offset and is encoded as K1's are, ``NOP`` padding included; the
    ``PROG_CHUNK`` alignment of two-word instructions matters only to the
    circuit kernel, which stages its program in chunks.  The block kernel
    stages a program's first rows at once and reads any later row where it
    lies, so no alignment matters to it.
    """

    prog: np.ndarray
    groups: np.ndarray
    outs: np.ndarray
    k_max: int

    @property
    def n_registers(self) -> int:
        """The largest register file of any group (sizes the kernel's block)."""
        return int(self.groups[:, 2].max()) if len(self.groups) else 0

    def program(self, g: int):
        """(int32[len, 4] instructions, output slots, n_registers, n_inputs) of group g."""
        off, length, n_regs, m = (int(v) for v in self.groups[g])
        return self.prog[off:off + length], self.outs[g], n_regs, m


def encode_program_table(circuits, k_max: int) -> ProgramTable:
    """One preloaded program per residual circuit (see :class:`ProgramTable`)."""
    progs, groups, outs = [], [], []
    off = 0
    for circ in circuits:
        bc = compile_circuit(circ, preloaded=True)
        ins = list(bc.instructions)
        regs = list(bc.output_regs)
        n_regs = bc.n_registers
        if len(regs) < k_max:
            ins.append((OP_CONST, n_regs, 0, 0))
            regs += [n_regs] * (k_max - len(regs))
            n_regs += 1
        prog = np.asarray(ins, dtype=np.int32).reshape(len(ins), 4)
        progs.append(prog)
        groups.append((off, len(ins), n_regs, circ.n_inputs))
        outs.append(regs)
        off += len(ins)
    return ProgramTable(
        prog=np.concatenate(progs) if progs else np.zeros((0, 4), np.int32),
        groups=np.asarray(groups, dtype=np.int32).reshape(-1, 4),
        outs=np.asarray(outs, dtype=np.int32).reshape(-1, k_max),
        k_max=int(k_max),
    )
