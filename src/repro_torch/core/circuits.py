"""Boolean-circuit construction for threshold / symmetric functions.

Builds the paper's gate DAGs (Tree adder = TREEADD, sideways sum = SSUM,
Batcher sorting network = SRTCKT, sum-of-products = SOPCKT) with the exact
adder decomposition used in the paper (Algorithm 4 / Appendix B):

    half adder:  s = a ^ b                 (1 gate)
                 c = a & b                 (1 gate)
    full adder:  s  = a ^ b               (1 gate)
                 s2 = s ^ cin             (1 gate)
                 c  = (a & b) | (cin & s)  (3 gates)

so HA = 2 gates and FA = 5 gates, and the *sum* XOR of the last adder is
removable by dead-code elimination when the low weight bit is unused --
which is what makes our op counts reproduce the paper's Tables 6-8
(e.g. the tree adder's c(2^k) = 7N - 5 log2 N - 7 and the sideways sum's
s(N) = 2, 9, 26, 63, 140 for N = 2..32, plus the comparator).

A circuit is evaluated gate by gate over packed word tensors (``int32``
holding the bit pattern of 32 positions) by :meth:`Circuit.evaluate`, or
compiled to the paper's straight-line byte code (``core.bytecode``) that
the CUDA kernel in ``kernels.threshold_ssum`` interprets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

# Node encoding: each gate is a tuple (op, a, b) where a/b are node ids.
# Special ids: CONST0 = -1, CONST1 = -2. Inputs are nodes with op == "in".
CONST0 = -1
CONST1 = -2

_BINOPS = ("and", "or", "xor", "andnot")


@dataclasses.dataclass
class Circuit:
    """A gate DAG over ``n_inputs`` inputs with a list of output node ids."""

    n_inputs: int
    ops: list  # list of (op, a, b); node id = n_inputs + index
    outputs: list  # node ids

    def node(self, op: str, a: int, b: int) -> int:
        self.ops.append((op, a, b))
        return self.n_inputs + len(self.ops) - 1

    # -- builders -------------------------------------------------------
    def AND(self, a, b):
        return self.node("and", a, b)

    def OR(self, a, b):
        return self.node("or", a, b)

    def XOR(self, a, b):
        return self.node("xor", a, b)

    def ANDNOT(self, a, b):
        """a AND NOT b (counts as a single 2-input op, as in the paper)."""
        return self.node("andnot", a, b)

    def NOT(self, a):
        # Realised as CONST1 ANDNOT: (1 & ~a). Counted as one op.
        return self.node("andnot", CONST1, a)

    def half_adder(self, a, b):
        s = self.XOR(a, b)
        c = self.AND(a, b)
        return s, c

    def full_adder(self, a, b, cin):
        s1 = self.XOR(a, b)
        s = self.XOR(s1, cin)
        c = self.OR(self.AND(a, b), self.AND(cin, s1))
        return s, c

    def wide_or(self, xs: Sequence[int]) -> int:
        xs = [x for x in xs]
        if not xs:
            return CONST0
        acc = xs[0]
        for x in xs[1:]:
            acc = self.OR(acc, x)
        return acc

    def wide_and(self, xs: Sequence[int]) -> int:
        xs = [x for x in xs]
        if not xs:
            return CONST1
        acc = xs[0]
        for x in xs[1:]:
            acc = self.AND(acc, x)
        return acc

    # -- accounting ------------------------------------------------------
    def gate_count(self) -> int:
        return len(self.ops)

    # -- optimisation ----------------------------------------------------
    def optimized(self, comp_folds: bool = False) -> "Circuit":
        """Constant folding + CSE + dead-code elimination (paper 4.4.5).

        ``comp_folds`` additionally tracks complements (nodes built as
        ``NOT x``) and folds ``x AND NOT x -> 0`` etc.  It is used by
        :meth:`specialize` so residual tile circuits collapse to constants
        in the RBMRG case-2 regime; it is off by default to keep the gate
        counts of the paper's reference constructions untouched.
        """
        new_ops: list = []
        remap: dict[int, int] = {}
        cse: dict[tuple, int] = {}
        comp: dict[int, int] = {}  # node -> its complement (both directions)

        def resolve(i: int) -> int:
            if i < 0 or i < self.n_inputs:
                return i
            return remap[i]

        for idx, (op, a, b) in enumerate(self.ops):
            nid = self.n_inputs + idx
            a, b = resolve(a), resolve(b)
            folded = _fold(op, a, b)
            if folded is None and comp_folds:
                folded = _fold_complement(op, a, b, comp)
            if folded is not None:
                remap[nid] = folded
                continue
            # canonicalise commutative ops for CSE
            key_a, key_b = (a, b)
            if op in ("and", "or", "xor") and key_b < key_a:
                key_a, key_b = key_b, key_a
            key = (op, key_a, key_b)
            if key in cse:
                remap[nid] = cse[key]
                continue
            new_ops.append((op, a, b))
            out_id = self.n_inputs + len(new_ops) - 1
            remap[nid] = out_id
            cse[key] = out_id
            if comp_folds:
                # NOT is realised as (1 ANDNOT x) or (1 XOR x)
                if (op == "andnot" and a == CONST1) or (op == "xor" and key_a == CONST1):
                    other = b if op == "andnot" else key_b
                    comp[out_id] = other
                    comp[other] = out_id

        outputs = [resolve(o) for o in self.outputs]
        pruned = Circuit(self.n_inputs, new_ops, outputs)
        return pruned._dce()

    def _dce(self) -> "Circuit":
        live = set(o for o in self.outputs if o >= self.n_inputs)
        order = sorted(live, reverse=True)
        seen = set(live)
        # walk backwards marking fan-in
        stack = list(order)
        while stack:
            nid = stack.pop()
            op, a, b = self.ops[nid - self.n_inputs]
            for x in (a, b):
                if x >= self.n_inputs and x not in seen:
                    seen.add(x)
                    stack.append(x)
        keep = sorted(seen)
        remap = {old: self.n_inputs + i for i, old in enumerate(keep)}

        def rm(i):
            return remap.get(i, i) if i >= self.n_inputs else i

        new_ops = [
            (op, rm(a), rm(b)) for old in keep for (op, a, b) in [self.ops[old - self.n_inputs]]
        ]
        return Circuit(self.n_inputs, new_ops, [rm(o) for o in self.outputs])

    # -- partial evaluation ----------------------------------------------
    def support(self) -> list:
        """Input ids actually reachable from the outputs (post-DCE inputs)."""
        live = set()
        seen = set(o for o in self.outputs if o >= self.n_inputs)
        stack = list(seen)
        for o in self.outputs:
            if 0 <= o < self.n_inputs:
                live.add(o)
        while stack:
            nid = stack.pop()
            op, a, b = self.ops[nid - self.n_inputs]
            for x in (a, b):
                if 0 <= x < self.n_inputs:
                    live.add(x)
                elif x >= self.n_inputs and x not in seen:
                    seen.add(x)
                    stack.append(x)
        return sorted(live)

    def specialize(self, assign: dict):
        """Partially evaluate with ``assign``: input id -> CONST0/CONST1.

        Returns ``(const_outputs, residual, kept_inputs)`` where
        ``const_outputs[j]`` is 0/1 when output j folded to a constant (else
        None), ``residual`` is an optimised circuit over the unassigned
        inputs computing the non-constant outputs (None if every output is
        constant), and ``kept_inputs`` lists the original ids of the
        residual's inputs in order.  This is the tile-skipping engine: with
        all-zero/all-one tiles assigned as constants, constant outputs are
        the RBMRG case-1/2 tiles and the residual circuit is the case-3
        dirty-resolution work.
        """
        for i, v in assign.items():
            if not 0 <= i < self.n_inputs or v not in (CONST0, CONST1):
                raise ValueError(f"bad assignment {i} -> {v}")
        kept = [i for i in range(self.n_inputs) if i not in assign]
        imap = {old: new for new, old in enumerate(kept)}

        sub = Circuit(len(kept), [], [])
        # node-id shift: gates keep their order, ids move with n_inputs delta
        shift = sub.n_inputs - self.n_inputs

        def remap(i):
            if i < 0:  # CONST0 / CONST1
                return i
            if i < self.n_inputs:
                return assign[i] if i in assign else imap[i]
            return i + shift

        for op, a, b in self.ops:
            sub.node(op, remap(a), remap(b))
        sub.outputs = [remap(o) for o in self.outputs]
        opt = sub.optimized(comp_folds=True)
        const = [
            (0 if o == CONST0 else 1) if o in (CONST0, CONST1) else None
            for o in opt.outputs
        ]
        live = [j for j, c in enumerate(const) if c is None]
        if not live:
            return const, None, kept
        residual = Circuit(opt.n_inputs, opt.ops, [opt.outputs[j] for j in live])._dce()
        # Exact semantic constancy (folding can miss e.g. z1 OR z2 == 1 inside
        # an adder): evaluate the whole truth table at once over bigint masks.
        # Only for small support -- larger residuals are real case-3 work.
        if 1 <= residual.n_inputs <= _EXACT_CONST_MAX_INPUTS:
            outs = residual.evaluate(*_truth_table_masks(residual.n_inputs))
            full = (1 << (1 << residual.n_inputs)) - 1
            for j, v in zip(live, outs):
                if v == 0:
                    const[j] = 0
                elif v == full:
                    const[j] = 1
            still = [j for j in live if const[j] is None]
            if not still:
                return const, None, kept
            if len(still) != len(live):
                pos = {j: i for i, j in enumerate(live)}
                residual = Circuit(
                    residual.n_inputs, residual.ops,
                    [residual.outputs[pos[j]] for j in still],
                )._dce()
        return const, residual, kept

    def semantic_key(self) -> tuple:
        """Gate-order-independent identity of the computed function(s).

        A Merkle hash over the DAG: each node's digest is built from its op
        and its operands' digests (sorted for commutative ops), so two
        circuits that encode the same expression DAG with different gate
        orderings -- e.g. residuals of :meth:`specialize` under different
        constant assignments that fold to the same shape -- get the same
        key.  The tiled executor merges such residuals into one kernel
        launch.  ``n_inputs`` is part of the key because callers gather one
        data row per declared input, read or not.
        """
        import hashlib

        digests: dict[int, bytes] = {}

        def key_of(i: int) -> bytes:
            if i == CONST0:
                return b"0"
            if i == CONST1:
                return b"1"
            if i < self.n_inputs:
                return b"i%d" % i
            return digests[i]

        for idx, (op, a, b) in enumerate(self.ops):
            ka, kb = key_of(a), key_of(b)
            if op in ("and", "or", "xor") and kb < ka:
                ka, kb = kb, ka
            digests[self.n_inputs + idx] = hashlib.md5(
                b"%s(%s,%s)" % (op.encode(), ka, kb)
            ).digest()
        return (self.n_inputs, tuple(key_of(o) for o in self.outputs))

    # -- evaluation -------------------------------------------------------
    def evaluate(self, inputs: Sequence, zeros=None, ones=None):
        """Evaluate the DAG over int32 word tensors (or, with ``zeros`` and
        ``ones`` given, Python ints for testing)."""
        if zeros is None:
            zeros = torch.zeros_like(inputs[0])
        if ones is None:
            ones = torch.full_like(inputs[0], -1)  # all 32 bits set
        vals: dict[int, object] = {}

        def get(i):
            if i == CONST0:
                return zeros
            if i == CONST1:
                return ones
            if i < self.n_inputs:
                return inputs[i]
            return vals[i]

        for idx, (op, a, b) in enumerate(self.ops):
            va, vb = get(a), get(b)
            if op == "and":
                out = va & vb
            elif op == "or":
                out = va | vb
            elif op == "xor":
                out = va ^ vb
            elif op == "andnot":
                out = va & ~vb
            else:  # pragma: no cover
                raise ValueError(op)
            vals[self.n_inputs + idx] = out
        return [get(o) for o in self.outputs]


def _fold(op, a, b):
    """Constant folding / unary-gate elimination rules (paper 4.4.5)."""
    if op == "and":
        if a == CONST0 or b == CONST0:
            return CONST0
        if a == CONST1:
            return b
        if b == CONST1:
            return a
        if a == b:
            return a
    elif op == "or":
        if a == CONST1 or b == CONST1:
            return CONST1
        if a == CONST0:
            return b
        if b == CONST0:
            return a
        if a == b:
            return a
    elif op == "xor":
        if a == CONST0:
            return b
        if b == CONST0:
            return a
        if a == b:
            return CONST0
    elif op == "andnot":  # a & ~b
        if a == CONST0 or b == CONST1 or a == b:
            return CONST0
        if b == CONST0:
            return a
    return None


# specialize(): exact constancy detection is exponential in the residual
# support, so it is capped; 2^16-bit ints are ~8 KB, still cheap per gate.
_EXACT_CONST_MAX_INPUTS = 16


def _truth_table_masks(d: int):
    """(inputs, zeros, ones) for evaluating a d-input circuit over its whole
    truth table at once: input j's mask has bit a set iff (a >> j) & 1."""
    size = 1 << d
    full = (1 << size) - 1
    masks = []
    for j in range(d):
        half = 1 << j  # table entries per half-period
        seg = ((1 << half) - 1) << half  # one period: half zeros, half ones
        rep = full // ((1 << (2 * half)) - 1) if 2 * half < size else 1
        masks.append(seg * rep)
    return masks, 0, full


def _fold_complement(op, a, b, comp: dict):
    """Folds enabled by knowing b == NOT a (see Circuit.optimized)."""
    if comp.get(a) != b:
        return None
    if op == "and":
        return CONST0
    if op in ("or", "xor"):
        return CONST1
    if op == "andnot":  # a & ~(~a) = a
        return a
    return None


# ---------------------------------------------------------------------------
# Hamming-weight circuits
# ---------------------------------------------------------------------------


def sideways_sum_bits(c: Circuit, bits: Sequence[int]) -> list:
    """Knuth's sideways sum (paper 4.4.3, Fig. 2).

    Each level chains full adders (the sum bit of one adder feeds the next
    adder's carry-in), reducing m same-weight bits to one output bit z_x and
    ~m/2 bits of double weight.  Returns weight bits [z0, z1, ...] (LSB first).
    """
    zs = []
    level = list(bits)
    while level:
        if len(level) == 1:
            zs.append(level[0])
            level = []
            continue
        carries = []
        s = level[0]
        i = 1
        while i < len(level):
            if i + 1 < len(level):
                s, cy = c.full_adder(s, level[i], level[i + 1])
                i += 2
            else:
                s, cy = c.half_adder(s, level[i])
                i += 1
            carries.append(cy)
        zs.append(s)
        level = carries
    return zs


def tree_adder_bits(c: Circuit, bits: Sequence[int]) -> list:
    """Tree of ripple-carry adders (paper 4.4.2, Fig. 1).

    Pads the input count to a power of two with constant zeros; the
    constant-propagation pass removes the padding gates afterwards.
    Returns weight bits LSB-first.
    """
    n = len(bits)
    size = 1 << max(1, math.ceil(math.log2(max(n, 2))))
    padded = list(bits) + [CONST0] * (size - n)
    # numbers are (bit-list LSB-first, max-value) pairs; value-range tracking
    # suppresses carry bits that are provably zero (so the gate counts track
    # the true maximum sum for non-power-of-two N, matching paper Table 8)
    numbers = [([b], 0 if b == CONST0 else 1) for b in padded]
    while len(numbers) > 1:
        nxt = []
        for i in range(0, len(numbers), 2):
            (a, amax), (b, bmax) = numbers[i], numbers[i + 1]
            if len(a) < len(b):
                a, b = b, a
            b = b + [CONST0] * (len(a) - len(b))
            nxt.append((_ripple_add(c, a, b, amax + bmax), amax + bmax))
        numbers = nxt
    out_bits, out_max = numbers[0]
    need = max(1, out_max.bit_length())
    return out_bits[:need]


def _ripple_add(c: Circuit, xs: list, ys: list, maxv: int) -> list:
    assert len(xs) == len(ys)
    out = []
    s, carry = c.half_adder(xs[0], ys[0])
    out.append(s)
    for a, b in zip(xs[1:], ys[1:]):
        s, carry = c.full_adder(a, b, carry)
        out.append(s)
    if maxv >= (1 << len(xs)):
        out.append(carry)
    else:
        out.append(CONST0)
    return out


# ---------------------------------------------------------------------------
# >= T comparator against a constant (paper 4.4.2's prefix_match circuit)
# ---------------------------------------------------------------------------


def ge_const(c: Circuit, weight_bits: Sequence[int], t: int) -> int:
    """Return node computing (binary number ``weight_bits``) >= t.

    Implements the paper's optimised constant comparator: with a = t - 1,
    result = OR over zero-positions j of a of (prefix_match(j) & b_j) where
    prefix_match(j) = AND of b_k over k > j with a_k = 1, shared incrementally.
    """
    n = len(weight_bits)
    if t <= 0:
        return CONST1
    if t >= (1 << n) + 1:
        return CONST0
    a = t - 1
    if a >= (1 << n):
        return CONST0
    terms = []
    prefix = None  # AND of b_k at one-positions seen so far (left to right)
    for j in range(n - 1, -1, -1):
        bit_a = (a >> j) & 1
        bj = weight_bits[j]
        if bit_a == 0:
            if prefix is None:
                terms.append(bj)
            else:
                terms.append(c.AND(prefix, bj))
        else:
            prefix = bj if prefix is None else c.AND(prefix, bj)
    return c.wide_or(terms)


def le_const(c: Circuit, weight_bits: Sequence[int], t: int) -> int:
    """weight <= t as NOT(weight >= t+1); used for interval functions."""
    ge = ge_const(c, weight_bits, t + 1)
    return c.NOT(ge) if ge >= 0 else (CONST1 if ge == CONST0 else CONST0)


# ---------------------------------------------------------------------------
# Batcher odd-even sorting network (SRTCKT)
# ---------------------------------------------------------------------------


def _batcher_pairs(n: int):
    """Comparator pairs of Batcher's odd-even mergesort on n wires."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, k):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def sorter_outputs(c: Circuit, bits: Sequence[int]) -> list:
    """Sorting network outputs, descending (ones first).

    Output wire ``T-1`` is then exactly the T-threshold (paper 4.4.1).
    """
    wires = list(bits)
    n = len(wires)
    size = 1 << max(1, math.ceil(math.log2(max(n, 2))))
    wires = wires + [CONST0] * (size - n)

    def comp(i, j):
        hi = c.OR(wires[i], wires[j])
        lo = c.AND(wires[i], wires[j])
        wires[i], wires[j] = hi, lo

    for i, j in _batcher_pairs(len(wires)):
        comp(i, j)
    return wires[:n]


# ---------------------------------------------------------------------------
# Top-level circuit constructors
# ---------------------------------------------------------------------------


def build_threshold_circuit(n: int, t: int, kind: str) -> Circuit:
    """Build an optimised circuit computing theta(t, N inputs).

    kind in {"ssum", "treeadd", "srtckt", "sopckt"}.
    """
    c = Circuit(n, [], [])
    ins = list(range(n))
    if t <= 0:
        c.outputs = [CONST1]
        return c
    if t > n:
        c.outputs = [CONST0]
        return c
    if t == 1 and kind != "sopckt":
        c.outputs = [c.wide_or(ins)]
        return c.optimized()
    if t == n and kind != "sopckt":
        c.outputs = [c.wide_and(ins)]
        return c.optimized()
    if kind == "ssum":
        out = ge_const(c, sideways_sum_bits(c, ins), t)
    elif kind == "treeadd":
        out = ge_const(c, tree_adder_bits(c, ins), t)
    elif kind == "srtckt":
        out = sorter_outputs(c, ins)[t - 1]
    elif kind == "sopckt":
        import itertools

        terms = [c.wide_and(list(combo)) for combo in itertools.combinations(ins, t)]
        out = c.wide_or(terms)
    else:  # pragma: no cover
        raise ValueError(kind)
    c.outputs = [out]
    return c.optimized()


def build_weight_circuit(n: int, kind: str = "ssum") -> Circuit:
    """Circuit whose outputs are the Hamming-weight bits (LSB first)."""
    c = Circuit(n, [], [])
    ins = list(range(n))
    bits = sideways_sum_bits(c, ins) if kind == "ssum" else tree_adder_bits(c, ins)
    c.outputs = list(bits)
    return c.optimized()


def build_symmetric_circuit(n: int, truth: Sequence[bool], kind: str = "ssum") -> Circuit:
    """Circuit for an arbitrary symmetric function given by its value on
    each Hamming weight 0..n (paper 2.2 / 4.4: synthesise from weight bits)."""
    assert len(truth) == n + 1
    c = Circuit(n, [], [])
    bits = sideways_sum_bits(c, list(range(n))) if kind == "ssum" else tree_adder_bits(
        c, list(range(n))
    )
    nb = len(bits)
    # Sum-of-products over the weight bits, with a tiny optimisation: merge
    # contiguous true-runs [lo, hi] into interval tests (>=lo AND NOT >=hi+1).
    runs = []
    w = 0
    while w <= n:
        if truth[w]:
            lo = w
            while w + 1 <= n and truth[w + 1]:
                w += 1
            runs.append((lo, w))
        w += 1
    terms = []
    for lo, hi in runs:
        ge_lo = ge_const(c, bits, lo)
        if hi >= n:
            terms.append(ge_lo)
        else:
            ge_hi1 = ge_const(c, bits, hi + 1)
            terms.append(c.ANDNOT(ge_lo, ge_hi1))
    c.outputs = [c.wide_or(terms)]
    return c.optimized()


def build_interval_circuit(n: int, lo: int, hi: int, kind: str = "ssum") -> Circuit:
    truth = [lo <= w <= hi for w in range(n + 1)]
    return build_symmetric_circuit(n, truth, kind)


# Reference formulas from the paper, used by tests/benchmarks --------------


def paper_tree_adder_gates(n_pow2: int) -> int:
    """c(2^k) = 7N - 5 log2 N - 7 (paper 4.4.2)."""
    k = int(math.log2(n_pow2))
    assert 1 << k == n_pow2
    return 7 * n_pow2 - 5 * k - 7


def looped_op_count(n: int, t: int) -> int:
    """2NT - N - T^2 + T - 1 binary ops (paper 4.5)."""
    return 2 * n * t - n - t * t + t - 1
