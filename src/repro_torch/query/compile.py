"""Compile query expression trees into one shared Boolean circuit.

The whole point of compiling the *tree* instead of executing node by node:
every symmetric leaf over the same member set shares ONE sideways-sum adder
(memoised here, then CSE'd again by ``Circuit.optimized``), and combinators
are single gates.  ``And(Interval(2, 10), Not(Threshold(15)))`` costs one
adder plus two comparators plus two gates -- not three separate kernel
launches with intermediate bitmaps round-tripping through device memory.

Sub-queries are ordinary circuit nodes, so they can feed *into* adders:
``Threshold(2, over=("a", And("b", "c"), Interval(1, 2)))`` counts a gate
output as one vote.  Multi-query compilation (``execute_many``) simply adds
more outputs to the same circuit.

The compiled circuit is also what the storage engine's tiled executor
consumes: the tiled executor partially evaluates it per
tile-class signature (``Circuit.specialize``), so a multi-output circuit
means all batched queries share ONE dirty-tile gather, and ``.support()``
(the inputs actually reachable from the outputs) bounds the signature
space to the columns the queries really read.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core import circuits as _ckt
from repro_torch.core.weighted import emit_weighted_ge

from .expr import (
    And,
    AndNot,
    Col,
    Not,
    Or,
    Parity,
    Query,
    Threshold,
    Weighted,
    _SymmetricLeaf,
)

__all__ = ["build_query_circuit"]


def _truth_runs(truth: Sequence[bool]):
    """Contiguous true-runs [(lo, hi)] of a weight truth table."""
    runs = []
    w = 0
    n = len(truth) - 1
    while w <= n:
        if truth[w]:
            lo = w
            while w + 1 <= n and truth[w + 1]:
                w += 1
            runs.append((lo, w))
        w += 1
    return runs


class _Builder:
    def __init__(self, n_inputs: int, names: Sequence[str]):
        if len(set(names)) != len(names):
            raise ValueError("duplicate column names")
        if len(names) != n_inputs:
            raise ValueError(f"{len(names)} names for {n_inputs} columns")
        self.c = _ckt.Circuit(n_inputs, [], [])
        self.slot = {name: i for i, name in enumerate(names)}
        self._expr_memo: dict[tuple, int] = {}
        self._weight_memo: dict[tuple, list] = {}

    def weight_bits(self, member_ids: tuple) -> list:
        """Sideways-sum weight bits, shared across every leaf over the same
        member set (the core reuse win of whole-tree compilation)."""
        bits = self._weight_memo.get(member_ids)
        if bits is None:
            bits = _ckt.sideways_sum_bits(self.c, list(member_ids))
            self._weight_memo[member_ids] = bits
        return bits

    def members(self, over: tuple | None) -> tuple:
        if over is None:
            return tuple(range(self.c.n_inputs))
        return tuple(self.emit(q) for q in over)

    def emit(self, q: Query) -> int:
        key = q.key()
        got = self._expr_memo.get(key)
        if got is not None:
            return got
        out = self._emit(q)
        self._expr_memo[key] = out
        return out

    def _emit(self, q: Query) -> int:
        c = self.c
        if isinstance(q, Col):
            try:
                return self.slot[q.name]
            except KeyError:
                raise KeyError(
                    f"unknown column {q.name!r}; index has {sorted(self.slot)[:8]}..."
                ) from None
        if isinstance(q, And):
            return c.wide_and([self.emit(x) for x in q.children])
        if isinstance(q, Or):
            return c.wide_or([self.emit(x) for x in q.children])
        if isinstance(q, Not):
            inner = self.emit(q.child)
            if inner == _ckt.CONST0:
                return _ckt.CONST1
            if inner == _ckt.CONST1:
                return _ckt.CONST0
            return c.NOT(inner)
        if isinstance(q, AndNot):
            return c.ANDNOT(self.emit(q.keep), self.emit(q.drop))
        if isinstance(q, Weighted):
            return emit_weighted_ge(c, list(self.members(q.over)), q.weights, q.t)
        if isinstance(q, _SymmetricLeaf):
            return self._emit_symmetric(q)
        raise TypeError(f"cannot compile {type(q).__name__}")

    def _emit_symmetric(self, q: _SymmetricLeaf) -> int:
        c = self.c
        ids = self.members(q.over)
        n = len(ids)
        truth = q.truth(n)
        if not any(truth):
            return _ckt.CONST0
        if all(truth):
            return _ckt.CONST1
        if isinstance(q, Parity):
            return self.weight_bits(ids)[0]
        # thresholds at the degenerate ends need no adder at all
        if isinstance(q, Threshold):
            if q.t == 1:
                return c.wide_or(list(ids))
            if q.t == n:
                return c.wide_and(list(ids))
        bits = self.weight_bits(ids)
        terms = []
        for lo, hi in _truth_runs(truth):
            ge_lo = _ckt.ge_const(c, bits, lo)
            if hi >= n:
                terms.append(ge_lo)
            else:
                ge_hi1 = _ckt.ge_const(c, bits, hi + 1)
                terms.append(c.ANDNOT(ge_lo, ge_hi1))
        return c.wide_or(terms)


def build_query_circuit(
    queries: Sequence[Query], n_inputs: int, names: Sequence[str]
) -> _ckt.Circuit:
    """Compile one or more queries into a single optimised multi-output
    circuit over the index columns (input i = column ``names[i]``)."""
    b = _Builder(n_inputs, names)
    b.c.outputs = [b.emit(q) for q in queries]
    return b.c.optimized()
