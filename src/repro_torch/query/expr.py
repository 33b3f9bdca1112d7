"""Query expression trees.

Leaves are symmetric Boolean functions of a set of columns (default: every
column of the index) or references to a single named column; combinators
are the paper's bitmap primitives AND / OR / NOT / ANDNOT.  Expressions are
immutable, hashable-by-structure values: ``q.key()`` is the *query shape*
used to key the compiled-circuit cache, and never contains data.

Sub-queries compose freely: any expression can appear where a column is
expected (``Threshold(2, over=("a", And("b", "c")))``) because a gate
output is just another input bit to the sideways-sum adder.

Python operators are overloaded for fluency::

    Interval(2, 10) & ~Threshold(15)       # And(Interval(2,10), Not(Threshold(15)))
    Col("a") | Col("b")                    # Or(Col("a"), Col("b"))
    Threshold(2) - Col("returns")          # AndNot(Threshold(2), Col("returns"))
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = [
    "Query",
    "Col",
    "Threshold",
    "Interval",
    "Exactly",
    "Parity",
    "Majority",
    "Weighted",
    "Sym",
    "And",
    "Or",
    "Not",
    "AndNot",
    "as_query",
    "bind_members",
    "canonical_key",
    "column_refs",
]


@dataclasses.dataclass(frozen=True)
class Query:
    """Base class: operator overloads + structural cache key."""

    def key(self) -> tuple:
        raise NotImplementedError

    def __and__(self, other) -> "And":
        return And(self, other)

    def __or__(self, other) -> "Or":
        return Or(self, other)

    def __invert__(self) -> "Not":
        return Not(self)

    def __sub__(self, other) -> "AndNot":
        return AndNot(self, other)


def as_query(x) -> Query:
    """Coerce a column name into :class:`Col`; pass queries through."""
    if isinstance(x, Query):
        return x
    if isinstance(x, str):
        return Col(x)
    raise TypeError(f"expected Query or column name, got {type(x).__name__}: {x!r}")


def _norm_over(over) -> tuple | None:
    if over is None:
        return None
    if isinstance(over, (str, Query)):
        over = (over,)
    out = tuple(as_query(x) for x in over)
    if not out:
        raise ValueError("`over` must name at least one column or sub-query")
    return out


def _over_key(over: tuple | None) -> tuple | None:
    return None if over is None else tuple(q.key() for q in over)


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Col(Query):
    """A named column of the index (base or virtual)."""

    name: str

    def key(self) -> tuple:
        return ("col", self.name)


@dataclasses.dataclass(frozen=True)
class _SymmetricLeaf(Query):
    """Shared machinery: a symmetric function over a member set."""

    over: tuple | None = None

    def __post_init__(self):
        object.__setattr__(self, "over", _norm_over(self.over))

    def truth(self, n: int) -> tuple:
        """Truth table on Hamming weights 0..n; n = number of members."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Threshold(_SymmetricLeaf):
    """At least ``t`` of the members are set (theta(T, .), paper 2.3)."""

    t: int = 1

    def __init__(self, t: int, over=None):
        object.__setattr__(self, "t", int(t))
        object.__setattr__(self, "over", _norm_over(over))

    def truth(self, n: int) -> tuple:
        return tuple(w >= self.t for w in range(n + 1))

    def key(self) -> tuple:
        return ("threshold", self.t, _over_key(self.over))


@dataclasses.dataclass(frozen=True)
class Interval(_SymmetricLeaf):
    """Member count within [lo, hi] ('on sale in 2 to 10 stores').

    An empty interval (lo > hi) is the constant-false query.
    """

    lo: int = 0
    hi: int = 0

    def __init__(self, lo: int, hi: int, over=None):
        object.__setattr__(self, "lo", int(lo))
        object.__setattr__(self, "hi", int(hi))
        object.__setattr__(self, "over", _norm_over(over))

    def truth(self, n: int) -> tuple:
        return tuple(self.lo <= w <= self.hi for w in range(n + 1))

    def key(self) -> tuple:
        return ("interval", self.lo, self.hi, _over_key(self.over))


@dataclasses.dataclass(frozen=True)
class Exactly(_SymmetricLeaf):
    """Member count == k (the paper's delta function)."""

    k: int = 0

    def __init__(self, k: int, over=None):
        object.__setattr__(self, "k", int(k))
        object.__setattr__(self, "over", _norm_over(over))

    def truth(self, n: int) -> tuple:
        return tuple(w == self.k for w in range(n + 1))

    def key(self) -> tuple:
        return ("exactly", self.k, _over_key(self.over))


@dataclasses.dataclass(frozen=True)
class Parity(_SymmetricLeaf):
    """Odd member count (wide XOR = weight bit z0)."""

    def truth(self, n: int) -> tuple:
        return tuple(w % 2 == 1 for w in range(n + 1))

    def key(self) -> tuple:
        return ("parity", _over_key(self.over))


@dataclasses.dataclass(frozen=True)
class Majority(_SymmetricLeaf):
    """More than half the members set: theta(ceil(n/2))."""

    def truth(self, n: int) -> tuple:
        t = (n + 1) // 2
        return tuple(w >= t for w in range(n + 1))

    def key(self) -> tuple:
        return ("majority", _over_key(self.over))


@dataclasses.dataclass(frozen=True)
class Sym(_SymmetricLeaf):
    """Arbitrary symmetric function given by its weight truth table.

    ``table`` must have exactly n_members + 1 entries at execution time.
    """

    table: tuple = ()

    def __init__(self, table: Sequence, over=None):
        object.__setattr__(self, "table", tuple(bool(x) for x in table))
        object.__setattr__(self, "over", _norm_over(over))

    def truth(self, n: int) -> tuple:
        if len(self.table) != n + 1:
            raise ValueError(
                f"Sym truth table has {len(self.table)} entries for {n} members "
                f"(needs {n + 1})"
            )
        return self.table

    def key(self) -> tuple:
        return ("sym", self.table, _over_key(self.over))


@dataclasses.dataclass(frozen=True)
class Weighted(Query):
    """sum_i w_i b_i >= t over the members (binary weight decomposition)."""

    weights: tuple = ()
    t: int = 1
    over: tuple | None = None

    def __init__(self, weights: Sequence[int], t: int, over=None):
        ws = tuple(int(w) for w in weights)
        if any(w < 0 for w in ws):
            raise ValueError("weights must be non-negative integers")
        object.__setattr__(self, "weights", ws)
        object.__setattr__(self, "t", int(t))
        object.__setattr__(self, "over", _norm_over(over))

    def key(self) -> tuple:
        return ("weighted", self.weights, self.t, _over_key(self.over))


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class And(Query):
    children: tuple = ()

    def __init__(self, *children):
        if not children:
            raise ValueError("And() needs at least one child")
        object.__setattr__(self, "children", tuple(as_query(c) for c in children))

    def key(self) -> tuple:
        return ("and",) + tuple(c.key() for c in self.children)


@dataclasses.dataclass(frozen=True)
class Or(Query):
    children: tuple = ()

    def __init__(self, *children):
        if not children:
            raise ValueError("Or() needs at least one child")
        object.__setattr__(self, "children", tuple(as_query(c) for c in children))

    def key(self) -> tuple:
        return ("or",) + tuple(c.key() for c in self.children)


@dataclasses.dataclass(frozen=True)
class Not(Query):
    child: Query = None  # type: ignore[assignment]

    def __init__(self, child):
        object.__setattr__(self, "child", as_query(child))

    def key(self) -> tuple:
        return ("not", self.child.key())


@dataclasses.dataclass(frozen=True)
class AndNot(Query):
    """keep AND NOT drop -- the paper's ANDNOT primitive."""

    keep: Query = None  # type: ignore[assignment]
    drop: Query = None  # type: ignore[assignment]

    def __init__(self, keep, drop):
        object.__setattr__(self, "keep", as_query(keep))
        object.__setattr__(self, "drop", as_query(drop))

    def key(self) -> tuple:
        return ("andnot", self.keep.key(), self.drop.key())


def _sorted_keys(keys) -> tuple:
    # keys are heterogeneous nested tuples (ints, strs, None); repr gives a
    # total, deterministic order where tuple comparison would raise
    return tuple(sorted(keys, key=repr))


def canonical_key(q: Query) -> tuple:
    """A *semantic* cache key: equal for queries that provably compute the
    same bitmap, stricter than :meth:`Query.key` (which is structural).

    Normalisations applied recursively:

      * symmetric-function leaves sort their member keys (a symmetric
        function cannot depend on member order);
      * :class:`Weighted` sorts (member, weight) pairs together;
      * :class:`And` / :class:`Or` flatten same-operator children, sort and
        deduplicate them (idempotence), and collapse the single-child case;
      * double negation cancels.

    This is the key the serving tier's result cache and in-flight request
    deduplication use (a serving front end): two clients asking
    ``Threshold(2, over=("a", "b"))`` and ``Threshold(2, over=("b", "a"))``
    share one execution and one cache entry.  Implicit ``over=None`` member
    sets are kept as ``None`` -- resolve them first with
    :func:`bind_members` when the key must be schema-stable.
    """

    def over_key(over):
        return None if over is None else _sorted_keys(canonical_key(m) for m in over)

    q = as_query(q)
    if type(q) is Col:
        return ("col", q.name)
    if isinstance(q, Threshold):
        return ("threshold", q.t, over_key(q.over))
    if isinstance(q, Interval):
        return ("interval", q.lo, q.hi, over_key(q.over))
    if isinstance(q, Exactly):
        return ("exactly", q.k, over_key(q.over))
    if isinstance(q, Parity):
        return ("parity", over_key(q.over))
    if isinstance(q, Majority):
        return ("majority", over_key(q.over))
    if isinstance(q, Sym):
        return ("sym", q.table, over_key(q.over))
    if isinstance(q, Weighted):
        if q.over is None:
            return ("weighted", q.weights, q.t, None)
        pairs = sorted(
            zip((canonical_key(m) for m in q.over), q.weights),
            key=lambda kw: repr(kw[0]),
        )
        return (
            "weighted",
            tuple(w for _, w in pairs),
            q.t,
            tuple(k for k, _ in pairs),
        )
    if isinstance(q, (And, Or)):
        tag = "and" if isinstance(q, And) else "or"
        parts = []
        for c in q.children:
            k = canonical_key(c)
            if k[0] == tag:  # flatten And(And(a,b),c) -> And(a,b,c)
                parts.extend(k[1:])
            else:
                parts.append(k)
        parts = _sorted_keys(set(parts))
        if len(parts) == 1:
            return parts[0]
        return (tag,) + parts
    if isinstance(q, Not):
        k = canonical_key(q.child)
        if k[0] == "not":
            return k[1]
        return ("not", k)
    if isinstance(q, AndNot):
        return ("andnot", canonical_key(q.keep), canonical_key(q.drop))
    raise TypeError(f"unknown query node {type(q).__name__}")


def column_refs(q: Query) -> frozenset | None:
    """The set of column names a query reads, or ``None`` when any leaf has
    an implicit ``over=None`` member set (meaning "every column at execution
    time" -- the caller must :func:`bind_members` first to resolve it).
    Used by the serving tier to build per-column cache version vectors."""
    names: set = set()

    def walk(x: Query) -> bool:
        if type(x) is Col:
            names.add(x.name)
            return True
        if isinstance(x, (_SymmetricLeaf, Weighted)):
            if x.over is None:
                return False
            return all(walk(m) for m in x.over)
        if isinstance(x, (And, Or)):
            return all(walk(c) for c in x.children)
        if isinstance(x, Not):
            return walk(x.child)
        if isinstance(x, AndNot):
            return walk(x.keep) and walk(x.drop)
        raise TypeError(f"unknown query node {type(x).__name__}")

    return frozenset(names) if walk(as_query(q)) else None


def bind_members(q: Query, names) -> Query:
    """Resolve every implicit ``over=None`` member set to the explicit
    column tuple ``names``, recursively.

    ``over=None`` means "every column of the index at execution time" --
    correct for ad-hoc queries, wrong for a *registered* one: a streaming
    materialized view must keep meaning what it meant when registered,
    even after new (view) columns join the schema.  Explicit member sets
    pass through untouched.
    """
    cols = tuple(Col(str(x)) for x in names)

    def bind(x: Query) -> Query:
        if isinstance(x, _SymmetricLeaf):
            over = cols if x.over is None else tuple(bind(m) for m in x.over)
            if isinstance(x, Threshold):
                return Threshold(x.t, over)
            if isinstance(x, Interval):
                return Interval(x.lo, x.hi, over)
            if isinstance(x, Exactly):
                return Exactly(x.k, over)
            if isinstance(x, Parity):
                return Parity(over)
            if isinstance(x, Majority):
                return Majority(over)
            if isinstance(x, Sym):
                return Sym(x.table, over)
            raise TypeError(f"unknown symmetric leaf {type(x).__name__}")
        if isinstance(x, Weighted):
            over = cols if x.over is None else tuple(bind(m) for m in x.over)
            return Weighted(x.weights, x.t, over)
        if isinstance(x, And):
            return And(*(bind(c) for c in x.children))
        if isinstance(x, Or):
            return Or(*(bind(c) for c in x.children))
        if isinstance(x, Not):
            return Not(bind(x.child))
        if isinstance(x, AndNot):
            return AndNot(bind(x.keep), bind(x.drop))
        return x  # Col

    return bind(as_query(q))



