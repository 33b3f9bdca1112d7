"""The one traffic generator: query specs, request orders and update batches
drawn from a traffic file's parameters and the run's seed.

A spec is a plain dict that both sides read: the program adapter
(``bench/program.py``) turns it into a ``repro_torch`` query, the reference
(``bench/reference.py``) evaluates it.  ``members`` are column numbers.

Kinds, over ``n`` columns read, with their parameters from the traffic
file's ``params`` table (keyed by ``n``):

* ``threshold``: at least ``t`` of ``n`` members;
* ``interval``: between ``lo`` and ``hi`` of ``n`` members (the paper's
  "2 to 10 stores");
* ``weighted``: the ``weights`` (``n`` of them, one pattern repeated) in an
  order the seed permutes, ``t`` half their total;
* ``andnot``: at least ``t`` of ``n - 1`` members and not column ``drop``:
  a result processed further in the index.

The seed draws the member columns, the order of the weights and the order
of the requests; the parameters are the table's, a fixed grid across the
range of each kind (the traffic file's ``grid`` names its source).  A threshold's cost on
clustered data moves with ``t`` far more than with the members (a low
threshold leaves fewer tiles constant), so drawing ``t`` would change the
work from seed to seed.  Every seed gets the same sizes, kinds and
parameters in the same proportions: the recurring templates are one of
each (n, kind) pair, requests cycle through them in blocks of one
permutation each, and ad-hoc requests draw a fresh spec of each pair once
a block.
"""
from __future__ import annotations

import numpy as np

from bench.common import derive_seed


def rng_for(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive_seed(seed, tag))


def draw_spec(rng: np.random.Generator, kind: str, n: int, n_cols: int, params: dict) -> dict:
    if not 8 <= n <= n_cols:
        raise ValueError(f"{n} columns read of {n_cols}")
    p = {k: (v[str(n)] if isinstance(v, dict) else v) for k, v in params[kind].items()}
    cols = [int(c) for c in rng.choice(n_cols, size=n, replace=False)]
    if kind == "threshold":
        return {"kind": kind, "members": cols, "t": int(p["t"])}
    if kind == "interval":
        return {"kind": kind, "members": cols, "lo": int(p["lo"]), "hi": int(p["hi"])}
    if kind == "weighted":
        pattern = [int(w) for w in p["weights"]]
        w = [int(x) for x in rng.permutation(np.resize(pattern, n))]
        return {"kind": kind, "members": cols, "weights": w, "t": sum(w) // 2}
    if kind == "andnot":
        return {"kind": kind, "members": cols[:-1], "drop": cols[-1], "t": int(p["t"])}
    raise ValueError(f"unknown query kind {kind!r}")


def columns_read(spec: dict) -> list:
    """Every column a spec reads."""
    return list(spec["members"]) + ([spec["drop"]] if "drop" in spec else [])


def pairs(traffic: dict) -> list:
    return [(n, k) for n in traffic["columns_read"] for k in traffic["kinds"]]


def recurring(traffic: dict, n_cols: int, seed: int) -> list:
    """One spec for each (columns read, kind) pair."""
    rng = rng_for(seed, "templates")
    return [draw_spec(rng, k, n, n_cols, traffic["params"]) for n, k in pairs(traffic)]


def order(n_templates: int, seed: int, tag: str = "order"):
    """Template numbers forever, in blocks that each hold every template once."""
    rng = rng_for(seed, tag)
    while True:
        yield from (int(i) for i in rng.permutation(n_templates))


def adhoc(traffic: dict, n_cols: int, seed: int, tag: str):
    """Fresh specs forever: each block of ``len(pairs)`` requests draws one
    new spec of every (columns read, kind) pair, in a permuted order."""
    rng = rng_for(seed, tag)
    ps = pairs(traffic)
    while True:
        for i in rng.permutation(len(ps)):
            n, k = ps[int(i)]
            yield draw_spec(rng, k, n, n_cols, traffic["params"])


def updates(traffic: dict, r: int, n_cols: int, seed: int, count: int) -> list:
    """``count`` update batches: (column, set positions, clear positions)."""
    u = traffic["updates"]
    rng = rng_for(seed, "updates")
    size = int(u["positions"])
    n_set = int(round(size * float(u["set_share"])))
    recent_lo = r - max(1, int(r * float(u["recent_rows_fraction"])))
    out = []
    for _ in range(count):
        col = int(rng.integers(0, n_cols))
        recent = rng.random(size) < float(u["recent_share"])
        pos = np.where(recent, rng.integers(recent_lo, r, size=size),
                       rng.integers(0, r, size=size)).astype(np.int64)
        out.append((col, pos[:n_set], pos[n_set:]))
    return out
