"""Weighted threshold functions over bitmaps.

The paper (2.3) handles integer weights by replicating input i w_i times
and notes "this approach may be practical if weights are small.  Otherwise,
the resulting threshold query may be impractically wide."

Beyond-paper contribution: **binary weight decomposition**.  Write each
weight w_i = sum_j 2^j * w_ij.  The weighted count is

    sum_i w_i b_i = sum_j 2^j * (count of set inputs with bit j of weight)

so we feed, for each j, the inputs whose weight has bit j into a sideways
sum, then combine the per-level Hamming-weight digits with a shift-add:
total circuit size O(sum_j s(|level_j|) + log-width adders) -- logarithmic
in max(w) instead of linear (replication costs s(sum_i w_i) gates).

Example: N=64 inputs with weights up to 1000.  Replication would build a
~64000-input adder (~5 * 64000 = 320k gates); decomposition builds 10
64-input sideways sums plus shift-adds (~10 * 5 * 64 + overhead ~= 4k gates),
an ~80x reduction, still yielding a bitmap.
"""
from __future__ import annotations

from typing import Sequence

from . import circuits as C

__all__ = ["build_weighted_threshold_circuit", "emit_weighted_ge",
           "weighted_threshold_decomposed", "replication_gate_cost", "decomposed_gate_cost"]


def emit_weighted_ge(c: C.Circuit, member_ids: Sequence[int], weights: Sequence[int],
                     t: int) -> int:
    """Emit gates computing sum_i w_i b_i >= t over existing circuit nodes.

    ``member_ids`` may be inputs or gate outputs (sub-queries), so weighted
    thresholds compose inside larger query circuits.  Returns the output
    node id.
    """
    if len(member_ids) != len(weights):
        raise ValueError(f"{len(weights)} weights for {len(member_ids)} members")
    total = sum(weights)
    if t <= 0:
        return C.CONST1
    if t > total:
        return C.CONST0
    wmax = max(weights)
    levels = wmax.bit_length()
    # per-bit-level Hamming weights (LSB-first digit vectors)
    acc_bits: list = []  # binary number, LSB first, accumulating shifted sums
    acc_max = 0
    for j in range(levels):
        members = [m for m, w in zip(member_ids, weights) if (w >> j) & 1]
        if not members:
            continue
        digits = C.sideways_sum_bits(c, members)  # weight of this level
        shifted = [C.CONST0] * j + digits  # x 2^j
        level_max = len(members) << j
        if not acc_bits:
            acc_bits, acc_max = shifted, level_max
        else:
            width = max(len(acc_bits), len(shifted))
            a = acc_bits + [C.CONST0] * (width - len(acc_bits))
            b = shifted + [C.CONST0] * (width - len(shifted))
            acc_max = acc_max + level_max
            acc_bits = C._ripple_add(c, a, b, acc_max)
            acc_bits = acc_bits[: max(1, acc_max.bit_length())]
    return C.ge_const(c, acc_bits, t)


def build_weighted_threshold_circuit(weights: Sequence[int], t: int) -> C.Circuit:
    """Circuit over N inputs computing sum_i w_i b_i >= t."""
    n = len(weights)
    c = C.Circuit(n, [], [])
    c.outputs = [emit_weighted_ge(c, list(range(n)), weights, t)]
    return c.optimized()


def weighted_threshold_decomposed(bitmaps, weights: tuple, t: int, *, device=None):
    """Evaluate the decomposed weighted threshold over packed bitmaps.

    ``device`` is the transient index's device (default: the CUDA card).

    .. deprecated:: shim over ``repro_torch.query`` (``Weighted(weights, t)``
       through the compiled-circuit cache); prefer ``BitmapIndex.execute``.
    """
    from repro_torch.query import Weighted, execute

    return execute(bitmaps, Weighted(tuple(int(w) for w in weights), int(t)), device=device)


def replication_gate_cost(weights: Sequence[int], t: int) -> int:
    """Gate count of the paper's replication approach (for comparison)."""
    n_rep = sum(weights)
    return C.build_threshold_circuit(n_rep, t, "ssum").gate_count()


def decomposed_gate_cost(weights: Sequence[int], t: int) -> int:
    return build_weighted_threshold_circuit(list(weights), t).gate_count()
