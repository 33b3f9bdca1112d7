"""Table 5: bitmap-index SCANCOUNT vs a no-index row scan.

The paper's point: answering a T-occurrence query from a bitmap index beats
scanning the base table ~4x (random-attribute queries) and still wins on
similarity queries.  We reproduce the *structure*: a row-store table of D
attributes vs its unary bitmap index, timed on the same query set.

The port's counterpart of ``benchmarks/table5_rowscan.py``: the index lives
on ``device`` (default: the CUDA card) and SCANCOUNT there is a chain of
torch ops; each timed call ends in a synchronise of the device.  The row
scan stays numpy on the host.  Every query's index answer is held against
the row scan's rows.

    PYTHONPATH=src:. python benchmarks/pt_table5_rowscan.py [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.pt_common import time_call
from repro_torch.core.bitmaps import pack, to_positions_np
from repro_torch.core.threshold import threshold
from repro_torch.device import resolve_device


def build_table(rows=10_000, attrs=42, values=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, values, (rows, attrs), dtype=np.int32)


def row_scan(table, query, t):
    """Algorithm 1: per-row counter over attribute predicates."""
    counts = (table == np.asarray(query)[None, :]).sum(axis=1)
    return np.nonzero(counts >= t)[0]


def bitmap_index(table, values, device=None):
    rows, attrs = table.shape
    bitmaps = []
    for a in range(attrs):
        for v in range(values):
            bitmaps.append(table[:, a] == v)
    return pack(np.stack(bitmaps), device)


def run(reps=5, device=None):
    dev = resolve_device(device)
    rows, attrs, values = 10_000, 42, 8
    table = build_table(rows, attrs, values)
    index = bitmap_index(table, values, dev)
    rng = np.random.default_rng(1)
    results = []
    for trial in range(10):
        query = rng.integers(0, values, attrs)
        t = int(rng.integers(2, attrs - 1))
        sel = torch.as_tensor([a * values + int(v) for a, v in enumerate(query)], device=dev)
        chosen = index.index_select(0, sel)
        t_row, expect = time_call(lambda: row_scan(table, query, t), None, reps)
        t_idx, got = time_call(lambda: threshold(chosen, t, "scancount"), dev, reps)
        if not np.array_equal(to_positions_np(got), expect):
            raise AssertionError(f"trial {trial}: the index's rows differ from the row scan's")
        results.append((t_row, t_idx))
    row = np.mean([r[0] for r in results])
    idx = np.mean([r[1] for r in results])
    return [
        ("table5_rowscan_us", row * 1e6, ""),
        ("table5_bitmap_scancount_us", idx * 1e6, f"speedup={row / idx:.1f}x"),
    ]


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    for name, val, extra in run(device=parse_args().device):
        print(f"{name},{val:.1f},{extra}")
