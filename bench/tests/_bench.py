"""Shared set-up of the benchmark's CPU tests: the repository root and
``src`` on the import path, and a tiny run of a cell on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: rows of a tiny run of 64 columns or fewer: 64 tiles of 64 words
TINY_ROWS = 1 << 17
#: the fewest rows of a tiny run: 4 tiles of 64 words
MIN_TINY_ROWS = 1 << 13
#: bits a tiny run holds, whatever its column count
TINY_BITS = TINY_ROWS * 64

#: cells whose loops the harness keeps but BENCHMARK.json does not list yet
#: (PERF.md, open questions): their entries as a later PR would add them, so
#: that the CPU tests keep driving the live loop
PARKED = {
    "workloads": [
        {"name": "clustered64.live-updates", "config": "paper-clustered-moderate-2e27",
         "traffic": "live20", "chips": 1,
         "why": "recurring16 on a StreamingIndex with a 64-bit update batch every 50 ms"},
    ],
    "per_layer": [
        {"name": "stream.delta_words", "unit": "words", "better": "lower",
         "source": "program_counter", "layer": "stream", "moves": "queries_per_s",
         "workloads": ["clustered64.live-updates"]},
        {"name": "stream.compactions", "unit": "compactions", "better": "lower",
         "source": "program_counter", "layer": "stream", "moves": "query_p95_ms",
         "workloads": ["clustered64.live-updates"]},
    ],
}


def with_parked():
    """The benchmark's layout with the parked cells and metrics added."""
    import copy

    from bench import run as harness

    out = harness.Layout(ROOT)
    out.spec = copy.deepcopy(out.spec)
    for key, entries in PARKED.items():
        out.spec[key].extend(copy.deepcopy(entries))
    return out


def cells() -> list:
    """Every cell of BENCHMARK.json, then the parked ones."""
    return [w["name"] for w in with_parked().spec["workloads"]]


def tiny_rows(columns: int) -> int:
    """Rows of a tiny run of ``columns`` columns: the largest power of two
    that holds no more bits than ``TINY_BITS``, between ``MIN_TINY_ROWS``
    and ``TINY_ROWS``."""
    fit = 1 << ((TINY_BITS // int(columns)).bit_length() - 1)
    return min(TINY_ROWS, max(MIN_TINY_ROWS, fit))


def tiny(cell: str, layout=None, seed: int = 2**33 + 7, seconds: float = 0.6,
         trace: bool = False, stand_in=None, rows: int | None = None) -> dict:
    """One run of ``cell`` on the CPU at a tiny universe: ``rows``, or by
    default ``tiny_rows`` of the cell's column count."""
    import torch

    from bench import run as harness

    layout = layout or with_parked()
    cfg = layout.config(layout.cell(cell)["config"])
    rows = tiny_rows(cfg["columns"]) if rows is None else rows
    over = {"universe": rows, "card": rows // int(cfg["universe_per_card"])}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the test workers share the machine's cores
    try:
        return harness.run_cell(layout, cell, seed, seconds, trace, device="cpu",
                                overrides=over, stand_in=stand_in)
    finally:
        torch.set_num_threads(threads)
