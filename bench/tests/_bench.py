"""Shared set-up of the benchmark's CPU tests: the repository root and
``src`` on the import path, and a tiny run of a cell on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: rows of a tiny run: 64 tiles of 64 words
TINY_ROWS = 1 << 17

#: cells whose loops the harness keeps but BENCHMARK.json does not list yet
#: (PERF.md, open questions): their entries as a later PR would add them, so
#: that the CPU tests keep driving the served and live loops
PARKED = {
    "workloads": [
        {"name": "uniform64.served-adhoc", "config": "paper-uniform-dense-2e27",
         "traffic": "adhoc8", "chips": 1,
         "why": "8 clients send fresh queries through QueryServer: plan, compile and the server's host path"},
        {"name": "clustered64.live-updates", "config": "paper-clustered-moderate-2e27",
         "traffic": "live20", "chips": 1,
         "why": "recurring16 on a StreamingIndex with a 64-bit update batch every 50 ms"},
    ],
    "per_layer": [
        {"name": "compile.host_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "compile", "moves": "queries_per_s", "workloads": ["uniform64.served-adhoc"]},
        {"name": "serve.batch_size", "unit": "queries/batch", "better": "higher",
         "source": "program_counter", "layer": "serve front end", "moves": "queries_per_s",
         "workloads": ["uniform64.served-adhoc"]},
        {"name": "serve.batch_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "serve front end", "moves": "query_p95_ms",
         "workloads": ["uniform64.served-adhoc"]},
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


def tiny(cell: str, layout=None, seed: int = 2**33 + 7, seconds: float = 0.6,
         trace: bool = False, stand_in=None, rows: int = TINY_ROWS) -> dict:
    import torch

    from bench import run as harness

    layout = layout or with_parked()
    cfg = layout.config(layout.cell(cell)["config"])
    over = {"universe": rows, "card": rows // int(cfg["universe_per_card"])}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the test workers share the machine's cores
    try:
        return harness.run_cell(layout, cell, seed, seconds, trace, device="cpu",
                                overrides=over, stand_in=stand_in)
    finally:
        torch.set_num_threads(threads)
