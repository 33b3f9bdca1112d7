"""The control: the plain reference put in the program's place, computed
below the precision the configurations state.

The configurations state exact answers.  The control answers as an
approximate engine a later change might be tempted into: each member count
held in 4 bits (saturating at 15, as a nibble-wide adder would) and every
64-word tile that holds a single set row read as empty (a lossy sparse
container).  The first changes dense answers wherever a threshold or
interval bound passes 15, the second sparse ones; each cell's comparison
has to call it incorrect.  It stands in for ``bench/program.py``'s
factories, so each loop's set-up, window and checks are the run's own.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

prints one JSON line a seed with ``correct`` and the checked numbers.  The
benchmark's own runs never load this module.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench import common, program, reference  # noqa: E402

COUNT_BITS = 4


def lossy(columns: torch.Tensor, tile_words: int) -> torch.Tensor:
    """A copy of ``columns`` with every tile of one set row cleared."""
    n, n_words = columns.shape
    n_tiles = n_words // tile_words
    out = columns.clone()
    body = out[:, : n_tiles * tile_words].view(n, n_tiles, tile_words)
    card = common.popcount64(common.words_from_int32(body)).sum(-1)
    body[card == 1] = 0
    return out


class Index:
    """Stands in for ``BitmapIndex``: ``execute(spec)``."""

    def __init__(self, columns, r: int, tile_words: int):
        self.columns = lossy(columns, tile_words)
        self.r, self.tile_words = r, tile_words

    def execute(self, spec):
        return reference.evaluate(self.columns, spec, self.r, count_bits=COUNT_BITS)


class Server:
    """Stands in for ``QueryServer``: a reply is computed as it is submitted."""

    def __init__(self, index: Index):
        self.index = index
        self.lock = threading.Lock()

    def submit(self, spec) -> Future:
        f: Future = Future()
        with self.lock:
            out = self.index.execute(spec)
            common.sync(out)
        f.set_result(out)
        return f

    def info(self) -> dict:
        return {}

    def stop(self) -> None:
        pass


class Stream:
    """Stands in for ``StreamingIndex``: updates applied in place, a
    query's index a copy of the data as it starts."""

    def __init__(self, index: Index):
        self.columns = index.columns.clone()
        self.r, self.tile_words = index.r, index.tile_words
        self.slot = {n: i for i, n in enumerate(column_names(self.columns.shape[0]))}
        self.delta_words = 0

    def update(self, sets=None, clears=None) -> None:
        (name, s), = sets.items()
        reference.apply_update(self.columns, self.slot[name], s, clears[name])

    def index(self) -> Index:
        return Index(self.columns, self.r, self.tile_words)

    def execute(self, spec):
        return self.index().execute(spec)

    def delta_stats(self) -> dict:
        return {"compactions": 0, "delta_words": self.delta_words}


# ``bench/program.py``'s factories, with the control in the program's place

column_names = program.column_names


def to_query(spec: dict, names: tuple) -> dict:
    return spec


def build_index(columns, cfg: dict, device) -> Index:
    return Index(columns, int(cfg["universe"]), int(cfg["tile_words"]))


def query_server(index: Index, **settings) -> Server:
    return Server(index)


def streaming_index(index: Index) -> Stream:
    return Stream(index)


def route(index, query) -> str:
    return "control"


def main(argv=None) -> int:
    from bench import run as harness

    ap = argparse.ArgumentParser(description="the control of a cell, one line a seed")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    layout = harness.Layout(common.ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(layout, args.workload, seed, args.seconds, False,
                               stand_in=sys.modules[__name__], t_start=t0)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
