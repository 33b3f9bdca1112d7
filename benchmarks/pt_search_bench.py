"""Similarity-search + windowed-analytics benchmark (repro_torch.search).

Two sweeps, one artifact (``artifacts/pt_bench/BENCH_search.json``):

* **candidate generation** -- the Sarawagi-Kirpal T-occurrence query for
  edit-distance screening, raced head-to-head per query: the bitmap
  threshold circuit (planner path over q-gram columns: the circuit kernel
  on the card) vs the paper's integer-list competitors
  (``repro_torch.core.listalgos`` MergeOpt / DivideSkip / WHEAP, on the
  host) merging the same posting lists at the same T.  Both sides produce
  identical candidate ids (checked).  The headline number is the speedup
  over DivideSkip; the smoke run holds the reference's contract that the
  bitmap path clears >= 1x DivideSkip at >= 1 sweep point
  (``check_contracts``).  Adaptive ``topk`` wall time and
  relaxation/verification counts ride along.

* **windowed analytics** -- an event stream with a materialized window
  count under append + expiry batches.  Every refresh is checked against
  the touched-tiles words bound (``words_touched <= tiles_refreshed *
  tile_words * (|support| + 1)``) -- the no-rebuild evidence: refresh
  work scales with the mutation batch, never the universe.

The port's counterpart of ``benchmarks/search_bench.py``, on ``device``
(default: the CUDA card).  A candidate set ends in host ids (the bitmap
is copied to the host), so every timed bitmap call waits for the device.

    PYTHONPATH=src:. python benchmarks/pt_search_bench.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np

from repro_torch.device import resolve_device

OUT_PATH = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "pt_bench" / \
    "BENCH_search.json"

SMOKE = dict(corpus=4000, name_len=(6, 14), queries=6, k=2, repeats=3,
             window_batches=8, batch_events=400, n_series=6)
FULL = dict(corpus=20000, name_len=(6, 16), queries=16, k=2, repeats=5,
            window_batches=24, batch_events=2000, n_series=12)

ALPHA = "abcdefghijklmnop"


def _corpus(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [
        "".join(ALPHA[i] for i in rng.integers(0, len(ALPHA), rng.integers(lo, hi)))
        for _ in range(n)
    ]


def _median_time(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def candidate_race(cfg, device=None) -> tuple[list, dict]:
    from repro_torch.core import listalgos as LA
    from repro_torch.search import build_qgram_index

    dev = resolve_device(device)
    corpus = _corpus(cfg["corpus"], *cfg["name_len"])
    idx = build_qgram_index(corpus, q=2, device=dev)
    rng = np.random.default_rng(3)
    # queries are perturbed corpus members: realistic selectivity, known hits
    queries = []
    for qi in rng.choice(cfg["corpus"], size=cfg["queries"], replace=False):
        s = corpus[int(qi)]
        pos = int(rng.integers(0, len(s)))
        queries.append(s[:pos] + ALPHA[int(rng.integers(0, len(ALPHA)))] + s[pos + 1:])

    competitors = {"dsk": LA.dsk, "mgopt": LA.mgopt, "wheap": LA.wheap}
    points, best_speedup = [], 0.0
    for s in queries:
        cand = idx.candidates(s, cfg["k"])  # warm-up: compiles the circuit
        lists = idx.posting_lists(s)
        t_bitmap = _median_time(lambda: idx.candidates(s, cfg["k"]), cfg["repeats"])
        point = {
            "query": s,
            "t": cand.t,
            "n_lists": len(lists),
            "list_elems": int(sum(l.size for l in lists)),
            "n_candidates": len(cand),
            "bitmap_s": t_bitmap,
            "lists_s": {},
        }
        if cand.t >= 1:  # the list merges have no vacuous mode
            for name, algo in competitors.items():
                got = algo(lists, cand.t, idx.r)
                if not np.array_equal(np.asarray(got), cand.ids):
                    raise AssertionError(
                        f"{name} disagrees with the bitmap candidates on {s!r}")
                point["lists_s"][name] = _median_time(
                    lambda a=algo: a(lists, cand.t, idx.r), cfg["repeats"]
                )
            point["speedup_vs_dsk"] = point["lists_s"]["dsk"] / t_bitmap
            best_speedup = max(best_speedup, point["speedup_vs_dsk"])
        points.append(point)

    # k=1: the planted perturbation is the nearest neighbour, so the loop
    # stops after the first relaxation band instead of widening to vacuous
    tk = idx.topk(queries[0], 1)  # warm
    t_topk = _median_time(lambda: idx.topk(queries[0], 1), cfg["repeats"])
    topk_info = {
        "k": 1,
        "wall_s": t_topk,
        "relaxations": tk.relaxations,
        "verified": tk.verified,
        "corpus": idx.r,
        "verified_fraction": tk.verified / idx.r,
    }
    rows = [
        ("search_best_speedup_vs_dsk", best_speedup,
         f"{len(points)} queries corpus={idx.r}"),
        ("search_topk_ms", t_topk * 1e3,
         f"verified {tk.verified}/{idx.r} rows in {tk.relaxations} bands"),
    ]
    return rows, {"points": points, "topk": topk_info,
                  "best_speedup_vs_dsk": best_speedup}


def window_sweep(cfg, device=None) -> tuple[list, dict]:
    from repro_torch.query.expr import Col, Threshold
    from repro_torch.search import WindowedStream, WindowRetentionPolicy

    dev = resolve_device(device)
    series = [f"s{i}" for i in range(cfg["n_series"])]
    ws = WindowedStream(
        series, window=30.0 * cfg["batch_events"] / 100.0, tile_words=8,
        policy=WindowRetentionPolicy(min_dead_rows=1 << 30),  # no retire: pure bound test
        device=dev,
    )
    ws.watch("hot", Threshold(2, over=[Col(s) for s in series]))
    rng = np.random.default_rng(9)
    sup = 1 + cfg["n_series"]  # __live__ + every series the watch reads
    tw = ws.stream.tile_words
    refreshes, t = [], 0.0
    worst_ratio = 0.0
    for _ in range(cfg["window_batches"]):
        batch = []
        for _ in range(cfg["batch_events"]):
            t += float(rng.uniform(0.0, 0.2))
            cols = rng.choice(series, size=int(rng.integers(1, 4)), replace=False)
            batch.append((t, list(cols)))
        ws.append(batch)
        info = ws.refresh_info("hot")
        bound = info["tiles_refreshed"] * tw * (sup + 1)
        if info["words_touched"] > bound:
            raise AssertionError(f"refresh touched {info['words_touched']} words, bound {bound}")
        universe_words = ws.stream.index().n_words
        worst_ratio = max(worst_ratio, info["words_touched"] / max(bound, 1))
        refreshes.append({**info, "bound": bound, "universe_words": universe_words,
                          "live": ws.live_events, "total_rows": ws.total_rows,
                          "count": ws.count("hot")})
    # the no-rebuild claim: late refreshes touch far fewer words than the
    # (ever-growing) universe holds per support column
    tail = refreshes[-1]
    if not tail["words_touched"] < tail["universe_words"] * sup:
        raise AssertionError("refresh ~ rebuild?")
    rows = [
        ("window_events", cfg["window_batches"] * cfg["batch_events"],
         f"live {ws.live_events} dead {ws.dead_rows} count {ws.count('hot')}"),
        ("window_words_touched_vs_bound", worst_ratio,
         f"tail refresh {tail['words_touched']}w vs universe "
         f"{tail['universe_words']}w x {sup} support cols"),
    ]
    return rows, {"refreshes": refreshes, "series": len(series),
                  "tile_words": tw, "support": sup}


def collect(smoke: bool = False, device=None) -> dict:
    """Both sweeps' rows and data, without the artifact and the contract."""
    dev = resolve_device(device)
    cfg = SMOKE if smoke else FULL
    data = {"smoke": smoke, "config": cfg, "device": str(dev)}
    r1, data["candidates"] = candidate_race(cfg, dev)
    r2, data["window"] = window_sweep(cfg, dev)
    data["rows"] = r1 + r2
    return data


def rows(data: dict) -> list:
    """The reference's rows of a payload (without the artifact's row)."""
    return list(data["rows"])


def contracts(data: dict) -> list:
    """The reference's time contract (``search_bench.py``'s smoke assert),
    with its value, its limit, whether it holds and the reference's
    message."""
    best = data["candidates"]["best_speedup_vs_dsk"]
    return [{"contract": "best_speedup_vs_dsk", "value": best, "limit": ">= 1.0",
             "ok": best >= 1.0,
             "message": f"bitmap candidate generation never reached DivideSkip: best "
                        f"{best:.2f}x"}]


def check_contracts(data: dict) -> None:
    """Raise ``AssertionError`` with the reference's message for the first
    contract that misses."""
    for c in contracts(data):
        if not c["ok"]:
            raise AssertionError(c["message"])


def run(smoke: bool = False, device=None) -> list:
    data = collect(smoke, device)
    out = rows(data) + [("bench_search_json", 1, str(OUT_PATH))]
    OUT_PATH.parent.mkdir(parents=True, exist_ok=True)
    OUT_PATH.write_text(json.dumps({k: v for k, v in data.items() if k != "rows"}, indent=2,
                                   sort_keys=True))
    if smoke:
        check_contracts(data)
    return out


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    args = parse_args(smoke=True)
    for name, val, extra in run(smoke=args.smoke, device=args.device):
        print(f"{name},{val if isinstance(val, int) else round(float(val), 3)},{extra}")
