"""Streaming update engine benchmark: delta apply + query vs full rebuild.

What the ``repro_torch.stream`` subsystem buys at serving time:

  * **update + query latency**: absorb a batch of random single-bit
    updates (1% of the universe by default) into a ``StreamingIndex`` and
    answer a threshold query through the delta overlay, vs rebuilding a
    ``BitmapIndex`` from the mutated bitmaps (tile classification +
    build-time statistics) and querying that -- the only option the
    immutable index offers.  The acceptance bar is >=10x at a 1% mutation
    rate.
  * **materialized-view refresh**: per-update-batch cost of keeping the
    abstract's "on sale in 2 to 10 stores" result fresh, vs re-executing
    the query from scratch; plus the words actually touched.
  * **compaction amortization curve**: compaction wall time as the delta
    grows (1 .. many update batches between compactions), and the
    query-after-compaction time showing the overlay bookkeeping being
    folded back to baseline.

The port's counterpart of ``benchmarks/stream_bench.py``, on ``device``
(default: the CUDA card).  The same calls in the same order as the
reference's (one warm-up and three timed calls a timer, one more of each
for the parity guards), so the delta, the compactions and the views'
refresh counters are the reference's.  Every timed call ends in a
synchronise of the device (``pt_common.time_call``); the reference's
``_time`` waits on nothing.  The rebuild is host tile classification
(``TileStore.from_packed``) plus the upload of the mutated words.
``write_json`` writes ``artifacts/pt_bench/BENCH_stream.json``.

    PYTHONPATH=src:. python benchmarks/pt_stream_bench.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from benchmarks.pt_common import sync, time_call
from repro_torch.device import resolve_device, to_numpy_u32
from repro_torch.query import BitmapIndex, Interval, Threshold
from repro_torch.stream import CompactionPolicy, StreamingIndex

MUTATION_RATES = (0.001, 0.01, 0.05)
ARTIFACTS = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "pt_bench"


def _time(fn, dev, reps=3):
    return time_call(fn, dev, reps)[0]


def _clean_heavy_bits(n, n_tiles, seed=0, span=64 * 32, clean=0.9):
    """Row-correlated clean-heavy data: a tile range is quiet (all-zero) or
    saturated (all-one) for EVERY column, else dirty -- the product-range
    structure streaming corpora actually have, and what keeps the tile
    signature count (and thus the tiled planner estimate) bounded."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, n_tiles * span), bool)
    for tj in range(n_tiles):
        u = rng.random()
        lo, hi = tj * span, (tj + 1) * span
        if u < clean / 2:
            pass
        elif u < clean:
            bits[:, lo:hi] = True
        else:
            bits[:, lo:hi] = rng.random((n, span)) < 0.35
    return bits


def _mutations(rng, n, r, k, *, lo=0, hi=None):
    """k single-bit updates over columns x positions in [lo, hi); deduped
    to the LAST write per (column, position) so a batched apply (sets then
    clears) and a sequential replay agree."""
    hi = r if hi is None else hi
    cols = rng.integers(0, n, k)
    pos = rng.integers(lo, hi, k)
    on = rng.random(k) < 0.5
    last = {int(c) * r + int(p): i for i, (c, p) in enumerate(zip(cols, pos))}
    sel = np.asarray(sorted(last.values()))
    return cols[sel], pos[sel], on[sel]


def _clean_heavy_packed(n, n_tiles, seed=0, tw=64, clean=0.95):
    """Packed-word variant of :func:`_clean_heavy_bits` -- builds the
    uint32 columns directly so the large bench shapes never materialise a
    boolean [n, r] array (8x the memory)."""
    rng = np.random.default_rng(seed)
    words = np.zeros((n, n_tiles * tw), np.uint32)
    for tj in range(n_tiles):
        u = rng.random()
        lo, hi = tj * tw, (tj + 1) * tw
        if u < clean / 2:
            pass
        elif u < clean:
            words[:, lo:hi] = 0xFFFFFFFF
        else:
            # ~0.25 bit density: AND of two uniform word draws
            words[:, lo:hi] = rng.integers(
                0, 1 << 32, (n, tw), dtype=np.uint32
            ) & rng.integers(0, 1 << 32, (n, tw), dtype=np.uint32)
    return words


def _apply_packed(packed, cols, pos, on):
    """The deduped update batch applied to packed words (last write wins
    already guaranteed by :func:`_mutations`)."""
    out = packed.copy()
    w = cols * packed.shape[1] + pos // 32
    b = (np.uint32(1) << (pos % 32).astype(np.uint32))
    flat = out.reshape(-1)
    np.bitwise_or.at(flat, w[on], b[on])
    np.bitwise_and.at(flat, w[~on], ~b[~on])
    return out


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def update_vs_rebuild(smoke: bool = False, device=None) -> list:
    """update+query latency: streaming engine vs from-scratch rebuild.

    The serving pattern under test: a registered query (here the
    Threshold(N/2) production selection, kept as a materialized view) must
    stay answerable while single-bit updates stream in.  The streaming
    engine absorbs the batch into the delta and refreshes the view over
    ONLY the mutated tiles; the immutable index's only alternative is a
    full rebuild -- re-classify and re-upload every column, re-execute the
    query -- before it can answer at all.

    The primary series follows Roaring's container-local update model:
    mutations churn inside a hot window (1% of the row space), the
    realistic steady state.  A uniform-random series (the delta smeared
    across every tile -- the overlay's worst case) is reported alongside
    for honesty; there the live :class:`CompactionPolicy` folds the delta
    mid-update, which is the designed response.  An ad-hoc (non-view)
    overlay execute is timed too, so the artifact separates "incremental
    view serving" from "plain query through the overlay".
    """
    dev = resolve_device(device)
    n, n_tiles = (8, 256) if smoke else (128, 4096)
    packed = _clean_heavy_packed(n, n_tiles, seed=3, clean=0.95)
    r = packed.shape[1] * 32
    names = [f"c{i}" for i in range(n)]
    q = Threshold(n // 2)
    rng = np.random.default_rng(7)
    out = []
    hot = max(64 * 32, int(0.01 * r))
    runs = [("hot_window", rate, 0, hot) for rate in MUTATION_RATES]
    runs.append(("uniform", 0.01, 0, r))
    for dist, rate, lo, hi in runs:
        k = max(1, int(r * rate))
        cols, pos, on = _mutations(rng, n, r, k, lo=lo, hi=hi)
        packed_mutated = _apply_packed(packed, cols, pos, on)

        # the serving steady state: index + registered view exist before
        # the updates arrive; time ONLY absorb + answer
        base = StreamingIndex(BitmapIndex(packed, names, r=r, device=dev))
        base.materialize("live", q)
        sets = {names[c]: pos[on & (cols == c)] for c in range(n) if (on & (cols == c)).any()}
        clears = {names[c]: pos[~on & (cols == c)] for c in range(n) if (~on & (cols == c)).any()}

        # each call ends in a host value (`count`'s int, `to_numpy_u32`'s
        # copy), which waits for the device already
        def stream_update_count(s=base):
            s.update(sets=sets, clears=clears)
            return s.count("live")

        def stream_update_adhoc(s=base):
            s.update(sets=sets, clears=clears)
            return to_numpy_u32(s.execute(q))

        def rebuild_count():
            return BitmapIndex(packed_mutated, names, r=r, device=dev).count(q)

        t_stream = _time(stream_update_count, dev)
        t_adhoc = _time(stream_update_adhoc, dev)
        t_rebuild = _time(rebuild_count, dev)
        # parity guard: the bench only counts if the answers agree
        got, want = stream_update_count(), rebuild_count()
        _check(got == want, f"{dist} m{rate}: the view counts {got}, a rebuild {want}")
        got = stream_update_adhoc()
        want = to_numpy_u32(BitmapIndex(packed_mutated, names, r=r, device=dev).execute(q))
        _check(bool((got == want).all()),
               f"{dist} m{rate}: the overlay's words differ from a rebuild's")
        info = base.view_info("live") or {}
        out.append(
            {
                "distribution": dist,
                "mutation_rate": rate,
                "updates": k,
                "r": r,
                "n": n,
                "stream_update_query_us": t_stream * 1e6,
                "stream_adhoc_query_us": t_adhoc * 1e6,
                "rebuild_query_us": t_rebuild * 1e6,
                "speedup": t_rebuild / t_stream,
                "view_tiles_refreshed": info.get("tiles_refreshed", 0),
                "view_words_touched": info.get("words_touched", 0),
                "n_tiles": n_tiles,
                "delta_words": base.delta_words,
                "compactions": base.compactions,
            }
        )
    return out


def view_refresh(smoke: bool = False, device=None) -> list:
    """Materialized-view maintenance vs re-executing the query."""
    dev = resolve_device(device)
    n, n_tiles = (8, 16) if smoke else (12, 64)
    bits = _clean_heavy_bits(n, n_tiles, seed=5)
    r = bits.shape[1]
    names = [f"store{i}" for i in range(n)]
    s = StreamingIndex.from_dense(
        bits, names, policy=CompactionPolicy(auto=False), device=dev
    )
    q = Interval(2, min(10, n - 1))
    s.materialize("mid", q)
    rng = np.random.default_rng(9)
    out = []
    for batch in (1, 8, 64):
        cols, pos, on = _mutations(rng, n, r, batch)

        def mutate_and_read():
            s.update(
                sets={names[c]: [int(p)] for c, p, o in zip(cols, pos, on) if o},
                clears={names[c]: [int(p)] for c, p, o in zip(cols, pos, on) if not o},
            )
            s.refresh()
            return s.count("mid")

        t_view = _time(mutate_and_read, dev)
        t_reexec = _time(lambda: int(s.count(q)), dev)
        info = s.view_info("mid") or {}
        out.append(
            {
                "update_batch": batch,
                "view_update_read_us": t_view * 1e6,
                "reexecute_us": t_reexec * 1e6,
                "tiles_refreshed": info.get("tiles_refreshed", 0),
                "words_touched": info.get("words_touched", 0),
                "total_words": n * s.index().store.n_words,
            }
        )
    return out


def compaction_curve(smoke: bool = False, device=None) -> list:
    """Compaction cost as the delta grows + query time after compaction."""
    dev = resolve_device(device)
    n, n_tiles = (8, 16) if smoke else (16, 64)
    bits = _clean_heavy_bits(n, n_tiles, seed=11)
    r = bits.shape[1]
    names = [f"c{i}" for i in range(n)]
    q = Threshold(n // 2)
    rng = np.random.default_rng(13)
    out = []
    for batches in (1, 4, 16):
        s = StreamingIndex.from_dense(
            bits, names, policy=CompactionPolicy(auto=False), device=dev
        )
        k = max(1, r // 1000)
        for _ in range(batches):
            cols, pos, on = _mutations(rng, n, r, k)
            s.update(
                sets={names[c]: [int(p)] for c, p, o in zip(cols, pos, on) if o},
                clears={names[c]: [int(p)] for c, p, o in zip(cols, pos, on) if not o},
            )
        dw = s.delta_words
        sync(dev)
        t0 = time.perf_counter()
        s.compact()
        sync(dev)
        t_compact = time.perf_counter() - t0
        t_query = _time(lambda: to_numpy_u32(s.execute(q)), dev)
        out.append(
            {
                "update_batches": batches,
                "delta_words_at_compaction": dw,
                "compact_us": t_compact * 1e6,
                "query_after_compact_us": t_query * 1e6,
                "amortized_us_per_batch": t_compact * 1e6 / batches,
            }
        )
    return out


def run(smoke: bool = False, payload: dict | None = None, device=None) -> list:
    if payload is None:
        payload = collect(smoke, device)
    return rows(payload)


def rows(payload: dict) -> list:
    """The reference's rows of a payload."""
    out = []
    for row in payload["update_vs_rebuild"]:
        tag = f"stream_{row['distribution']}_m{row['mutation_rate']}"
        out.append(
            (
                f"{tag}_update_query_us",
                row["stream_update_query_us"],
                f"{row['updates']} single-bit updates",
            )
        )
        out.append((f"{tag}_rebuild_us", row["rebuild_query_us"], ""))
        out.append((f"{tag}_speedup", row["speedup"], ">=10x target at 1% hot"))
    for row in payload["view_refresh"]:
        out.append(
            (
                f"stream_view_b{row['update_batch']}_us",
                row["view_update_read_us"],
                f"{row['tiles_refreshed']} tiles, {row['words_touched']} words",
            )
        )
    for row in payload["compaction"]:
        out.append(
            (
                f"stream_compact_b{row['update_batches']}_us",
                row["compact_us"],
                f"{row['delta_words_at_compaction']} delta words",
            )
        )
    return out


def collect(smoke: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    return {
        "bench": "stream",
        "smoke": bool(smoke),
        "device": str(dev),
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "update_vs_rebuild": update_vs_rebuild(smoke, dev),
        "view_refresh": view_refresh(smoke, dev),
        "compaction": compaction_curve(smoke, dev),
    }


def write_json(path=None, smoke: bool = False, payload: dict | None = None,
               device=None) -> dict:
    """Write the artifact (default ``artifacts/pt_bench/BENCH_stream.json``)."""
    if payload is None:
        payload = collect(smoke, device)
    if path is None:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        path = ARTIFACTS / "BENCH_stream.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return payload


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    args = parse_args(smoke=True)
    payload = collect(args.smoke, args.device)
    for name, val, extra in run(args.smoke, payload=payload):
        print(f"{name},{val:.2f},{extra}")
    write_json(smoke=args.smoke, payload=payload)
    for row in payload["update_vs_rebuild"]:
        print(
            f"{row['distribution']} mutation_rate={row['mutation_rate']}: stream "
            f"{row['stream_update_query_us']:.0f}us vs rebuild "
            f"{row['rebuild_query_us']:.0f}us ({row['speedup']:.1f}x, "
            f"{row['view_tiles_refreshed']}/{row['n_tiles']} tiles refreshed)"
        )
    print("wrote artifacts/pt_bench/BENCH_stream.json")
