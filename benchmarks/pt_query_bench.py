"""Query-layer benchmark: what the unified API + tiled storage engine buy.

  * composed expression compiled as ONE circuit (shared sideways-sum adder)
    vs leaf-at-a-time execution with a bitwise combine afterwards;
  * ``execute_many`` batching k independent queries into one jitted
    multi-output call vs k sequential calls;
  * compiled-circuit cache: cold (build + optimise + jit) vs warm hit;
  * clean-fraction sweep: dense fused kernel vs the storage engine's
    ``tiled_fused`` executor at clean fractions {0.0, 0.5, 0.9, 0.99} --
    wall time AND words touched (the roofline term), written to
    ``BENCH_query.json`` so CI tracks the perf trajectory;
  * shard-count sweep (1/2/4/8 row shards, mixed-density data): wall time +
    per-shard backend + per-shard words touched, so the trajectory captures
    scaling efficiency of the sharded engine, not just single-device
    numbers.  With >= 8 XLA devices the 8-shard point runs on a real mesh.

The port's counterpart of ``benchmarks/query_bench.py``, on ``device``
(default: the CUDA card): ``fused`` / ``circuit`` plans are one launch of
the circuit kernel, ``tiled_fused`` the event stage and the tiled block
kernel.  Every timed call ends in a synchronise of the device (the
reference's tiled calls are timed without ``block_until_ready``).  The
8-shard point passes ``devices`` (the device, once a shard: the port's
counterpart of the reference's host mesh; with this data the plans are
mixed, so it runs per shard).  ``write_json`` writes
``artifacts/pt_bench/BENCH_query.json``.

    PYTHONPATH=src:. python benchmarks/pt_query_bench.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from benchmarks.pt_common import sync, time_call
from repro_torch.device import resolve_device
from repro_torch.query import (
    And,
    BitmapIndex,
    Interval,
    Not,
    Parity,
    Threshold,
    clear_compiled_cache,
)

CLEAN_FRACTIONS = (0.0, 0.5, 0.9, 0.99)
SHARD_COUNTS = (1, 2, 4, 8)
DENSITIES = (1e-4, 1e-3, 1e-2, 0.1, 0.5)
ARTIFACTS = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "pt_bench"


def _time(fn, dev, reps=5):
    return time_call(fn, dev, reps)[0]


def _clean_fraction_bits(n, n_tiles, clean_fraction, seed=0, span=64 * 32):
    rng = np.random.default_rng(seed)
    r = n_tiles * span
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for tj in range(n_tiles):
            u = rng.random()
            lo, hi = tj * span, (tj + 1) * span
            if u < clean_fraction / 2:
                pass
            elif u < clean_fraction:
                bits[i, lo:hi] = True
            else:
                bits[i, lo:hi] = rng.random(span) < 0.35
    return bits


def clean_fraction_sweep(smoke: bool = False, device=None) -> list:
    """Dense fused vs tiled_fused: wall time + words touched per backend,
    PLUS the plan the cost model actually picks at each point -- the sweep
    otherwise cannot show whether the launch-overhead pricing steers
    production away from tiled_fused in the regimes where it loses on wall
    time (e.g. 3868us vs 80us fused at cf=0.5 in smoke data)."""
    dev = resolve_device(device)
    n, n_tiles = (8, 8) if smoke else (16, 48)
    sweep = []
    for cf in CLEAN_FRACTIONS:
        bits = _clean_fraction_bits(n, n_tiles, cf, seed=int(cf * 100) + 1)
        idx = BitmapIndex.from_dense(bits, device=dev)
        q = Threshold(n // 2)
        plan = idx.explain(q)  # what production would run at this point
        dense_words = idx.n * idx.n_words + idx.n_words  # N reads + 1 write
        t_fused = _time(lambda: idx.execute(q, backend="fused"), dev)
        t_tiled = _time(lambda: idx.execute(q, backend="tiled_fused"), dev)
        info = idx.last_info
        tiled_words = info["dirty_words_gathered"] + idx.n_words
        sweep.append(
            {
                "clean_fraction": cf,
                "n": n,
                "n_words": idx.n_words,
                "planned": {
                    "algorithm": plan.algorithm,
                    "cost_words": plan.cost,
                    "candidates": [[b, c] for b, c in plan.candidates],
                },
                "backends": {
                    "fused": {
                        "wall_us": t_fused * 1e6,
                        "words_touched": dense_words,
                    },
                    "tiled_fused": {
                        "wall_us": t_tiled * 1e6,
                        "words_touched": tiled_words,
                        "case3_tiles": info["case3_tiles"],
                        "const_tiles": info["const_tiles"],
                        "signatures": info["signatures"],
                    },
                },
            }
        )
    return sweep


def sparsity_sweep(smoke: bool = False, device=None) -> list:
    """Column-density sweep 1e-4 .. 0.5: memory footprint and words touched
    per container kind, container store vs the legacy dense dirty pack.

    The query is the membership scan Threshold(1) (every dirty tile
    participates, so nothing hides behind case-1/2 folding) forced through
    ``tiled_fused`` on both stores -- the words-touched delta is purely the
    container representation.  The acceptance bar: >= 4x reduction at
    density <= 1e-3, no regression at 0.5 (where every container is dense
    and both stores are byte-identical).
    """
    dev = resolve_device(device)
    n, n_tiles = (8, 8) if smoke else (16, 48)
    span = 64 * 32
    r = n_tiles * span
    q = Threshold(1)
    out = []
    for d in DENSITIES:
        rng = np.random.default_rng(int(1 / d) % 2**31)
        bits = rng.random((n, r)) < d
        idx = BitmapIndex.from_dense(bits, device=dev)
        legacy = BitmapIndex.from_dense(bits, containers=False, device=dev)
        t_cont = _time(lambda: idx.execute(q, backend="tiled_fused"), dev)
        info = idx.last_info
        t_leg = _time(lambda: legacy.execute(q, backend="tiled_fused"), dev)
        linfo = legacy.last_info
        words = info["dirty_words_gathered"] + idx.n_words
        words_legacy = linfo["dirty_words_gathered"] + idx.n_words
        out.append(
            {
                "density": d,
                "n": n,
                "n_words": idx.n_words,
                "dense_words": idx.n * idx.n_words + idx.n_words,
                "census": idx.store.container_census(),
                "memory_words": idx.store.storage_words(),
                "memory_words_legacy": legacy.store.storage_words(),
                "words_touched": words,
                "words_touched_legacy": words_legacy,
                "words_by_kind": info["words_by_kind"],
                "event_tiles": info["event_tiles"],
                "densified_tiles": info["densified_tiles"],
                # container pack reads vs the dense dirty pack's (the output
                # write pass is identical on both sides and excluded)
                "reduction": linfo["dirty_words_gathered"]
                / max(1, info["dirty_words_gathered"]),
                "wall_us": t_cont * 1e6,
                "wall_us_legacy": t_leg * 1e6,
            }
        )
    return out


def _mixed_density_bits(n, n_tiles, seed=0, span=64 * 32):
    """Half the row space dense (cf=0.0), half mostly clean (cf=0.95)."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, n_tiles * span), bool)
    for i in range(n):
        for tj in range(n_tiles):
            lo, hi = tj * span, (tj + 1) * span
            if tj < n_tiles // 2:
                bits[i, lo:hi] = rng.random(span) < 0.35
            else:
                u = rng.random()
                if u < 0.475:
                    pass
                elif u < 0.95:
                    bits[i, lo:hi] = True
                else:
                    bits[i, lo:hi] = rng.random(span) < 0.35
    return bits


def shard_sweep(smoke: bool = False, device=None) -> list:
    """Row-shard scaling: wall time + per-shard backends + words touched.

    The reference puts its 8-shard point on an 8-device host mesh; the port
    gives that point ``devices`` (the one device, once a shard)."""
    dev = resolve_device(device)
    n, n_tiles = (8, 8) if smoke else (16, 48)
    bits = _mixed_density_bits(n, n_tiles, seed=11)
    idx = BitmapIndex.from_dense(bits, device=dev)
    q = Threshold(n // 2)
    out = []
    for s in SHARD_COUNTS:
        devices = [dev] * s if s == max(SHARD_COUNTS) else None
        sidx = idx.shard(n_shards=s, devices=devices)
        t = _time(lambda: sidx.execute(q).gather(), dev)
        info = sidx.last_info
        per_shard = []
        if info["mode"] == "per_shard":
            for sh, be, inf in zip(
                sidx.store.shards, info["backends"], info["per_shard"]
            ):
                words = (
                    inf["dirty_words_gathered"] + sh.n_words
                    if inf is not None
                    else sh.n * sh.n_words + sh.n_words
                )
                per_shard.append({"backend": be, "words_touched": int(words)})
        out.append(
            {
                "n_shards": sidx.n_shards,
                "mesh": devices is not None,
                "mode": info["mode"],
                "wall_us": t * 1e6,
                "backends": list(info["backends"]),
                "per_shard": per_shard,
            }
        )
    return out


def run(smoke: bool = False, sweep: list | None = None, device=None):
    dev = resolve_device(device)
    out = []
    rng = np.random.default_rng(0)
    n, nw = (16, 1 << 10) if smoke else (32, 1 << 14)
    bm = rng.integers(0, 2**32, (n, nw), dtype=np.uint32)
    idx = BitmapIndex(bm, device=dev)

    q = And(Interval(2, 10), Not(Threshold(n - 2)))
    composed = _time(lambda: idx.execute(q, backend="circuit"), dev)

    def leafwise():
        a = idx.execute(Interval(2, 10), backend="circuit")
        b = idx.execute(Threshold(n - 2), backend="ssum")
        return a & ~b

    leaf = _time(leafwise, dev)
    out.append(("query_composed_us", composed * 1e6, f"N={n} r={nw * 32}"))
    out.append(("query_leafwise_us", leaf * 1e6, "2 adder passes + combine"))
    out.append(("query_composed_speedup", leaf / composed, "one shared adder"))

    qs = [Threshold(t) for t in (2, n // 4, n // 2, n - 1)] + [Parity()]
    many = _time(lambda: idx.execute_many(qs), dev)
    seq = _time(lambda: [idx.execute(x) for x in qs], dev)
    out.append(("query_batched_us", many * 1e6, f"{len(qs)} queries, one call"))
    out.append(("query_sequential_us", seq * 1e6, f"{len(qs)} separate executes"))

    clear_compiled_cache()
    t0 = time.perf_counter()
    idx.execute(q, backend="circuit")
    sync(dev)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.execute(q, backend="circuit")
    sync(dev)
    warm = time.perf_counter() - t0
    out.append(("query_compile_cold_ms", cold * 1e3, "build + optimise + encode"))
    out.append(("query_cached_warm_ms", warm * 1e3, "compiled-circuit cache hit"))

    if sweep is None:
        sweep = clean_fraction_sweep(smoke, dev)
    for row in sweep:
        cf = row["clean_fraction"]
        fused = row["backends"]["fused"]
        tiled = row["backends"]["tiled_fused"]
        out.append(
            (f"query_cf{cf}_fused_words", fused["words_touched"], "dense sweep")
        )
        out.append(
            (
                f"query_cf{cf}_tiled_words",
                tiled["words_touched"],
                f"{tiled['case3_tiles']} case-3 tiles",
            )
        )
        out.append((f"query_cf{cf}_fused_us", fused["wall_us"], ""))
        out.append((f"query_cf{cf}_tiled_us", tiled["wall_us"], ""))
        planned = row.get("planned")
        if planned:
            out.append(
                (
                    f"query_cf{cf}_planned_cost",
                    planned["cost_words"] or 0.0,
                    f"planner picks {planned['algorithm']}",
                )
            )
    return out


def write_json(path=None, smoke: bool = False,
               sweep: list | None = None, shards: list | None = None,
               sparsity: list | None = None, device=None) -> dict:
    """Write the perf-trajectory artifact (default
    ``artifacts/pt_bench/BENCH_query.json``)."""
    dev = resolve_device(device)
    if path is None:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        path = ARTIFACTS / "BENCH_query.json"
    payload = {
        "bench": "query",
        "smoke": bool(smoke),
        "device": str(dev),
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "clean_fraction_sweep": sweep if sweep is not None else clean_fraction_sweep(smoke, dev),
        "shard_sweep": shards if shards is not None else shard_sweep(smoke, dev),
        "sparsity_sweep": sparsity if sparsity is not None else sparsity_sweep(smoke, dev),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return payload


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    args = parse_args(smoke=True)
    smoke, dev = args.smoke, resolve_device(args.device)
    sweep = clean_fraction_sweep(smoke, dev)  # measured once, printed + persisted
    shards = shard_sweep(smoke, dev)
    sparsity = sparsity_sweep(smoke, dev)
    for name, val, extra in run(smoke, sweep=sweep, device=dev):
        print(f"{name},{val:.2f},{extra}")
    write_json(smoke=smoke, sweep=sweep, shards=shards, sparsity=sparsity, device=dev)
    for row in sweep:
        be = row["backends"]
        print(
            f"cf={row['clean_fraction']}: fused {be['fused']['words_touched']} words, "
            f"tiled {be['tiled_fused']['words_touched']} words, "
            f"planner -> {row['planned']['algorithm']}"
        )
    for row in shards:
        print(
            f"shards={row['n_shards']} ({row['mode']}): {row['wall_us']:.0f} us, "
            f"backends {sorted(set(row['backends']))}"
        )
    for row in sparsity:
        c = row["census"]
        print(
            f"density={row['density']}: {row['words_touched']} words vs "
            f"{row['words_touched_legacy']} legacy ({row['reduction']:.1f}x), "
            f"mem {row['memory_words']}/{row['memory_words_legacy']} words, "
            f"census d/s/r={c['dense']}/{c['sparse']}/{c['run']}"
        )
    print("wrote artifacts/pt_bench/BENCH_query.json")
