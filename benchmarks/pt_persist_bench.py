"""Persistence benchmark: snapshot size, cold-load-to-first-query, WAL replay.

What the ``repro_torch.persist`` subsystem buys:

  * **snapshot size vs density**: the ``.bmsnap`` container packs store
    sparse columns as uint16 event lists and run columns as interval
    pairs, so the on-disk footprint tracks the data's information
    content, not the dense universe size.  Reported against the raw
    dense footprint (N x n_words x 4 bytes) at several densities.
  * **cold load to first query**: ``persist.load_index`` reconstructs the
    TileStore as memmap views over the snapshot's pack sections -- no
    classification, no container rebuild -- vs rebuilding the index from
    the raw packed words (tile classification + container packing +
    build-time statistics).  The acceptance bar is >=5x at density
    <=1e-2, where classification dominates rebuild cost.
  * **WAL replay throughput**: records/second for recovering a
    ``StreamingIndex`` from snapshot + write-ahead log, the crash-
    recovery path.

The port's counterpart of ``benchmarks/persist_bench.py``, on ``device``
(default: the CUDA card).  Snapshot and WAL files are the reference's
byte for byte.  The timed load and rebuild answer from host state (the
persisted or recomputed cardinalities); the untimed parity guard executes
a threshold on the card (``backend="ssum"``) over the loaded and the
built store.  Every timed call ends in a synchronise of the device
(``pt_common.time_call``); the reference's ``_time`` waits on nothing.
``write_json`` writes ``artifacts/pt_bench/BENCH_persist.json``; every
scratch snapshot lives in a temporary directory removed on exit.

    PYTHONPATH=src:. python benchmarks/pt_persist_bench.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from benchmarks.pt_common import sync, time_call
from repro_torch import persist
from repro_torch.device import resolve_device, to_numpy_u32
from repro_torch.query import BitmapIndex, Threshold
from repro_torch.stream import CompactionPolicy, StreamingIndex

DENSITIES = (1e-3, 1e-2, 0.1, 0.5)
ARTIFACTS = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "pt_bench"


def _time(fn, dev, reps=3):
    return time_call(fn, dev, reps)[0]


def _packed_at_density(n, n_words, density, seed=0, tw=64):
    """Packed uint32 columns with ~``density`` bit density, tile-correlated
    so the classifier finds sparse/run structure (the shape persistent
    corpora actually have -- uniform noise defeats every container)."""
    rng = np.random.default_rng(seed)
    r = n_words * 32
    arr = np.zeros((n, r), np.uint8)
    span = tw * 32
    for i in range(n):
        for lo in range(0, r, span):
            hi = min(lo + span, r)
            u = rng.random()
            if u < 0.1:  # occasional saturated run tile regardless of density
                arr[i, lo:hi] = 1
            elif u < 0.9:
                arr[i, lo:hi] = (rng.random(hi - lo) < density).astype(np.uint8)
            # else: zero tile
    return np.packbits(arr, axis=1, bitorder="little").view(np.uint32), r


def snapshot_size(smoke: bool = False, scratch: str = ".", device=None) -> list:
    dev = resolve_device(device)
    n, n_words = (8, 64 * 8) if smoke else (32, 64 * 64)
    out = []
    for density in DENSITIES:
        packed, r = _packed_at_density(n, n_words, density, seed=1)
        names = [f"c{i}" for i in range(n)]
        idx = BitmapIndex(packed, names, r=r, device=dev)
        path = os.path.join(scratch, f"size_{density}.bmsnap")
        persist.save(idx, path)
        size = os.path.getsize(path)
        dense_bytes = n * n_words * 4
        out.append(
            {
                "density": density,
                "snapshot_bytes": size,
                "dense_bytes": dense_bytes,
                "ratio": size / dense_bytes,
                "n": n,
                "r": r,
            }
        )
    return out


def cold_load(smoke: bool = False, scratch: str = ".", device=None) -> list:
    """Cold-load-to-first-query vs rebuild-to-first-query.

    Both paths end in the same serving-ready state -- tile classes known,
    container packs materialized (what container-native execution reads),
    cardinalities available -- and answer one query from that state (a
    column count, served straight from the persisted cardinalities).  The
    rebuild path must upload the words, classify every tile, assemble the
    per-kind packs and popcount every column from scratch; the load path
    gets all of it as memmap views over the snapshot's sections.  A full
    threshold is executed (untimed) on both stores as a bit-identity
    parity guard; a timed threshold would only add a kernel time paid
    equally by both sides."""
    dev = resolve_device(device)
    n, n_words = (8, 64 * 16) if smoke else (32, 64 * 64)
    q = Threshold(max(2, n // 4))
    out = []
    for density in (1e-3, 1e-2, 0.1):
        packed, r = _packed_at_density(n, n_words, density, seed=2)
        names = [f"c{i}" for i in range(n)]
        idx = BitmapIndex(packed, names, r=r, device=dev)
        path = os.path.join(scratch, f"cold_{density}.bmsnap")
        persist.save(idx, path)

        def load_and_query():
            loaded = persist.load_index(path, device=dev)
            loaded.store.packs  # serving-ready: zero-copy views, no work
            return int(loaded.store.cardinalities[0])

        def rebuild_and_query():
            built = BitmapIndex(packed, names, r=r, device=dev)
            built.store.packs  # serving-ready: classify + pack every tile
            return int(built.store.cardinalities[0])

        t_load = _time(load_and_query, dev)
        t_rebuild = _time(rebuild_and_query, dev)
        # parity guards: the count answers agree, and the loaded store
        # executes a real threshold bit-identically to the built one
        got, want = load_and_query(), rebuild_and_query()
        if got != want:
            raise AssertionError(f"density {density}: loaded count {got}, rebuilt {want}")
        loaded = persist.load_index(path, device=dev)
        bad = int((to_numpy_u32(loaded.execute(q, backend="ssum"))
                   != to_numpy_u32(idx.execute(q, backend="ssum"))).sum())
        if bad:
            raise AssertionError(f"density {density}: the loaded index differs from the "
                                 f"built one in {bad} words")
        out.append(
            {
                "density": density,
                "load_to_query_us": t_load * 1e6,
                "rebuild_to_query_us": t_rebuild * 1e6,
                "speedup": t_rebuild / t_load,
                "target": ">=5x at density<=1e-2",
                "snapshot_bytes": os.path.getsize(path),
            }
        )
    return out


def wal_replay(smoke: bool = False, scratch: str = ".", device=None) -> list:
    """Recovery throughput: WAL records replayed per second."""
    dev = resolve_device(device)
    n, n_words = (8, 64 * 4) if smoke else (16, 64 * 16)
    packed, r = _packed_at_density(n, n_words, 0.05, seed=3)
    names = [f"c{i}" for i in range(n)]
    rng = np.random.default_rng(17)
    out = []
    for batches in (16, 128) if smoke else (64, 512):
        d = os.path.join(scratch, f"wal_{batches}")
        s = StreamingIndex(
            BitmapIndex(packed, names, r=r, device=dev),
            policy=CompactionPolicy(auto=False),
            durable_dir=d,
        )
        for _ in range(batches):
            c = int(rng.integers(0, n))
            p = rng.integers(0, r, 8)
            s.update(sets={names[c]: p[:4]}, clears={names[c]: p[4:]})
        sync(dev)
        t0 = time.perf_counter()
        rec = StreamingIndex.recover(d, device=dev)
        sync(dev)
        t_recover = time.perf_counter() - t0
        if rec.wal_version != s.wal_version:
            raise AssertionError(f"recovered WAL version {rec.wal_version}, "
                                 f"live {s.wal_version}")
        out.append(
            {
                "wal_records": batches,
                "recover_us": t_recover * 1e6,
                "records_per_s": batches / t_recover,
                "wal_bytes": os.path.getsize(os.path.join(d, "wal.bmwal")),
            }
        )
    return out


def collect(smoke: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="pt_persist_bench_") as scratch:
        return {
            "bench": "persist",
            "smoke": bool(smoke),
            "device": str(dev),
            "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "snapshot_size": snapshot_size(smoke, scratch, dev),
            "cold_load": cold_load(smoke, scratch, dev),
            "wal_replay": wal_replay(smoke, scratch, dev),
        }


def run(smoke: bool = False, payload: dict | None = None, device=None) -> list:
    if payload is None:
        payload = collect(smoke, device)
    return rows(payload)


def rows(payload: dict) -> list:
    """The reference's rows of a payload."""
    out = []
    for row in payload["snapshot_size"]:
        out.append(
            (
                f"persist_size_d{row['density']}_bytes",
                row["snapshot_bytes"],
                f"{row['ratio']:.3f} of dense {row['dense_bytes']}B",
            )
        )
    for row in payload["cold_load"]:
        out.append(
            (
                f"persist_coldload_d{row['density']}_us",
                row["load_to_query_us"],
                f"rebuild {row['rebuild_to_query_us']:.0f}us",
            )
        )
        out.append(
            (
                f"persist_coldload_d{row['density']}_speedup",
                row["speedup"],
                row["target"],
            )
        )
    for row in payload["wal_replay"]:
        out.append(
            (
                f"persist_walreplay_{row['wal_records']}_rps",
                row["records_per_s"],
                f"{row['wal_bytes']}B log",
            )
        )
    return out


def write_json(path=None, smoke: bool = False, payload: dict | None = None,
               device=None) -> dict:
    """Write the artifact (default ``artifacts/pt_bench/BENCH_persist.json``)."""
    if payload is None:
        payload = collect(smoke, device)
    if path is None:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        path = ARTIFACTS / "BENCH_persist.json"
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
    for row in payload["cold_load"]:
        print(
            f"density={row['density']}: load {row['load_to_query_us']:.0f}us vs "
            f"rebuild {row['rebuild_to_query_us']:.0f}us ({row['speedup']:.1f}x)"
        )
    print("wrote artifacts/pt_bench/BENCH_persist.json")
