"""Kernel-level benchmarks: the single-scan tiled engine vs the dense fused
kernel, plus the legacy fused-vs-composed comparison.

The port's counterpart of ``benchmarks/kernel_bench.py``, on ``device``
(default: the CUDA card).  Two sections, both written into
``artifacts/pt_bench/BENCH_kernel.json``:

  * ``crossover`` -- tiled_fused (scan engine: the event stage and the
    tiled block kernel, at most two dispatches) vs ``fused`` (one launch of
    the circuit kernel) wall time across clean-fraction and density sweep
    points, with launches-per-query and the planner's words-touched
    estimates.  The acceptance contract, as the reference's: wherever the
    words model predicts a tiled win (``est_tiled < _TILED_ADVANTAGE *
    est_fused``) on a traffic-bound point, measured tiled wall time must
    beat fused, with O(1) launches.  Each tiled result is held against the
    fused one.

  * ``legacy`` -- SCANCOUNT / the sideways-sum circuit gate by gate / LOOPED /
    CSVCKT wall time (chains of eager torch ops here, where the reference's
    are XLA programs), the bytes model of the fused kernel against a
    gate-by-gate evaluation, and, where the reference reports its TPU
    BlockSpec's working set, the circuit kernel's own launch shape on the
    card (threads, words a thread, the shared memory of its register file)
    and its byte bound over 3.35 TB/s.  On the CPU the plain version makes
    one pass over the whole row, and the row says so.

Every timed call ends in a synchronise of the device.  ``--smoke`` runs
tiny shapes and asserts the collapsed launch count: a batched
multi-residual query must report ``info["launches"] <= 2``.

    PYTHONPATH=src:. python benchmarks/pt_kernel_bench.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np

from benchmarks.pt_common import time_call
from repro_torch.core import circuits as C
from repro_torch.core.threshold import threshold
from repro_torch.device import resolve_device, to_words

REPO = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts" / "pt_bench"
#: one H100 SXM's memory rate (NVIDIA data sheet): the yardstick of the byte bound
PEAK_BYTES_PER_S = 3.35e12


def bytes_model(n: int, t: int, n_words: int) -> dict:
    """Bytes moved to/from device memory per threshold query."""
    gates = C.build_threshold_circuit(n, t, "ssum").gate_count()
    word_bytes = 4
    fused = (n + 1) * n_words * word_bytes  # stream in N planes, write 1
    # gate by gate: every gate reads 2 planes and writes 1 (upper bound)
    composed = (3 * gates) * n_words * word_bytes
    return {"fused_bytes": fused, "composed_bytes": composed, "ratio": composed / fused}


def launch_shape(n: int, t: int, n_words: int, dev) -> tuple:
    """``(words a block, derived text)`` of the circuit kernel's launch for
    the ``(n, t)`` sideways-sum threshold; on the CPU the plain version's
    single pass over the row."""
    from repro_torch.core.threshold import _tabulated_circuit
    from repro_torch.kernels import threshold_ssum as K

    regs = K._program_for(_tabulated_circuit(n, t, "ssum"), None).n_registers
    bound_us = (n + 1) * n_words * 4 / PEAK_BYTES_PER_S * 1e6
    if dev.type != "cuda":
        return n_words, f"plain version: one pass over the row; registers={regs}"
    threads, vec = K.pick_launch_shape(regs, K._max_shared(dev))
    shared = regs * vec * threads * 4
    return threads * vec, (f"threads={threads} words_per_thread={vec} registers={regs} "
                           f"shared={shared / 1024:.1f}KiB byte_bound_us={bound_us:.2f}")


def _clean_fraction_bits(n, n_tiles, clean_fraction, seed=0, span=64 * 32):
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, n_tiles * span), bool)
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


def tiled_crossover(smoke: bool = False, device=None) -> list:
    """tiled_fused (scan engine) vs fused: wall time, launches, words model.

    ``assert_win`` marks the rows where the measured backend is expected to
    be traffic-bound, so a words-model win must show up as a wall-time win:
    every clean-fraction point, and density points at or below 1e-4 on the
    CPU; on the card the traffic model governs the whole sweep (the
    reference's rule, with the CPU in place of XLA's CPU backend).
    """
    from repro_torch.core.planner import _TILED_ADVANTAGE, estimate_words_touched
    from repro_torch.device import to_numpy_u32
    from repro_torch.query import BitmapIndex, Threshold

    dev = resolve_device(device)
    cpu = dev.type == "cpu"
    n = 8
    n_tiles = 8 if smoke else 2048
    span = 64 * 32
    points = [("clean_fraction", cf) for cf in (0.0, 0.5, 0.9, 0.99)]
    points += [("density", d) for d in (1e-5, 1e-4, 1e-3)]
    rows = []
    for kind, param in points:
        if kind == "clean_fraction":
            bits = _clean_fraction_bits(n, n_tiles, param, seed=int(param * 100) + 1)
        else:
            rng = np.random.default_rng(int(param * 1e6) + 7)
            bits = rng.random((n, n_tiles * span)) < param
        idx = BitmapIndex.from_dense(bits, device=dev)
        q = Threshold(n // 2)
        t_fused, fused = time_call(lambda: idx.execute(q, backend="fused"), dev, 5)
        t_tiled, tiled = time_call(lambda: idx.execute(q, backend="tiled_fused"), dev, 5)
        if not np.array_equal(to_numpy_u32(tiled), to_numpy_u32(fused)):
            raise AssertionError(f"{kind}={param}: tiled_fused differs from fused")
        info = idx.last_info
        stats = idx.store.member_stats(None)
        est_t = estimate_words_touched(
            "tiled_fused", n, n // 2, n_words=stats.n_words, stats=stats
        )
        est_f = estimate_words_touched(
            "fused", n, n // 2, n_words=stats.n_words, stats=stats
        )
        predicted_win = est_t is not None and est_t < _TILED_ADVANTAGE * est_f
        rows.append({
            kind: param,
            "n": n,
            "n_tiles": n_tiles,
            "tiled_us": t_tiled * 1e6,
            "fused_us": t_fused * 1e6,
            "speedup": t_fused / t_tiled,
            "launches": info["launches"],
            "engine": info.get("engine"),
            "event_tiles": info.get("event_tiles", 0),
            "dirty_words_gathered": info["dirty_words_gathered"],
            "decode_words": info.get("decode_words", 0),
            "est_tiled_words": est_t,
            "est_fused_words": est_f,
            "predicted_win": predicted_win,
            "assert_win": predicted_win and not smoke and (
                kind == "clean_fraction" or param <= 1e-4 or not cpu
            ),
        })
    return rows


def batched_launch_collapse(smoke: bool = False, device=None) -> dict:
    """Launches for a batched multi-residual query (seed path: one launch
    per structurally distinct residual group; scan engine: <= 2)."""
    from repro_torch.query import BitmapIndex, Interval, Threshold

    n, n_tiles = 8, 8 if smoke else 32
    bits = _clean_fraction_bits(n, n_tiles, 0.5, seed=3)
    idx = BitmapIndex.from_dense(bits, device=resolve_device(device))
    qs = [Threshold(2), Threshold(5), Interval(3, 6)]
    idx.execute_many(qs, backend="tiled_fused")
    info = idx.last_info
    os.environ["REPRO_TILED_ENGINE"] = "merge"
    try:
        idx.execute_many(qs, backend="tiled_fused")
    finally:
        del os.environ["REPRO_TILED_ENGINE"]
    return {
        "n_queries": len(qs),
        "residual_groups": info["residual_signatures"],
        "launches": info["launches"],
        "launches_per_group_path": idx.last_info["launches"],
    }


def run(smoke: bool = False, device=None):
    dev = resolve_device(device)
    out = []
    rng = np.random.default_rng(0)
    shapes = [(16, 1 << 10)] if smoke else [(32, 1 << 16), (128, 1 << 16), (256, 1 << 14)]
    for n, nw in shapes:
        bm = to_words(rng.integers(0, 2**32, (n, nw), dtype=np.uint32), dev)
        t = n // 2
        for alg in ("scancount", "ssum", "looped", "csvckt"):
            if alg == "looped" and n * t > 4000:
                continue
            dt, _ = time_call(lambda: threshold(bm, t, alg), dev, 5)
            out.append((f"kernel_N{n}_{alg}_us", dt * 1e6, f"r={nw * 32}"))
        m = bytes_model(n, t, nw)
        out.append(
            (f"kernel_N{n}_hbm_ratio", m["ratio"],
             f"fused={m['fused_bytes'] / 2**20:.1f}MiB composed={m['composed_bytes'] / 2**20:.0f}MiB")
        )
        words, extra = launch_shape(n, t, nw, dev)
        out.append((f"kernel_N{n}_block_words", words, extra))
    return out


def main(smoke: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    legacy = run(smoke=smoke, device=dev)
    for name, val, extra in legacy:
        print(f"{name},{val:.2f},{extra}")
    crossover = tiled_crossover(smoke=smoke, device=dev)
    batched = batched_launch_collapse(smoke=smoke, device=dev)
    doc = {
        "backend": dev.type,
        "smoke": smoke,
        "crossover": crossover,
        "batched_multi_residual": batched,
        "legacy": [
            {"name": name, "value": val, "extra": extra}
            for name, val, extra in legacy
        ],
    }
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    (ARTIFACTS / "BENCH_kernel.json").write_text(json.dumps(doc, indent=2))
    for row in crossover:
        kind = "clean_fraction" if "clean_fraction" in row else "density"
        print(
            f"crossover_{kind}={row[kind]},tiled_us={row['tiled_us']:.0f},"
            f"fused_us={row['fused_us']:.0f},launches={row['launches']},"
            f"predicted_win={row['predicted_win']}"
        )
    print(
        f"batched_multi_residual,groups={batched['residual_groups']},"
        f"launches={batched['launches']} (per-group path: "
        f"{batched['launches_per_group_path']})"
    )
    # contract asserts: O(1) dispatch for the batched multi-residual query,
    # and measured wall-time wins wherever the words model predicts one on
    # a traffic-bound point (smoke shapes are dispatch-overhead-bound, so
    # only the launch contract is enforced there)
    assert batched["launches"] <= 2, batched
    for row in crossover:
        if row["predicted_win"]:
            assert row["launches"] <= 2, row
        if row["assert_win"]:
            assert row["tiled_us"] < row["fused_us"], row
    return doc


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    args = parse_args(smoke=True)
    main(smoke=args.smoke, device=args.device)
