#!/usr/bin/env python3
"""Time the circuit kernel (K1) of one or more checkouts on one CUDA card, in turns.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``::

    python3 tools/k1_ab.py build/ab/old . . build/ab/old      # old, new, new, old
    python3 tools/k1_ab.py . --rows-log2 22 --reps 5          # a quick look at one tree

Each ROOT is the root of a checkout of this repository.  Every ROOT's
``circuit_eval`` library is built first (one ``nvcc`` per checkout, all
started together); then, for each ROOT in the order given, a process of its
own imports that checkout's ``repro_torch``, makes the dense index of
``chip_smoke.py``'s main path (64 columns of ``2**rows_log2 - 5`` rows,
densities from 0.5 to 1e-3, the same bits from the same seed in every
process) and times K1 on the queries of ``chip_smoke.py``'s
``timing.fused``: CUDA events around each launch, the median of ``--reps``
after 3 warm-up launches.  Each run reports per query the time, the
program's register slots, the launch shape and a digest of the result;
every run must give the same digests (the script fails otherwise).

A checkout whose library exports ``circuit_eval_phase_cycles`` (a copy of
the kernel instrumented with ``clock64()`` counters, which is never
committed) also reports the cycles its counters collected over one launch
of each query.

Prints one JSON line per run, then one line per query with its times in
run order; ``--out`` also writes the runs there.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.abspath(__file__)


def queries(n: int) -> tuple:
    from repro_torch.query import Col, Interval, Parity, Threshold, Weighted

    names = tuple(f"s{i}" for i in range(n))
    sixteen = tuple(names[i] for i in range(0, 64, 4))
    eight = tuple(names[i] for i in range(1, 64, 8))
    return names, {
        "interval_2_10": [Interval(2, 10)],
        "threshold_2": [Threshold(2)],
        f"threshold_{n // 2}": [Threshold(n // 2)],
        f"threshold_{n - 1}": [Threshold(n - 1)],
        "composite": [(Threshold(3, over=sixteen) & ~Col(names[5])) | Parity(over=eight)],
        "weighted": [Weighted(tuple(1 + (i * 5) % 9 for i in range(n)), 3 * n // 2)],
        "threshold_3_of_16": [Threshold(3, over=sixteen)],
        "execute_many_k8": [Threshold(t) for t in (2, 3, 5, 8, 13, 21, 34, n - 9)],
    }


def child(root: str, rows_log2: int, reps: int, seed: int) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import ctypes

    import numpy as np
    import torch

    from repro_torch.core.bitmaps import n_words_for, pack
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.query.index import circuit_for

    check = "jax" not in sys.modules and "repro" not in sys.modules
    dev = torch.device("cuda", 0)
    n, r = 64, 2**rows_log2 - 5
    # the columns of chip_smoke.py's main path
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.empty((n, n_words_for(r)), dtype=torch.int32, device=dev)
    for i, p in enumerate(np.geomspace(0.5, 1e-3, n)):
        cols[i] = pack(torch.rand(r, generator=gen, device=dev) < float(p), dev)
    names, qs = queries(n)
    lib = K._lib()
    phases = hasattr(lib, "circuit_eval_phase_cycles")
    if phases:
        lib.circuit_eval_phase_cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        lib.circuit_eval_phase_cycles.restype = ctypes.c_int
    out = {"root": root, "n_words": cols.shape[1], "queries": {}}
    # bring the card to its working clock before the first timed launch
    warm = circuit_for(tuple(qs["interval_2_10"]), n, names)
    for _ in range(300):
        K.run_circuit_cached(cols, warm)
    torch.cuda.synchronize()
    for name, q in qs.items():
        circ = circuit_for(tuple(q), n, names)
        prog = K._program_for(circ, None)
        run = lambda: K.run_circuit_cached(cols, circ)  # noqa: E731
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        got = run()
        torch.cuda.synchronize()
        shape = K.pick_launch_shape(prog.n_registers, K._max_shared(dev))
        rec = {"ms_median": statistics.median(times), "ms_min": min(times), "ms_max": max(times),
               "reps": reps, "n_registers": prog.n_registers, "n_instr": int(prog.prog.shape[0]),
               "launch_shape": list(shape),
               "digest": hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()}
        if phases:
            cyc = (ctypes.c_ulonglong * 8)()
            lib.circuit_eval_phase_cycles(cyc)  # reads and clears the counters
            run()
            torch.cuda.synchronize()
            lib.circuit_eval_phase_cycles(cyc)
            rec["phase_cycles"] = list(cyc)
        out["queries"][name] = rec
    out["no_jax"] = check and "jax" not in sys.modules and "repro" not in sys.modules
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="checkout roots, timed in this order")
    ap.add_argument("--rows-log2", type=int, default=27)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the runs (JSON lines) to this file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.rows_log2, args.reps, args.seed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.roots:
        print("k1_ab.py needs a CUDA device and at least one checkout root", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in args.roots]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from repro_torch.kernels import _build; "
                                "_build.build_libraries(['circuit_eval'])", os.path.join(r, "src")])
              for r in dict.fromkeys(roots)]
    if any([b.wait() != 0 for b in builds]):
        print("a build failed", file=sys.stderr)
        return 1
    runs = []
    for r in roots:
        got = subprocess.run([sys.executable, HERE, "--child", r, "--rows-log2", str(args.rows_log2),
                              "--reps", str(args.reps), "--seed", str(args.seed)],
                             capture_output=True, text=True)
        if got.returncode != 0:
            print(got.stdout, got.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(got.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps({"card": smi}) + "\n")
            for run in runs:
                f.write(json.dumps(run) + "\n")
    bad = []
    for name in runs[0]["queries"]:
        recs = [run["queries"][name] for run in runs]
        if len({rec["digest"] for rec in recs}) != 1:
            bad.append(name)
        print(f"{name:20s} " + " ".join(f"{rec['ms_median']:.4f}" for rec in recs)
              + "   shapes " + " ".join(f"{tuple(rec['launch_shape'])}/{rec['n_registers']}" for rec in recs))
    if bad or not all(run["no_jax"] for run in runs):
        print(f"results differ between checkouts: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
