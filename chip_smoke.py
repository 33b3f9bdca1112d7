#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and
``nvcc``::

    python3 chip_smoke.py                 # full size: 64 columns x (2**27 - 5) rows
    python3 chip_smoke.py --rows-log2 22  # a quick, small run

What it does, one JSON object per line:

1. ``env``       -- card name and power limit, torch / CUDA / nvcc versions,
                    seconds the kernel build took (built here from
                    ``src/repro_torch/kernels/csrc``).
2. ``kernels``   -- the circuit-program kernel against its plain version on
                    the card over a sweep of shapes and circuits; mismatched
                    words per case (must all be 0).
3. ``main_path`` -- builds a device-resident ``BitmapIndex`` and runs
                    planner-driven ``execute`` / ``execute_many`` queries;
                    every result is compared with the plain version over the
                    whole array and with a counter oracle on a slice that
                    holds the tail; launch counts are read around this phase.
4. ``timing``    -- CUDA-event medians of the fused queries, bytes moved,
                    GB/s and the memory bound; host time of plan + dispatch.

Then the card's ``nvidia-smi`` line, one ``{"kernels": [...]}`` summary
line, and the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises: the script then exits non-zero and prints no ``ok`` line.
It never runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet): the yardsticks of `bound_ms`
PEAK_BYTES_PER_S = 3.35e12
# 67 TFLOP/s float32 outside the tensor cores counts a fused multiply-add as
# two: 33.5e12 32-bit ALU instructions per second is the rate held against
# the kernel's one bitwise operation per gate and word
PEAK_ALU_OPS_PER_S = 33.5e12

K1_SOURCE = "src/repro_torch/kernels/csrc/circuit_eval.cu"
K1_REPLACES = "src/repro/kernels/threshold_ssum.py:88"


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, *, reps: int, warmup: int = 3) -> list:
    """Per-call device times of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a != b).sum().item())


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------


def phase_env() -> str:
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2:]
    t0 = time.perf_counter()
    _build.load_library("circuit_eval")
    emit("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=" | ".join(nvcc), python=sys.version.split()[0],
         kernel_build_seconds=round(time.perf_counter() - t0, 3),
         build_dir=os.path.relpath(str(_build.build_dir()), ROOT))
    return smi


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def rand_words(gen: torch.Generator, n: int, n_words: int, dev) -> torch.Tensor:
    return torch.randint(-(2**31), 2**31, (n, n_words), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


def phase_kernels(dev) -> dict:
    from repro_torch.core import circuits as C
    from repro_torch.core.bytecode import compile_circuit
    from repro_torch.core.weighted import build_weighted_threshold_circuit
    from repro_torch.kernels import ref
    from repro_torch.kernels import threshold_ssum as K

    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = []
    worst = 0

    def run(name, bm, circ, *, rows=None, oracle=None):
        nonlocal worst
        got = K.run_circuit_cached(bm, circ, rows=rows)
        torch.cuda.synchronize()
        want = K.run_circuit_plain(bm, circ, rows=rows)
        bad = mismatches(got, want)
        if oracle is not None:
            bad += mismatches(got, oracle)
        worst = max(worst, int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
                    if got.numel() else 0)
        cases.append({"case": name, "mismatched_words": bad})
        check(bad == 0, f"kernel case {name}: {bad} mismatched words")

    for n in (2, 3, 5, 16, 64, 130):
        for nw in (1, 7, 100, 1030):
            bm = rand_words(gen, n, nw, dev)
            t = max(1, n // 2)
            run(f"ssum n={n} nw={nw} t={t}", bm, C.build_threshold_circuit(n, t, "ssum"),
                oracle=ref.threshold_ref(bm, t))
            truth = tuple((w * 7 + n) % 3 == 0 for w in range(n + 1))
            run(f"sym n={n} nw={nw}", bm, C.build_symmetric_circuit(n, list(truth)),
                oracle=ref.symmetric_ref(bm, truth))
        bm = rand_words(gen, n, 1030, dev)
        lo, hi = max(0, n // 4), max(1, n // 2)
        run(f"interval n={n} [{lo},{hi}]", bm, C.build_interval_circuit(n, lo, hi),
            oracle=ref.symmetric_ref(bm, tuple(lo <= w <= hi for w in range(n + 1))))
        t = max(1, (2 * n) // 3)
        run(f"treeadd n={n} t={t}", bm, C.build_threshold_circuit(n, t, "treeadd"),
            oracle=ref.threshold_ref(bm, t))
        if n <= 64:
            run(f"srtckt n={n} t={t}", bm, C.build_threshold_circuit(n, t, "srtckt"),
                oracle=ref.threshold_ref(bm, t))
        ws = [1 + (i * 5) % 9 for i in range(n)]
        run(f"weighted n={n}", bm, build_weighted_threshold_circuit(ws, sum(ws) // 3))
        for t in (0, -2, n + 1):
            got = K.threshold_fused(bm, t, device=dev)
            want = torch.full_like(bm[0], -1 if t <= 0 else 0)
            cases.append({"case": f"vacuous n={n} t={t}", "mismatched_words": mismatches(got, want)})
            check(cases[-1]["mismatched_words"] == 0, f"vacuous t={t}")

    # k outputs, a constant output, a pass-through output
    n = 16
    bm = rand_words(gen, n, 4099, dev)
    for k in (2, 8):
        c = C.Circuit(n, [], [])
        bits = C.sideways_sum_bits(c, list(range(n)))
        c.outputs = [C.ge_const(c, bits, t) for t in range(1, k + 1)]
        run(f"k={k} thresholds", bm, c.optimized(),
            oracle=torch.stack([ref.threshold_ref(bm, t) for t in range(1, k + 1)]))
    c = C.Circuit(n, [], [])
    c.outputs = [C.CONST1, 3, c.XOR(0, 1), C.CONST0, n - 1]
    run("constant and pass-through outputs", bm, c)

    # a row-strided view, a word-offset view, and a row subset read in place
    big = rand_words(gen, 2 * n, 4099, dev)
    circ = C.build_threshold_circuit(n, 5, "ssum")
    run("strided rows [::2]", big[::2], circ, oracle=ref.threshold_ref(big[::2], 5))
    run("word-axis slice [:, 3:4001]", big[:n, 3:4001], circ,
        oracle=ref.threshold_ref(big[:n, 3:4001], 5))
    slots = tuple(range(2 * n - 1, -1, -2))
    run("row subset via rows=", big, circ, rows=slots,
        oracle=ref.threshold_ref(big[list(slots)], 5))

    # a circuit with so many live registers that only 32 threads per block fit
    n = 64
    c = C.Circuit(n, [], [])
    terms = [c.AND(i % n, (i * 7 + 1 + i // n) % n) for i in range(1000)]
    c.outputs = [c.wide_or(terms)]
    bc = compile_circuit(c)
    limit = K._max_shared(dev)
    shape = K.pick_launch_shape(bc.n_registers, limit)
    check(shape == (32, 1), f"expected the 32-thread launch shape, got {shape} for "
                            f"{bc.n_registers} registers")
    run(f"{bc.n_registers} live registers -> {shape[0]} threads", rand_words(gen, n, 5000, dev), c)
    too_big = C.Circuit(n, [], [])
    terms = [too_big.AND(i % n, (i * 7 + 1 + i // n) % n) for i in range(2200)]
    too_big.outputs = [too_big.wide_or(terms)]
    try:
        K.run_circuit_cached(rand_words(gen, n, 64, dev), too_big)
    except ValueError as e:
        check("n_registers" in str(e), "the refusal names n_registers")
        cases.append({"case": "register file beyond shared memory raises ValueError",
                      "mismatched_words": 0})
    else:
        raise AssertionError("an oversized register file was not refused")

    emit("kernels", n_cases=len(cases), max_shared_bytes=limit,
         all_zero=all(c["mismatched_words"] == 0 for c in cases), cases=cases)
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def make_columns(n: int, r: int, dev, seed: int) -> tuple:
    """int32[n, n_words] with per-column densities from 0.5 down to 1e-3,
    bits drawn on the card from a seeded generator."""
    from repro_torch.core.bitmaps import n_words_for, pack

    gen = torch.Generator(device=dev).manual_seed(seed)
    dens = np.geomspace(0.5, 1e-3, n)
    cols = torch.empty((n, n_words_for(r)), dtype=torch.int32, device=dev)
    for i, p in enumerate(dens):
        bits = torch.rand(r, generator=gen, device=dev) < float(p)
        cols[i] = pack(bits, dev)
    return cols, [float(p) for p in dens]


def oracle_bits(q, slot: dict, rows: torch.Tensor) -> torch.Tensor:
    """Bit-level counter oracle of a query over ``rows`` (bool[n_bits]):
    unpacks every member and counts, independent of circuits and byte code."""
    from repro_torch.core.bitmaps import unpack
    from repro_torch.query import expr as E

    def members(over):
        if over is None:
            return [unpack(rows[i]) for i in range(rows.shape[0])]
        return [oracle_bits(m, slot, rows) for m in over]

    if isinstance(q, E.Col):
        return unpack(rows[slot[q.name]])
    if isinstance(q, E.Weighted):
        ms = members(q.over)
        total = torch.zeros(ms[0].shape, dtype=torch.int32, device=rows.device)
        for w, m in zip(q.weights, ms):
            total += int(w) * m.to(torch.int32)
        return total >= q.t
    if isinstance(q, E._SymmetricLeaf):
        ms = members(q.over)
        count = torch.zeros(ms[0].shape, dtype=torch.int64, device=rows.device)
        for m in ms:
            count += m
        table = torch.tensor(q.truth(len(ms)), dtype=torch.bool, device=rows.device)
        return table[count]
    if isinstance(q, E.And):
        out = oracle_bits(q.children[0], slot, rows)
        for c in q.children[1:]:
            out = out & oracle_bits(c, slot, rows)
        return out
    if isinstance(q, E.Or):
        out = oracle_bits(q.children[0], slot, rows)
        for c in q.children[1:]:
            out = out | oracle_bits(c, slot, rows)
        return out
    if isinstance(q, E.Not):
        return ~oracle_bits(q.child, slot, rows)
    if isinstance(q, E.AndNot):
        return oracle_bits(q.keep, slot, rows) & ~oracle_bits(q.drop, slot, rows)
    raise TypeError(type(q).__name__)


def phase_main_path(dev, rows_log2: int, n: int, seed: int):
    from repro_torch.core.bitmaps import cardinality, pack
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.query import (BitmapIndex, Col, Interval, Parity, Threshold,
                                   Weighted)
    from repro_torch.query.index import circuit_for

    r = 2**rows_log2 - 5
    t0 = time.perf_counter()
    cols, dens = make_columns(n, r, dev, seed)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    names = tuple(f"s{i}" for i in range(n))

    # counts to 0 just before the main path is driven
    for key in K.launch_counts:
        K.launch_counts[key] = 0

    t0 = time.perf_counter()
    idx = BitmapIndex(cols, names, r=r)  # device=None: the card
    store = idx.store  # host classification of the whole index
    t_build = time.perf_counter() - t0
    check(idx.columns.is_cuda and idx.columns.data_ptr() == cols.data_ptr(),
          "the index keeps the tensor on the card as its dense view")
    ms = store.member_stats(None)

    sixteen = tuple(names[i] for i in range(0, 64, 4)) if n >= 64 else names[: max(2, n // 2)]
    eight = tuple(names[i] for i in range(1, 64, 8)) if n >= 64 else names[: max(2, n // 4)]
    queries = {
        "interval_2_10": Interval(2, 10),
        **{f"threshold_{t}": Threshold(t) for t in (1, 2, n // 2, n - 1, n)},
        "composite": (Threshold(3, over=sixteen) & ~Col(names[5])) | Parity(over=eight),
        "weighted": Weighted(tuple(1 + (i * 5) % 9 for i in range(n)), 3 * n // 2),
        "threshold_3_of_16": Threshold(3, over=sixteen),
    }
    many = [Threshold(t) for t in (2, 3, 5, 8, 13, 21, 34, n - 9)]

    sl_words = min(idx.n_words, 2**16)
    tail_rows = idx.columns[:, idx.n_words - sl_words:]
    tail_bits = r - (idx.n_words - sl_words) * 32
    slot = {name: i for i, name in enumerate(names)}

    def verify(name, q, got):
        # whole array: the plain version of the same compiled circuit
        circ = circuit_for((q,), idx.n, names)
        want = idx._mask(K.run_circuit_plain(idx.columns, circ))
        bad_plain = mismatches(got, want)
        # tail slice: the independent counter oracle
        ob = oracle_bits(q, slot, tail_rows)
        ob[tail_bits:] = False
        want_tail = pack(ob, dev)
        bad_oracle = mismatches(got[idx.n_words - sl_words:], want_tail)
        check(bad_plain == 0, f"{name}: {bad_plain} words differ from the plain version")
        check(bad_oracle == 0, f"{name}: {bad_oracle} words differ from the oracle")
        return bad_plain, bad_oracle

    report = []
    results = {}
    for name, q in queries.items():
        before = K.launch_counts["circuit_eval"]
        plan = idx.explain(q)
        got = idx.execute(q)
        torch.cuda.synchronize()
        launches = K.launch_counts["circuit_eval"] - before
        check(got.shape == (idx.n_words,) and got.dtype == torch.int32 and got.is_cuda,
              f"{name}: result shape/dtype/device")
        results[name] = (q, plan, got)
        report.append({"query": name, "algorithm": plan.algorithm, "cost_words": plan.cost,
                       "kernel_launches": launches, "info_backend": idx.last_info["backend"],
                       "words_touched": idx.last_info["words_touched"]})
    before = K.launch_counts["circuit_eval"]
    many_plans = [idx.explain(q).algorithm for q in many]
    many_got = idx.execute_many(many)
    torch.cuda.synchronize()
    many_launches = K.launch_counts["circuit_eval"] - before

    # counts read just after the main path was driven
    counts = dict(K.launch_counts)

    # verification (its launches and plain runs are not part of the counts above)
    for rec in report:
        q, plan, got = results[rec["query"]]
        rec["mismatch_plain"], rec["mismatch_oracle"] = verify(rec["query"], q, got)
    many_bad = [verify(f"execute_many[{i}]", q, g) for i, (q, g) in enumerate(zip(many, many_got))]
    q, _, got = results["interval_2_10"]
    ob = oracle_bits(q, slot, tail_rows)
    ob[tail_bits:] = False
    check(int(cardinality(got[idx.n_words - sl_words:]).item()) == int(ob.sum().item()),
          "count() of the slice equals the oracle's popcount")
    n_hit = idx.count(q)
    check(n_hit == int(cardinality(got).item()), "count() equals the result's cardinality")

    # every query's plan and launch count are pinned, and so is their total
    expected = {name: ("fused", 1) for name in queries}
    expected["threshold_1"] = ("wide_or", 0)
    expected[f"threshold_{n}"] = ("wide_and", 0)
    for rec in report:
        got_plan = (rec["algorithm"], rec["kernel_launches"])
        check(got_plan == expected[rec["query"]],
              f"{rec['query']}: planned and launched {got_plan}, expected {expected[rec['query']]}")
    check(many_launches == 1, f"execute_many: {many_launches} launches, expected 1")
    total = sum(launches for _alg, launches in expected.values()) + 1
    check(counts["circuit_eval"] == total,
          f"the main path launched the circuit kernel {counts['circuit_eval']} times, expected {total}")

    emit("main_path", n_columns=n, r=r, n_words=idx.n_words,
         index_bytes=idx.columns.numel() * 4, densities=[dens[0], dens[-1]],
         seconds_make_bits=round(t_make, 2), seconds_build_and_classify=round(t_build, 2),
         clean_fraction=ms.clean_fraction, container_tiles=ms.container_tiles,
         queries=report,
         execute_many={"k": len(many), "plans": many_plans, "kernel_launches": many_launches,
                       "mismatch": [list(x) for x in many_bad]},
         interval_2_10_count=n_hit, launch_counts=counts)
    return idx, queries, many, counts


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------


def phase_timing(idx, queries, many, reps: int) -> dict:
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.query.index import circuit_for

    names = idx.names
    nw = idx.n_words
    out = []
    headline = None

    def one(name, qs):
        nonlocal headline
        circ = circuit_for(tuple(qs), idx.n, names)
        prog = K._program_for(circ, None)
        k = len(circ.outputs)
        n_in = len(circ.support())
        times = cuda_ms(lambda: K.run_circuit_cached(idx.columns, circ), reps=reps)
        plain = cuda_ms(lambda: K.run_circuit_plain(idx.columns, circ), reps=3, warmup=1)
        ms = statistics.median(times)
        nbytes = (n_in + k) * nw * 4
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = len(circ.ops) * nw / PEAK_ALU_OPS_PER_S * 1e3
        rec = {"query": name, "inputs_read": n_in, "outputs": k, "gates": len(circ.ops),
               "n_registers": prog.n_registers,
               "launch_shape": K.pick_launch_shape(prog.n_registers, K._max_shared(idx.device)),
               "ms_median": ms, "ms_min": min(times), "ms_max": max(times), "reps": reps,
               "bytes": nbytes, "GBps": nbytes / ms / 1e6,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
               "share_of_bound": max(bytes_ms, ops_ms) / ms,
               "plain_ms_median": statistics.median(plain)}
        out.append(rec)
        if name == "interval_2_10":
            headline = rec

    for name, q in queries.items():
        if idx.explain(q).algorithm == "fused":
            one(name, [q])
    one("execute_many_k8", many)

    # host side: plan (memo hit) and plan + dispatch without waiting for the card
    q = queries["interval_2_10"]
    idx.explain(q)
    t0 = time.perf_counter()
    for _ in range(200):
        idx.explain(q)
    explain_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        idx.execute(q)
        host.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    wall = []
    for _ in range(20):
        t0 = time.perf_counter()
        idx.execute(q)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    # every main-path query end to end: plan, dispatch, kernel or plain folds, result ready
    per_query = {}
    for name, qq in queries.items():
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            idx.execute(qq)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        per_query[name] = {"algorithm": idx.explain(qq).algorithm, "ms_median": statistics.median(ts)}
    emit("timing", fused=out, execute_to_result=per_query,
         host={"explain_memo_hit_us": explain_us,
               "execute_enqueue_us_median": statistics.median(host),
               "execute_to_result_ms_median": statistics.median(wall)})
    return headline


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-log2", type=int, default=27,
                    help="the index holds 2**this - 5 rows (default 27: a 1 GiB index)")
    ap.add_argument("--columns", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here when the checkout is not around)

    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port must not import jax or the reference package")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_env()
    kernel_check = phase_kernels(dev)
    idx, queries, many, counts = phase_main_path(dev, args.rows_log2, args.columns, args.seed)
    head = phase_timing(idx, queries, many, args.reps)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port must not import jax or the reference package")

    emit("done", seconds_total=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "circuit_eval",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": counts["circuit_eval"],
        "max_abs_err": kernel_check["max_abs_err"],
        "ms": head["ms_median"],
        "plain_ms": head["plain_ms_median"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"interval_2_10: {head['inputs_read']} x {idx.n_words} int32 in, "
                 f"{head['outputs']} x {idx.n_words} out",
        "tolerance": "exact (bitmaps)",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
