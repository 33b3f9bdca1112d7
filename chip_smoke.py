#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and
``nvcc``::

    python3 chip_smoke.py                 # full size: 64 columns x (2**27 - 5) rows
    python3 chip_smoke.py --rows-log2 22 --tiled-rows-log2 22  # a quick, small run

What it does, one JSON object per line:

1. ``env``          -- card name and power limit, torch / CUDA / nvcc versions,
                       seconds the kernel builds took (both built here from
                       ``src/repro_torch/kernels/csrc``, one ``nvcc`` each,
                       started together), and the registers and spilled
                       bytes per thread of each kernel instance as
                       ``nvcc -Xptxas -v`` reports them.
2. ``kernels``      -- the circuit-program kernel (K1) against its plain
                       version on the card over a sweep of shapes and circuits
                       (every words-a-thread instance, ragged ends of the word
                       axis, rows on and off 16-byte boundaries, the main
                       path's Weighted circuit at its launch shape);
                       mismatched words per case (must all be 0).
3. ``tiled_kernels``-- the tiled block kernel (K2) against its plain version
                       over a sweep of synthetic block plans (tile widths,
                       residual widths up to 64 inputs, 1 and 4 outputs, one
                       and several groups, every container kind, 90 % clean
                       cells, all-dense and all-clean blocks, a full adder
                       with one constant output, a wide register file, a
                       program longer than the rows a block stages).
4. ``main_path``    -- builds a device-resident ``BitmapIndex`` of random
                       columns and runs planner-driven ``execute`` /
                       ``execute_many`` queries (the dense ``fused`` route);
                       every result is compared with the plain version over
                       the whole array and with a counter oracle on a slice
                       that holds the tail; launch counts are read around it.
5. ``timing``       -- CUDA-event medians of the fused queries, bytes moved,
                       GB/s and the memory bound, K1's launch shape, blocks
                       and word columns resident on an SM; host time of
                       plan + dispatch.
6. ``tiled_path``   -- a second index, clustered (runs, noise, a dense tail),
                       on which the planner picks ``tiled_fused``; every result
                       is compared with the dense route, the counter oracle
                       and the ``merge`` engine on a tile subset; launch counts
                       are read around it.
7. ``tiled_timing`` -- per tiled query: K2's time and bound, the event stage's
                       time, the plain version's, time to result, and the dense
                       route's time to result on the same index; K2's shared
                       memory a block and the blocks that fit on one SM
                       (from its registers and the card's limits).
8. ``calibration``  -- on the random index: ``measure_calibration()`` at the
                       reference's shape and at 64 x 2**18 words (smaller if
                       the host lacks the memory to generate it), the
                       calibrated plans of four thresholds beside the
                       uncalibrated ones, each executed and held against K1,
                       and the ``calibration.json`` round trip with a foreign
                       stamp refused.
9. ``backends``     -- ``looped``, ``csvckt``, ``rbmrg_block`` on the random
                       index, ``dsk`` on its 16 sparsest columns x 2**15
                       words, and the five legacy shims on its first 2**16
                       words: 0 mismatched words against K1, to-result ms.
10. ``backends_tiled`` -- ``rbmrg_block`` on the clustered index beside the
                       tiled route: its case split and to-result ms.
11. ``obs``         -- ``repro_torch.obs`` on the clustered index: span trees,
                       the kernel counters against K2's launches and the
                       reference's decode-word count, the Prometheus lint,
                       drift samples, and ``Interval(2,10)`` to result with
                       tracing on and off.
12. ``stream``      -- a ``StreamingIndex`` over the clustered index: two
                       materialized views, three seeded batches (2**14
                       corrections a column in the newest 2**20 rows, 4,096
                       scattered updates, 4,096 appended rows), queries through
                       the overlay (``merge`` engine and K1) held against K1
                       over a dense copy replayed with torch ops and the counter
                       oracle, view refreshes through K1, ``compact()`` against
                       a rebuild and its answers on the ``scan`` engine (K2),
                       and auto-compaction under the default policy; times of
                       each step under the card's name and power limit.
13. ``persist``     -- in a temporary directory, removed at the end:
                       ``attach_durable`` (a checkpoint), two logged batches,
                       ``recover`` against the live index, a torn last WAL
                       record dropped, ``BitmapIndex.load(to_device=True)``
                       re-saved to the same sha256, a ``PagedTileStore``
                       query on the ``merge`` engine with its ``cache_info``,
                       and the WAL append latency.

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
K2_SOURCE = "src/repro_torch/kernels/csrc/tiled_block.cu"
K2_REPLACES = "src/repro/kernels/tiled_scan.py:236"


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


def ptxas_start(source: str) -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v`` on ``source`` with the kernels' target and
    optimisation flags, to a cubin in the build directory (the report is on
    standard error; read it with :func:`ptxas_resources`)."""
    from repro_torch.kernels import _build

    os.makedirs(_build.build_dir(), exist_ok=True)
    out = os.path.join(_build.build_dir(), f"ptxas-{os.getpid()}-{os.path.basename(source)}.cubin")
    return subprocess.Popen([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                             "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o", out, source],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_resources(proc: subprocess.Popen) -> dict:
    """Registers and spilled bytes per thread of each kernel instance, by
    name (``tiled_block_kernel<1>``), from the report of :func:`ptxas_start`."""
    import re

    _out, err = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{err}")
    got, name = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"([a-z][a-z_]*_kernel)ILi(\d+)E", m.group(1))
            name = f"{t.group(1)}<{t.group(2)}>" if t else m.group(1)
            got[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            got[name].update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            got[name]["registers"] = int(m.group(1))
    return got


# the limits of one SM of compute capability 9.0 (CUDA C++ Programming Guide,
# "Technical Specifications per Compute Capability"): 64K 32-bit registers
# allocated per warp in units of 256 over four schedulers, 2,048 threads,
# 32 blocks, 228 KB of shared memory of which each block also holds 1 KB
SM_REGISTERS, SM_THREADS, SM_BLOCKS, SM_SHARED, BLOCK_RESERVED_SHARED = 65536, 2048, 32, 233472, 1024


def blocks_per_sm(registers: int, threads: int, shared: int) -> int:
    """Blocks of ``threads`` threads at ``registers`` a thread and ``shared``
    bytes of dynamic shared memory that fit on one SM at once."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (SM_REGISTERS // per_warp) // 4 * 4 // warps
    return min(SM_BLOCKS, SM_THREADS // (warps * 32), by_regs,
               SM_SHARED // (shared + BLOCK_RESERVED_SHARED))


KERNEL_RESOURCES: dict = {}


def phase_env() -> str:
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2:]
    t0 = time.perf_counter()
    reports = [ptxas_start(os.path.join(ROOT, src)) for src in (K1_SOURCE, K2_SOURCE)]
    _build.build_libraries(["circuit_eval", "tiled_block"])
    for name in ("circuit_eval", "tiled_block"):
        _build.load_library(name)
    build_s = time.perf_counter() - t0
    for proc in reports:
        KERNEL_RESOURCES.update(ptxas_resources(proc))
    emit("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=" | ".join(nvcc), python=sys.version.split()[0],
         kernel_build_seconds=round(build_s, 3),
         per_kernel_build_seconds={k: round(v, 3) for k, v in _build.build_seconds.items()},
         build_dir=os.path.relpath(str(_build.build_dir()), ROOT),
         ptxas=KERNEL_RESOURCES)
    return smi


# ---------------------------------------------------------------------------
# phase 2: the circuit kernel against its plain version
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
    vecs_run = set()
    limit = K._max_shared(dev)

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
        p = K._program_for(circ, None if rows is None else tuple(rows))
        threads, vec = K.pick_launch_shape(p.n_registers, limit)
        vecs_run.add(vec)
        cases.append({"case": name, "n_words": bm.shape[1], "n_registers": p.n_registers,
                      "launch_shape": [threads, vec],
                      # one VEC*4-byte copy per LOAD (else VEC 4-byte copies)
                      "whole_copies": vec > 1 and bm.data_ptr() % (vec * 4) == 0
                      and (bm.shape[0] == 1 or bm.stride(0) % vec == 0),
                      "mismatched_words": bad})
        check(bad == 0, f"kernel case {name}: {bad} mismatched words")
        return cases[-1]

    def evaluated(bm, circ):  # gate by gate, no byte code
        got = circ.evaluate(list(bm))
        return got[0] if len(got) == 1 else torch.stack(got)

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

    # programs longer than a staged chunk: a run of LOADs and a chain of gates across it
    from repro_torch.core.bytecode import OP_LOAD, PROG_CHUNK

    c = C.build_threshold_circuit(132, 44, "ssum")
    ops = K._program_for(c, None).prog[:, 0]
    check(any(ops[j - 1] == OP_LOAD == ops[j] for j in range(PROG_CHUNK, len(ops), PROG_CHUNK)),
          "the 132-input program has a LOAD run across a chunk boundary")
    bm = rand_words(gen, 132, 5003, dev)
    run(f"a LOAD run across a chunk ({len(ops)} rows)", bm, c, oracle=ref.threshold_ref(bm, 44))
    n = 8
    c = C.Circuit(n, [], [])
    acc = 0
    for i in range(700):
        acc = c.XOR(acc, 1 + i % (n - 1)) if i % 3 else c.AND(acc, c.OR(i % n, (i + 3) % n))
    c.outputs = [acc]
    bm = rand_words(gen, n, 4099, dev)
    run(f"a chain of gates over {len(K._program_for(c, None).prog)} rows", bm, c, oracle=evaluated(bm, c))

    # word counts 4k+1 .. 4k+3 with four words a thread, rows off 16-byte boundaries
    c16 = C.build_threshold_circuit(16, 5, "ssum")
    big = rand_words(gen, 16, 4100, dev)
    for nw in (4097, 4098, 4099, 5, 6, 7):
        rec = run(f"threshold 5 of 16 over {nw} words", big[:16, :nw], c16,
                  oracle=ref.threshold_ref(big[:16, :nw], 5))
        check(rec["launch_shape"][1] == 4 and rec["whole_copies"], f"{rec}: not 16-byte copies")
    for off in (1, 2, 3):
        rec = run(f"threshold 5 of 16, rows from word {off}", big[:16, off:off + 4093], c16,
                  oracle=ref.threshold_ref(big[:16, off:off + 4093], 5))
        check(rec["launch_shape"][1] == 4 and not rec["whole_copies"], f"{rec}: whole copies")
    odd = rand_words(gen, 16, 4101, dev)
    rec = run("threshold 5 of 16, row stride 4101 words", odd, c16, oracle=ref.threshold_ref(odd, 5))
    check(not rec["whole_copies"], "a row stride off 4 words takes word copies")

    # every words-a-thread instance: a wide OR of m terms holds about m slots
    instances = {v for v, _floor in K.SHAPE_PREFERENCE}
    for vec in sorted(instances):
        for m in range(2, 400):
            c = C.Circuit(n, [], [])
            c.outputs = [c.wide_or([c.AND(i % n, (i * 3 + 1 + i // n) % n) for i in range(m)])]
            if K.pick_launch_shape(K._program_for(c, None).n_registers, limit)[1] == vec:
                bm = rand_words(gen, n, 9999, dev)
                run(f"{m} terms live at once, {vec} words a thread", bm, c, oracle=evaluated(bm, c))
                break
    check(vecs_run == instances, f"instances run: {sorted(vecs_run)}")

    # the main path's Weighted query at its launch shape
    from repro_torch.query import Weighted
    from repro_torch.query.index import circuit_for

    names = tuple(f"s{i}" for i in range(64))
    wq = Weighted(tuple(1 + (i * 5) % 9 for i in range(64)), 96)
    bm = rand_words(gen, 64, 100003, dev)
    wc = circuit_for((wq,), 64, names)
    run("the main path's Weighted, 64 inputs", bm, wc, oracle=evaluated(bm, wc))

    emit("kernels", n_cases=len(cases), max_shared_bytes=limit,
         words_per_thread_run=sorted(vecs_run),
         all_zero=all(c["mismatched_words"] == 0 for c in cases), cases=cases)
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 3: the tiled block kernel against its plain version
# ---------------------------------------------------------------------------


def mixed_tile_bits(rng, n: int, n_tiles: int, tw: int) -> np.ndarray:
    """bool[n, n_tiles * tw * 32 - 7]: each tile of each column all-zero,
    all-one, sparse, a few runs, or dense; the last tile is partial."""
    span = tw * 32
    r = n_tiles * span - 7
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for t, kind in enumerate(rng.integers(0, 5, n_tiles)):
            lo, hi = t * span, min((t + 1) * span, r)
            if kind == 1:
                bits[i, lo:hi] = True
            elif kind == 2:
                bits[i, rng.integers(lo, hi, int(rng.integers(1, 2 * tw)))] = True
            elif kind == 3:
                for _ in range(int(rng.integers(1, max(2, tw // 4)))):
                    a = int(rng.integers(lo, hi))
                    bits[i, a:min(hi, a + int(rng.integers(1, span // 2)))] = True
            elif kind == 4:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.4
    return bits


def group_circuit(m: int, k: int, salt: int):
    """A residual-like circuit over m inputs with k outputs (a threshold, a
    parity, an OR-like threshold, an AND of two inputs)."""
    from repro_torch.core import circuits as C

    c = C.Circuit(m, [], [])
    w = C.sideways_sum_bits(c, list(range(m)))
    outs = [C.ge_const(c, w, max(1, (m + salt) // 2)), w[0], C.ge_const(c, w, 1),
            c.AND(0, m - 1) if m > 1 else 0]
    c.outputs = outs[:k]
    return c.optimized()


def long_chain_circuit(n_terms: int):
    """A program of many rows over few register slots: a chain of gates over
    12 inputs, each step reading the last (1,511 rows and 25 slots at 600)."""
    from repro_torch.core import circuits as C

    c = C.Circuit(12, [], [])
    acc = 0
    for i in range(n_terms):
        j = 1 + i % 11
        if i % 2:
            acc = c.XOR(c.AND(acc, j), c.OR(acc, (j * 5 + i // 11) % 12))
        else:
            acc = c.OR(c.ANDNOT(acc, j), c.AND(j, (j + 3) % 12))
    c.outputs = [acc]
    return c.optimized()


def synthetic_block_stage(store, specs, k_max: int, rng, *, dummy_share=0.1, clean_share=None,
                          kinds=None, circs=None):
    """A block-stage plan over random (column, tile) cells of ``store``:
    ``specs`` is [(m, k, n_tiles)] per group.  ``clean_share`` draws that
    share of the cells from clean tiles and ``kinds`` only cells of those
    ``CELL_*`` kinds; ``circs`` replaces the groups' circuits.  Returns
    (stage, n_sel, cell kinds used)."""
    from repro_torch.kernels import tiled_scan as TK
    from repro_torch.storage.tiled import cell_descriptors

    tw = store.tile_words
    if circs is None:
        circs = tuple(group_circuit(m, k, g) for g, (m, k, _n) in enumerate(specs))
    table = TK.program_table(tuple(circs), k_max)
    B = TK.pick_tile_block(tw, table, max(n for _m, _k, n in specs))
    m_max = max(c.n_inputs for c in circs)
    n_sel = sum(n for _m, _k, n in specs) + 5
    D = store.packs["dense_pack"].shape[0]
    wall, tall = (a.reshape(-1) for a in np.meshgrid(np.arange(store.n), np.arange(store.n_tiles),
                                                     indexing="ij"))
    desc = cell_descriptors(store, wall, tall)
    pool = np.arange(len(desc)) if kinds is None else np.nonzero(np.isin(desc[:, 0], kinds))[0]
    clean = np.nonzero(desc[:, 0] <= TK.CELL_ONE)[0]
    gids, cells, dst = [], [], []
    tile0 = 0
    for g, (circ, (_m, _k, ng)) in enumerate(zip(circs, specs)):
        m, k = circ.n_inputs, len(circ.outputs)
        nb = -(-ng // B)
        pick = rng.choice(pool, (m, ng))
        if clean_share is not None:
            swap = rng.random((m, ng)) < clean_share
            pick[swap] = rng.choice(clean, int(swap.sum()))
        c = np.zeros((m_max, nb * B, 3), np.int64)
        c[:, :, 1] = D
        c[:m, :ng] = desc[pick]
        cells.append(c.reshape(m_max, nb, B, 3).transpose(1, 0, 2, 3))
        d = np.full((nb, k_max, B), -1, np.int64)
        tpos = np.arange(ng)
        aimed = rng.random(ng) >= dummy_share  # the rest go nowhere
        for j in range(k):
            d[tpos[aimed] // B, j, tpos[aimed] % B] = j * n_sel + tile0 + tpos[aimed]
        dst.append(d)
        gids.append(np.full(nb, g, np.int32))
        tile0 += ng
    cells = np.concatenate(cells)
    st = TK.make_block_stage(table, np.concatenate(gids), cells, np.concatenate(dst),
                             store.device_packs(), B, tw)
    return st, n_sel, np.bincount(cells[..., 0].reshape(-1), minlength=5)


def full_adder_stage(store):
    """One block whose full adder has a constant carry and a varying sum:
    sum = 1 ^ 1 ^ c, carry = maj(1, 1, c) = 1, outputs (sum, carry | z) over
    column 0 (all ones) twice and two dense columns.  Returns (stage, n_sel)."""
    from repro_torch.core import circuits as C
    from repro_torch.kernels import tiled_scan as TK
    from repro_torch.storage.tiled import cell_descriptors

    c = C.Circuit(4, [], [])
    s, carry = c.full_adder(0, 1, 2)
    c.outputs = [s, c.OR(carry, 3)]
    table = TK.program_table((c,), 2)
    B = TK.pick_tile_block(store.tile_words, table, 4)
    cols = np.array([0, 0, 1, 2])
    cells = cell_descriptors(store, np.repeat(cols[:, None], B, 1), np.tile(np.arange(B), (4, 1)))
    check((cells[:2, :, 0] == TK.CELL_ONE).all() and (cells[2:, :, 0] == TK.CELL_DENSE).all(),
          "the full-adder case's columns are all ones and dense")
    dst = np.stack([np.arange(B), B + np.arange(B)])[None]
    st = TK.make_block_stage(table, np.zeros(1, np.int32), cells[None], dst,
                             store.device_packs(), B, store.tile_words)
    return st, B


def phase_tiled_kernels(dev) -> dict:
    from repro_torch.core import circuits as C
    from repro_torch.core.bitmaps import pack
    from repro_torch.kernels import tiled_scan as TK
    from repro_torch.storage import TileStore

    rng = np.random.default_rng(4321)
    gen = torch.Generator(device=dev).manual_seed(4321)
    cases = []
    worst = 0
    kinds_seen = np.zeros(5, np.int64)

    def run(name, st, n_sel, kinds=None):
        nonlocal worst
        buf0 = torch.randint(-(2**31), 2**31, (st.k_max, n_sel, st.tw), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
        got = buf0.clone()
        TK.block_runner(got, st)
        torch.cuda.synchronize()
        want = buf0.clone()
        TK.block_plain(want, st)
        bad = mismatches(got, want)
        worst = max(worst, int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()))
        written = int((got != buf0).sum().item())
        cases.append({"case": name, "B": st.B, "blocks": st.n_blocks,
                      "launch_shape": TK.launch_shape(st.B * st.tw),
                      "n_registers": st.table.n_registers, "m_max": st.m_max,
                      "program_rows": int(st.table.groups[:, 1].max()),
                      "cells_by_kind": None if kinds is None else kinds.tolist(),
                      "words_written": written, "mismatched_words": bad})
        check(bad == 0, f"tiled_block case {name}: {bad} mismatched words")
        check(written > 0, f"tiled_block case {name}: nothing written")

    specs = {
        "m=1 k_max=1": ([(1, 1, 7)], 1),
        "m=3,5 k_max=4": ([(3, 1, 40), (5, 4, 33)], 4),
        "overflow-style m=64 k_max=1": ([(64, 1, 70)], 1),
        "m=64,12,2 k_max=4": ([(64, 4, 45), (12, 2, 61), (2, 1, 9)], 4),
        "m=16,40 k_max=4": ([(16, 3, 30), (40, 4, 29)], 4),
        "m=8 k_max=1, many blocks": ([(8, 1, 5000)], 1),
        "m=2 k_max=1, a block of few words": ([(2, 1, 3)], 1),
    }
    wide = ("m=3,5 k_max=4", "m=8 k_max=1, many blocks")  # register files that fit 1,536 words
    for tw, n_tiles in ((8, 96), (64, 96), (1536, 12)):
        bits = mixed_tile_bits(rng, 8, n_tiles, tw)
        store = TileStore.from_packed(pack(torch.from_numpy(bits).to(dev), dev), tile_words=tw,
                                      r=bits.shape[1], device=dev)
        census = store.container_census()
        check(min(census[k] for k in ("clean", "dense", "sparse", "run")) > 0,
              f"tw={tw}: the sweep's store lacks a container kind: {census}")
        for name, (spec, k_max) in specs.items():
            if tw > 1024 and name not in wide:
                continue
            if tw > 1024:
                spec = [(m, k, min(n, 300)) for m, k, n in spec]
            st, n_sel, kinds = synthetic_block_stage(store, spec, k_max, rng)
            kinds_seen += kinds
            run(f"tw={tw} {name}", st, n_sel, kinds)
            # mostly clean cells, as on clustered data
            st, n_sel, kinds = synthetic_block_stage(store, spec, k_max, rng, clean_share=0.9)
            run(f"tw={tw} {name}, 90 % clean", st, n_sel, kinds)
        # whole blocks of one class: a padding tile is a clean cell
        spec, k_max = ([(16, 3, 64), (40, 4, 32)], 4) if tw <= 1024 else ([(3, 1, 40), (5, 4, 32)], 4)
        st, n_sel, kinds = synthetic_block_stage(store, spec, k_max, rng, kinds=[TK.CELL_DENSE])
        run(f"tw={tw} all dense", st, n_sel, kinds)
        st, n_sel, kinds = synthetic_block_stage(store, spec, k_max, rng,
                                                 kinds=[TK.CELL_ZERO, TK.CELL_ONE])
        run(f"tw={tw} all clean", st, n_sel, kinds)
        # a program past the rows a block stages, at every width
        st, n_sel, kinds = synthetic_block_stage(store, [(12, 1, 40)], 1, rng,
                                                 circs=(long_chain_circuit(600),))
        check(int(st.table.groups[0, 1]) > TK.STAGED_ROWS, "the long program outgrows the staging")
        run(f"tw={tw} a program of {st.table.groups[0, 1]} rows", st, n_sel, kinds)
        if tw == 64:
            fb = np.zeros((3, 8 * tw * 32), bool)
            fb[0] = True
            fb[1:] = rng.random((2, fb.shape[1])) < 0.4
            fstore = TileStore.from_packed(pack(torch.from_numpy(fb).to(dev), dev), tile_words=tw,
                                           r=fb.shape[1], device=dev)
            st, n_sel = full_adder_stage(fstore)
            run("tw=64 full adder: carry constant, sum varying", st, n_sel)
            # a wide register file (200 terms live at once) beside a narrow one
            big = C.Circuit(16, [], [])
            terms = [big.AND(i % 16, (i * 7 + 1 + i // 16) % 16) for i in range(200)]
            big.outputs = [big.wide_or(terms)]
            st, n_sel, kinds = synthetic_block_stage(store, [(16, 1, 40), (6, 1, 40)], 1, rng,
                                                     clean_share=0.9,
                                                     circs=(big, group_circuit(6, 1, 0)))
            run(f"tw=64 a group of {st.table.groups[0, 2]} slots beside one of "
                f"{st.table.groups[1, 2]}", st, n_sel, kinds)
    check(bool((kinds_seen > 0).all()), f"every cell kind in the sweep: {kinds_seen.tolist()}")
    emit("tiled_kernels", n_cases=len(cases), cells_by_kind=kinds_seen.tolist(),
         all_zero=all(c["mismatched_words"] == 0 for c in cases), cases=cases)
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 4: the main path (dense route)
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
# phase 5: timing of the dense route
# ---------------------------------------------------------------------------


def phase_timing(idx, queries, many, reps: int) -> dict:
    from repro_torch.core.bytecode import PROG_CHUNK
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
        threads, vec = K.pick_launch_shape(prog.n_registers, K._max_shared(idx.device))
        regs = KERNEL_RESOURCES[f"circuit_eval_kernel<{vec}>"]["registers"]
        shared = PROG_CHUNK * 16 + prog.n_registers * vec * threads * 4
        blocks = blocks_per_sm(regs, threads, shared)
        rec = {"query": name, "inputs_read": n_in, "outputs": k, "gates": len(circ.ops),
               "n_registers": prog.n_registers, "program_rows": int(prog.prog.shape[0]),
               "launch_shape": [threads, vec], "registers": regs, "blocks_per_sm": blocks,
               "resident_columns_per_sm": blocks * threads * vec,
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


# ---------------------------------------------------------------------------
# phase 6: the tiled path
# ---------------------------------------------------------------------------

MEAN_RUN_BITS = 2**15
NOISE_DENSITY = 2e-5
DENSE_TAIL_COLUMNS, DENSE_TAIL_DENSITY = 8, 0.35


def make_clustered_columns(n: int, r: int, dev, seed: int) -> tuple:
    """int32[n, n_words] modelled on a bitmap index over a sorted table:
    column i is a union of runs covering a share of the rows that falls
    geometrically from 0.5 to 1e-3 (run lengths geometric, mean 2**15 bits;
    boundaries from a seeded numpy generator), plus uniform noise bits at
    2e-5; in the last 1/16 of the rows, columns 0-7 are i.i.d. bits at 0.35.
    Noise and dense bits come from a seeded generator on the card."""
    from repro_torch.core.bitmaps import n_words_for, pack

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    cover = np.geomspace(0.5, 1e-3, n)
    dense_from = r - r // 16
    cols = torch.empty((n, n_words_for(r)), dtype=torch.int32, device=dev)
    runs = []
    for i, p in enumerate(cover):
        mean_gap = MEAN_RUN_BITS * (1 - p) / p
        k = int(r / (MEAN_RUN_BITS + mean_gap) * 1.5) + 16
        lengths = np.empty(2 * k, np.int64)
        lengths[0::2] = rng.geometric(1 / mean_gap, k)  # gap, then run, ...
        lengths[1::2] = rng.geometric(1 / MEAN_RUN_BITS, k)
        edges = np.cumsum(lengths)
        edges = edges[edges < r]  # an odd count: the last run reaches the end
        runs.append((len(edges) + 1) // 2)
        toggles = torch.zeros(r, dtype=torch.int32, device=dev)
        vals = torch.ones(len(edges), dtype=torch.int32, device=dev)
        vals[1::2] = -1
        toggles[torch.from_numpy(edges).to(dev)] = vals
        bits = torch.cumsum(toggles, 0, dtype=torch.int32) != 0
        del toggles
        bits |= torch.rand(r, generator=gen, device=dev) < NOISE_DENSITY
        if i < DENSE_TAIL_COLUMNS:
            bits[dense_from:] = torch.rand(r - dense_from, generator=gen, device=dev) < DENSE_TAIL_DENSITY
        cols[i] = pack(bits, dev)
    return cols, [float(p) for p in cover], runs


def tiled_queries(names: tuple) -> tuple:
    from repro_torch.query import Col, Interval, Parity, Threshold

    n = len(names)
    every4 = tuple(names[i] for i in range(0, n, 4))
    eight = tuple(names[i] for i in range(1, n, 8))
    queries = {
        "interval_2_10": Interval(2, 10),
        "threshold_2": Threshold(2),
        f"threshold_{n // 2}": Threshold(n // 2),
        "threshold_3_of_every4": Threshold(3, over=every4),
        "composite": (Threshold(3, over=every4) & ~Col(names[5])) | Parity(over=eight),
        "threshold_2_of_last16": Threshold(2, over=names[n - 16:]),
    }
    return queries, [Threshold(2), Threshold(4), Threshold(8)]


def phase_tiled_path(dev, rows_log2: int, n: int, seed: int):
    from repro_torch.core.bitmaps import cardinality, pack, packed_tail_mask
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK
    from repro_torch.query import BitmapIndex
    from repro_torch.query.index import circuit_for
    from repro_torch.storage import run_tiled_circuit

    r = 2**rows_log2 - 5
    t0 = time.perf_counter()
    cols, cover, runs = make_clustered_columns(n, r, dev, seed)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    names = tuple(f"s{i}" for i in range(n))
    queries, many = tiled_queries(names)

    # counts to 0 just before the tiled path is driven
    for counts in (K.launch_counts, TK.launch_counts):
        for key in counts:
            counts[key] = 0

    t0 = time.perf_counter()
    idx = BitmapIndex(cols, names, r=r)  # device=None: the card
    store = idx.store
    census = store.container_census()
    t_build = time.perf_counter() - t0
    report, results, block_stages = [], {}, 0
    for name, q in queries.items():
        plan = idx.explain(q)
        t0 = time.perf_counter()
        got = idx.execute(q)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        info = dict(idx.last_info)
        t0 = time.perf_counter()
        again = idx.execute(q)  # the cached plan
        torch.cuda.synchronize()
        t_cached = time.perf_counter() - t0
        block_stages += 2 * (info["densified_tiles"] > 0)
        check(got.shape == (idx.n_words,) and got.dtype == torch.int32
              and got.device == idx.device, f"{name}: result shape/dtype/device")
        check(torch.equal(got, again), f"{name}: the cached plan gives another result")
        results[name] = (q, got)
        report.append({
            "query": name, "algorithm": plan.algorithm, "cost_words": plan.cost,
            "words_touched": info["words_touched"], "decode_words": info["decode_words"],
            "dirty_words_gathered": info["dirty_words_gathered"],
            "signatures": info["signatures"], "residual_signatures": info["residual_signatures"],
            "const_tiles": info["const_tiles"], "event_tiles": info["event_tiles"],
            "densified_tiles": info["densified_tiles"], "launches": info["launches"],
            "words_by_kind": info["words_by_kind"],
            "host_s_first_call": t_first, "host_s_cached_call": t_cached})
    many_plans = [idx.explain(q).algorithm for q in many]
    t0 = time.perf_counter()
    many_got = idx.execute_many(many)
    torch.cuda.synchronize()
    t_many = time.perf_counter() - t0
    many_info = dict(idx.last_info)
    block_stages += many_info["densified_tiles"] > 0

    # counts read just after the tiled path was driven
    counts = {**K.launch_counts, **TK.launch_counts}

    for rec in report:
        check(rec["algorithm"] == "tiled_fused", f"{rec['query']}: planned {rec['algorithm']}")
        check(rec["launches"] <= 2, f"{rec['query']}: {rec['launches']} launches")
    check(all(a == "tiled_fused" for a in many_plans), f"execute_many plans {many_plans}")
    check(many_info["backend"] == "tiled_fused" and many_info["n_outputs"] == len(many)
          and many_info["launches"] <= 2, f"execute_many: one tiled dispatch, got {many_info}")
    infos = [rec for rec in report] + [many_info]
    check(any(i["event_tiles"] > 0 and i["densified_tiles"] > 0 for i in infos),
          "a query with both an event and a block stage")
    for key in ("event_tiles", "densified_tiles", "const_tiles"):
        check(any(i[key] > 0 for i in infos), f"{key} > 0 somewhere")
    for kind in ("dense", "sparse", "run"):
        check(sum(i["words_by_kind"][kind] for i in infos) > 0, f"words_by_kind[{kind}] > 0")
    check(counts["tiled_block"] == block_stages and block_stages > 0,
          f"tiled_block launched {counts['tiled_block']} times, {block_stages} block stages")
    check(counts["circuit_eval"] == 0, "the tiled path launched the circuit kernel")

    # verification: the dense route, the counter oracle, the merge engine
    sl_words = min(idx.n_words, 2**16)
    tail_rows = idx.columns[:, idx.n_words - sl_words:]
    tail_bits = r - (idx.n_words - sl_words) * 32
    slot = {nm: i for i, nm in enumerate(names)}
    tw = store.tile_words
    rng = np.random.default_rng(seed + 7)
    sel = np.unique(np.append(rng.choice(store.n_tiles, min(3000, store.n_tiles), replace=False),
                              store.n_tiles - 1))
    mask = packed_tail_mask(r, idx.n_words, dev)
    if mask is None:
        mask = torch.full((idx.n_words,), -1, dtype=torch.int32, device=dev)
    pad = store.n_tiles * tw - idx.n_words
    mask_t = torch.nn.functional.pad(mask, (0, pad)).view(store.n_tiles, tw)[torch.from_numpy(sel).to(dev)]

    def verify(name, q, got, circ, j):
        want = idx.execute(q, backend="fused")
        bad_dense = mismatches(got, want)
        ob = oracle_bits(q, slot, tail_rows)
        ob[tail_bits:] = False
        bad_oracle = mismatches(got[idx.n_words - sl_words:], pack(ob, dev))
        merged, minfo = run_tiled_circuit(store, circ, tiles=sel, engine="merge")
        got_t = torch.nn.functional.pad(got, (0, pad)).view(store.n_tiles, tw)
        bad_merge = mismatches(merged[j] & mask_t, got_t[torch.from_numpy(sel).to(dev)])
        check(bad_dense == 0, f"{name}: {bad_dense} words differ from the dense route")
        check(bad_oracle == 0, f"{name}: {bad_oracle} words differ from the oracle")
        check(bad_merge == 0, f"{name}: {bad_merge} words differ from the merge engine")
        return {"dense": bad_dense, "oracle": bad_oracle, "merge": bad_merge,
                "merge_launches": minfo["launches"]}

    for rec in report:
        q, got = results[rec["query"]]
        rec["mismatch"] = verify(rec["query"], q, got, circuit_for((q,), n, names), 0)
    many_circ = circuit_for(tuple(many), n, names)
    many_bad = [verify(f"execute_many[{j}]", q, g, many_circ, j)
                for j, (q, g) in enumerate(zip(many, many_got))]
    q, got = results["interval_2_10"]
    check(idx.count(q) == int(cardinality(got).item()), "count() equals the result's cardinality")

    emit("tiled_path", n_columns=n, r=r, n_words=idx.n_words, tile_words=tw,
         n_tiles=store.n_tiles, coverage=[cover[0], cover[-1]], runs_per_column=[runs[0], runs[-1]],
         mean_run_bits=MEAN_RUN_BITS, noise_density=NOISE_DENSITY,
         dense_tail={"columns": DENSE_TAIL_COLUMNS, "density": DENSE_TAIL_DENSITY, "rows": r // 16},
         seconds_make_bits=round(t_make, 2), seconds_build_and_classify=round(t_build, 2),
         census=census, clean_fraction=store.clean_fraction, queries=report,
         execute_many={"k": len(many), "plans": many_plans, "host_s": t_many,
                       "launches": many_info["launches"], "event_tiles": many_info["event_tiles"],
                       "densified_tiles": many_info["densified_tiles"],
                       "decode_words": many_info["decode_words"], "mismatch": many_bad},
         merge_tiles=int(sel.size), launch_counts=counts)
    return idx, queries, many, counts


# ---------------------------------------------------------------------------
# phase 7: timing of the tiled route
# ---------------------------------------------------------------------------

GATES_PER_OP = {7: 5, 8: 4, 0: 1, 1: 1, 2: 1, 3: 1}  # FA, MAJ, and/or/xor/andnot


def block_stage_work(st) -> dict:
    """Bytes the block stage must move and gate-words it must compute, for
    this plan's data (padding cells and unused dst entries not counted)."""
    cells = st.cells.cpu().numpy()
    dst = st.dst.cpu().numpy()
    gids = st.gids.cpu().numpy()
    tw = st.tw
    kind = cells[..., 0]
    sizes = cells[..., 2] - cells[..., 1]
    dense_b = int((kind == 2).sum()) * tw * 4
    sparse_b = int(sizes[kind == 3].sum()) * 2
    run_b = int(sizes[kind == 4].sum()) * 4
    tables_b = (gids.nbytes + cells.nbytes + dst.nbytes + st.table.prog.nbytes
                + st.table.groups.nbytes + st.table.outs.nbytes)
    written_b = int((dst >= 0).sum()) * tw * 4
    ops = 0
    for g in range(len(st.table.groups)):
        prog, _outs, _n, _m = st.table.program(g)
        gates = sum(GATES_PER_OP.get(int(op), 0) for op in prog[:, 0])
        tiles = int((dst[gids == g][:, 0, :] >= 0).sum())
        ops += gates * tiles * tw
    return {"bytes": dense_b + sparse_b + run_b + tables_b + written_b, "dense_bytes": dense_b,
            "payload_bytes": sparse_b + run_b, "table_bytes": tables_b, "written_bytes": written_b,
            "gate_words": ops}


def k2_occupancy(st) -> dict:
    """Shared memory a block of this stage takes and the blocks that fit on
    one SM, from the kernel instance's registers (``nvcc -Xptxas -v``)."""
    from repro_torch.kernels import tiled_scan as TK

    threads, vec = TK.launch_shape(st.B * st.tw)
    n_rows = int(st.table.groups[:, 1].max())
    shared = TK.block_shared_bytes(st.B, st.tw, st.table.n_registers, st.m_max, n_rows)
    regs = KERNEL_RESOURCES[f"tiled_block_kernel<{vec}>"]["registers"]
    return {"threads": threads, "shared_bytes": shared, "registers": regs,
            "blocks_per_sm": blocks_per_sm(regs, threads, shared)}


def phase_tiled_timing(idx, queries, many, reps: int) -> dict:
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK
    from repro_torch.query.index import circuit_for
    from repro_torch.storage import run_tiled_circuit

    store = idx.store
    names = idx.names
    out, headline = [], None

    def to_result(fn, n=5):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    def one(name, qs):
        nonlocal headline
        circ = circuit_for(tuple(qs), idx.n, names)
        run_tiled_circuit(store, circ)  # the plan is cached
        ckey = K.circuit_structural_key(circ)
        plan, info = store._scan_plan_cache[(ckey, None)]
        k, n_sel, tw = plan["k"], plan["n_sel"], plan["tw"]
        buf = plan["base"][:, :, None].expand(k, n_sel, tw).contiguous()
        rec = {"query": name, "outputs": k}
        if plan["block"] is not None:
            st = plan["block"]
            times = cuda_ms(lambda: TK.block_runner(buf, st), reps=reps)
            plain = cuda_ms(lambda: TK.block_plain(buf, st), reps=3, warmup=1)
            work = block_stage_work(st)
            bytes_ms = work["bytes"] / PEAK_BYTES_PER_S * 1e3
            ops_ms = work["gate_words"] / PEAK_ALU_OPS_PER_S * 1e3
            ms = statistics.median(times)
            rec.update({"k2_ms_median": ms, "k2_ms_min": min(times), "k2_ms_max": max(times),
                        "blocks": st.n_blocks, "B": st.B, "groups": len(st.table.groups),
                        "launch_shape": TK.launch_shape(st.B * st.tw),
                        "n_registers": st.table.n_registers, **work,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                        "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
                        "share_of_bound": max(bytes_ms, ops_ms) / ms,
                        "k2_plain_ms_median": statistics.median(plain),
                        "decode_words": info["decode_words"], **k2_occupancy(st)})
        if plan["event"] is not None:
            ev = plan["event"]
            rec.update({"event_ms_median": statistics.median(
                cuda_ms(lambda: TK.event_runner(buf, ev), reps=reps)),
                "event_toggles": int(ev.keys.numel())})
        if len(qs) == 1:
            q = qs[0]
            rec["tiled_to_result_ms"] = to_result(lambda: idx.execute(q))
            rec["dense_fused_to_result_ms"] = to_result(lambda: idx.execute(q, backend="fused"))
            rec["dense_k1_ms_median"] = statistics.median(
                cuda_ms(lambda: K.run_circuit_cached(idx.columns, circ), reps=reps))
        else:
            rec["tiled_to_result_ms"] = to_result(lambda: idx.execute_many(qs))
        out.append(rec)
        if name == "interval_2_10":
            headline = rec

    for name, q in queries.items():
        one(name, [q])
    one(f"execute_many_k{len(many)}", many)
    emit("tiled_timing", queries=out)
    return headline


# ---------------------------------------------------------------------------
# phase 8: planner calibration measured on the card
# ---------------------------------------------------------------------------

CAL_THRESHOLDS = (2, 3, 32, 63)
CAL_MAX_WORDS_LOG2 = 18


def zero_counts() -> None:
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK

    for counts in (K.launch_counts, TK.launch_counts):
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK

    return {**K.launch_counts, **TK.launch_counts}


def to_result_ms(fn, n: int = 5) -> float:
    """Median host time of ``fn`` through a device synchronise (ms)."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def calibration_words_log2(n: int) -> int:
    """The largest n_words <= 2**18 whose host generation (a float64
    [n, n_words * 32] array) takes at most an eighth of the free memory."""
    free = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
    lg = CAL_MAX_WORDS_LOG2
    while lg > 11 and n * (2**lg) * 32 * 8 > free // 8:
        lg -= 1
    return lg


def phase_calibration(idx) -> None:
    import tempfile

    from repro_torch.core.calibration import (Calibration, clear_calibration, device_signature,
                                              get_calibration, measure_calibration,
                                              set_calibration)
    from repro_torch.persist import ensure_calibration, load_calibration, save_calibration
    from repro_torch.query import Threshold

    dev = idx.device
    clear_calibration()
    base = {t: idx.explain(Threshold(t), memo=False) for t in CAL_THRESHOLDS}
    zero_counts()
    t0 = time.perf_counter()
    small = measure_calibration(device=dev)
    t_small = time.perf_counter() - t0
    lg = calibration_words_log2(64)
    t0 = time.perf_counter()
    large = measure_calibration(n=64, n_words=2**lg, device=dev)
    t_large = time.perf_counter() - t0
    counts = read_counts()
    for cal in (small, large):
        check(cal.device == device_signature(dev) == "cudax1", f"stamped {cal.device}")
        check(set(cal.us_per_kword) == {"fused", "ssum", "tiled_fused", "looped",
                                        "scancount_streaming", "wide_or", "wide_and"},
              f"priced backends {sorted(cal.us_per_kword)}")
        check(all(v > 0 and np.isfinite(v) for v in cal.us_per_kword.values()),
              f"constants finite and positive: {cal.us_per_kword}")

    set_calibration(large)
    plans = []
    for t in CAL_THRESHOLDS:
        q = Threshold(t)
        cal_plan = idx.explain(q, memo=False)
        check(cal_plan.cost_us is not None, f"T={t}: a calibrated plan carries cost_us")
        got = idx.execute(q, backend=cal_plan.algorithm)
        ms = to_result_ms(lambda: idx.execute(q, backend=cal_plan.algorithm))
        want = idx.execute(q, backend="fused")
        bad = mismatches(got, want)
        check(bad == 0, f"T={t}: calibrated plan {cal_plan.algorithm} differs in {bad} words")
        plans.append({"t": t, "uncalibrated": base[t].algorithm, "cost_words": base[t].cost,
                      "calibrated": cal_plan.algorithm, "cost_us": cal_plan.cost_us,
                      "candidates_us": [list(c) for c in cal_plan.candidates_us],
                      "to_result_ms": ms, "mismatched_words": bad})

    with tempfile.TemporaryDirectory() as tmp:
        path = save_calibration(large, tmp)
        back = load_calibration(tmp)
        check(back is not None and back.to_obj() == large.to_obj(), "calibration round trip")
        for stamp in ("tpux4", "cpux1"):
            save_calibration(Calibration(device=stamp, us_per_kword={"fused": 1.0}),
                             os.path.join(tmp, stamp))
            check(load_calibration(os.path.join(tmp, stamp)) is None,
                  f"a file stamped {stamp} is refused on the card")
            check(load_calibration(os.path.join(tmp, stamp), allow_mismatch=True) is not None,
                  f"allow_mismatch reads the {stamp} file")
        save_calibration(Calibration.identity(), os.path.join(tmp, "identity"))
        check(load_calibration(os.path.join(tmp, "identity")) is not None, "identity accepted")
        got = ensure_calibration(tmp)
        check(got.to_obj() == large.to_obj() and get_calibration() is got,
              "ensure_calibration loads and installs the saved constants")
        file_name = os.path.basename(str(path))
    clear_calibration()
    emit("calibration", default_shape={"n": 16, "n_words": 2048, "repeats": 3},
         default_us_per_kword=small.us_per_kword, default_seconds=round(t_small, 2),
         large_shape={"n": 64, "n_words": 2**lg, "repeats": 3},
         large_us_per_kword=large.us_per_kword, large_seconds=round(t_large, 2),
         device=large.device, plans_on_the_random_index=plans,
         persisted=file_name, launch_counts=counts)


# ---------------------------------------------------------------------------
# phase 9: the remaining executors and the legacy shims on the random index
# ---------------------------------------------------------------------------

SHIM_WORDS = 2**16


def phase_backends(idx) -> None:
    import importlib

    from repro_torch.core.threshold import threshold, weighted_threshold
    from repro_torch.kernels import ops
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.query import BitmapIndex, Interval, Threshold, Weighted
    from repro_torch.query.index import circuit_for

    symmetric = importlib.import_module("repro_torch.core.symmetric")
    names = idx.names
    n = idx.n
    sparse = names[48:64] if n >= 64 else names[-16:]
    small = BitmapIndex(idx.columns[names.index(sparse[0]):names.index(sparse[-1]) + 1,
                                    :2**15].contiguous(), sparse, device=idx.device)
    cases = [(idx, "looped", t) for t in (2, 3, 32)]
    cases += [(idx, "csvckt", t) for t in (2, 32, 63)]
    cases += [(idx, "rbmrg_block", t) for t in (2, 32)]
    cases += [(small, "dsk", t) for t in (15, 16)]

    sub = idx.columns[:, :SHIM_WORDS].contiguous()
    dev = idx.device
    weights = tuple(1 + i % 3 for i in range(n))
    wt = sum(weights) // 2
    shims = [
        ("threshold", Threshold(32), lambda: threshold(sub, 32)),
        ("weighted_threshold", Weighted(weights, wt), lambda: weighted_threshold(sub, weights, wt)),
        ("symmetric.interval", Interval(2, 10), lambda: symmetric.interval(sub, 2, 10, device=dev)),
        ("ops.fused_threshold", Threshold(32), lambda: ops.fused_threshold(sub, 32, device=dev)),
        ("ops.fused_weighted_threshold", Weighted(weights, wt),
         lambda: ops.fused_weighted_threshold(sub, weights, wt, device=dev)),
    ]

    zero_counts()
    runs = []
    for index, backend, t in cases:
        q = Threshold(t)
        got = index.execute(q, backend=backend)
        engine = index.last_info["engine"]
        ms = to_result_ms(lambda: index.execute(q, backend=backend))
        runs.append((index, backend, t, got, engine, ms))
    shim_runs = []
    for name, q, fn in shims:
        got = fn()
        torch.cuda.synchronize()
        shim_runs.append((name, q, got, to_result_ms(fn)))
    counts = read_counts()

    report = []
    for index, backend, t, got, engine, ms in runs:
        want = index.execute(Threshold(t), backend="fused")
        bad = mismatches(got, want)
        check(bad == 0, f"{backend} T={t}: {bad} words differ from K1")
        check(engine == ("host" if backend == "dsk" else "dense"), f"{backend}: engine {engine}")
        report.append({"backend": backend, "t": t, "rows": f"{index.n} x {index.n_words} words",
                       "to_result_ms": ms, "engine": engine, "mismatched_words": bad})
    for name, q, got, ms in shim_runs:
        want = K.run_circuit_cached(sub, circuit_for((q,), n, names))
        bad = mismatches(got, want)
        check(bad == 0, f"shim {name}: {bad} words differ from K1")
        report.append({"shim": name, "query": repr(q)[:60],
                       "rows": f"{n} x {SHIM_WORDS} words", "to_result_ms": ms,
                       "mismatched_words": bad})
    check(counts["circuit_eval"] >= 3, f"the shims launched K1 {counts['circuit_eval']} times")
    emit("backends", runs=report, launch_counts=counts)


# ---------------------------------------------------------------------------
# phase 10: rbmrg_block on the clustered index, beside the tiled route
# ---------------------------------------------------------------------------


def phase_backends_tiled(idx) -> None:
    from repro_torch.query import Threshold
    from repro_torch.storage import rbmrg_block_threshold

    names = idx.names
    every4 = tuple(names[i] for i in range(0, idx.n, 4))
    queries = [("threshold_2", Threshold(2), None), ("threshold_32", Threshold(32), None),
               ("threshold_3_of_every4", Threshold(3, over=every4), every4)]
    zero_counts()
    runs = []
    for name, q, over in queries:
        got = idx.execute(q, backend="rbmrg_block")
        rb_ms = to_result_ms(lambda: idx.execute(q, backend="rbmrg_block"))
        tiled = idx.execute(q)
        tiled_alg = idx.last_info["backend"]
        tiled_ms = to_result_ms(lambda: idx.execute(q))
        runs.append((name, q, over, got, tiled, tiled_alg, rb_ms, tiled_ms))
    counts = read_counts()
    report = []
    for name, q, over, got, tiled, tiled_alg, rb_ms, tiled_ms in runs:
        bad = mismatches(got, tiled)
        check(bad == 0, f"rbmrg_block {name}: {bad} words differ from the tiled route")
        check(tiled_alg == "tiled_fused", f"{name}: the planned route is {tiled_alg}")
        rows = idx.columns if over is None else idx.columns[[names.index(c) for c in over]]
        _out, info = rbmrg_block_threshold(rows, q.t)
        report.append({"query": name, "case1_tiles": info["case1_tiles"],
                       "case2_tiles": info["case2_tiles"], "case3_tiles": info["case3_tiles"],
                       "dirty_words_processed": info["dirty_words_processed"],
                       "work_fraction": info["work_fraction"], "rbmrg_to_result_ms": rb_ms,
                       "tiled_to_result_ms": tiled_ms, "mismatched_words": bad})
    emit("backends_tiled", runs=report, launch_counts=counts)


# ---------------------------------------------------------------------------
# phase 11: observability on the query path
# ---------------------------------------------------------------------------


def phase_obs(idx, reps: int = 20) -> None:
    import repro_torch.obs as obs
    from repro_torch.kernels import tiled_scan as TK
    from repro_torch.obs.registry import lint_prometheus
    from repro_torch.query import Interval, Threshold, clear_compiled_cache

    store = idx.store

    def last_stage_words() -> int:
        plan, _info = next(reversed(store._scan_plan_cache.values()))
        return plan["block"].counted_decode_words if plan["block"] is not None else 0

    q = Interval(2, 10)
    many = [Threshold(2), Threshold(4), Threshold(8)]
    obs.disable()
    obs.reset()
    clear_compiled_cache()  # a compile span on the first call of each circuit
    zero_counts()
    obs.enable()
    trees, counted, info_words = [], 0, 0
    for call in (lambda: idx.execute(q), lambda: idx.execute(q, backend="fused"),
                 lambda: idx.execute_many(many)):
        call()
        trees.append(obs.last_trace())
        if idx.last_info["backend"] == "tiled_fused":
            counted += last_stage_words()
            info_words += idx.last_info["decode_words"]
    torch.cuda.synchronize()
    obs.disable()
    counts = read_counts()
    snap = obs.REGISTRY.snapshot()
    block_launches = snap["repro_kernel_launches_total"]["samples"].get("block", 0)
    decode_words = snap["repro_kernel_decode_words_total"]["samples"].get("", 0)
    prom = obs.export_prometheus()
    problems = lint_prometheus(prom)
    drift = obs.drift_samples()
    executions = obs.QUERY_WALL.merged().count

    def names_of(sp):
        return [s.name for s in sp.iter()]

    tiled_tree, fused_tree, many_tree = trees
    check(tiled_tree.name == "execute" and fused_tree.name == "execute", "execute roots")
    check(many_tree.name == "execute_many", f"execute_many root, got {many_tree.name}")
    for label, tree in (("tiled", tiled_tree), ("fused", fused_tree), ("many", many_tree)):
        got = names_of(tree)
        check("dispatch" in got, f"{label}: a dispatch span in {got}")
        check(("compile" in got) or any(s.attrs.get("compile_cache") == "hit" for s in tree.iter()),
              f"{label}: a compile span or a compile-cache hit in {got}")
    check("plan" in names_of(tiled_tree) and "plan" in names_of(many_tree),
          "the planned queries have plan spans")
    check("compile" in names_of(tiled_tree), "the first call compiles")
    check("decode" in names_of(tiled_tree) and "decode" in names_of(many_tree),
          "the tiled dispatches carry a decode span")
    check("decode" not in names_of(fused_tree), "the dense dispatch has no decode span")
    check(tiled_tree.find("dispatch").attrs["backend"] == "tiled_fused", "planned tiled_fused")
    check(block_launches == counts["tiled_block"] and block_launches > 0,
          f"block stage counter {block_launches}, K2 launches {counts['tiled_block']}")
    check(counts["circuit_eval"] == 1, f"one K1 launch (the fused query), {counts}")
    check(decode_words == counted,
          f"decode-words counter {decode_words}, the plans' reference count {counted}")
    check(problems == [], f"prometheus lint: {problems[:3]}")
    check(drift == 2 and executions == 3,
          f"drift samples {drift} (2 priced executions), wall samples {executions} (3)")

    # the tracing cost: the same query with obs on and off, in turns
    on, off = [], []
    for _ in range(reps):
        for enabled, out in ((True, on), (False, off)):
            if enabled:
                obs.enable()
            t0 = time.perf_counter()
            idx.execute(q)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            obs.disable()
    obs.reset()
    emit("obs", span_trees={"tiled": tiled_tree.format(), "fused": fused_tree.format(),
                            "execute_many": many_tree.format()},
         block_launches_counter=block_launches, k2_launches=counts["tiled_block"],
         decode_words_counter=decode_words, decode_words_reference_count=counted,
         decode_words_exec_info=info_words, drift_samples=drift, executions=executions,
         prometheus_lines=len(prom.splitlines()),
         interval_2_10_to_result_ms={"obs_on_median": statistics.median(on),
                                     "obs_off_median": statistics.median(off), "reps": reps},
         launch_counts=counts)


# ---------------------------------------------------------------------------
# phase 12: streaming updates, materialized views and compaction
# ---------------------------------------------------------------------------

STREAM_TAIL_ROWS = 2**20  # late corrections land in the newest rows
STREAM_TAIL_UPDATES = 2**14  # per column
STREAM_SCATTERED = 4096
STREAM_APPEND_ROWS = 4096
STREAM_APPEND_DENSITY = 0.05


def replay_on_dense(dense: torch.Tensor, cols, pos, on) -> None:
    """Apply a batch of single-bit sets (``on``) and clears to ``dense``
    (int32[n, n_words] on the card) with torch ops, sets first: the oracle
    of the streaming engine, independent of its host buffers."""
    n, nw = dense.shape
    flat = dense.view(-1)
    for sel, setting in ((on, True), (~on, False)):
        if not sel.any():
            continue
        key = torch.unique(torch.from_numpy(cols[sel] * (nw * 32) + pos[sel]).to(dense.device))
        word = (key // (nw * 32)) * nw + (key % (nw * 32)) // 32
        mask = torch.zeros(n * nw, dtype=torch.int64, device=dense.device)
        mask.index_add_(0, word, torch.bitwise_left_shift(torch.ones_like(key), key % 32))
        mask = torch.where(mask >= 2**31, mask - 2**32, mask).to(torch.int32)
        if setting:
            flat |= mask
        else:
            flat &= ~mask


def as_update(names, cols, pos, on) -> dict:
    """The ``update(sets=..., clears=...)`` keywords of a flat batch."""
    sets, clears = {}, {}
    for c in np.unique(cols).tolist():
        sel = cols == c
        sets[names[c]] = pos[sel & on]
        clears[names[c]] = pos[sel & ~on]
    return {"sets": sets, "clears": clears}


def stream_queries(data: tuple, composite) -> tuple:
    """The overlay's queries, all over the data columns (views join the
    schema, and ``over=None`` would read them too); ``composite`` is the
    tiled path's, whose members it names."""
    from repro_torch.query import Interval, Threshold

    queries = {"interval_2_10": Interval(2, 10, over=data), "threshold_2": Threshold(2, over=data),
               "threshold_32": Threshold(32, over=data), "composite": composite}
    many = [Threshold(t, over=data) for t in (2, 4, 8)]
    return queries, many


def host_profile(fn, top: int = 10) -> list:
    """Where one call's host time goes: ``cProfile`` around ``fn`` through a
    device synchronise; the ``top`` functions by own time, in ms (the
    profiler's own cost inflates them)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"function": f"{os.path.basename(path)}:{line}:{name}", "calls": st[1],
             "own_ms": st[2] * 1e3, "cumulative_ms": st[3] * 1e3}
            for (path, line, name), st in rows]


def phase_stream(tidx, composite, smi: str, seed: int):
    from repro_torch.core.bitmaps import cardinality, n_words_for, pack, packed_tail_mask
    from repro_torch.kernels.threshold_ssum import run_circuit_cached
    from repro_torch.query import Interval, Threshold
    from repro_torch.query.index import circuit_for
    from repro_torch.storage import TileStore
    from repro_torch.stream import CompactionPolicy, OverlayStore, StreamingIndex

    dev = tidx.device
    data = tidx.names
    n = len(data)
    rng = np.random.default_rng(seed + 12)
    report = {"card": smi}

    def timed_s(fn):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    # views first: materialize() compacts, so they are registered on the
    # clean base and the batches below land in the overlay
    s = StreamingIndex(tidx, policy=CompactionPolicy(auto=False))
    view_queries = {"v_interval_2_10": Interval(2, 10), "v_threshold_2_s48_s63":
                    Threshold(2, over=data[48:64])}
    zero_counts()
    mat_s = {name: timed_s(lambda q=q, name=name: s.materialize(name, q))[1]
             for name, q in view_queries.items()}
    report["materialize"] = {"seconds": mat_s, "launch_counts": read_counts()}

    # three seeded batches, replayed with torch ops on a clone of the dense view
    r0 = s.r
    dense = tidx.columns.clone()
    tail_cols = np.repeat(np.arange(n), STREAM_TAIL_UPDATES)
    tail_rows = min(STREAM_TAIL_ROWS, r0 // 4)
    tail_pos = r0 - tail_rows + rng.integers(0, tail_rows, tail_cols.size)
    tail_on = rng.random(tail_cols.size) < 0.5
    sc_cols = rng.integers(0, n, STREAM_SCATTERED)
    sc_pos = rng.integers(0, r0, STREAM_SCATTERED)
    sc_on = rng.random(STREAM_SCATTERED) < 0.5
    app = rng.random((n, STREAM_APPEND_ROWS)) < STREAM_APPEND_DENSITY
    batches = []
    for name, cols, pos, on in (("tail_corrections", tail_cols, tail_pos, tail_on),
                                ("scattered", sc_cols, sc_pos, sc_on)):
        kw = as_update(data, cols, pos, on)
        zero_counts()
        _, secs = timed_s(lambda: s.update(**kw))
        batches.append({"batch": name, "updates": int(cols.size), "apply_ms": secs * 1e3,
                        "patched_tiles": s.delta_stats()["patched_tiles"],
                        "launch_counts": read_counts()})
        replay_on_dense(dense, cols, pos, on)
    zero_counts()
    (start, stop), secs = timed_s(lambda: s.append_rows(app))
    batches.append({"batch": "append_rows", "rows": STREAM_APPEND_ROWS, "apply_ms": secs * 1e3,
                    "patched_tiles": s.delta_stats()["patched_tiles"], "r": [r0, s.r],
                    "launch_counts": read_counts()})
    check((start, stop) == (r0, r0 + STREAM_APPEND_ROWS), f"append_rows range {(start, stop)}")
    r1 = s.r
    nw1 = n_words_for(r1)
    check(nw1 > tidx.n_words, "the appended rows grew the word axis")
    dense = torch.nn.functional.pad(dense, (0, nw1 - dense.shape[1]))
    arow, apos = np.nonzero(app)
    replay_on_dense(dense, arow.astype(np.int64), r0 + apos.astype(np.int64),
                    np.ones(arow.size, bool))
    tail_touched = len({int(p) // (s.tile_words * 32) for p in tail_pos[tail_cols == 0]})
    report["batches"] = batches
    report["tail_tiles_touched_per_column"] = tail_touched

    # the views refresh through K1 over the touched tiles only
    zero_counts()
    _, refresh_s = timed_s(s.refresh)
    refresh_counts = read_counts()
    report["view_refresh"] = {"ms": refresh_s * 1e3, "launch_counts": refresh_counts,
                              "info": {v: s.view_info(v) for v in view_queries}}
    check(refresh_counts["circuit_eval"] == len(view_queries),
          f"one K1 launch per view refresh, {refresh_counts}")

    # the overlay: build and dense view timed on their own
    base_store = s._base.store
    ov, ov_s = timed_s(lambda: OverlayStore(base_store, s._delta))
    _, dens_s = timed_s(ov.densify)
    report["overlay"] = {"build_s": ov_s, "densify_ms": dens_s * 1e3,
                         "n_tiles": ov.n_tiles, "n_words": ov.n_words}
    del ov

    # queries through the overlay, then the two oracles
    queries, many = stream_queries(data, composite)
    zero_counts()
    results, runs = {}, []
    for name, q in queries.items():
        plan = s.explain(q)
        got, first_s = timed_s(lambda q=q: s.execute(q))
        info = dict(s.index().last_info)
        results[name] = got
        runs.append({"query": name, "algorithm": plan.algorithm, "engine": info.get("engine"),
                     "launches": info.get("launches"), "first_call_s": first_s})
    many_got, many_s = timed_s(lambda: s.execute_many(many))
    many_info = dict(s.index().last_info)
    overlay_counts = read_counts()
    check(overlay_counts["circuit_eval"] > 0, f"the overlay's routes launched K1, {overlay_counts}")
    check(overlay_counts["tiled_block"] == 0, "the overlay never takes the scan engine")
    for rec in runs + [many_info]:
        if rec.get("algorithm", rec.get("backend")) == "tiled_fused":
            check(rec["engine"] == "merge", f"tiled on the overlay is the merge engine: {rec}")

    mask = packed_tail_mask(r1, nw1, dev)

    def k1_dense(q):
        """K1 over the independent dense copy, tail-masked."""
        want = run_circuit_cached(dense, circuit_for((q,), n, data))
        return want if mask is None else want & mask

    sl_words = min(nw1, 2**16)
    tail_rows = dense[:, nw1 - sl_words:]
    tail_bits = r1 - (nw1 - sl_words) * 32
    slot = {nm: i for i, nm in enumerate(data)}
    bad = {}
    held = [(name, q, results[name]) for name, q in queries.items()]
    held += [(f"execute_many[{j}]", q, g) for j, (q, g) in enumerate(zip(many, many_got))]
    for name, q, got in held:
        want = k1_dense(q)
        ob = oracle_bits(q, slot, tail_rows)
        ob[tail_bits:] = False
        bad[name] = {"k1_dense_copy": mismatches(got, want),
                     "oracle": mismatches(got[nw1 - sl_words:], pack(ob, dev))}
        check(bad[name] == {"k1_dense_copy": 0, "oracle": 0}, f"{name}: {bad[name]}")
    report["overlay_queries"] = runs
    report["execute_many"] = {"k": len(many), "backend": many_info["backend"],
                              "engine": many_info.get("engine"), "first_call_s": many_s}
    report["overlay_launch_counts"] = overlay_counts
    report["mismatch"] = bad

    # the views equal the same query executed, their counts its popcount
    view_words = {}
    for name in view_queries:
        q = s._views[name].query  # its members bound at registration
        col = s.column(name)
        want = s.execute(q)
        view_words[name] = want
        check(mismatches(col, want) == 0, f"view {name} differs from its query")
        card = int(cardinality(want).item())
        check(s.count(name) == card, f"view {name}: count {s.count(name)} vs popcount {card}")
        check(mismatches(want, k1_dense(q)) == 0, f"view {name} differs from K1 over the dense copy")
    report["views"] = {name: {"cardinality": s.count(name)} for name in view_queries}

    # to result: the overlay beside the compacted base, after compaction
    overlay_ms = {name: to_result_ms(lambda q=q: s.execute(q)) for name, q in queries.items()}
    report["overlay_profile"] = host_profile(lambda: s.execute(queries["interval_2_10"]))

    zero_counts()
    compacted, compact_s = timed_s(s.compact)
    check(compacted, "compact() merged the delta")
    store = s._base.store
    rebuilt, rebuild_s = timed_s(lambda: TileStore.from_packed(
        torch.cat([dense] + [view_words[v][None] for v in view_queries]), r=r1, device=dev))
    for attr in ("classes_word", "container_kinds"):
        check(np.array_equal(getattr(store, attr), getattr(rebuilt, attr)),
              f"compacted {attr} differ from a rebuild")
    check(store.cardinalities == rebuilt.cardinalities, "compacted cardinalities differ")
    del rebuilt
    compact_runs = []
    for name, q in queries.items():
        got = s.execute(q)
        info = dict(s.index().last_info)
        check(info["backend"] == "tiled_fused" and info["engine"] == "scan",
              f"{name}: the compacted base ran {info['backend']} / {info.get('engine')}")
        check(mismatches(got, results[name]) == 0, f"{name}: compacted differs from the overlay")
        compact_runs.append({"query": name, "to_result_ms": to_result_ms(lambda q=q: s.execute(q)),
                             "overlay_to_result_ms": overlay_ms[name]})
    got = s.execute_many(many)
    for j in range(len(many)):
        check(mismatches(got[j], many_got[j]) == 0, f"many[{j}]: compacted differs")
    compact_counts = read_counts()
    check(compact_counts["tiled_block"] > 0, f"the compacted base launched K2, {compact_counts}")
    report["compaction"] = {"seconds": compact_s, "rebuild_seconds": rebuild_s,
                            "queries": compact_runs, "launch_counts": compact_counts}

    # the default policy: a batch past its threshold compacts on its own
    s2 = StreamingIndex(s._base)
    pol = s2.policy
    need = max(pol.min_delta_words, pol.max_delta_ratio * s2._base_working_words())
    k = int(need / s2.tile_words * 1.25) + 1
    cols = rng.integers(0, n, k)
    pos = rng.integers(0, r1, k)
    on = rng.random(k) < 0.5
    zero_counts()
    _, auto_s = timed_s(lambda: s2.update(**as_update(data, cols, pos, on)))
    check(s2.compactions == 1 and s2.delta_words == 0,
          f"auto-compaction: {s2.compactions} compactions, {s2.delta_words} delta words")
    replay_on_dense(dense, cols, pos, on)
    q = queries["interval_2_10"]
    got = s2.execute(q)
    auto_counts = read_counts()
    check(mismatches(got, k1_dense(q)) == 0,
          "after auto-compaction: differs from K1 over the dense copy")
    report["auto_compaction"] = {"updates": k, "threshold_words": need, "seconds": auto_s,
                                 "compactions": s2.compactions,
                                 "engine": s2.index().last_info.get("engine"),
                                 "launch_counts": auto_counts}
    emit("stream", **report)
    return s, dense, queries


# ---------------------------------------------------------------------------
# phase 13: durable snapshots and the write-ahead log
# ---------------------------------------------------------------------------


def sha256_of(path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def phase_persist(s, dense, queries, smi: str, seed: int) -> None:
    import shutil
    import tempfile

    from repro_torch.persist import PagedTileStore, WriteAheadLog, load, read_manifest, save
    from repro_torch.query import BitmapIndex, Threshold
    from repro_torch.stream import StreamingIndex

    data = s.names[:dense.shape[0]]
    rng = np.random.default_rng(seed + 13)
    q = queries["interval_2_10"]
    # three columns: at most 27 signatures, so no overflow group; their dense
    # tails make tiles that go through the page cache
    paged_q = Threshold(2, over=data[:3])
    report = {"card": smi}
    tmp = tempfile.mkdtemp(prefix="bmsnap-")
    try:
        d = os.path.join(tmp, "durable")
        zero_counts()
        t0 = time.perf_counter()
        s.attach_durable(d)  # no checkpoint there yet: writes one
        report["checkpoint_s"] = time.perf_counter() - t0
        snap = os.path.join(d, "snapshot.bmsnap")
        report["snapshot_bytes"] = os.path.getsize(snap)
        want_snap = s.execute(paged_q)

        def batch(k):
            cols = rng.integers(0, len(data), k)
            return as_update(data, cols, rng.integers(0, s.r, k), rng.random(k) < 0.5)

        s.update(**batch(4096))  # logged: batch A
        want_a = s.execute(q)
        s.update(**batch(4096))  # logged: batch B
        want_b = s.execute(q)
        t0 = time.perf_counter()
        rec = StreamingIndex.recover(d)
        got = rec.execute(q)
        torch.cuda.synchronize()
        report["recover_s"] = time.perf_counter() - t0
        check(rec.wal_version == s.wal_version, "recovered WAL version")
        check(mismatches(got, want_b) == 0, "recovered answers differ from the live index")
        for v in s.views:
            check(mismatches(rec.column(v), s.column(v)) == 0, f"recovered view {v} differs")
        # a torn last record: recovery answers as of batch A
        wal = os.path.join(d, "wal.bmwal")
        raw = open(wal, "rb").read()
        with open(wal, "wb") as f:
            f.write(raw[:-5])
        rec_a = StreamingIndex.recover(d)
        check(rec_a.wal_version == s.wal_version - 1, "the torn record was dropped")
        check(mismatches(rec_a.execute(q), want_a) == 0,
              "after a torn record: differs from the index as of the batch before")
        report["durable_launch_counts"] = read_counts()

        # load(to_device=True) and save again: the same bytes
        idx = BitmapIndex.load(snap, to_device=True)
        check(idx.store._dirty_dev is not None and idx.device.type == "cuda", "dirty pack uploaded")
        resaved = os.path.join(tmp, "resaved.bmsnap")
        manifest = read_manifest(snap)  # the checkpoint's extra keys go along
        save(idx, resaved, extra={k: manifest[k] for k in ("wal_version", "views")})
        report["sha256"] = sha256_of(snap)
        check(sha256_of(resaved) == report["sha256"], "load + save changed the snapshot's bytes")

        check(mismatches(idx.execute(paged_q), want_snap) == 0,
              "the loaded index differs from the checkpointed one")

        # the paged tier over the mapped snapshot: one tiled query, merge engine
        zero_counts()
        paged = PagedTileStore(load(snap))
        pidx = BitmapIndex(names=idx.names, _store=paged)
        got = pidx.execute(paged_q, backend="tiled_fused")
        check(pidx.last_info["engine"] == "merge", "the paged store takes the merge engine")
        check(mismatches(got, want_snap) == 0, "paged query differs from the checkpointed index")
        paged_ms = to_result_ms(lambda: pidx.execute(paged_q, backend="tiled_fused"))
        paged_counts = read_counts()
        check(paged_counts["circuit_eval"] > 0 and paged_counts["tiled_block"] == 0,
              f"the paged path launched K1 and never K2, {paged_counts}")
        report["paged"] = {"query": "threshold_2_of_s0_s2", "to_result_ms": paged_ms,
                           "cache_info": paged.cache_info(), "launch_counts": paged_counts}

        # WAL append latency on a log of its own
        wl = WriteAheadLog(os.path.join(tmp, "bench.bmwal"))
        cols = rng.integers(0, len(data), 4096)
        pos = rng.integers(0, s.r, 4096)
        on = rng.random(4096) < 0.5
        times = []
        for _ in range(50):
            t0 = time.perf_counter()
            wl.append_update(cols, pos, on)
            times.append((time.perf_counter() - t0) * 1e6)
        wl.close()
        report["wal_append_us"] = {"updates": 4096, "median": statistics.median(times),
                                   "min": min(times), "max": max(times), "appends": 50}
        emit("persist", **report)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-log2", type=int, default=27,
                    help="the dense path's index holds 2**this - 5 rows (default 27: 1 GiB)")
    ap.add_argument("--tiled-rows-log2", type=int, default=27,
                    help="the tiled path's index holds 2**this - 5 rows (default 27: 1 GiB)")
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
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        got = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return got

    smi = timed("env", phase_env)
    k1_check = timed("kernels", phase_kernels, dev)
    k2_check = timed("tiled_kernels", phase_tiled_kernels, dev)
    idx, queries, many, counts = timed("main_path", phase_main_path, dev, args.rows_log2,
                                       args.columns, args.seed)
    head = timed("timing", phase_timing, idx, queries, many, args.reps)
    timed("calibration", phase_calibration, idx)
    timed("backends", phase_backends, idx)
    n_words_dense = idx.n_words
    del idx
    tidx, tqueries, tmany, tcounts = timed("tiled_path", phase_tiled_path, dev,
                                           args.tiled_rows_log2, args.columns, args.seed)
    thead = timed("tiled_timing", phase_tiled_timing, tidx, tqueries, tmany, args.reps)
    timed("backends_tiled", phase_backends_tiled, tidx)
    timed("obs", phase_obs, tidx)
    stream, dense, squeries = timed("stream", phase_stream, tidx,
                                      tqueries["composite"], smi, args.seed)
    del tidx
    timed("persist", phase_persist, stream, dense, squeries, smi, args.seed)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port must not import jax or the reference package")

    emit("done", seconds_total=round(time.perf_counter() - t_start, 1), seconds=seconds)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "circuit_eval",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": counts["circuit_eval"],
        "max_abs_err": k1_check["max_abs_err"],
        "ms": head["ms_median"],
        "plain_ms": head["plain_ms_median"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"interval_2_10: {head['inputs_read']} x {n_words_dense} int32 in, "
                 f"{head['outputs']} x {n_words_dense} out",
        "tolerance": "exact (bitmaps)",
    }, {
        "name": "tiled_block",
        "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "launches": tcounts["tiled_block"],
        "max_abs_err": k2_check["max_abs_err"],
        "ms": thead["k2_ms_median"],
        "plain_ms": thead["k2_plain_ms_median"],
        "bound_ms": thead["bound_ms"],
        "bound_by": thead["bound_by"],
        "library_ms": None,
        "shape": f"interval_2_10 on the clustered index: {thead['blocks']} blocks of "
                 f"{thead['B']} tiles, {thead['groups']} residual groups",
        "tolerance": "exact (bitmaps)",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
