#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and
``nvcc``::

    python3 chip_smoke.py                 # full size: 64 columns x (2**27 - 5) rows
    python3 chip_smoke.py --rows-log2 22 --tiled-rows-log2 22 --search-rows-log2 16  # quick

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
14. ``serve``       -- run after ``backends``, on the random index: a threaded
                       ``QueryServer`` (2 ms window, batches of up to 64, a
                       128-entry result cache) under 8 clients sending 4,096
                       requests drawn Zipf(1.1) from 256 distinct queries, a
                       quarter with their members reordered; every result,
                       on receipt, against K1 over its own one-output
                       circuit, and the widest batch's circuit through K1
                       against its plain version; throughput,
                       latency and queue-wait percentiles, the batch-size
                       histogram, the widest batch's circuit and K1 launch
                       shape, the cache's bytes on the card, the calibration
                       constants before and after the feedback; then a run
                       with 8 pending queries at most, which sheds.
15. ``serve_stream`` -- the server over a ``StreamingIndex`` of the clustered
                       index: 64 queries, 4,096 updates to s0-s3, the same 64
                       again; invalidations against the cached results that
                       read s0-s3, and every result against K1 over a dense
                       copy the updates were replayed on with torch ops.
16. ``search``      -- similarity search over 2**20 random strings (16
                       letters, lengths 6-15, bigrams, length columns,
                       ``tile_words`` 8): build steps timed, 16 edited corpus
                       records as queries, the bitmap T-occurrence beside
                       MergeOpt, DivideSkip and ScanCount over the same
                       posting lists (equal ids, each side's time), a numpy
                       gram-count oracle, a vacuous query, ``topk(10)``, an
                       append of 4,096 strings with new letters, minhash
                       bands on 2**16 records; then a ``WindowedStream`` of
                       12 series, 24 batches of 2**14 events and a window of 8
                       batches, held against a numpy oracle after each batch;
                       last, the first 2**16 records in 4 row shards beside
                       an unsharded index (candidates and a ``topk(10)`` equal).
17. ``sharded``     -- run after ``obs``, on the clustered index: 8 row shards
                       sliced with no column classified (dense views strided
                       over the index's), every tiled query and
                       ``execute_many`` against the unsharded index with the
                       per-shard backends, K1 / K2 launches, first and cached
                       to-result ms and a ``cProfile`` of one cached query; 16
                       shards with a heterogeneous plan (``fused`` on the
                       dense tail); ``add_column`` of a sharded result,
                       ``replace_column``, ``from_sharded``; the shard-map path
                       at 8 and 7 pieces (one K1 launch a piece, a piece
                       against the plain version, ms beside one K1 launch);
                       a sharded snapshot directory (``load_shard``,
                       ``load_sharded``, re-saved to equal sha256); a 4-shard
                       ``StreamingIndex`` (a view, 4,096 updates straddling
                       every boundary, appended rows, compaction, a
                       checkpoint and ``recover``) against K1 over a replayed
                       dense copy; ``head_vote_mask`` over 64 x 2**20 KV
                       positions through K1 against its plain version and
                       numpy, and the KV-tile skip list.
18. ``lm_serve``    -- run last: qwen3-1.7b at full width (1,720,574,976
                       float32 parameters from ``--seed``) served by a
                       ``ServeEngine`` of 8 slots and ``max_seq`` 512 to 16
                       requests (prompts of 32-128 seeded tokens, 32 new
                       tokens each); tokens/s, engine steps, prefill and
                       decode-step ms (CUDA events), host ms per step in
                       slot commits and queries, K1 launches in the window
                       and per ``free_slots()`` call (at least one each),
                       free / draining slots against the request table after
                       every step, the decode step against its byte bound;
                       4 requests decoded alone equal to their batched
                       output; decode against the forward pass; a profile
                       of 3 decode steps; the reduced model on the CPU and
                       the card (logits within 1e-4); and the reduced
                       recurrentgemma, mixtral, rwkv6 and gemma2 batched
                       against alone.
19. ``lm_train``    -- after ``lm_serve``: qwen3-1.7b at full width trained
                       through ``repro_torch.train`` (float32, TF32 off, batch
                       8 x 128 tokens from ``lm_batch``, the ``OptConfig`` of
                       ``launch/train.py``) for 8 steps: loss and gradient
                       norm a step, step ms (CUDA events), tokens/s, peak
                       memory, the step's FLOP bound; 2 steps each with remat
                       "full" and "dots" (peak memory, step ms); 2 steps at 2
                       microbatches, each loss against the batch's loss in
                       one piece; a profile of one step (kernels, device
                       busy ms, the products' share).  Reduced: one step of
                       each of the ten architectures on the card against
                       the CPU from the same state; the reference's "loss falls" recipe; 3
                       steps, a checkpoint, a restore and 3 more against 6
                       straight (deterministic algorithms); and
                       ``repro_torch.launch.train.main`` run, then resumed
                       from its checkpoint.  Launch counts are read around
                       the training path: it reaches neither kernel.
20. ``lm_mesh``     -- after ``lm_train``: a one-rank process group (NCCL
                       for the card) and a 1 x 1 ``DeviceMesh``, destroyed at
                       the end.  qwen3-1.7b at full width (float32, TF32
                       off, batch 8 x 128 from ``lm_batch``, the
                       ``OptConfig`` of ``launch/train.py``): 4 steps of the
                       no-mesh path and 4 of the mesh path (state placed by
                       ``state_shardings``, batches by ``batch_shardings``,
                       the step under ``use_rules``) from the same initial
                       state, losses, grad norms and weights compared, step
                       ms, tokens/s, peak memory and a profiled step of
                       each; granite-moe at full width, 2 x 128 tokens
                       under the rules (the MoE mesh branch) against the
                       no-rules forward; mixtral reduced (token chunks)
                       under the rules, card against CPU;
                       ``launch.train.main`` on the mesh path, then resumed
                       through ``restore(..., shardings=)``.  Launch counts
                       are read around the phase: it reaches neither kernel.
21. ``lm_dryrun``   -- after ``lm_mesh``: ``repro_torch.launch.dryrun.run_cell``
                       on fake CUDA tensors and a fake process group of the
                       production size (no memory on the card) for qwen3-1.7b
                       ``train_4k`` and ``decode_32k`` on the 16 x 16 mesh
                       (heads split over 'model') and mixtral-8x22b
                       ``prefill_32k`` on 2 x 16 x 16 (the MoE branch, 512
                       ranks); each cell OK, its trace seconds, dot FLOPs,
                       collective bytes by kind, argument and temporary
                       bytes a rank, and whether they fit on the card.  Then
                       ``lm_train``'s own step under the same accounting on
                       fake tensors: its predicted dot FLOPs beside
                       ``FlopCounterMode`` on the real step, its predicted
                       peak beside the ``max_memory_allocated`` that
                       ``lm_train`` measured.  No process group is left,
                       ``max_memory_allocated`` rises under 64 MiB, and
                       neither kernel launches.

Then the card's ``nvidia-smi`` line, one ``{"kernels": [...]}`` summary
line (each kernel's ``launches`` from its main path's own window: K1's
from ``main_path``, K2's from ``tiled_path``; ``launches_by_phase`` the
launches of every phase's windows), and the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
then exits non-zero and prints no ``ok`` line.  It never runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# cuBLAS reads its workspace size once: the lm_train phase replays a run
# under torch.use_deterministic_algorithms(True), which needs this set
# before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# 67 TFLOP/s float32 outside the tensor cores (the same data sheet): the
# yardstick of a float32 training step with TF32 off
PEAK_FP32_FLOPS = 67e12

K1_SOURCE = "src/repro_torch/kernels/csrc/circuit_eval.cu"
K1_REPLACES = "src/repro/kernels/threshold_ssum.py:88"
K2_SOURCE = "src/repro_torch/kernels/csrc/tiled_block.cu"
K2_REPLACES = "src/repro/kernels/tiled_scan.py:236"


#: per phase, the K1 and K2 launches of the windows it drove (see ``read_counts``)
PHASE_LAUNCHES: dict = {}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def tally(phase: str, counts: dict) -> None:
    """Add one window's launches to ``phase``'s: a window is the counts set
    to 0 just before a path is driven and read just after."""
    into = PHASE_LAUNCHES.setdefault(phase, {"circuit_eval": 0, "tiled_block": 0})
    for key in into:
        into[key] += counts.get(key, 0)


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
    tally("main_path", counts)

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
    tally("tiled_path", counts)

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


def read_counts(phase: str) -> dict:
    """The counts of the window ``zero_counts`` opened, tallied to ``phase``."""
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK

    counts = {**K.launch_counts, **TK.launch_counts}
    tally(phase, counts)
    return counts


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


def phase_calibration(idx):
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
    counts = read_counts("calibration")
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
    return large


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
    counts = read_counts("backends")

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
    counts = read_counts("backends_tiled")
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
    counts = read_counts("obs")
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
    report["materialize"] = {"seconds": mat_s, "launch_counts": read_counts("stream")}

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
                        "launch_counts": read_counts("stream")})
        replay_on_dense(dense, cols, pos, on)
    zero_counts()
    (start, stop), secs = timed_s(lambda: s.append_rows(app))
    batches.append({"batch": "append_rows", "rows": STREAM_APPEND_ROWS, "apply_ms": secs * 1e3,
                    "patched_tiles": s.delta_stats()["patched_tiles"], "r": [r0, s.r],
                    "launch_counts": read_counts("stream")})
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
    refresh_counts = read_counts("stream")
    report["view_refresh"] = {"ms": refresh_s * 1e3, "launch_counts": refresh_counts,
                              "info": {v: s.view_info(v) for v in view_queries}}
    check(refresh_counts["circuit_eval"] == len(view_queries),
          f"one K1 launch per view refresh, {refresh_counts}")

    # the overlay: build and dense view timed on their own
    base_store = s._base.store
    ov, ov_s = timed_s(lambda: OverlayStore(base_store, s._deltas[0]))
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
    overlay_counts = read_counts("stream")
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
    compact_counts = read_counts("stream")
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
    auto_counts = read_counts("stream")
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
        report["durable_launch_counts"] = read_counts("persist")

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
        paged_counts = read_counts("persist")
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


# ---------------------------------------------------------------------------
# phase 14: the query server
# ---------------------------------------------------------------------------

SERVE_POOL = 256
SERVE_REQUESTS = 4096
SERVE_CLIENTS = 8
SERVE_IN_FLIGHT = 32  # requests a client keeps outstanding
SERVE_ZIPF = 1.1
SERVE_TWIN_SHARE = 0.25  # requests sent with their members reordered
SERVE_CACHE = 128
SERVE_SHED_PENDING = 8
SERVE_SHED_REQUESTS = 512
SERVE_WAIT_S = 300.0  # every wait of the serve phase ends within this


def serve_pool(names: tuple, seed: int) -> list:
    """``SERVE_POOL`` distinct queries as (query, twin) pairs, the twin the
    same query with its members (and its Or's children) reordered:
    thresholds T = 2..n-1 and 64 intervals over every column, 64 thresholds
    over 16-column subsets, and composites to fill the pool."""
    from repro_torch.query import And, Col, Interval, Not, Or, Parity, Threshold

    rng = np.random.default_rng(seed)
    n = len(names)

    def perm(cols):
        return tuple(cols[i] for i in rng.permutation(len(cols)))

    def sub(k):
        return tuple(names[i] for i in sorted(rng.choice(n, k, replace=False)))

    pool = [(Threshold(t), Threshold(t, over=perm(names))) for t in range(2, n)]
    spans = set()
    while len(spans) < 64:
        lo = int(rng.integers(1, n - 1))
        spans.add((lo, int(rng.integers(lo, n))))
    pool += [(Interval(lo, hi), Interval(lo, hi, over=perm(names))) for lo, hi in sorted(spans)]
    for _ in range(64):
        t, s = int(rng.integers(2, 16)), sub(16)
        pool.append((Threshold(t, over=s), Threshold(t, over=perm(s))))
    while len(pool) < SERVE_POOL:
        t, s16, s8, c = int(rng.integers(2, 8)), sub(16), sub(8), Col(names[int(rng.integers(n))])
        pool.append((Or(And(Threshold(t, over=s16), Not(c)), Parity(over=s8)),
                     Or(Parity(over=perm(s8)), And(Not(c), Threshold(t, over=perm(s16))))))
    return pool


def run_clients(n_clients: int, fn) -> float:
    """Run ``fn(ci)`` in ``n_clients`` threads; returns the wall seconds
    until all joined.  A client's exception, or one left running after
    ``SERVE_WAIT_S``, fails the phase."""
    import threading

    errors = []

    def body(ci):
        try:
            fn(ci)
        except BaseException as e:  # noqa: BLE001 - re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(ci,)) for ci in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_WAIT_S)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    return wall


def stop_server(server) -> None:
    """``server.stop()`` within ``SERVE_WAIT_S``; its batcher must be gone."""
    import threading

    batcher = server._thread
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    stopper.join(SERVE_WAIT_S)
    check(not stopper.is_alive() and (batcher is None or not batcher.is_alive()),
          "the server did not stop")


def phase_serve(idx, calibration, smi: str, seed: int) -> None:
    """The threaded ``QueryServer`` over the random index under a Zipf load."""
    from repro_torch.core.calibration import Calibration, clear_calibration, set_calibration
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.query import bind_members, canonical_key
    from repro_torch.query.index import circuit_for
    from repro_torch.serve import Overloaded, QueryServer

    names = idx.names
    dev = idx.device
    pool = serve_pool(names, seed + 14)
    keys = [canonical_key(bind_members(q, names)) for q, _ in pool]
    check(len(set(keys)) == SERVE_POOL, "the pool's queries are distinct")
    check(all(canonical_key(bind_members(tw, names)) == key for (_, tw), key in zip(pool, keys)),
          "a reordered twin has its query's canonical key")
    rng = np.random.default_rng(seed + 15)
    p = np.arange(1, SERVE_POOL + 1, dtype=np.float64) ** -SERVE_ZIPF
    rank = rng.permutation(SERVE_POOL)  # the query at each popularity rank
    draws = rank[rng.choice(SERVE_POOL, SERVE_REQUESTS, p=p / p.sum())]
    twin = rng.random(SERVE_REQUESTS) < SERVE_TWIN_SHARE
    report = {"card": smi, "pool": SERVE_POOL, "requests": SERVE_REQUESTS,
              "clients": SERVE_CLIENTS, "in_flight_per_client": SERVE_IN_FLIGHT,
              "zipf": SERVE_ZIPF, "distinct_drawn": int(np.unique(draws).size),
              "twins_sent": int(twin.sum())}

    # the calibration phase's constants, installed: plans and feedback use them
    cal = Calibration.from_obj(calibration.to_obj())
    set_calibration(cal)
    plans_before = [idx.explain(q, memo=False).algorithm for q, _ in pool]
    before = {"us_per_kword": dict(cal.us_per_kword), "samples": dict(cal.samples)}

    widest: list = []
    execute_many = idx.execute_many

    def recording(queries, **kw):  # remembers the widest batch the server sends
        qs = list(queries)
        if len(qs) > len(widest):
            widest[:] = qs
        return execute_many(qs, **kw)

    # each drawn query's oracle, made before the load: K1 over the query's
    # own one-output circuit, past the planner and its memo
    want = {i: idx._mask(K.run_circuit_cached(idx.columns, circuit_for((pool[i][0],), idx.n, names)))
            for i in np.unique(draws).tolist()}
    torch.cuda.synchronize()

    server = QueryServer(idx, window=0.002, max_batch=64, cache_entries=SERVE_CACHE)
    check(server.calibration is cal, "the server feeds the installed calibration")
    # every result is held against its oracle on receipt; the mismatched
    # words add up on the card and are read after the load
    bad_words = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(SERVE_CLIENTS)]
    received = [0] * SERVE_CLIENTS

    def client(ci):
        mine = list(range(ci, SERVE_REQUESTS, SERVE_CLIENTS))
        for lo in range(0, len(mine), SERVE_IN_FLIGHT):
            futs = [(int(draws[j]), server.submit(pool[draws[j]][int(twin[j])]))
                    for j in mine[lo:lo + SERVE_IN_FLIGHT]]
            for i, fut in futs:
                out = fut.result(SERVE_WAIT_S)
                check(out.shape == want[i].shape and out.is_cuda, f"query {i}: result shape/device")
                bad_words[ci] += (out != want[i]).sum()
                received[ci] += 1

    idx.execute_many = recording
    try:
        zero_counts()
        server.start()
        wall = run_clients(SERVE_CLIENTS, client)
        stop_server(server)
        counts = read_counts("serve")
    finally:
        del idx.execute_many
    info = server.info()
    check(info["requests"] == SERVE_REQUESTS and info["served"] == SERVE_REQUESTS,
          f"served {info['served']} of {info['requests']} requests")
    check(info["executed"] + info["cache_hits"] + info["dedup_hits"] == SERVE_REQUESTS,
          f"executed + cache hits + dedup hits = {info['executed']} + {info['cache_hits']} + "
          f"{info['dedup_hits']}, not {SERVE_REQUESTS}")
    check(info["errors"] == 0 and info["shed"] == 0 and info["pending"] == 0, f"info {info}")
    check(counts["circuit_eval"] > 0, f"the served queries launched K1, {counts}")
    cache_bytes = sum(out.numel() * out.element_size() for _cols, out in server._cache._od.values())

    bad = sum(int(b.item()) for b in bad_words)
    tensors = sum(received)
    check(tensors == SERVE_REQUESTS, f"{tensors} results received, {SERVE_REQUESTS} sent")
    check(bad == 0, f"{bad} served words differ from K1 over each query's own circuit")
    del want, bad_words

    circ = circuit_for(tuple(widest), idx.n, names)
    prog = K._program_for(circ, None)
    # what one new bucket of that width costs: the host's compile (its queries
    # in another order, so no cache holds them) and K1 over the 1 GiB index
    t0 = time.perf_counter()
    fresh = circuit_for(tuple(reversed(widest)), idx.n, names)
    compile_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    K._program_for(fresh, None)
    encode_ms = (time.perf_counter() - t0) * 1e3
    k1_ms = statistics.median(cuda_ms(lambda: K.run_circuit_cached(idx.columns, circ), reps=5))
    # these shapes (up to 64 outputs in one circuit) reach K1 only here:
    # held against the plain version over the whole array
    widest_bad = mismatches(idx._mask(K.run_circuit_cached(idx.columns, circ)),
                            idx._mask(K.run_circuit_plain(idx.columns, circ)))
    check(widest_bad == 0, f"the widest batch's circuit: {widest_bad} K1 words differ from "
                           "the plain version")
    plans_after = [idx.explain(q, memo=False).algorithm for q, _ in pool]
    after = {"us_per_kword": dict(cal.us_per_kword), "samples": dict(cal.samples)}

    # where one pump's host time goes: the 64 most popular queries, uncached
    probe = QueryServer(idx, window=0, max_batch=64, cache_entries=0)
    for i in rank[:64].tolist():
        probe.submit(pool[i][0])
    pump_profile = host_profile(probe.pump, top=12)
    check(probe.info()["executed"] == 64, "the profiled pump executed 64 queries")
    report.update({
        "seconds": wall, "served_per_s": SERVE_REQUESTS / wall,
        "executed_per_s": info["executed"] / wall,
        **{key: info[key] for key in ("executed", "cache_hits", "dedup_hits", "batches")},
        "latency_s": info["latency"], "queue_wait_s": info["queue_wait"],
        "batch_size_hist": info["batch_size_hist"],
        "k1_launches_per_executed": counts["circuit_eval"] / info["executed"],
        "widest_batch": {"k": len(widest), "gates": len(circ.ops),
                         "n_registers": prog.n_registers, "compile_ms": compile_ms,
                         "encode_ms": encode_ms, "k1_ms_median": k1_ms,
                         "mismatch_plain": widest_bad,
                         "launch_shape": list(K.pick_launch_shape(prog.n_registers,
                                                                  K._max_shared(dev)))},
        "cache": {"entries": info["cache_entries"], "capacity": SERVE_CACHE,
                  "bytes_on_card": cache_bytes},
        "result_tensors_checked": tensors, "mismatched_words": bad,
        "plan_memo": info["plan_memo"], "pump_profile": pump_profile,
        "calibration": {"before": before, "after": after,
                        "pool_plans_changed": sum(a != b for a, b in zip(plans_before, plans_after)),
                        "pool_plans": sorted(set(plans_after))},
        "launch_counts": counts,
    })
    clear_calibration()
    del server

    # admission control: a small pending bound sheds, and loses no accepted request
    hot = [int(i) for i in rank[:SERVE_SHED_PENDING * 2]]
    want = {i: idx.execute(pool[i][0]) for i in hot}
    shed_rng = np.random.default_rng(seed + 16)
    picks = shed_rng.choice(hot, (SERVE_CLIENTS, SERVE_SHED_REQUESTS // SERVE_CLIENTS))
    accepted, refused, bad_shed = [0] * SERVE_CLIENTS, [0] * SERVE_CLIENTS, [0] * SERVE_CLIENTS
    server = QueryServer(idx, window=0.002, max_pending=SERVE_SHED_PENDING, cache_entries=0)

    def eager_client(ci):
        futs = []
        for i in picks[ci].tolist():
            try:
                futs.append((i, server.submit(pool[i][0])))
            except Overloaded:
                refused[ci] += 1
        accepted[ci] = len(futs)
        for i, fut in futs:
            bad_shed[ci] += mismatches(fut.result(SERVE_WAIT_S), want[i])

    zero_counts()
    server.start()
    run_clients(SERVE_CLIENTS, eager_client)
    stop_server(server)
    shed_counts = read_counts("serve")
    shed = server.info()
    check(sum(refused) == shed["shed"] > 0, f"a pending bound of {SERVE_SHED_PENDING} sheds: {shed}")
    check(sum(accepted) == shed["served"] == SERVE_SHED_REQUESTS - shed["shed"],
          f"every accepted request served: {sum(accepted)} accepted, {shed['served']} served")
    check(sum(bad_shed) == 0, f"{sum(bad_shed)} words differ under shedding")
    report["shedding"] = {"max_pending": SERVE_SHED_PENDING, "sent": SERVE_SHED_REQUESTS,
                          "shed": shed["shed"], "served": shed["served"],
                          "executed": shed["executed"], "dedup_hits": shed["dedup_hits"],
                          "mismatched_words": sum(bad_shed), "launch_counts": shed_counts}
    emit("serve", **report)


def serve_stream_queries(data: tuple, touched: tuple) -> list:
    """64 distinct queries over the data columns, some reading ``touched``
    and some not."""
    from repro_torch.query import And, Col, Interval, Not, Threshold

    rest = tuple(c for c in data if c not in touched)
    qs = [Threshold(t, over=data) for t in range(2, 18)]
    qs += [Threshold(t, over=rest[8:40]) for t in range(2, 18)]
    qs += [Interval(lo, lo + 3, over=data[a:a + 16]) for lo, a in
           zip(range(1, 17), range(0, 48, 3))]
    qs += [And(Threshold(2, over=data[a:a + 8]), Not(Col(data[(a + 9) % len(data)])))
           for a in range(0, 64, 4)]
    return qs


def phase_serve_stream(s, smi: str, seed: int) -> None:
    """The server over a ``StreamingIndex`` of the clustered index: a batch
    of updates invalidates exactly the cached results that read a touched
    column, and the results served after it are the new bits."""
    from repro_torch.core.bitmaps import packed_tail_mask
    from repro_torch.kernels.threshold_ssum import run_circuit_cached
    from repro_torch.query import bind_members, column_refs
    from repro_torch.query.index import circuit_for
    from repro_torch.serve import QueryServer
    from repro_torch.stream import CompactionPolicy, StreamingIndex

    base = s._base
    dev = base.device
    data = tuple(nm for nm in base.names if nm not in s.views)
    touched = data[:4]
    st = StreamingIndex(base, policy=CompactionPolicy(auto=False))
    dense = base.columns[[base.names.index(nm) for nm in data]].clone()
    queries = serve_stream_queries(data, touched)
    reads = [column_refs(bind_members(q, st.names)) for q in queries]
    expect = sum(bool(r & set(touched)) for r in reads)
    mask = packed_tail_mask(st.r, dense.shape[1], dev)

    def k1_dense(q):
        want = run_circuit_cached(dense, circuit_for((q,), len(data), data))
        return want if mask is None else want & mask

    server = QueryServer(st, window=0)
    zero_counts()
    t0 = time.perf_counter()
    first = server.serve_many(queries, timeout=SERVE_WAIT_S)
    first_s = time.perf_counter() - t0
    first_counts = read_counts("serve_stream")
    check(server.info()["cache_entries"] == len(queries), "every result cached")
    bad_before = sum(mismatches(got, k1_dense(q)) for q, got in zip(queries, first))

    rng = np.random.default_rng(seed + 17)
    cols = rng.integers(0, len(touched), 4096)
    pos = rng.integers(0, st.r, 4096)
    on = rng.random(4096) < 0.5
    t0 = time.perf_counter()
    st.update(**as_update(data, cols, pos, on))
    update_ms = (time.perf_counter() - t0) * 1e3
    replay_on_dense(dense, cols, pos, on)
    info = server.info()
    check(info["invalidations"] == expect and info["cache_entries"] == len(queries) - expect,
          f"invalidated {info['invalidations']} cached results, {expect} read {touched}")

    zero_counts()
    t0 = time.perf_counter()
    again = server.serve_many(queries, timeout=SERVE_WAIT_S)
    again_s = time.perf_counter() - t0
    again_counts = read_counts("serve_stream")
    info = server.info()
    check(info["cache_hits"] == len(queries) - expect, f"cache hits {info['cache_hits']}")
    bad_after = sum(mismatches(got, k1_dense(q)) for q, got in zip(queries, again))
    changed = sum(mismatches(a, b) > 0 for a, b in zip(first, again))
    check(bad_before == 0 and bad_after == 0,
          f"{bad_before} / {bad_after} words differ from K1 over the replayed dense copy")
    check(changed > 0, "the update changed some served result")
    check(first_counts["circuit_eval"] + first_counts["tiled_block"] > 0
          and again_counts["circuit_eval"] > 0, "the served queries launched the kernels")
    emit("serve_stream", card=smi, queries=len(queries), touched=list(touched),
         reading_touched=expect, first_serve_s=first_s, update_4096_ms=update_ms,
         invalidations=info["invalidations"], cache_hits_after=info["cache_hits"],
         second_serve_s=again_s, results_changed=changed,
         mismatched_words={"before": bad_before, "after": bad_after},
         engine_after=st.index().last_info.get("engine") if st.index().last_info else None,
         launch_counts={"first": first_counts, "after_update": again_counts})


# ---------------------------------------------------------------------------
# phase 15: similarity search and windowed counts
# ---------------------------------------------------------------------------

# the corpus of benchmarks/search_bench.py's FULL shape, at 2**20 records
SEARCH_ALPHABET = "abcdefghijklmnop"
SEARCH_LENGTHS = (6, 16)  # lengths 6..15
SEARCH_Q, SEARCH_K, SEARCH_TILE_WORDS = 2, 2, 8
SEARCH_QUERIES = 16
SEARCH_TOPK, SEARCH_TOPK_QUERIES = 10, 4
SEARCH_TOPK_TRIES = 64  # further queries top-k may try for ones that stop before the vacuous band
SEARCH_APPEND = 2**12
SEARCH_APPEND_ALPHABET = "qrstuvwxyz"  # letters no record of the corpus holds
SEARCH_MINHASH_ROWS_LOG2 = 16
SEARCH_SHARDS = 4
WINDOW_SERIES, WINDOW_BATCHES, WINDOW_EVENTS, WINDOW_SPAN = 12, 24, 2**14, 8


def make_strings(n: int, rng, alphabet: str = SEARCH_ALPHABET,
                 lengths: tuple = SEARCH_LENGTHS) -> list:
    """``n`` random strings over ``alphabet`` with lengths in
    ``range(*lengths)``, built as one NUL-padded numpy unicode array
    (numpy drops the trailing NULs)."""
    codes = np.frombuffer(alphabet.encode("utf-32-le"), np.uint32)
    width = lengths[1] - 1
    cps = codes[rng.integers(0, codes.size, (n, width))]
    cps[np.arange(width)[None, :] >= rng.integers(lengths[0], lengths[1], n)[:, None]] = 0
    return np.ascontiguousarray(cps).view(f"<U{width}").ravel().tolist()


def edited(s: str, n_edits: int, rng, alphabet: str = SEARCH_ALPHABET) -> str:
    """``s`` after ``n_edits`` random substitutions, insertions or deletions."""
    for _ in range(n_edits):
        i = int(rng.integers(0, len(s) + 1))
        c = alphabet[int(rng.integers(0, len(alphabet)))]
        op = int(rng.integers(0, 3)) if len(s) > 1 else 1
        s = (s[:i] + c + s[i + 1:]) if op == 0 else (s[:i] + c + s[i:]) if op == 1 \
            else (s[:i] + s[i + 1:] if i < len(s) else s[:-1])
    return s


class GramOracle:
    """The distinct bigrams of every record as a CSR (record id, gram id),
    from numpy alone: ``#`` + string + ``$``, each gram the pair of code
    points.  Independent of the tokenizer and the index."""

    def __init__(self, strings: list):
        width = max(len(s) for s in strings)
        cps = np.array(strings, dtype=f"<U{width}").view(np.uint32).reshape(len(strings), width)
        lens = np.fromiter(map(len, strings), np.int64, len(strings))
        padded = np.zeros((len(strings), width + 2), np.int64)
        padded[:, 0] = ord("#")
        padded[:, 1:width + 1] = cps
        padded[np.arange(len(strings)), lens + 1] = ord("$")
        grams = (padded[:, :-1] << 21) | padded[:, 1:]
        valid = np.arange(width + 1)[None, :] <= lens[:, None]
        grams = np.where(valid, grams, -1)
        grams.sort(axis=1)
        first = np.ones_like(valid)
        first[:, 1:] = grams[:, 1:] != grams[:, :-1]
        keep = first & (grams >= 0)
        self.n = len(strings)
        self.cps, self.lens = cps, lens
        self.rec = np.nonzero(keep)[0]
        self.gram = grams[keep]

    def edit_distances(self, s: str) -> np.ndarray:
        """Levenshtein distance from ``s`` to every record: the textbook
        dynamic program, one numpy vector over the records a cell."""
        q = np.array([ord(c) for c in s], np.uint32)
        width = self.cps.shape[1]
        prev = np.broadcast_to(np.arange(width + 1, dtype=np.int16), (self.n, width + 1)).copy()
        for i, qc in enumerate(q.tolist(), 1):
            cur = np.empty_like(prev)
            cur[:, 0] = i
            for j in range(1, width + 1):
                sub = prev[:, j - 1] + (self.cps[:, j - 1] != qc)
                cur[:, j] = np.minimum(np.minimum(prev[:, j], cur[:, j - 1]) + 1, sub)
            prev = cur
        return prev[np.arange(self.n), self.lens]

    @staticmethod
    def query_grams(s: str) -> np.ndarray:
        p = [ord("#")] + [ord(c) for c in s] + [ord("$")]
        return np.unique([(a << 21) | b for a, b in zip(p, p[1:])])

    def candidates(self, s: str, k: int, r: int | None = None) -> tuple:
        """(T, sorted ids of the first ``r`` records sharing >= T of the
        query's distinct grams), T = n_grams - k * q."""
        g = self.query_grams(s)
        t = g.size - k * SEARCH_Q
        r = self.n if r is None else r
        sel = np.isin(self.gram, g) & (self.rec < r)
        counts = np.bincount(self.rec[sel], minlength=r)
        return t, np.nonzero(counts >= t)[0]


def topk_goes_vacuous(s: str, d: np.ndarray) -> bool:
    """Whether ``topk(s, SEARCH_TOPK)`` reaches the vacuous band, from the
    distances ``d`` of every record: it stops at the edit budget ``j`` of the
    k-th nearest record, and the band at ``j`` is vacuous when
    ``n_grams - j * q <= 0``."""
    j = int(np.partition(d, SEARCH_TOPK - 1)[SEARCH_TOPK - 1])
    return GramOracle.query_grams(s).size - j * SEARCH_Q <= 0


def checked_topk(sidx, s: str, d: np.ndarray) -> dict:
    """``sidx.topk(s, SEARCH_TOPK)``, held against the oracle's distances
    ``d`` (ties by row id); its reading."""
    t0 = time.perf_counter()
    tk = sidx.topk(s, SEARCH_TOPK)
    secs = time.perf_counter() - t0
    dists = tk.distances.tolist()
    best = np.lexsort((np.arange(d.size), d))[:SEARCH_TOPK]
    check(tk.ids.tolist() == best.tolist() and dists == d[best].tolist(),
          f"{s!r}: top-k {list(zip(dists, tk.ids.tolist()))}, oracle "
          f"{list(zip(d[best].tolist(), best.tolist()))}")
    check(tk.vacuous == topk_goes_vacuous(s, d), f"{s!r}: vacuous {tk.vacuous}, not as predicted")
    return {"query": s, "distances": dists, "relaxations": tk.relaxations,
            "verified": tk.verified, "vacuous": tk.vacuous, "seconds": secs}


def phase_search(dev, rows_log2: int, smi: str, seed: int) -> None:
    import dataclasses

    from repro_torch.core import listalgos as LA
    from repro_torch.query import Col, Threshold
    from repro_torch.search import (MinHashParams, band_buckets, build_qgram_index,
                                    edit_distance, minhash_signature, qgrams)

    rng = np.random.default_rng(seed + 18)
    r = 2**rows_log2
    corpus = make_strings(r, rng)
    extra = make_strings(SEARCH_APPEND, rng, SEARCH_ALPHABET + SEARCH_APPEND_ALPHABET)
    oracle = GramOracle(corpus + extra)
    report = {"card": smi, "records": r, "alphabet": len(SEARCH_ALPHABET),
              "lengths": [SEARCH_LENGTHS[0], SEARCH_LENGTHS[1] - 1],
              "q": SEARCH_Q, "k": SEARCH_K, "tile_words": SEARCH_TILE_WORDS}

    t0 = time.perf_counter()
    sidx = build_qgram_index(corpus, q=SEARCH_Q, tile_words=SEARCH_TILE_WORDS, device=dev)
    torch.cuda.synchronize()
    report["build"] = {"seconds": time.perf_counter() - t0, **sidx.build_seconds,
                       "columns": len(sidx.stream.names), "n_words": sidx.index.n_words,
                       "clean_fraction": sidx.index.store.member_stats(None).clean_fraction}

    picks = rng.choice(r, SEARCH_QUERIES, replace=False)
    queries = [edited(corpus[int(i)], 1 + j % 2, rng) for j, i in enumerate(picks)]
    zero_counts()
    runs = []
    for s in queries:
        cand = sidx.candidates(s, SEARCH_K)
        info = dict(sidx.index.last_info or {})
        runs.append((s, cand, info))
    counts = read_counts("search")
    check(counts["circuit_eval"] + counts["tiled_block"] > 0,
          f"candidate generation launched the kernels, {counts}")

    race = []
    for (s, cand, info), i in zip(runs, picks):
        t, want = oracle.candidates(s, SEARCH_K, r)
        check(cand.t == t and not cand.vacuous, f"{s!r}: T {cand.t} vs the oracle's {t}")
        check(np.array_equal(cand.ids, want), f"{s!r}: candidates differ from the gram-count oracle")
        check(edit_distance(s, corpus[int(i)]) <= SEARCH_K and int(i) in set(cand.ids.tolist()),
              f"{s!r}: the record it was edited from is a candidate")
        grams = [Col(g) for g in sidx._present_grams(s)]
        plan = sidx.index.explain(Threshold(cand.t, over=grams))
        bitmap_ms = to_result_ms(lambda s=s: sidx.candidates(s, SEARCH_K))
        t0 = time.perf_counter()
        lists = sidx.posting_lists(s)
        lists_ms = (time.perf_counter() - t0) * 1e3
        point = {"query": s, "t": cand.t, "n_lists": len(lists),
                 "list_elems": int(sum(x.size for x in lists)), "candidates": len(cand),
                 "plan": plan.algorithm, "cost_words": plan.cost,
                 "backend": info.get("backend"), "engine": info.get("engine"),
                 "bitmap_to_result_ms": bitmap_ms, "posting_lists_ms": lists_ms, "lists_ms": {}}
        for name, algo in (("mgopt", LA.mgopt), ("dsk", LA.dsk), ("scancount", LA.scancount_np)):
            t0 = time.perf_counter()
            got = np.asarray(algo(lists, cand.t, sidx.r))
            point["lists_ms"][name] = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(got, cand.ids), f"{s!r}: {name} differs from the bitmap candidates")
        race.append(point)
    report["queries"] = race
    report["launch_counts"] = counts
    report["candidates_profile"] = host_profile(lambda: sidx.candidates(queries[0], SEARCH_K), top=8)

    vac = sidx.candidates("ab", SEARCH_K)
    check(vac.t <= 0 and vac.vacuous and len(vac) == sidx.r, "a vacuous query returns all rows")
    report["vacuous"] = {"query": "ab", "t": vac.t, "candidates": len(vac)}

    # top-k against the distances of every record (ties by row id), on the
    # queries the oracle says stop before the vacuous band: that band
    # verifies every row in Python, and the 2**16 index below covers it
    tops = []
    more = np.random.default_rng(seed + 20)  # more edited records, when a small corpus needs them
    tried = queries + [edited(corpus[int(i)], 1, more) for i in more.choice(r, SEARCH_TOPK_TRIES)]
    for s in tried:
        if len(tops) == SEARCH_TOPK_QUERIES:
            break
        d = oracle.edit_distances(s)[:r]
        if topk_goes_vacuous(s, d):
            continue
        tops.append(checked_topk(sidx, s, d))
    check(len(tops) == SEARCH_TOPK_QUERIES and not any(tk["vacuous"] for tk in tops),
          f"{len(tops)} top-k queries stop before the vacuous band")
    report["topk"] = tops

    zero_counts()
    t0 = time.perf_counter()
    start, stop = sidx.append(extra)
    append_s = time.perf_counter() - t0
    check((start, stop) == (r, r + SEARCH_APPEND), f"append range {(start, stop)}")
    after = []
    for s in (queries[0], edited(extra[0], 1, rng, SEARCH_ALPHABET + SEARCH_APPEND_ALPHABET)):
        cand = sidx.candidates(s, SEARCH_K)
        t, want = oracle.candidates(s, SEARCH_K)
        check(cand.t == t and np.array_equal(cand.ids, want),
              f"{s!r} after the append: candidates differ from the oracle")
        after.append({"query": s, "t": t, "candidates": len(cand),
                      "engine": (sidx.index.last_info or {}).get("engine")})
    report["append"] = {"records": SEARCH_APPEND, "seconds": append_s,
                        "columns": len(sidx.stream.names), "queries": after,
                        "launch_counts": read_counts("search")}
    del sidx

    # minhash bands: signatures are hashed per record on the host
    m = 2**min(SEARCH_MINHASH_ROWS_LOG2, rows_log2)
    params = MinHashParams()
    t0 = time.perf_counter()
    midx = build_qgram_index(corpus[:m], q=SEARCH_Q, minhash=params,
                             tile_words=SEARCH_TILE_WORDS, device=dev)
    build_s = time.perf_counter() - t0
    buckets = np.array([band_buckets(minhash_signature(qgrams(s, SEARCH_Q), params), params)
                        for s in corpus[:m]])
    mh = []
    for j, s in enumerate(corpus[:4] + queries[:4]):
        qb = np.array(band_buckets(minhash_signature(qgrams(s, SEARCH_Q), params), params))
        bands = 1 + j % params.bands
        got = midx.minhash_candidates(s, min_bands=bands)
        want = np.nonzero((buckets == qb).sum(1) >= bands)[0]
        check(np.array_equal(got.ids, want), f"{s!r}: minhash candidates differ")
        mh.append({"query": s, "min_bands": bands, "candidates": len(got)})
    check(all(i in set(midx.minhash_candidates(corpus[i], min_bands=params.bands).ids.tolist())
              for i in range(4)), "a record shares every band with itself")
    report["minhash"] = {"records": m, "params": dataclasses.asdict(params),
                         "build_seconds": build_s, **{f"build_{k}": v for k, v in
                                                      midx.build_seconds.items()},
                         "queries": mh}

    # the vacuous relaxation: a top-k whose last band is every row left
    moracle = GramOracle(corpus[:m])
    for s in queries + ["ab"]:  # "ab": 3 grams, and no record is that short
        d = moracle.edit_distances(s)
        if topk_goes_vacuous(s, d):
            break
    vac_tk = checked_topk(midx, s, d)
    check(vac_tk["vacuous"] and vac_tk["verified"] == m,
          f"{s!r}: a vacuous top-k verifies all {m} rows, {vac_tk}")
    report["topk_vacuous"] = {"records": m, **vac_tk}
    del midx
    report["sharded"] = sharded_search_run(dev, corpus[:m], queries, moracle)
    report["window"] = window_run(dev, seed)
    emit("search", **report)


def sharded_search_run(dev, corpus: list, queries: list, oracle) -> dict:
    """The same records in a ``SimilarityIndex`` of 4 row shards beside an
    unsharded one: the candidates of every query and one ``topk(10)`` equal
    (ids, distances), and the candidates equal to the gram-count oracle."""
    from repro_torch.search import build_qgram_index

    m = len(corpus)
    t0 = time.perf_counter()
    shidx = build_qgram_index(corpus, q=SEARCH_Q, tile_words=SEARCH_TILE_WORDS,
                              n_shards=SEARCH_SHARDS, device=dev)
    build_s = time.perf_counter() - t0
    uidx = build_qgram_index(corpus, q=SEARCH_Q, tile_words=SEARCH_TILE_WORDS, device=dev)
    check(shidx.index.n_shards == SEARCH_SHARDS, f"{shidx.index.n_shards} shards")
    zero_counts()
    runs = []
    for s in queries:
        got = shidx.candidates(s, SEARCH_K)
        backends = list(shidx.index.last_info["backends"])
        want = uidx.candidates(s, SEARCH_K)
        t, oracle_ids = oracle.candidates(s, SEARCH_K, m)
        check(got.t == want.t == t and np.array_equal(got.ids, want.ids)
              and np.array_equal(got.ids, oracle_ids),
              f"{s!r}: sharded candidates differ from the unsharded index's")
        runs.append({"query": s, "t": got.t, "candidates": len(got), "backends": backends})
    counts = read_counts("search")
    for s in queries:
        d = oracle.edit_distances(s)
        if not topk_goes_vacuous(s, d):
            break
    tk, utk = shidx.topk(s, SEARCH_TOPK), uidx.topk(s, SEARCH_TOPK)
    check(np.array_equal(tk.ids, utk.ids) and np.array_equal(tk.distances, utk.distances),
          f"{s!r}: sharded top-k differs from the unsharded index's")
    return {"records": m, "n_shards": SEARCH_SHARDS, "build_seconds": build_s,
            "queries": runs, "launch_counts": counts,
            "topk": {"query": s, "ids": tk.ids.tolist(), "vacuous": bool(tk.vacuous)},
            "to_result_ms": to_result_ms(lambda: shidx.candidates(queries[0], SEARCH_K)),
            "unsharded_to_result_ms": to_result_ms(lambda: uidx.candidates(queries[0], SEARCH_K))}


def window_run(dev, seed: int) -> dict:
    """``WindowedStream``: 12 series, 24 batches of 2**14 events (batch b's
    timestamps in [b, b + 1)), a window of 8 batches, a materialized count of
    events in at least 2 series; after every batch the counts, ids, rows and
    retirements equal a numpy oracle's, and each refresh stays inside the
    touched-tiles bound of ``benchmarks/search_bench.py``."""
    from repro_torch.query import Col, Threshold
    from repro_torch.search import WindowedStream, WindowRetentionPolicy

    rng = np.random.default_rng(seed + 19)
    series = [f"w{i}" for i in range(WINDOW_SERIES)]
    policy = WindowRetentionPolicy(min_dead_rows=4 * WINDOW_EVENTS, max_dead_ratio=0.5)
    ws = WindowedStream(series, window=float(WINDOW_SPAN), tile_words=SEARCH_TILE_WORDS,
                        policy=policy, device=dev)
    ws.watch("hot", Threshold(2, over=[Col(c) for c in series]))
    support = 1 + WINDOW_SERIES  # __live__ and every series the watch reads
    seed_rows = ws.total_rows  # the all-zero rows a stream starts with
    ts_all = np.empty(0)
    member_all = np.empty((0, WINDOW_SERIES), bool)
    rows = np.empty(0, np.int64)  # each event's row, renumbered when rows retire
    next_row, dead, first_live = seed_rows, seed_rows, 0
    steps = []
    zero_counts()
    for b in range(WINDOW_BATCHES):
        ts = b + np.sort(rng.random(WINDOW_EVENTS))
        order = np.argsort(rng.random((WINDOW_EVENTS, WINDOW_SERIES)), axis=1)
        member = np.zeros((WINDOW_EVENTS, WINDOW_SERIES), bool)
        k = rng.integers(1, 4, WINDOW_EVENTS)
        np.put_along_axis(member, order[:, :3], np.arange(3)[None, :] < k[:, None], axis=1)
        events = [(t, [series[c] for c in np.flatnonzero(m)]) for t, m in zip(ts.tolist(), member)]
        t0 = time.perf_counter()
        ws.append(events)
        torch.cuda.synchronize()
        append_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        info = ws.refresh_info("hot")
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t0) * 1e3

        # the oracle: rows appended at the tail, expiry, the retention rule
        ts_all = np.concatenate([ts_all, ts])
        member_all = np.concatenate([member_all, member])
        rows = np.concatenate([rows, next_row + np.arange(WINDOW_EVENTS)])
        next_row += WINDOW_EVENTS
        now = float(ts[-1])
        expired = int(np.searchsorted(ts_all, now - WINDOW_SPAN, side="right")) - first_live
        first_live += expired
        dead += expired
        retired = dead >= policy.min_dead_rows and dead >= policy.max_dead_ratio * next_row
        if retired:
            n_live = ts_all.size - first_live
            rows[first_live:] = seed_rows + np.arange(n_live)
            next_row, dead = seed_rows + n_live, seed_rows
        live = slice(first_live, None)
        hot = member_all[live].sum(1) >= 2
        want_ids = rows[live][hot]
        check((ws.total_rows, ws.dead_rows, ws.live_events) == (next_row, dead, ts_all.size - first_live),
              f"batch {b}: rows {(ws.total_rows, ws.dead_rows, ws.live_events)}, oracle "
              f"{(next_row, dead, ts_all.size - first_live)}")
        check(ws.count("hot") == int(hot.sum()), f"batch {b}: count {ws.count('hot')}")
        check(np.array_equal(ws.ids("hot"), want_ids), f"batch {b}: ids of the view")
        check(ws.count(Col(series[0])) == int(member_all[live, 0].sum()), f"batch {b}: ad-hoc count")
        step = {"batch": b, "append_ms": append_ms, "refresh_ms": refresh_ms, "expired": expired,
                "retired": retired, "live": ts_all.size - first_live, "rows": next_row,
                "count": int(hot.sum())}
        if not retired:  # a retirement re-materializes the view: no refresh to bound
            bound = info["tiles_refreshed"] * SEARCH_TILE_WORDS * (support + 1)
            check(info["words_touched"] <= bound,
                  f"batch {b}: refresh touched {info['words_touched']} words, bound {bound}")
            step.update(info, bound=bound)
        steps.append(step)
    counts = read_counts("search")
    check(any(st["retired"] for st in steps), "retention retired rows")
    return {"series": WINDOW_SERIES, "batches": WINDOW_BATCHES, "events_per_batch": WINDOW_EVENTS,
            "window_batches": WINDOW_SPAN, "tile_words": SEARCH_TILE_WORDS,
            "policy": {"min_dead_rows": policy.min_dead_rows,
                       "max_dead_ratio": policy.max_dead_ratio},
            "steps": steps, "launch_counts": counts}


# ---------------------------------------------------------------------------
# phase 17: row-sharded execution on the clustered index
# ---------------------------------------------------------------------------

SHARDS = 8
SHARDS_HETERO = 16
SHARDS_RAGGED = 7  # the word axis does not split evenly: a padded last piece
SHARDS_STREAM = 4
SHARD_STREAM_UPDATES = 4096
SHARD_STREAM_STRADDLE = 16  # updates a column within 2 bits of each shard boundary
MASK_HEADS, MASK_KV_LOG2, MASK_T, MASK_TILE = 64, 20, 8, 2048


def phase_sharded(tidx, queries, many, smi: str, seed: int) -> None:
    """``tidx`` row-sharded: slicing, per-shard plans beside the unsharded
    index, a heterogeneous plan, composition without a gather, the
    shard-map path (one K1 launch a piece), sharded snapshot directories,
    streaming over a sharded base, and the head-vote mask step."""
    import tempfile

    from repro_torch.kernels.threshold_ssum import run_circuit_plain
    from repro_torch.persist import load_shard, load_sharded, save_sharded
    from repro_torch.query import BitmapIndex, Col, Interval, Threshold
    from repro_torch.query.index import circuit_for
    from repro_torch.storage import tilestore as TS

    dev = tidx.device
    names = tidx.names
    n, nw = tidx.n, tidx.n_words
    report = {"card": smi, "n_columns": n, "n_words": nw, "tile_words": tidx.store.tile_words}
    want = {name: tidx.execute(q) for name, q in queries.items()}
    want_many = tidx.execute_many(many)
    torch.cuda.synchronize()

    # 1. slicing is bookkeeping: no column is classified again
    classified = []
    real_classify = TS._classify_column
    TS._classify_column = lambda *a, **k: classified.append(1) or real_classify(*a, **k)
    t0 = time.perf_counter()
    sidx = tidx.shard(n_shards=SHARDS)
    slice_s = time.perf_counter() - t0
    TS._classify_column = real_classify
    check(not classified, f"slicing classified {len(classified)} columns")
    check(sidx.n_shards == SHARDS and sidx.store.densify() is tidx.columns,
          "the sharded store keeps the parent's dense view")
    for sh, (t0_, _t1) in zip(sidx.store.shards, sidx.store.tile_bounds):
        view = sh.densify()
        check(view.data_ptr() == tidx.columns[:, t0_ * sh.tile_words:].data_ptr()
              and view.stride(0) == nw, "a shard's dense view is a strided view of the parent's")
    report["slice"] = {"n_shards": SHARDS, "seconds": slice_s, "classified_columns": 0,
                       "tile_bounds": [list(b) for b in sidx.store.tile_bounds]}

    # 2. per-shard plans; every result against the unsharded index
    runs = []
    for name, q in queries.items():
        plan = sidx.plan(q)
        zero_counts()
        t0 = time.perf_counter()
        res = sidx.execute(q)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        info = dict(sidx.last_info)
        counts = read_counts("sharded")
        got = res.gather()
        bad = mismatches(got, want[name])
        check(bad == 0, f"sharded {name}: {bad} words differ from the unsharded index")
        check(counts["tiled_block"] <= plan.backends.count("tiled_fused"),
              f"sharded {name}: at most one K2 launch a tiled shard, {counts}")
        runs.append({"query": name, "backends": list(plan.backends), "mode": info["mode"],
                     "first_call_s": first_s, "launch_counts": counts,
                     "to_result_ms": to_result_ms(lambda q=q: sidx.execute(q)),
                     "unsharded_to_result_ms": to_result_ms(lambda q=q: tidx.execute(q)),
                     "words_touched": info["words_touched"],
                     "decode_words": info.get("decode_words"), "mismatched_words": bad})
    zero_counts()
    t0 = time.perf_counter()
    got_many = sidx.execute_many(many)
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    many_counts = read_counts("sharded")
    for j, (g, w) in enumerate(zip(got_many, want_many)):
        bad = mismatches(g.gather(), w)
        check(bad == 0, f"sharded execute_many[{j}]: {bad} words differ")
    report["queries"] = runs
    # where a cached sharded query's host time goes (8 host-sequenced shards)
    report["host_profile"] = host_profile(lambda: sidx.execute(queries["interval_2_10"]))
    report["execute_many"] = {"k": len(many), "backends": list(sidx.last_info["backends"]),
                              "first_call_s": many_s, "launch_counts": many_counts,
                              "to_result_ms": to_result_ms(lambda: sidx.execute_many(many))}

    # 3. a heterogeneous plan: at 16 shards the last one is the dense tail
    s16 = tidx.shard(n_shards=SHARDS_HETERO)
    hetero = None
    for members in (names[:8], names[:4], names[2:8], names[:2]):
        q = Threshold(3, over=[Col(m) for m in members]) if len(members) > 2 else \
            Threshold(2, over=[Col(m) for m in members])
        plan = s16.plan(q)
        if len(plan.distinct) >= 2 and "tiled_fused" in plan.distinct:
            hetero = (members, q, plan)
            break
    check(hetero is not None, "a column set of the dense tail that plans two backends")
    members, q, plan = hetero
    zero_counts()
    res = s16.execute(q)
    hcounts = read_counts("sharded")
    bad = mismatches(res.gather(), tidx.execute(q))
    check(bad == 0, f"heterogeneous plan: {bad} words differ")
    report["heterogeneous"] = {"n_shards": SHARDS_HETERO, "members": list(members), "t": q.t,
                               "backends": list(plan.backends), "distinct": list(plan.distinct),
                               "launch_counts": hcounts, "mismatched_words": bad,
                               "to_result_ms": to_result_ms(lambda: s16.execute(q))}
    del s16, res

    # 4. composition without a gather
    hot_q = Threshold(4)
    q2 = Col("hot") & Interval(2, 10, over=[Col(m) for m in names])
    sidx2 = sidx.add_column("hot", sidx.execute(hot_q))
    got = sidx2.execute(q2).gather()
    idx2 = tidx.add_column("hot", tidx.execute(hot_q))
    bad_add = mismatches(got, idx2.execute(q2))
    check(bad_add == 0, f"add_column of a sharded result: {bad_add} words differ")
    del sidx2, idx2, got
    flipped = ~tidx.columns[0]
    sidx3 = sidx.replace_column(names[0], sidx.store.split(flipped))
    bad_stale = mismatches(sidx.column(names[0]), tidx.columns[0])
    bad_new = mismatches(sidx3.column(names[0]), flipped)
    check(bad_stale == 0 and bad_new == 0,
          f"replace_column: stale {bad_stale}, replaced {bad_new} words differ")
    del sidx3, flipped
    back = BitmapIndex.from_sharded(sidx)
    bad_back = mismatches(back.columns, tidx.columns)
    check(bad_back == 0 and np.array_equal(back.store.classes_word, tidx.store.classes_word),
          f"from_sharded: {bad_back} words differ")
    del back
    report["composition"] = {"add_column_mismatched_words": bad_add,
                             "replace_column_stale_mismatched_words": bad_stale,
                             "from_sharded_mismatched_words": bad_back}

    # 5. the shard-map path: one K1 launch a piece of the word axis
    smap = []
    for n_shards in (SHARDS, SHARDS_RAGGED):
        sm = tidx.shard(n_shards=n_shards, devices=[dev] * n_shards)
        pieces = sm.store.spmd_pieces(sm.devices)
        w = pieces[0].shape[1]
        views = sum(p.data_ptr() == tidx.columns[:, d * w:].data_ptr() for d, p in enumerate(pieces))
        check(views >= n_shards - (n_shards * w != nw), f"{n_shards} pieces: {views} are views")
        for name in ("interval_2_10", "composite"):
            q = queries[name]
            zero_counts()
            res = sm.execute(q, backend="fused")
            torch.cuda.synchronize()
            counts = read_counts("sharded")
            check(sm.last_info["mode"] == "shard_map", f"{name}: mode {sm.last_info['mode']}")
            check(counts["circuit_eval"] == n_shards and counts["tiled_block"] == 0,
                  f"{name} at {n_shards} shards: one K1 launch a piece, {counts}")
            got = res.gather()
            bad = mismatches(got, tidx.execute(q, backend="fused"))
            circ = circuit_for((q,), n, names)
            d = 1  # a piece that starts off a 16-byte boundary when w is odd
            plain = run_circuit_plain(pieces[d], circ)
            bad_plain = mismatches(got[d * w:(d + 1) * w], plain)
            check(bad == 0 and bad_plain == 0,
                  f"{name} at {n_shards} shards: {bad} words differ from K1, "
                  f"{bad_plain} from the plain version on piece {d}")
            k1 = cuda_ms(lambda q=q: tidx.execute(q, backend="fused"), reps=10)
            spmd = cuda_ms(lambda q=q, sm=sm: sm.execute(q, backend="fused"), reps=10)
            n_in = len(circ.support())
            bytes_ms = (n_in + 1) * nw * 4 / PEAK_BYTES_PER_S * 1e3
            ops_ms = len(circ.ops) * nw / PEAK_ALU_OPS_PER_S * 1e3
            smap.append({
                "query": name, "n_shards": n_shards, "piece_words": w,
                "padded": n_shards * w != nw, "piece_views": views,
                "unaligned_pieces": sum((d * w * 4) % 16 != 0 for d in range(n_shards)),
                "launch_counts": counts, "mismatched_words": bad,
                "plain_piece_mismatched_words": bad_plain,
                "ms_median": statistics.median(spmd),
                "unsharded_k1_ms_median": statistics.median(k1),
                "to_result_ms": to_result_ms(lambda q=q, sm=sm: sm.execute(q, backend="fused")),
                "unsharded_k1_to_result_ms": to_result_ms(
                    lambda q=q: tidx.execute(q, backend="fused")),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        del sm, pieces, res, got
    report["shard_map"] = smap

    with tempfile.TemporaryDirectory(prefix="bmshards-") as tmp:
        # 6. sharded snapshot directories
        d = os.path.join(tmp, "sharded")
        t0 = time.perf_counter()
        meta = save_sharded(sidx, d)
        save_s = time.perf_counter() - t0
        files = sorted(os.listdir(d))
        sizes = {f: os.path.getsize(os.path.join(d, f)) for f in files}
        k = SHARDS // 2
        t0 = time.perf_counter()
        store_k, bounds_k = load_shard(d, k, device=dev)
        load_shard_s = time.perf_counter() - t0
        check(tuple(bounds_k) == sidx.store.tile_bounds[k], f"shard {k}: bounds {bounds_k}")
        bad_k = mismatches(store_k.densify(), sidx.store.shards[k].densify())
        check(bad_k == 0, f"load_shard({k}): {bad_k} words differ")
        del store_k
        t0 = time.perf_counter()
        loaded = load_sharded(d, device=dev, to_device=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        zero_counts()
        for name, q in queries.items():
            bad = mismatches(loaded.execute(q).gather(), want[name])
            check(bad == 0, f"loaded sharded {name}: {bad} words differ")
        loaded_counts = read_counts("sharded")
        again = os.path.join(tmp, "again")
        save_sharded(loaded, again)
        digests = {f: sha256_of(os.path.join(d, f)) for f in files}
        check(sorted(os.listdir(again)) == files
              and all(sha256_of(os.path.join(again, f)) == h for f, h in digests.items()),
              "a loaded sharded index re-saves to other bytes")
        del loaded
        report["persist"] = {"save_s": save_s, "load_shard_s": load_shard_s,
                             "load_sharded_to_device_s": load_s, "n_shards": meta["n_shards"],
                             "bytes": sum(sizes.values()), "files": len(files),
                             "largest_file_bytes": max(sizes.values()),
                             "sha256_equal_after_resave": True,
                             "launch_counts": loaded_counts}

        # 7. streaming over a 4-shard base, held against a dense copy
        report["stream"] = sharded_stream_run(tidx, queries["composite"],
                                              os.path.join(tmp, "durable"), seed)
    del sidx
    report["masks"] = masks_run(dev, seed)
    emit("sharded", **report)


def sharded_stream_run(tidx, composite, durable_dir: str, seed: int) -> dict:
    """``StreamingIndex`` over ``tidx`` in 4 row shards: one view, a seeded
    batch (some updates within 2 bits of every shard boundary) and appended
    rows; the view and two queries against K1 over a dense copy the updates
    were replayed on with torch ops, before and after per-shard compaction;
    then a checkpoint (a sharded directory) and ``recover``."""
    from repro_torch.core.bitmaps import n_words_for, packed_tail_mask
    from repro_torch.kernels.threshold_ssum import run_circuit_cached
    from repro_torch.query import Interval, Threshold
    from repro_torch.query.index import circuit_for
    from repro_torch.stream import CompactionPolicy, StreamingIndex

    dev = tidx.device
    data = tidx.names
    n = len(data)
    rng = np.random.default_rng(seed + 17)
    out = {"n_shards": SHARDS_STREAM}
    t0 = time.perf_counter()
    s = StreamingIndex(tidx.shard(n_shards=SHARDS_STREAM), policy=CompactionPolicy(auto=False))
    view_q = Threshold(2, over=data[48:64])
    zero_counts()
    s.materialize("v_sharded", view_q)
    torch.cuda.synchronize()
    out["materialize_s"] = time.perf_counter() - t0
    out["materialize_launch_counts"] = read_counts("sharded")

    r0 = s.r
    bounds = [w * 32 for w in s.index().store.word_offsets[1:]]
    cols = rng.integers(0, n, SHARD_STREAM_UPDATES)
    pos = rng.integers(0, r0, SHARD_STREAM_UPDATES)
    near = np.repeat(np.asarray(bounds, np.int64), SHARD_STREAM_STRADDLE)
    pos[: near.size] = near + rng.integers(-2, 2, near.size)  # bits b-2 .. b+1
    on = rng.random(SHARD_STREAM_UPDATES) < 0.5
    last = {}  # one write a (column, position): sets apply before clears
    for i, (c, p) in enumerate(zip(cols.tolist(), pos.tolist())):
        last[(c, p)] = i
    sel = np.asarray(sorted(last.values()))
    cols, pos, on = cols[sel], pos[sel], on[sel]
    dense = tidx.columns.clone()
    zero_counts()
    t0 = time.perf_counter()
    s.update(**as_update(data, cols, pos, on))
    out["apply_ms"] = (time.perf_counter() - t0) * 1e3
    replay_on_dense(dense, cols, pos, on)
    straddled = sum(bool(((pos >= b - 2) & (pos < b)).any() and ((pos >= b) & (pos < b + 2)).any())
                    for b in bounds)
    app = rng.random((n, STREAM_APPEND_ROWS)) < STREAM_APPEND_DENSITY
    start, stop = s.append_rows(app)
    check((start, stop) == (r0, r0 + STREAM_APPEND_ROWS), f"append_rows range {(start, stop)}")
    r1 = s.r
    nw1 = n_words_for(r1)
    dense = torch.nn.functional.pad(dense, (0, nw1 - dense.shape[1]))
    arow, apos = np.nonzero(app)
    replay_on_dense(dense, arow.astype(np.int64), r0 + apos.astype(np.int64),
                    np.ones(arow.size, bool))
    mask = packed_tail_mask(r1, nw1, dev)

    def k1_dense(q):
        got = run_circuit_cached(dense, circuit_for((q,), n, data))
        return got if mask is None else got & mask

    check_queries = {"interval_2_10": Interval(2, 10, over=data), "composite": composite}
    t0 = time.perf_counter()
    s.refresh()
    torch.cuda.synchronize()
    out["view_refresh"] = {"ms": (time.perf_counter() - t0) * 1e3, **s.view_info("v_sharded")}
    bad = {"view": mismatches(s.column("v_sharded"), k1_dense(view_q))}
    for name, q in check_queries.items():
        bad[name] = mismatches(s.execute(q).gather(), k1_dense(q))
    out["overlay_launch_counts"] = read_counts("sharded")
    out["overlay_backends"] = {name: list(s.explain(q).backends) for name, q in check_queries.items()}
    check(all(v == 0 for v in bad.values()), f"sharded overlay vs the dense copy: {bad}")
    check(straddled == len(bounds), f"{straddled} of {len(bounds)} boundaries straddled")
    zero_counts()
    t0 = time.perf_counter()
    check(s.compact(), "compact() merged the deltas")
    out["compact_s"] = time.perf_counter() - t0
    bad_c = {"view": mismatches(s.column("v_sharded"), k1_dense(view_q))}
    for name, q in check_queries.items():
        bad_c[name] = mismatches(s.execute(q).gather(), k1_dense(q))
    out["compacted_launch_counts"] = read_counts("sharded")
    check(all(v == 0 for v in bad_c.values()), f"compacted sharded index vs the dense copy: {bad_c}")

    t0 = time.perf_counter()
    s.attach_durable(durable_dir)  # writes a sharded checkpoint
    out["checkpoint_s"] = time.perf_counter() - t0
    check(os.path.exists(os.path.join(durable_dir, "sharded.json")), "a sharded checkpoint")
    more = rng.integers(0, r1, 512)
    s.update(sets={data[1]: more})
    t0 = time.perf_counter()
    rec = StreamingIndex.recover(durable_dir, device=dev)
    out["recover_s"] = time.perf_counter() - t0
    bad_r = {name: mismatches(rec.execute(q).gather(), s.execute(q).gather())
             for name, q in check_queries.items()}
    bad_r["view"] = mismatches(rec.column("v_sharded"), s.column("v_sharded"))
    check(rec.is_sharded and all(v == 0 for v in bad_r.values()),
          f"recovered sharded index differs: {bad_r}")
    out.update(updates=int(cols.size), appended_rows=STREAM_APPEND_ROWS,
               boundaries_straddled=straddled, mismatched_words=bad,
               compacted_mismatched_words=bad_c, recovered_mismatched_words=bad_r)
    return out


def masks_run(dev, seed: int) -> dict:
    """``head_vote_mask`` over 64 heads x 2**20 KV positions through K1,
    against its plain version on a CPU copy and a numpy count oracle; the
    KV-tile skip list against numpy.  Heads vote densely on a random half of
    the 2,048-position tiles and rarely elsewhere, so tiles die."""
    from repro_torch.core.bitmaps import pack
    from repro_torch.serve.masks import head_vote_mask, kv_tile_skiplist

    rng = np.random.default_rng(seed + 23)
    n_kv = 2**MASK_KV_LOG2
    live = rng.random(n_kv // MASK_TILE) < 0.5
    p = np.where(np.repeat(live, MASK_TILE), 0.3, 0.01)
    votes_np = rng.random((MASK_HEADS, n_kv)) < p
    votes = pack(votes_np, dev)
    zero_counts()
    kept = head_vote_mask(votes, MASK_T)
    torch.cuda.synchronize()
    counts = read_counts("sharded")
    check(counts["circuit_eval"] == 1, f"head_vote_mask launched K1 once, {counts}")
    plain = head_vote_mask(votes.cpu(), MASK_T)
    want_bits = votes_np.sum(0) >= MASK_T
    bad_plain = mismatches(kept.cpu(), plain)
    bad_oracle = mismatches(kept.cpu(), pack(want_bits, "cpu"))
    check(bad_plain == 0 and bad_oracle == 0,
          f"head_vote_mask: {bad_plain} words differ from the plain version, {bad_oracle} from numpy")
    keep, info = kv_tile_skiplist(kept, n_kv, tile_positions=MASK_TILE)
    want_keep = np.nonzero(want_bits.reshape(-1, MASK_TILE).any(1))[0]
    check(np.array_equal(keep, want_keep), "the KV-tile skip list differs from numpy")
    return {"heads": MASK_HEADS, "kv_positions": n_kv, "t": MASK_T, "tile_positions": MASK_TILE,
            "launch_counts": counts, "mismatched_words": bad_plain,
            "oracle_mismatched_words": bad_oracle, "kept_positions": int(want_bits.sum()),
            "skiplist": info, "to_result_ms": to_result_ms(lambda: head_vote_mask(votes, MASK_T))}


# ---------------------------------------------------------------------------
# phase 18: the LM serving path (models, ServeEngine) with slot queries on K1
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-1.7b"
LM_PARAMS = 1_720_574_976  # the reference's param_count_exact of the full config
LM_SLOTS, LM_MAX_SEQ, LM_REQUESTS, LM_MAX_NEW = 8, 512, 16, 32
LM_PROMPT_LENGTHS = (32, 128)  # inclusive
LM_UNBATCHED = 4  # requests also decoded alone, each against the batched output
LM_FAMILIES = ("recurrentgemma-2b", "mixtral-8x22b", "rwkv6-3b", "gemma2-27b")
# decode at position p against the forward over the prefix through p, on the
# card: the two sum 28 layers in another order (prefill's [1, p, d] products
# beside decode's [8, 1, d] ones); logits are O(1)
LM_PREFILL_DECODE_TOL = {"atol": 2e-3, "rtol": 1e-3}
# the reduced model on the card against the same weights on the CPU: float32
# everywhere, TF32 off, two libraries' summation orders
LM_CPU_CARD_TOL = {"atol": 1e-4, "rtol": 1e-4}
LM_BYTES = 4  # float32 weights and caches


def lm_decode_bound(cfg, slots: int, max_seq: int) -> dict:
    """The least time of one decode step: every weight read once, plus the
    K and V caches the reference attends over (the whole ``max_seq`` of
    each slot, ring length for a local layer), over 3.35 TB/s."""
    from repro_torch.models.model import _ATTN_KINDS, _cache_len, block_kinds

    weight_bytes = cfg.param_count() * LM_BYTES
    kv_bytes = sum(2 * slots * _cache_len(kind, cfg, max_seq) * cfg.kv_dim * LM_BYTES
                   for kind in block_kinds(cfg) if kind in _ATTN_KINDS)
    weights_ms = weight_bytes / PEAK_BYTES_PER_S * 1e3
    kv_ms = kv_bytes / PEAK_BYTES_PER_S * 1e3
    return {"weight_bytes": weight_bytes, "kv_bytes": kv_bytes, "weights_ms": weights_ms,
            "kv_ms": kv_ms, "bound_ms": weights_ms + kv_ms,
            "bound_tokens_per_s": slots / ((weights_ms + kv_ms) / 1e3)}


def greedy_alone(model, cfg, prompt: list, max_new: int, max_seq: int, dev) -> list:
    """Unbatched greedy decode: prefill, then ``decode_step`` at one (scalar)
    position."""
    from repro_torch.models import decode_step, forward

    toks = torch.tensor(prompt, dtype=torch.long, device=dev)[None, :]
    _, caches, _ = forward(model, cfg, {"tokens": toks}, mode="prefill", max_seq=max_seq)
    out, cur, pos = [], toks[:, -1:], len(prompt)
    for _ in range(max_new):
        logits, caches = decode_step(model, cfg, caches, cur, pos)
        cur = logits.argmax(-1)
        out.append(int(cur[0, 0]))
        pos += 1
    return out


def lm_requests(cfg, n: int, lengths: tuple, max_new: int, rng) -> list:
    from repro_torch.serve import Request

    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(lengths[0],
                                                                        lengths[1] + 1)).tolist(),
                    max_new=max_new) for i in range(n)]


class EngineProbe:
    """Wraps one ``ServeEngine`` instance's methods to time and count what a
    run does: CUDA events around every decode step and prefill, host time of
    the slot commits and the engine's own slot queries, K1 launches per
    ``free_slots()`` call, and after every step free / draining slots
    against the request table (the oracle's own queries are not timed)."""

    def __init__(self, eng):
        from repro_torch.kernels import threshold_ssum as K

        self.eng, self.K = eng, K
        self.decode_events, self.prefill_events = [], []
        self.host_s, self.free_launches, self.steps_checked = 0.0, [], 0
        self._in_oracle = False
        for name in ("_decode", "_prefill"):
            setattr(eng, name, self._events(getattr(eng, name), self.decode_events
                                            if name == "_decode" else self.prefill_events))
        for name in ("_commit_slot_state", "select_slots"):
            setattr(eng, name, self._host_timed(getattr(eng, name)))
        free, step = eng.free_slots, eng.step

        def free_slots():
            before = K.launch_counts["circuit_eval"]
            got = free()
            if not self._in_oracle:
                self.free_launches.append(K.launch_counts["circuit_eval"] - before)
            return got

        def checked_step():
            emitted = step()
            self._in_oracle = True
            try:
                want_free = [i for i, r in enumerate(eng.requests) if r is None]
                want_near = [i for i, r in enumerate(eng.requests) if r is not None
                             and eng.pos[i] >= eng.max_seq - eng._near_margin]
                got = (eng.free_slots(), eng.draining_slots())
            finally:
                self._in_oracle = False
            check(got == (want_free, want_near),
                  f"step {eng.step_count}: slot queries {got} vs the oracle "
                  f"{(want_free, want_near)}")
            self.steps_checked += 1
            return emitted

        eng.free_slots, eng.step = free_slots, checked_step

    def _events(self, fn, into: list):
        def timed(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            into.append((e0, e1))
            return out
        return timed

    def _host_timed(self, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if not self._in_oracle:
                    self.host_s += time.perf_counter() - t0
        return timed

    @staticmethod
    def ms(events: list) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in events]


def lm_serve_run(cfg, model, dev, seed: int) -> dict:
    """The main path: ``ServeEngine`` over ``LM_REQUESTS`` seeded prompts,
    launch counts read around it, then each of ``LM_UNBATCHED`` requests
    decoded alone against its batched output.  Returns the report and
    request 0's prompt and output."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, model, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, device=dev)
    probe = EngineProbe(eng)
    reqs = lm_requests(cfg, LM_REQUESTS, LM_PROMPT_LENGTHS, LM_MAX_NEW,
                       np.random.default_rng(seed + 31))
    prompts = {r.rid: list(r.prompt) for r in reqs}
    # counts to 0 just before the serving path is driven, read just after
    zero_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts("lm_serve")
    check(sorted(r.rid for r in done) == list(range(LM_REQUESTS))
          and all(len(r.out) == LM_MAX_NEW for r in done),
          "every request was served to max_new tokens")
    check(counts["circuit_eval"] >= 1, f"slot queries launched K1, {counts}")
    check(min(probe.free_launches) >= 1,
          f"every free_slots() launched K1: {probe.free_launches}")
    check(probe.steps_checked == eng.step_count, "the oracle checked every step")
    decode_ms, prefill_ms = probe.ms(probe.decode_events), probe.ms(probe.prefill_events)
    tokens = sum(len(r.out) for r in done)
    bound = lm_decode_bound(cfg, LM_SLOTS, LM_MAX_SEQ)
    dmed = statistics.median(decode_ms)
    report = {
        "arch": cfg.name, "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ, "requests": LM_REQUESTS,
        "prompt_tokens": sum(len(p) for p in prompts.values()), "max_new": LM_MAX_NEW,
        "tokens": tokens, "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        "engine_steps": eng.step_count, "decode_steps_timed": len(decode_ms),
        "decode_step_ms": {"median": dmed, "min": min(decode_ms), "max": max(decode_ms)},
        "prefill_ms_per_request": {"median": statistics.median(prefill_ms),
                                   "min": min(prefill_ms), "max": max(prefill_ms)},
        "host_ms_per_step": probe.host_s * 1e3 / eng.step_count,
        "free_slots_calls": len(probe.free_launches),
        "k1_launches_per_free_slots": sorted(set(probe.free_launches)),
        "launch_counts": counts, "decode_bound": bound,
        "decode_share_of_bound": bound["bound_ms"] / dmed,
        "steps_checked_against_oracle": probe.steps_checked,
    }
    # batched == unbatched greedy decode, on the card
    by_rid = {r.rid: r.out for r in done}
    t0 = time.perf_counter()
    for rid in range(LM_UNBATCHED):
        alone = greedy_alone(model, cfg, prompts[rid], LM_MAX_NEW, LM_MAX_SEQ, dev)
        check(alone == by_rid[rid], f"request {rid}: batched {by_rid[rid]} vs alone {alone}")
    report["unbatched_checked"] = LM_UNBATCHED
    report["unbatched_s"] = time.perf_counter() - t0
    return report, prompts[0], by_rid[0]


def lm_prefill_decode_err(model, cfg, seq: list, p: int, dev) -> float:
    """decode_step's logits at position ``p`` after a prefill of ``seq[:p]``,
    against ``forward`` over ``seq[:p + 1]`` at its last position."""
    from repro_torch.models import decode_step, forward, logits_from_hidden

    toks = torch.tensor(seq[: p + 1], dtype=torch.long, device=dev)[None, :]
    h, _, _ = forward(model, cfg, {"tokens": toks})
    full = logits_from_hidden(model, cfg, h[:, -1:])
    _, caches, _ = forward(model, cfg, {"tokens": toks[:, :p]}, mode="prefill",
                           max_seq=LM_MAX_SEQ)
    dec, _ = decode_step(model, cfg, caches, toks[:, p:], p)
    check(torch.allclose(dec, full, **LM_PREFILL_DECODE_TOL),
          f"decode at {p} vs forward: max abs err {float((dec - full).abs().max())}")
    return float((dec - full).abs().max())


def lm_cpu_card_err(cfg, dev, seed: int) -> dict:
    """The reduced model with the same weights on the CPU and on the card:
    prefill hidden states and logits, then three decode steps."""
    import copy

    from repro_torch.models import decode_step, forward, init_params, logits_from_hidden

    cpu = init_params(cfg, seed, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    toks = torch.from_numpy(np.random.default_rng(seed + 37).integers(0, cfg.vocab, (2, 24)))
    errs = []
    sides = []
    for model, d in ((cpu, torch.device("cpu")), (card, dev)):
        h, caches, _ = forward(model, cfg, {"tokens": toks.to(d)}, mode="prefill", max_seq=64)
        outs = [logits_from_hidden(model, cfg, h)]
        cur = toks[:, -1:].to(d)
        for i in range(3):
            logits, caches = decode_step(model, cfg, caches, cur, 24 + i)
            outs.append(logits)
            cur = torch.full_like(cur, 7 + i)  # the same feed on both sides
        sides.append([o.cpu() for o in outs])
    for a, b in zip(*sides):
        check(torch.allclose(b, a, **LM_CPU_CARD_TOL),
              f"card vs CPU logits: max abs err {float((b - a).abs().max())}")
        errs.append(float((b - a).abs().max()))
    return {"arch": cfg.name, "tolerance": LM_CPU_CARD_TOL, "max_abs_err": max(errs),
            "checked": ["prefill logits", "decode 1", "decode 2", "decode 3"]}


def lm_family_run(arch: str, dev, seed: int) -> dict:
    """A reduced config through the engine on the card: batched == alone."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch, reduced=True)
    if cfg.moe:  # no capacity drops, as tests/test_serve.py decodes MoE archs
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    model = init_params(cfg, seed, device=dev)
    reqs = lm_requests(cfg, 4, (3, 30), 8, np.random.default_rng(seed + 41))
    prompts = {r.rid: list(r.prompt) for r in reqs}
    eng = ServeEngine(cfg, model, batch_slots=2, max_seq=64, device=dev)
    t0 = time.perf_counter()
    done = {r.rid: r.out for r in eng.run_until_drained(reqs)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid, prompt in prompts.items():
        alone = greedy_alone(model, cfg, prompt, 8, 64, dev)
        check(alone == done[rid], f"{arch} request {rid}: batched {done[rid]} vs alone {alone}")
    return {"arch": arch, "requests": len(prompts), "engine_steps": eng.step_count,
            "wall_s": wall, "batched_equals_alone": True}


def decode_profile(eng, steps: int = 3) -> dict:
    """``torch.profiler`` over a few decode steps of a full engine: kernels
    launched and device busy time per step beside the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.zeros((eng.slots, 1), dtype=torch.long, device=eng.device)
    pos = torch.from_numpy(eng.pos).to(eng.device)
    eng._decode(eng.params, caches=eng.cache, tokens=tokens, pos=pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._decode(eng.params, caches=eng.cache, tokens=tokens, pos=pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    return {"steps": steps, "kernels_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": busy_ms, "wall_ms_per_step": wall_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if kernels else None}


def phase_lm_serve(dev, smi: str, seed: int, cfg=None) -> None:
    """qwen3-1.7b at full width (``cfg``: another config, for a rehearsal)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    # full float32 products: TF32 would keep about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = cfg is None
    cfg = cfg or get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), f"{n_params} parameters vs param_count_exact")
    if full:
        check(n_params == LM_PARAMS, f"qwen3-1.7b has {n_params} parameters, not {LM_PARAMS}")
    report = {"card": smi, "arch": cfg.name, "params": n_params, "dtype": "float32",
              "init_s": init_s, "weights_max_memory_allocated": torch.cuda.max_memory_allocated(),
              "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    report["serve"], prompt, out = lm_serve_run(cfg, model, dev, seed)
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    seq, p0 = prompt + out, len(prompt)
    report["prefill_decode"] = {
        "tolerance": LM_PREFILL_DECODE_TOL,
        "max_abs_err": max(lm_prefill_decode_err(model, cfg, seq, p, dev)
                           for p in (p0, p0 + LM_MAX_NEW // 2)),
        "positions": [p0, p0 + LM_MAX_NEW // 2]}
    eng = ServeEngine(cfg, model, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, device=dev)
    report["decode_profile"] = decode_profile(eng)
    del eng, model
    torch.cuda.empty_cache()
    report["cpu_vs_card"] = lm_cpu_card_err(get_config(LM_ARCH, reduced=True), dev, seed)
    report["families"] = [lm_family_run(arch, dev, seed) for arch in LM_FAMILIES]
    emit("lm_serve", **report)


# ---------------------------------------------------------------------------
# phase 19: the LM training path (train, data, ckpt, ft, launch/train.py)
# ---------------------------------------------------------------------------

LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 128, 8  # launch/train.py's batch and seq
LM_TRAIN_LR = 1e-3  # launch/train.py's --lr
# the loss of 2 microbatches (the mean of the halves' means) against the
# batch's loss in one piece, same weights: float32 sums of 1,024 per-token
# losses of about 12 in two groupings (cuBLAS may also pick other kernels
# for 512 rows than for 1,024)
LM_TRAIN_MICRO_ATOL = 1e-4
# one step on the card against the CPU from the same state: float32, TF32
# off, two libraries' summation orders.  Parameters after the update are
# held to half a step: Adam's first step moves a weight by lr g/(|g| + eps),
# about +-lr whatever |g|, so a gradient within rounding of zero can move
# by another fraction of a step (tests/test_torch_train_step.py)
LM_TRAIN_CARD_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4, "param_atol": 0.5 * LM_TRAIN_LR}


def lm_train_bound(cfg, batch: int, seq: int) -> dict:
    """The least time of one training step.  Operations: 6 x parameters x
    tokens (forward and backward products of every weight, the tied
    embedding's logits included) plus attention's scores and weighted sums
    over the whole S x S square the model computes (masked, not skipped),
    4 B S^2 H hd a layer forward, three times that with the backward; over
    67e12 float32 FLOP/s.  Bytes: the update reads parameters, gradients,
    m and v and writes parameters, m and v once; over 3.35e12 B/s."""
    from repro_torch.models.model import _ATTN_KINDS, block_kinds

    n = cfg.param_count()
    tokens = batch * seq
    attn_layers = sum(kind in _ATTN_KINDS for kind in block_kinds(cfg))
    flops = 6 * n * tokens + 3 * 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * attn_layers
    update_bytes = 7 * n * LM_BYTES
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = update_bytes / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "update_bytes": update_bytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "peak": "67e12 float32 FLOP/s outside the tensor cores, 3.35e12 B/s "
                    "(NVIDIA H100 SXM data sheet)"}


def timed_steps(step_fn, state, batches: list) -> tuple:
    """Run ``step_fn`` over ``batches``; CUDA events around each step, the
    metrics read after it.  Returns (state, per-step metrics, step ms)."""
    mets, events = [], []
    for batch in batches:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step_fn(state, batch)
        e1.record()
        events.append((e0, e1))
        mets.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    return state, mets, [a.elapsed_time(b) for a, b in events]


def train_profile(step_fn, state, batch) -> tuple:
    """``torch.profiler`` over one training step: kernels, device busy ms
    beside the step's wall ms, the matrix products' share (cuBLAS kernels,
    "gemm" in their names) and the eight kernels that took longest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    gemm_ms = sum(v for k, v in by_name.items() if "gemm" in k.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return state, {"loss": loss, "kernels": len(kernels), "device_busy_ms": busy_ms,
                   "wall_ms": wall_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
                   "gemm_ms": gemm_ms, "top_kernels_ms": [[k[:90], v] for k, v in top]}


def ms_summary(ms: list) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms), "all": ms}


def lm_train_full(dev, seed: int, cfg) -> dict:
    """qwen3-1.7b at full width (``cfg``: another config, for a rehearsal):
    8 steps, then remat, microbatches and one profiled step."""
    import dataclasses

    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.train import (
        OptConfig,
        TrainConfig,
        init_train_state,
        make_eval_step,
        make_train_step,
    )

    total = LM_TRAIN_STEPS + 7
    opt = OptConfig(peak_lr=LM_TRAIN_LR, warmup_steps=10, total_steps=total)
    dc = DataConfig(vocab=cfg.vocab, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, seed=seed)
    batches = [lm_batch(dc, i, dev) for i in range(total)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    check(n_params == cfg.param_count(), f"{n_params} parameters vs param_count_exact")
    if cfg.name == LM_ARCH:  # the full config
        check(n_params == LM_PARAMS, f"qwen3-1.7b has {n_params} parameters, not {LM_PARAMS}")
    state_bytes = torch.cuda.memory_allocated()
    # counts to 0 just before the training path is driven, read just after
    zero_counts()
    state, mets, ms = timed_steps(make_train_step(cfg, TrainConfig(opt=opt)), state,
                                  batches[:LM_TRAIN_STEPS])
    counts = read_counts("lm_train")
    check(not any(counts.values()), f"the training path reaches no bitmap kernel: {counts}")
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(mets):
        check(all(np.isfinite(v) for v in m.values()), f"step {i}: metrics {m}")
    bound = lm_train_bound(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    med = statistics.median(ms)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    report = {
        "arch": cfg.name, "params": n_params, "dtype": "float32",
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "batch": LM_TRAIN_BATCH,
        "seq": LM_TRAIN_SEQ, "opt": dataclasses.asdict(opt), "init_s": init_s,
        "state_bytes_after_init": state_bytes,
        "loss": [m["loss"] for m in mets], "grad_norm": [m["grad_norm"] for m in mets],
        "lr": [m["lr"] for m in mets], "step_ms": ms_summary(ms),
        "tokens_per_s": tokens / (med / 1e3), "max_memory_allocated": peak,
        "bound": bound, "share_of_bound": bound["bound_ms"] / med,
        "achieved_flops_per_s": bound["flops"] / (med / 1e3), "launch_counts": counts,
    }
    step = LM_TRAIN_STEPS
    for policy in ("full", "dots"):
        torch.cuda.reset_peak_memory_stats()
        tc = TrainConfig(opt=opt, remat=True, remat_policy=policy)
        state, rm, rms = timed_steps(make_train_step(cfg, tc), state, batches[step:step + 2])
        step += 2
        check(all(np.isfinite(v) for m in rm for v in m.values()), f"remat {policy}: {rm}")
        report[f"remat_{policy}"] = {"loss": [m["loss"] for m in rm], "step_ms": ms_summary(rms),
                                     "max_memory_allocated": torch.cuda.max_memory_allocated()}
    eval_step = make_eval_step(cfg, TrainConfig(opt=opt))
    micro_step = make_train_step(cfg, TrainConfig(opt=opt, microbatches=2))
    micro = []
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[step:step + 2]:
        whole = float(eval_step(state["params"], batch)["loss"])
        state, mm, mms = timed_steps(micro_step, state, [batch])
        err = abs(mm[0]["loss"] - whole)
        check(err <= LM_TRAIN_MICRO_ATOL and np.isfinite(mm[0]["grad_norm"]),
              f"2 microbatches: loss {mm[0]['loss']} vs {whole} in one piece")
        micro.append({"loss": mm[0]["loss"], "one_piece_loss": whole, "abs_err": err,
                      "step_ms": mms[0]})
    report["microbatches_2"] = {"steps": micro, "tolerance": LM_TRAIN_MICRO_ATOL,
                                "max_memory_allocated": torch.cuda.max_memory_allocated()}
    state, report["profile"] = train_profile(make_train_step(cfg, TrainConfig(opt=opt)), state,
                                             batches[step + 2])
    check(np.isfinite(report["profile"]["loss"]), f"profiled step: {report['profile']}")
    # the products' FLOPs of one more step (the dry run's accounting is held to it)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        state, _ = make_train_step(cfg, TrainConfig(opt=opt))(state, batches[0])
    torch.cuda.synchronize()
    report["flop_counter_flops"] = fc.get_total_flops()
    return report


def train_state_to(state: dict, dev) -> dict:
    """A copy of a train state on ``dev``."""
    import copy

    opt = state["opt"]
    return {"params": copy.deepcopy(state["params"]).to(dev),
            "opt": {"m": {k: v.to(dev, copy=True) for k, v in opt["m"].items()},
                    "v": {k: v.to(dev, copy=True) for k, v in opt["v"].items()},
                    "step": opt["step"].to(dev, copy=True)}}


def lm_train_card_vs_cpu(dev, seed: int) -> list:
    """One step of each reduced architecture on the card and on the CPU
    from the same state and batch."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data import arch_batch
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    tc = TrainConfig(opt=OptConfig(peak_lr=LM_TRAIN_LR, warmup_steps=0, total_steps=100))
    out = []
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        cpu = init_train_state(cfg, seed, device="cpu")
        card = train_state_to(cpu, dev)
        step = make_train_step(cfg, tc)
        cpu, mc = step(cpu, arch_batch(cfg, 4, 32, "train", seed, device="cpu"))
        card, mg = step(card, arch_batch(cfg, 4, 32, "train", seed, device=dev))
        torch.cuda.synchronize()
        dp = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(card["params"].parameters(), cpu["params"].parameters()))
        row = {"arch": arch, "loss_cpu": float(mc["loss"]), "loss_card": float(mg["loss"]),
               "aux_card": float(mg["aux_loss"]), "grad_norm_cpu": float(mc["grad_norm"]),
               "grad_norm_card": float(mg["grad_norm"]), "max_param_diff": dp}
        tol = LM_TRAIN_CARD_TOL
        check(abs(row["loss_card"] - row["loss_cpu"]) <= tol["loss_rtol"] * abs(row["loss_cpu"])
              and abs(row["grad_norm_card"] - row["grad_norm_cpu"])
              <= tol["grad_norm_rtol"] * row["grad_norm_cpu"] and dp <= tol["param_atol"],
              f"card vs CPU, one step: {row}")
        out.append(row)
    return out


def lm_train_loss_falls(dev) -> dict:
    """The reference's recipe (tests/test_train.py): qwen3 reduced, peak
    3e-3, warmup 5, 15 steps of 8 x 64 tokens; the loss falls by 0.5."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    cfg = get_config(LM_ARCH, reduced=True)
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=5,
                                                          total_steps=100)))
    state = init_train_state(cfg, 0, device=dev)
    dc = DataConfig(vocab=cfg.vocab, batch=8, seq=64)
    losses = []
    for i in range(15):
        state, m = step(state, lm_batch(dc, i, dev))
        losses.append(float(m["loss"]))
    check(losses[-1] < losses[0] - 0.5, f"the loss did not fall by 0.5: {losses}")
    return {"losses": losses}


def lm_train_resume(dev, directory: str) -> dict:
    """3 steps, a checkpoint, a restore into a fresh state, 3 more, against
    6 straight: under deterministic algorithms both runs are the same
    sequence of kernels, so they must agree to the reference's 1e-6."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    cfg = get_config(LM_ARCH, reduced=True)
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=2,
                                                          total_steps=10)))
    dc = DataConfig(vocab=cfg.vocab, batch=4, seq=32)
    torch.use_deterministic_algorithms(True)
    try:
        s = init_train_state(cfg, 4, device=dev)
        for i in range(6):
            s, _ = step(s, lm_batch(dc, i, dev))
        straight = s
        mgr = CheckpointManager(directory, async_save=True)
        s = init_train_state(cfg, 4, device=dev)
        for i in range(3):
            s, _ = step(s, lm_batch(dc, i, dev))
        t0 = time.perf_counter()
        mgr.save(3, s)
        mgr.wait()
        save_s = time.perf_counter() - t0
        del s  # crash
        t0 = time.perf_counter()
        s2 = mgr.restore(3, init_train_state(cfg, 4, device="meta"), device=dev)
        restore_s = time.perf_counter() - t0
        for i in range(3, 6):
            s2, _ = step(s2, lm_batch(dc, i, dev))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    d = max(float((a - b).detach().abs().max())
            for a, b in zip(straight["params"].parameters(), s2["params"].parameters()))
    check(d < 1e-6 and int(s2["opt"]["step"]) == 6, f"resumed run differs by {d}")
    return {"max_param_diff": d, "save_s": save_s, "restore_s": restore_s,
            "deterministic_algorithms": True}


def lm_train_launch(directory: str) -> dict:
    """``repro_torch.launch.train.main`` on the card (its default device),
    then again with more steps: the second resumes from the first's
    newest checkpoint.  The driver's signal handlers are put back after."""
    import contextlib
    import io
    import signal

    from repro_torch.launch import train as launch_train

    argv = ["--arch", LM_ARCH, "--reduced", "--batch", "8", "--seq", "64",
            "--ckpt-dir", directory, "--ckpt-every", "3"]
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    outs = []
    try:
        for steps in (6, 9):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                launch_train.main(argv + ["--steps", str(steps)])
            outs.append((buf.getvalue().splitlines(), time.perf_counter() - t0))
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    (first, s1), (second, s2) = outs
    check(first[-1] == "[done]" and not any(ln.startswith("[resume]") for ln in first),
          f"first run: {first}")
    check(second[0] == f"[resume] restored step 6 from {directory}" and second[-1] == "[done]",
          f"second run did not resume from step 6: {second}")
    from repro_torch.ckpt import CheckpointManager

    steps = CheckpointManager(directory).all_steps()
    check(steps == [3, 6, 9], f"checkpoints {steps}")
    return {"first": first, "second": second, "seconds": [s1, s2], "checkpoints": steps}


def phase_lm_train(dev, smi: str, seed: int, cfg=None) -> None:
    """qwen3-1.7b at full width (``cfg``: another config, for a rehearsal),
    then the reduced checks."""
    import tempfile

    from repro_torch.configs import get_config

    # full float32 products: TF32 would keep about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"card": smi}
    t0 = time.perf_counter()
    report["full"] = lm_train_full(dev, seed, cfg or get_config(LM_ARCH))
    report["full_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["card_vs_cpu"] = {"tolerance": LM_TRAIN_CARD_TOL,
                             "archs": lm_train_card_vs_cpu(dev, seed)}
    report["card_vs_cpu_s"] = time.perf_counter() - t0
    report["loss_falls"] = lm_train_loss_falls(dev)
    with tempfile.TemporaryDirectory() as tmp:
        report["resume"] = lm_train_resume(dev, os.path.join(tmp, "resume"))
        report["launch_train"] = lm_train_launch(os.path.join(tmp, "launch"))
    emit("lm_train", **report)
    return {k: report["full"][k] for k in ("max_memory_allocated", "flop_counter_flops")}


# ---------------------------------------------------------------------------
# phase 20: the mesh half of the LM substrate on a 1 x 1 mesh (dist/context,
# launch/mesh, launch/sharding, the mesh branches of models/layers)
# ---------------------------------------------------------------------------

LM_MESH_STEPS = 4
# granite-moe at full width, the MoE mesh branch on one rank against the
# no-rules forward: one rank routes all tokens, so the dispatch is the same
# and only the collectives (a one-rank all-reduce) stand between them
LM_MESH_MOE_TOL = {"atol": 1e-5, "rtol": 1e-5}
LM_MESH_MOE_BATCH, LM_MESH_MOE_SEQ = 2, 128
LM_MESH_LOSS_RTOL = 1e-6  # the mesh step's loss against the no-mesh step's
# after the steps, weights of the two paths "the same" within this, and the
# share of weights allowed to differ by more (the tied embedding's gradient
# sums its two uses in another order under DTensor: last-bit differences)
LM_MESH_PARAM_SAME, LM_MESH_PARAM_SHARE = 1e-6, 1e-3


def under_rules(step_fn, rules):
    """``step_fn`` run under ``use_rules(rules)`` (the mesh path's step)."""
    from repro_torch.dist.context import use_rules

    def run(state, batch):
        with use_rules(rules):
            return step_fn(state, batch)

    return run


def lm_mesh_train(dev, mesh, seed: int, cfg) -> dict:
    """4 steps of qwen3-1.7b at full width through the no-mesh path,
    then 4 through the mesh path (state and batches DTensors on the 1 x 1
    mesh, the step under ``use_rules``) from the same initial state (the
    same seed on the same card); one profiled step of each."""
    import dataclasses

    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.dist.context import ShardingRules
    from repro_torch.launch.sharding import batch_shardings, place, state_bytes, state_shardings
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    opt = OptConfig(peak_lr=LM_TRAIN_LR, warmup_steps=10, total_steps=LM_MESH_STEPS + 1)
    dc = DataConfig(vocab=cfg.vocab, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, seed=seed)
    batches = [lm_batch(dc, i, dev) for i in range(LM_MESH_STEPS + 1)]
    step_fn = make_train_step(cfg, TrainConfig(opt=opt))
    bound = lm_train_bound(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    report = {"arch": cfg.name, "dtype": "float32", "batch": LM_TRAIN_BATCH,
              "seq": LM_TRAIN_SEQ, "opt": dataclasses.asdict(opt), "bound": bound}
    rules = ShardingRules(mesh, batch_shardable=LM_TRAIN_BATCH % mesh.size() == 0)
    final = {}
    for path in ("no_mesh", "mesh"):
        torch.cuda.empty_cache()
        state = init_train_state(cfg, seed, device=dev)
        checksum = float(sum(p.detach().double().sum() for p in state["params"].parameters()))
        run_batches = batches
        if path == "mesh":
            state = place(state, state_shardings(state, mesh, cfg))
            b_sh = batch_shardings(batches[0], mesh, LM_TRAIN_BATCH)
            run_batches = [place(b, b_sh) for b in batches]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state_b = state_bytes(state)
        fn = under_rules(step_fn, rules) if path == "mesh" else step_fn
        state, mets, ms = timed_steps(fn, state, run_batches[:LM_MESH_STEPS])
        peak = torch.cuda.max_memory_allocated()
        params = dict(state["params"].named_parameters())
        max_param_diff = moved = None
        if path == "no_mesh":
            final = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
        else:
            max_param_diff, moved = 0.0, 0
            for k, v in params.items():
                d = (v.full_tensor().detach() - final[k].to(dev)).abs()
                max_param_diff = max(max_param_diff, float(d.max()))
                moved += int((d > LM_MESH_PARAM_SAME).sum())
        state, prof = train_profile(fn, state, run_batches[LM_MESH_STEPS])
        med = statistics.median(ms)
        report[path] = {
            "initial_param_checksum": checksum, "state_bytes": state_b,
            "loss": [m["loss"] for m in mets], "grad_norm": [m["grad_norm"] for m in mets],
            "lr": [m["lr"] for m in mets],
            "step_ms": ms_summary(ms), "tokens_per_s": tokens / (med / 1e3),
            "share_of_bound": bound["bound_ms"] / med, "max_memory_allocated": peak,
            "profile": prof, "max_param_diff_vs_no_mesh": max_param_diff,
            "params_differing_by_more_than_1e-6": moved,
            "param_types": sorted({type(p).__name__ for p in params.values()}),
        }
        del state, params
    a, b = report["no_mesh"], report["mesh"]
    check(a["initial_param_checksum"] == b["initial_param_checksum"],
          "the two paths did not start from the same state")
    check(b["param_types"] == ["DTensor"] and a["param_types"] == ["Parameter"],
          f"parameter types {a['param_types']} / {b['param_types']}")
    rel = [abs(x - y) / abs(y) for x, y in zip(b["loss"], a["loss"])]
    report["loss_max_rel_diff"] = max(rel)
    report["grad_norm_max_rel_diff"] = max(abs(x - y) / abs(y)
                                           for x, y in zip(b["grad_norm"], a["grad_norm"]))
    report["step_ms_ratio_mesh_over_no_mesh"] = b["step_ms"]["median"] / a["step_ms"]["median"]
    check(max(rel) <= LM_MESH_LOSS_RTOL and all(np.isfinite(b["loss"] + b["grad_norm"])),
          f"mesh losses {b['loss']} vs no-mesh {a['loss']}")
    # Adam moves a weight by about lr_t a step whatever its gradient, so a
    # gradient within rounding of zero may go either way: the two runs may
    # part by up to the rates summed, on a few weights
    n_params = sum(p.numel() for p in init_train_state(cfg, device="meta")["params"].parameters())
    check(b["max_param_diff_vs_no_mesh"] <= sum(a["lr"])
          and b["params_differing_by_more_than_1e-6"] <= LM_MESH_PARAM_SHARE * n_params,
          f"mesh parameters differ by {b['max_param_diff_vs_no_mesh']} "
          f"({b['params_differing_by_more_than_1e-6']} of {n_params} by more than 1e-6)")
    return report


def lm_mesh_moe(dev, mesh, seed: int, cfg) -> dict:
    """granite-moe at full width: one forward of 2 x 128 tokens without
    rules, then the same weights placed on the 1 x 1 mesh and the forward
    under the rules (the MoE mesh branch, experts TP-sharded over 'model'
    with a psum, since 512 ff columns over one rank is not under 128)."""
    from repro_torch.data import arch_batch
    from repro_torch.dist.context import ShardingRules, use_rules
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.sharding import batch_shardings, param_shardings, place
    from repro_torch.models import forward, init_params

    model = init_params(cfg, seed, device=dev)
    batch = arch_batch(cfg, LM_MESH_MOE_BATCH, LM_MESH_MOE_SEQ, "train", seed, device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        h0, _, aux0 = forward(model, cfg, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        place(model, param_shardings(model, mesh, cfg))
        with use_rules(ShardingRules(mesh)):
            t0 = time.perf_counter()
            h1, _, aux1 = forward(model, cfg, place(batch, batch_shardings(batch, mesh,
                                                                           LM_MESH_MOE_BATCH)))
            h1, aux1 = h1.full_tensor(), aux1.full_tensor()
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
    err = float((h1 - h0).abs().max())
    scale = float(h0.abs().max())
    out = {"arch": cfg.name, "params": cfg.param_count(), "tokens": [LM_MESH_MOE_BATCH,
                                                                     LM_MESH_MOE_SEQ],
           "moe_d_ff": cfg.moe_d_ff,
           "experts_tp_sharded": cfg.moe_d_ff // mesh_axis_sizes(mesh)["model"] >= 128,
           "h_max_abs_err": err, "h_max_abs": scale, "aux_plain": float(aux0),
           "aux_mesh": float(aux1), "tolerance": LM_MESH_MOE_TOL,
           "forward_s_plain": plain_s, "forward_s_mesh_first_call": mesh_s}
    tol = LM_MESH_MOE_TOL
    check(bool(torch.isfinite(h1).all()) and err <= tol["atol"] + tol["rtol"] * scale
          and abs(float(aux1) - float(aux0)) <= tol["atol"] + tol["rtol"] * abs(float(aux0)),
          f"granite-moe under the rules vs without: {out}")
    return out


def lm_mesh_mixtral(dev, mesh, cpu_mesh, seed: int) -> dict:
    """mixtral reduced (``moe_token_chunk=2``: capacity per token chunk under
    the rules) on the card's 1 x 1 mesh against the CPU's, same weights."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data import arch_batch
    from repro_torch.dist.context import ShardingRules, use_rules
    from repro_torch.launch.sharding import batch_shardings, param_shardings, place
    from repro_torch.models import forward, init_params

    cfg = get_config("mixtral-8x22b", reduced=True)
    cpu_model = init_params(cfg, seed, device="cpu")
    plain_h, _, _ = forward(cpu_model, cfg, arch_batch(cfg, 4, 32, "train", seed, device="cpu"))
    out = {"arch": cfg.name, "moe_token_chunk": cfg.moe_token_chunk}
    for name, m, d in (("cpu", cpu_mesh, "cpu"), ("card", mesh, dev)):
        model = place(copy.deepcopy(cpu_model).to(d), param_shardings(cpu_model, m, cfg))
        batch = arch_batch(cfg, 4, 32, "train", seed, device=d)
        with use_rules(ShardingRules(m)), torch.no_grad():
            h, _, aux = forward(model, cfg, place(batch, batch_shardings(batch, m, 4)))
            out[name] = (h.full_tensor().cpu(), float(aux.full_tensor()))
    (hc, ac), (hg, ag) = out.pop("cpu"), out.pop("card")
    out.update(h_max_abs_err=float((hg - hc).abs().max()), aux_cpu=ac, aux_card=ag,
               tolerance=LM_CPU_CARD_TOL,
               rules_vs_no_rules_max_abs=float((hc - plain_h).abs().max()))
    tol = LM_CPU_CARD_TOL
    check(torch.allclose(hg, hc, **tol) and abs(ag - ac) <= tol["atol"] + tol["rtol"] * abs(ac),
          f"mixtral reduced under the rules, card vs CPU: {out}")
    return out


def lm_mesh_launch(directory: str) -> dict:
    """``launch.train.main`` on the card's mesh path (the phase's group),
    reduced, 4 steps with checkpoints, then resumed to 6 through
    ``restore(..., shardings=)``."""
    import contextlib
    import io
    import signal

    from repro_torch.launch import train as launch_train

    argv = ["--arch", LM_ARCH, "--reduced", "--batch", "8", "--seq", "64",
            "--ckpt-dir", directory, "--ckpt-every", "2"]
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    outs = []
    try:
        for steps in (4, 6):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                launch_train.main(argv + ["--steps", str(steps)])
            outs.append((buf.getvalue().splitlines(), time.perf_counter() - t0))
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    (first, s1), (second, s2) = outs
    check(first[-1] == "[done]" and not any(ln.startswith("[resume]") for ln in first),
          f"first run: {first}")
    check(second[0] == f"[resume] restored step 4 from {directory}" and second[-1] == "[done]",
          f"second run did not resume from step 4: {second}")
    return {"first": first, "second": second, "seconds": [s1, s2]}


def phase_lm_mesh(dev, smi: str, seed: int, cfg=None) -> None:
    """The mesh path on one card: a one-rank group (NCCL for the card) and
    a 1 x 1 mesh, qwen3-1.7b at full width (``cfg``: another config, for a
    rehearsal) through the mesh step against the no-mesh step, granite-moe
    at full width, mixtral reduced card vs CPU, ``launch.train`` resumed;
    K1 / K2 launches read around the whole phase (it reaches neither)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not dist.is_initialized(), "a process group is left from an earlier phase")
    report = {"card": smi}
    zero_counts()
    try:
        mesh = make_host_mesh(device=dev)  # starts the one-rank group
        cpu_mesh = make_host_mesh(device="cpu")
        report["group"] = {"backend": str(dist.get_backend()), "world": dist.get_world_size(),
                           "mesh": mesh_axis_sizes(mesh), "device_type": mesh.device_type}
        check(dist.get_world_size() == 1 and mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
              and (dev.type != "cuda" or "nccl" in report["group"]["backend"]),
              f"the 1 x 1 mesh: {report['group']}")
        t0 = time.perf_counter()
        report["train"] = lm_mesh_train(dev, mesh, seed, cfg or get_config(LM_ARCH))
        report["train_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["moe"] = lm_mesh_moe(dev, mesh, seed, get_config("granite-moe-1b-a400m")
                                    if cfg is None else get_config("granite-moe-1b-a400m",
                                                                   reduced=True))
        report["moe_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        report["mixtral"] = lm_mesh_mixtral(dev, mesh, cpu_mesh, seed)
        with tempfile.TemporaryDirectory() as tmp:
            report["launch_train"] = lm_mesh_launch(os.path.join(tmp, "launch"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    counts = read_counts("lm_mesh")
    report["launch_counts"] = counts
    check(not any(counts.values()), f"the mesh path reaches no bitmap kernel: {counts}")
    emit("lm_mesh", **report)


# ---------------------------------------------------------------------------
# phase 21: the dry run (launch/dryrun, launch/hlo_analysis) on fake ranks
# ---------------------------------------------------------------------------

LM_DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "single"), ("qwen3-1.7b", "decode_32k", "single"),
                   ("mixtral-8x22b", "prefill_32k", "multi"))
LM_DRYRUN_PEAK_RTOL = 0.15  # target of the predicted peak of lm_train's step (reported)
LM_DRYRUN_MAX_ALLOC = 64 * 2**20  # the phase allocates nothing on the card: under this


def lm_dryrun_cell(arch: str, shape: str, mesh: str, dev, out_dir: str, card_bytes: int) -> dict:
    """One cell of the dry run on fake tensors of ``dev``: its record, read."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import run_cell

    rec = run_cell(arch, shape, mesh, out_dir, force=True, device=dev)
    check(not dist.is_initialized(), f"{arch} {shape} {mesh}: the fake group was left")
    check(rec["status"] == "OK", f"{arch} {shape} {mesh}: {rec.get('error')}\n"
                                 f"{rec.get('traceback', '')}")
    mem = rec["memory_analysis"]
    held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {"cell": f"{arch} {shape} {mesh}", "n_devices": rec["n_devices"],
            "mesh_shape": rec["mesh_shape"], "trace_s": rec["lower_s"],
            "dot_flops_per_device": rec["loop_aware"]["dot_flops"],
            "collective_bytes_per_device": rec["collectives"]["bytes"],
            "collective_counts": rec["collectives"]["counts"],
            "argument_gib": mem["argument_size_in_bytes"] / 2**30,
            "temp_gib": mem["temp_size_in_bytes"] / 2**30,
            "output_gib": mem["output_size_in_bytes"] / 2**30,
            "fits_on_card": held <= card_bytes, "ops": rec["loop_aware"]["n_computations"]}


def lm_dryrun_accounting(dev, seed: int, cfg, measured: dict) -> dict:
    """``lm_train``'s own step (float32, batch 8 x 128, the launch's
    ``OptConfig``, no mesh) on fake tensors under ``OpAccounting``: the
    predicted dot FLOPs and peak (the step's arguments plus the most bytes
    its storages held at once) beside what ``lm_train`` measured."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.launch.dryrun import _local_bytes
    from repro_torch.launch.hlo_analysis import OpAccounting
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    total = LM_TRAIN_STEPS + 7
    opt = OptConfig(peak_lr=LM_TRAIN_LR, warmup_steps=10, total_steps=total)
    dc = DataConfig(vocab=cfg.vocab, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, seed=seed)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = init_train_state(cfg, seed, device=dev)
        batch = lm_batch(dc, 0, dev)
        args = _local_bytes((state, batch))
        with OpAccounting() as acc:
            make_train_step(cfg, TrainConfig(opt=opt))(state, batch)
        del state, batch
    flops = acc.result()["dot_flops"]
    predicted = args + acc.peak_bytes
    out = {"seconds": time.perf_counter() - t0, "predicted_dot_flops": flops,
           "flop_counter_flops": measured["flop_counter_flops"],
           "argument_bytes": args, "temp_peak_bytes": acc.peak_bytes,
           "predicted_peak_bytes": predicted,
           "measured_peak_bytes": measured["max_memory_allocated"],
           "peak_rel_err": predicted / measured["max_memory_allocated"] - 1.0,
           "peak_rtol": LM_DRYRUN_PEAK_RTOL}
    # a miss of the peak's target is a reading to explain, not a failed run
    out["peak_within_target"] = abs(out["peak_rel_err"]) <= LM_DRYRUN_PEAK_RTOL
    check(flops == measured["flop_counter_flops"],
          f"predicted dot FLOPs {flops} vs FlopCounterMode {measured['flop_counter_flops']}")
    return out


def phase_lm_dryrun(dev, smi: str, seed: int, measured: dict, cells=LM_DRYRUN_CELLS,
                    cfg=None) -> None:
    """The dry run's production cells on fake CUDA tensors and fake ranks,
    then its accounting held to ``lm_train``'s real step (``measured``: the
    peak and FLOPs ``phase_lm_train`` returned; ``cfg``: another config, for
    a rehearsal)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config

    check(not dist.is_initialized(), "a process group is left from an earlier phase")
    report = {"card": smi, "torch": torch.__version__}
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.synchronize()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    alloc_before = torch.cuda.memory_allocated()
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        report["cells"] = [lm_dryrun_cell(a, s, m, dev, tmp, card_bytes) for a, s, m in cells]
    report["accounting"] = lm_dryrun_accounting(dev, seed, cfg or get_config(LM_ARCH), measured)
    counts = read_counts("lm_dryrun")
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - alloc_before
    report.update(launch_counts=counts, card_bytes=card_bytes,
                  max_memory_allocated_rise=rise, peak_before_phase=peak_before,
                  process_group_left=dist.is_initialized())
    emit("lm_dryrun", **report)
    check(not dist.is_initialized(), "the dry run left a process group")
    check(not any(counts.values()), f"the dry run reaches no bitmap kernel: {counts}")
    check(rise < LM_DRYRUN_MAX_ALLOC, f"the dry run allocated {rise} bytes on the card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-log2", type=int, default=27,
                    help="the dense path's index holds 2**this - 5 rows (default 27: 1 GiB)")
    ap.add_argument("--tiled-rows-log2", type=int, default=27,
                    help="the tiled path's index holds 2**this - 5 rows (default 27: 1 GiB)")
    ap.add_argument("--search-rows-log2", type=int, default=20,
                    help="the similarity index holds 2**this records (default 20)")
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
    cal = timed("calibration", phase_calibration, idx)
    timed("backends", phase_backends, idx)
    timed("serve", phase_serve, idx, cal, smi, args.seed)
    n_words_dense = idx.n_words
    del idx
    tidx, tqueries, tmany, tcounts = timed("tiled_path", phase_tiled_path, dev,
                                           args.tiled_rows_log2, args.columns, args.seed)
    thead = timed("tiled_timing", phase_tiled_timing, tidx, tqueries, tmany, args.reps)
    timed("backends_tiled", phase_backends_tiled, tidx)
    timed("obs", phase_obs, tidx)
    timed("sharded", phase_sharded, tidx, tqueries, tmany, smi, args.seed)
    stream, dense, squeries = timed("stream", phase_stream, tidx,
                                      tqueries["composite"], smi, args.seed)
    del tidx
    timed("persist", phase_persist, stream, dense, squeries, smi, args.seed)
    del dense
    timed("serve_stream", phase_serve_stream, stream, smi, args.seed)
    del stream
    timed("search", phase_search, dev, args.search_rows_log2, smi, args.seed)
    timed("lm_serve", phase_lm_serve, dev, smi, args.seed)
    lm_train_measured = timed("lm_train", phase_lm_train, dev, smi, args.seed)
    timed("lm_mesh", phase_lm_mesh, dev, smi, args.seed)
    timed("lm_dryrun", phase_lm_dryrun, dev, smi, args.seed, lm_train_measured)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port must not import jax or the reference package")

    # launches: the main paths' own windows; launches_by_phase: every window
    by_phase = {name: c for name, c in PHASE_LAUNCHES.items() if any(c.values())}
    emit("done", seconds_total=round(time.perf_counter() - t_start, 1), seconds=seconds)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "circuit_eval",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": counts["circuit_eval"],
        "launches_by_phase": {name: c["circuit_eval"] for name, c in by_phase.items()},
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
        "launches_by_phase": {name: c["tiled_block"] for name, c in by_phase.items()},
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
