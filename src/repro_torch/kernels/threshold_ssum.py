"""Fused circuit evaluation over packed bitmaps (CUDA, Hopper target).

The paper's circuit algorithms are "horizontal": W bits of every input are
combined into W output bits using ~5N bitwise ops (4.4.3).  Evaluated gate
by gate as tensor ops, every intermediate bit-plane round-trips through
device memory -- ~5N extra bitmap reads and writes.  The fused kernel reads
each of the N input rows once, keeps every intermediate on chip, and writes
the ``k`` output rows once, so its traffic is the ``(N + k) * n_words``
words the function has to move: it is bound by bytes, not by operations.

**The kernel** (``csrc/circuit_eval.cu``) replaces the reference's Pallas
kernel ``_circuit_kernel`` (``src/repro/kernels/threshold_ssum.py``, called
by ``run_circuit_pallas``).  The reference traces one kernel per circuit;
here ONE kernel interprets the register-allocated byte code of
``core.bytecode`` (the paper's 4.4.4), because a circuit is a function of
the query and a compiler run per query is not affordable.  Each thread owns
up to four consecutive word columns, the program's register file lives in
shared memory as ``[n_registers][threads][columns]`` (one 16-byte access an
operand, bank-conflict free), input rows enter it through the program's
``LOAD`` instructions as asynchronous copies (16 bytes where rows are
aligned) scheduled a batch ahead of the gates that use them (by row index
and row stride, so member subsets and strided views are not copied), and
the ragged end of the word axis is masked in the kernel (no padded copy of
the input).

**The plain version**, :func:`run_circuit_plain`, executes the same encoded
program over whole rows with torch ops.  It is what runs for tensors on the
CPU, and what the kernel is compared with on the card.  On a CUDA tensor
the wrappers launch the kernel or raise; they never give way to the plain
version.

``launch_counts["circuit_eval"]`` counts the kernel's launches (and nothing
else), so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import circuits as _ckt
from repro_torch.core.bytecode import (
    OP_CONST,
    OP_EXT,
    OP_FA,
    OP_LOAD,
    OP_MAJ,
    PROG_CHUNK,
    compile_circuit,
    encode_program,
)
from repro_torch.device import WORD_DTYPE, resolve_device, to_words

from . import _build

__all__ = [
    "run_circuit",
    "run_circuit_cached",
    "run_circuit_plain",
    "circuit_structural_key",
    "clear_circuit_runners",
    "threshold_fused",
    "launch_counts",
    "pick_launch_shape",
    "SHAPE_PREFERENCE",
    "THREAD_CHOICES",
]

#: launches of each hand-written kernel of this module since the count was
#: last set to 0 (incremented only where the kernel is launched)
launch_counts = {"circuit_eval": 0}

#: (word columns a thread, fewest threads a block) in the order the wrapper
#: tries them; the kernel is built for these column counts
SHAPE_PREFERENCE = ((4, 128), (2, 128), (1, 32))
#: threads per block the wrapper picks from, largest first
THREAD_CHOICES = (256, 128, 64, 32)

# ---------------------------------------------------------------------------
# Structural program cache: circuits are a function of the query (and, on
# the tiled route, of the data), so the encoded program is cached by the
# circuit's structure and uploaded to a device once.
# ---------------------------------------------------------------------------

_CIRCUIT_RUNNERS: dict[tuple, "_Program"] = {}
_CIRCUIT_RUNNERS_CAP = 1024  # residual circuits are data-dependent; bound them


def clear_circuit_runners() -> None:
    """Drop the structural program cache (wired into query.clear_compiled_cache)."""
    _CIRCUIT_RUNNERS.clear()


def circuit_structural_key(circuit: _ckt.Circuit) -> tuple:
    """Hashable identity of a gate DAG (used to cache encoded programs)."""
    return (circuit.n_inputs, tuple(circuit.ops), tuple(circuit.outputs))


class _Program:
    """One encoded program: host arrays plus their per-device tensors."""

    def __init__(self, circuit: _ckt.Circuit, rows):
        bc = compile_circuit(circuit)
        # with `rows`, input i of the circuit reads row rows[i] of the matrix
        self.prog, self.outs = encode_program(bc, rows)
        self.n_registers = bc.n_registers
        self.n_loads = len(bc.loaded_inputs)
        self.n_fused = bc.n_fused
        self.k = len(self.outs)
        self._on_device: dict = {}

    def tensors(self, device: torch.device):
        got = self._on_device.get(device)
        if got is None:
            got = (
                torch.from_numpy(self.prog).to(device).contiguous(),
                torch.from_numpy(self.outs).to(device).contiguous(),
            )
            self._on_device[device] = got
        return got


def _program_for(circuit: _ckt.Circuit, rows) -> _Program:
    key = (circuit_structural_key(circuit), rows)
    p = _CIRCUIT_RUNNERS.get(key)
    if p is None:
        if len(_CIRCUIT_RUNNERS) >= _CIRCUIT_RUNNERS_CAP:
            _CIRCUIT_RUNNERS.clear()
        p = _CIRCUIT_RUNNERS[key] = _Program(circuit, rows)
    return p


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _run_program_plain(bitmaps: torch.Tensor, prog, outs, n_registers: int, *,
                       preloaded: bool = False) -> torch.Tensor:
    """Execute an encoded program over whole int32 rows with torch ops.

    The one plain interpreter of both kernels: a K1 program
    (``_Program``) reads its inputs through ``LOAD``; a tiled block program
    (``core.bytecode.encode_program_table``) is ``preloaded``: row ``i`` of
    ``bitmaps`` starts in slot ``i``.  Returns ``int32[len(outs), n_words]``.
    """
    n_words = bitmaps.shape[1]
    regs: list = [None] * n_registers
    if preloaded:
        regs[: bitmaps.shape[0]] = list(bitmaps)

    prog = prog.tolist()
    i = 0
    while i < len(prog):
        op, dst, a, b = prog[i]
        i += 1
        if op in (OP_FA, OP_MAJ):
            ext, dst_carry, c, _ = prog[i]
            assert ext == OP_EXT
            i += 1
            va, vb, vc = regs[a], regs[b], regs[c]
            half = va ^ vb
            carry = (va & vb) | (vc & half)
            if op == OP_FA:
                regs[dst] = half ^ vc
                regs[dst_carry] = carry
            else:
                regs[dst] = carry
        elif op == OP_LOAD:
            regs[dst] = bitmaps[a]
        elif op == OP_CONST:
            regs[dst] = torch.full((n_words,), a, dtype=WORD_DTYPE, device=bitmaps.device)
        elif op > OP_LOAD:
            pass  # COMMIT / WAIT / NOP order the kernel's asynchronous copies only
        elif op == 0:
            regs[dst] = regs[a] & regs[b]
        elif op == 1:
            regs[dst] = regs[a] | regs[b]
        elif op == 2:
            regs[dst] = regs[a] ^ regs[b]
        else:
            regs[dst] = regs[a] & ~regs[b]
    return torch.stack([regs[s] for s in outs.tolist()])


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_LIB = None
_MAX_SHARED: dict[int, int] = {}


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _build.LOCK:
        if _LIB is not None:  # bound by another thread while this one waited
            return _LIB
        lib = _build.load_library("circuit_eval")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.circuit_eval_launch.argtypes = [vp, ll, ll, vp, i, vp, i, vp, ll, i, i, i, vp]
        lib.circuit_eval_launch.restype = i
        lib.circuit_eval_max_shared.argtypes = [i]
        lib.circuit_eval_max_shared.restype = i
        lib.circuit_eval_program_bytes.argtypes = []
        lib.circuit_eval_program_bytes.restype = i
        lib.circuit_eval_error_string.argtypes = [i]
        lib.circuit_eval_error_string.restype = ctypes.c_char_p
        if lib.circuit_eval_program_bytes() != PROG_CHUNK * 16:
            raise RuntimeError("the kernel's program chunk differs from core.bytecode.PROG_CHUNK")
        _LIB = lib
    return _LIB


def _max_shared(device: torch.device) -> int:
    """Bytes of shared memory a block may spend on its register file."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    got = _MAX_SHARED.get(idx)
    if got is None:
        got = _lib().circuit_eval_max_shared(idx)
        if got <= 0:
            raise RuntimeError(f"cannot read the shared-memory limit of cuda:{idx}")
        # what is left for the register file beside the staged program chunk
        got -= _lib().circuit_eval_program_bytes()
        _MAX_SHARED[idx] = got
    return got


def pick_launch_shape(n_registers: int, max_shared: int) -> tuple:
    """(threads per block, word columns per thread) whose register file
    ``n_registers * columns * threads * 4`` bytes fits ``max_shared``.

    More columns a thread amortise the interpreter's decode, address
    arithmetic and load/store instructions over more words (measured faster
    on an H100, PERF.md): the most columns a thread are kept while at least
    ``floor`` threads still fit (``SHAPE_PREFERENCE``), then the most
    threads of ``THREAD_CHOICES``.  Raises ``ValueError`` when even 32
    threads of one column do not fit.
    """
    for vec, floor in SHAPE_PREFERENCE:
        for threads in THREAD_CHOICES:
            if threads >= floor and n_registers * vec * threads * 4 <= max_shared:
                return threads, vec
    raise ValueError(
        f"circuit needs n_registers={n_registers} live registers: "
        f"{n_registers * 32 * 4} bytes of shared memory for 32 threads exceed "
        f"the device's {max_shared} bytes per block"
    )


def _circuit_eval_cuda(bitmaps: torch.Tensor, p: _Program) -> torch.Tensor:
    """Launch the circuit-program kernel on ``bitmaps``' device and stream."""
    if not bitmaps.is_cuda:
        raise ValueError("the CUDA kernel needs a CUDA tensor")
    if bitmaps.dtype != WORD_DTYPE:
        raise TypeError(f"packed words must be int32, got {bitmaps.dtype}")
    if bitmaps.dim() != 2:
        raise ValueError(f"expected int32[N, n_words], got shape {tuple(bitmaps.shape)}")
    n_words = bitmaps.shape[1]
    if n_words > 1 and bitmaps.stride(1) != 1:
        raise ValueError("the word axis must be contiguous (stride 1); rows may be strided")
    lib = _lib()
    dev = bitmaps.device
    threads, vec = pick_launch_shape(p.n_registers, _max_shared(dev))
    out = torch.empty((p.k, n_words), dtype=WORD_DTYPE, device=dev)
    if n_words == 0:
        return out
    with torch.cuda.device(dev):
        prog, outs = p.tensors(dev)
        code = lib.circuit_eval_launch(
            bitmaps.data_ptr(), bitmaps.stride(0) if bitmaps.shape[0] > 1 else n_words,
            n_words, prog.data_ptr(), prog.shape[0], outs.data_ptr(), p.k,
            out.data_ptr(), out.stride(0), p.n_registers, threads, vec,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            "circuit_eval launch failed: "
            f"{lib.circuit_eval_error_string(code).decode()} (n_registers={p.n_registers}, "
            f"threads={threads}, words_per_thread={vec}, n_words={n_words})"
        )
    launch_counts["circuit_eval"] += 1
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check(bitmaps: torch.Tensor, circuit: _ckt.Circuit, rows):
    if bitmaps.dim() != 2:
        raise ValueError(f"expected int32[N, n_words], got shape {tuple(bitmaps.shape)}")
    if rows is not None:
        rows = tuple(int(r) for r in rows)
        if any(not 0 <= r < bitmaps.shape[0] for r in rows):
            raise ValueError(f"rows {rows} outside [0, {bitmaps.shape[0]})")
    n = bitmaps.shape[0] if rows is None else len(rows)
    if circuit.n_inputs != n:
        raise ValueError(f"circuit has {circuit.n_inputs} inputs, bitmaps {n}")
    return rows


def run_circuit_cached(bitmaps: torch.Tensor, circuit: _ckt.Circuit, *, rows=None,
                       block_words: int | None = None) -> torch.Tensor:
    """Evaluate ``circuit`` over an int32 word tensor where the tensor lies:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.

    ``rows`` (optional slots into ``bitmaps``' first axis) makes input ``i``
    of the circuit read row ``rows[i]``, so a member subset needs no gather.
    The encoded program is cached by circuit structure.  ``block_words`` is
    accepted for parity with the reference's call sites and unused: the
    kernel sizes its blocks from the program's register count.  Returns
    ``int32[n_words]`` for a single-output circuit, ``int32[k, n_words]``
    otherwise.
    """
    del block_words
    rows = _check(bitmaps, circuit, rows)
    p = _program_for(circuit, rows)
    if bitmaps.is_cuda:
        out = _circuit_eval_cuda(bitmaps, p)
    else:
        out = _run_program_plain(bitmaps, p.prog, p.outs, p.n_registers)
    return out[0] if p.k == 1 else out


def run_circuit_plain(bitmaps: torch.Tensor, circuit: _ckt.Circuit, *, rows=None) -> torch.Tensor:
    """The kernel's plain version: the same encoded program, executed over
    whole rows with torch ops on whatever device ``bitmaps`` lies."""
    rows = _check(bitmaps, circuit, rows)
    p = _program_for(circuit, rows)
    out = _run_program_plain(bitmaps, p.prog, p.outs, p.n_registers)
    return out[0] if p.k == 1 else out


def run_circuit(bitmaps, circuit: _ckt.Circuit, *, rows=None, device=None,
                block_words: int | None = None) -> torch.Tensor:
    """Entry point: evaluate an arbitrary (multi-output) circuit fused.

    ``bitmaps`` is ``int32[N, n_words]`` (or numpy ``uint32``) with
    ``N == circuit.n_inputs``; it is moved to ``device`` (default: the CUDA
    card, see :func:`repro_torch.device.resolve_device`).  One sweep writes
    every output while the inputs are on chip, so ``k`` queries cost one
    pass over the inputs, not ``k``.
    """
    words = to_words(bitmaps, resolve_device(device))
    return run_circuit_cached(words, circuit, rows=rows, block_words=block_words)


def threshold_fused(bitmaps, t: int | None = None, *, truth: tuple | None = None,
                    weights: tuple | None = None, kind: str = "ssum", device=None,
                    block_words: int | None = None) -> torch.Tensor:
    """theta(T, .) fused; ``truth`` selects an arbitrary symmetric function,
    ``weights`` a weighted threshold (binary-decomposed circuit).

    bitmaps: int32[N, n_words].  Returns int32[n_words].
    """
    words = to_words(bitmaps, resolve_device(device))
    n, n_words = words.shape
    if weights is not None:
        from repro_torch.core.weighted import build_weighted_threshold_circuit

        assert t is not None and len(weights) == n
        circuit = build_weighted_threshold_circuit(list(weights), t)
    elif truth is not None:
        circuit = _ckt.build_symmetric_circuit(n, list(truth), kind)
    else:
        assert t is not None
        if t <= 0:
            return torch.full((n_words,), -1, dtype=WORD_DTYPE, device=words.device)
        if t > n:
            return torch.zeros((n_words,), dtype=WORD_DTYPE, device=words.device)
        circuit = _ckt.build_threshold_circuit(n, t, kind)
    return run_circuit_cached(words, circuit, block_words=block_words)
