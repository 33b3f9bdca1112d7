"""Single-scan tiled execution: the two device stages of ``tiled_fused``.

``storage.tiled``'s scan engine turns a query over a tile store into at
most two dispatches, both writing into one ``int32[k, n_sel, tile_words]``
buffer on the store's device that was seeded with each tile's
constant-fold value:

  * **Event stage** (:func:`event_runner`, torch ops) -- tiles whose
    residual inputs are ALL sparse/run containers: their boundary events
    (sorted once on the host, cached with the plan) are XOR-accumulated
    into input combinations, mapped through stacked per-group truth-table
    LUTs, and the value changes rasterized back to words by prefix-XOR --
    the device counterpart of
    :func:`repro_torch.storage.containers.evaluate_event_tiles`.  It
    replaces the reference's jitted XLA ``event_runner`` (no Pallas there):
    the XOR scan of one-hot wire masks is a per-wire ``cumsum & 1`` (at most
    ``_EV_MAX_INPUTS`` = 12 wires), the two forward fills are
    ``torch.cummax``, and the collision-free scatter is ``index_add_``.

  * **Block stage** (:func:`block_runner`) -- every other case-3 tile, in
    blocks of ``B`` tiles of one residual group.  On a CUDA tensor ONE
    launch of the hand-written kernel ``csrc/tiled_block.cu`` does all of
    it per block: stage the block's cell descriptors and the first rows of
    its group's program in shared memory, fill the clean input words by
    class, decode every other cell with one warp a cell straight into shared
    memory
    (dense rows by 16-byte ``cp.async``, sparse bits set by ``atomicOr``,
    run endpoints toggled by ``atomicXor`` and filled by a warp
    prefix-XOR), interpret the group's program from the program table
    (``core.bytecode.encode_program_table``) as the circuit kernel
    interprets its own, then store the ``k_max`` output rows to their
    tiles.  It replaces the reference's Pallas kernel ``_kernel``
    (``src/repro/kernels/tiled_scan.py``, ``block_runner`` ->
    ``_pallas_eval``) together with the XLA decode prologue and output
    scatter around it.  :func:`block_plain` is its plain version on the
    same plan arrays: what runs for tensors on the CPU, and what the kernel
    is compared with on the card.  On a CUDA tensor the wrapper launches
    the kernel or raises.

The plan arrays are the port's own: per-cell descriptors ``(kind, a, b)``
take the place of the reference's flattened take/cell/row triples, and
nothing is padded to powers of two (the reference pads to share jit
traces; results and every ``ExecInfo`` field are unchanged by it).
Words are ``int32`` with the reference's ``uint32`` bits: every logical
right shift is ``(x >> s) & mask``.

``launch_counts["tiled_block"]`` counts the block kernel's launches (and
nothing else).  With :mod:`repro_torch.obs` enabled, each stage also adds
to the reference's counters ``repro_kernel_launches_total{stage=block|
event}``, ``repro_kernel_decode_words_total`` and
``repro_kernel_event_toggles_total``, with the reference's values for the
same plan (:func:`reference_decode_words`; the reference counts its toggle
array padded to a power of two).
"""
from __future__ import annotations

import ctypes
import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.bytecode import (
    OP_COMMIT,
    OP_LOAD,
    OP_WAIT,
    ProgramTable,
    encode_program_table,
)
from repro_torch.device import WORD_DTYPE
from repro_torch.obs import REGISTRY as _OBS

from . import _build

__all__ = [
    "block_runner",
    "block_plain",
    "block_shared_bytes",
    "event_runner",
    "clear_scan_runners",
    "next_pow2",
    "pick_tile_block",
    "program_table",
    "launch_counts",
    "launch_shape",
    "BlockStage",
    "EventStage",
    "make_block_stage",
    "reference_decode_words",
]

#: launches of the block kernel since the count was last set to 0
#: (incremented only where the kernel is launched)
launch_counts = {"tiled_block": 0}

# dispatch accounting on the process registry (no-op until obs.enable()):
# stage dispatches per kind, words the decode stages, and event toggles
# merged -- the reference's names, labels and values
_LAUNCHES = _OBS.counter(
    "repro_kernel_launches_total", "Device kernel dispatches", ("stage",),
)
_DECODE_WORDS = _OBS.counter(
    "repro_kernel_decode_words_total",
    "Dense-equivalent words staged by the in-kernel container decode",
)
_EVENT_TOGGLES = _OBS.counter(
    "repro_kernel_event_toggles_total",
    "Boundary toggles merged by the event stage",
)
# label keys pre-bound once: the stages inc these per dispatch
_LAUNCH_BLOCK = _LAUNCHES.bind(stage="block")
_LAUNCH_EVENT = _LAUNCHES.bind(stage="event")
_DECODE_WORDS_B = _DECODE_WORDS.bind()
_EVENT_TOGGLES_B = _EVENT_TOGGLES.bind()

# the reference's block sizing (a TPU lane of 1024 words, 2 MiB of VMEM),
# kept only to count its decode words
_REF_LANE_WORDS = 1024
_REF_VMEM_BYTES = 2 * 1024 * 1024

# per-cell descriptor kinds of the block stage: (kind, a, b) per
# (block, wire, tile).  ZERO / ONE / DENSE read row ``a`` of the
# sentinel-extended dense pack (D / D + 1 for the clean classes); SPARSE and
# RUN decode payload entries ``[a, b)`` of their pack.
CELL_ZERO, CELL_ONE, CELL_DENSE, CELL_SPARSE, CELL_RUN = 0, 1, 2, 3, 4

#: shared memory one block may opt in to on an H100 (bytes); the plan sizes
#: its blocks against it, and the wrapper checks the card's own limit
SHARED_BYTES = 232_448
#: words of one residual row a block spans where a tile is narrower
BLOCK_WORDS = 256
#: rows of a group's program a block stages in shared memory; the kernel
#: reads the rows of a longer program past these from device memory
STAGED_ROWS = 256

# residual program tables, keyed by the circuits' structures and k_max
_PROGRAMS: OrderedDict = OrderedDict()
_PROGRAMS_CAP = 256


def clear_scan_runners() -> None:
    """Drop the cached program tables (wired into clear_compiled_cache)."""
    _PROGRAMS.clear()


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


def reference_decode_words(tile_words: int, m_max: int, k_max: int,
                           group_tiles) -> int:
    """The reference's ``repro_kernel_decode_words_total`` increment for a
    block stage: it counts every cell of its padded cell table, ``nb_pad *
    m_max * B * tile_words`` words, where ``B`` is its VMEM-sized tiles per
    block and ``nb_pad`` the power of two at or above its block count.  The
    port pads nothing (its ``B`` is sized for shared memory), so the count
    is reproduced from the plan's group sizes ``group_tiles``."""
    b = max(1, _REF_LANE_WORDS // tile_words)
    while b > 1 and (m_max + k_max) * b * tile_words * 8 > _REF_VMEM_BYTES:
        b //= 2
    b = max(1, min(b, next_pow2(max(group_tiles))))
    nb = sum(-(-int(g) // b) for g in group_tiles)
    return next_pow2(nb) * m_max * b * tile_words


def block_shared_bytes(B: int, tile_words: int, n_registers: int, m_max: int,
                       n_rows: int) -> int:
    """Dynamic shared memory of one block of the block kernel (bytes).

    The kernel's layout (``csrc/tiled_block.cu``, which counts the same and
    is held to this count when it loads): the block's cell descriptors
    (``m_max * B * 3`` int32, padded to 16 bytes), the first
    ``min(n_rows, STAGED_ROWS)`` rows of the group's program (16 bytes a
    row), the register file ``n_registers * B * tile_words`` words."""
    cells = (m_max * B * 3 * 4 + 15) // 16 * 16
    return cells + min(n_rows, STAGED_ROWS) * 16 + n_registers * B * tile_words * 4


def pick_tile_block(tile_words: int, table: ProgramTable, max_group_tiles: int,
                    shared_bytes: int = SHARED_BYTES) -> int:
    """Tiles per block of the block kernel for the groups of ``table``.

    A block spans ``BLOCK_WORDS`` words of each residual row (one per
    thread) where a tile is narrower, and holds the largest group's
    register file, cell descriptors and the first ``STAGED_ROWS`` rows of
    its program in shared memory (:func:`block_shared_bytes`); ``B`` halves
    until that fits and is never wider than the largest group needs.  (The reference's
    ``LANE_WORDS`` / 2 MiB VMEM sizing is the TPU's and is not used.)
    Raises ``ValueError`` when one tile per block does not fit.
    """
    n_regs = table.n_registers
    m_max = int(table.groups[:, 3].max()) if len(table.groups) else 0
    n_rows = int(table.groups[:, 1].max()) if len(table.groups) else 0

    def size(b):
        return block_shared_bytes(b, tile_words, n_regs, m_max, n_rows)

    b = max(1, BLOCK_WORDS // int(tile_words))
    b = min(b, next_pow2(max_group_tiles))
    while b > 1 and size(b) > shared_bytes:
        b //= 2
    if size(b) > shared_bytes:
        raise ValueError(
            f"residual program needs n_registers={n_regs} slots of {tile_words} words: "
            f"{size(b)} bytes of shared memory a block, {shared_bytes} allowed"
        )
    return b


def program_table(circuits: tuple, k_max: int) -> ProgramTable:
    """The (cached) preloaded program table of a tuple of residual circuits."""
    from repro_torch.kernels.threshold_ssum import circuit_structural_key

    key = (tuple(circuit_structural_key(c) for c in circuits), int(k_max))
    got = _PROGRAMS.get(key)
    if got is not None:
        _PROGRAMS.move_to_end(key)
        return got
    got = encode_program_table(circuits, k_max)
    if np.isin(got.prog[:, 0], (OP_LOAD, OP_COMMIT, OP_WAIT)).any():
        raise AssertionError("a preloaded residual program must not load rows")
    if len(_PROGRAMS) >= _PROGRAMS_CAP:
        _PROGRAMS.popitem(last=False)
    _PROGRAMS[key] = got
    return got


# ---------------------------------------------------------------------------
# shared torch-op helpers
# ---------------------------------------------------------------------------


def _bit(pos: torch.Tensor) -> torch.Tensor:
    """1 << (pos % 32) as int32 (bit 31 is -2**31)."""
    return torch.ones(pos.shape, dtype=WORD_DTYPE, device=pos.device) << (pos & 31).to(WORD_DTYPE)


def _prefix_xor_words(t: torch.Tensor) -> torch.Tensor:
    """Toggle masks int32[rows, tw + 1] -> filled words int32[rows, tw].

    Prefix-XOR within each word by doubling shifts, then carry the word
    parities across the row (a running sum mod 2); column ``tw`` catches
    toggles at the span boundary and is dropped.  ``>>`` is arithmetic on
    int32, so the parity is masked."""
    for sh in (1, 2, 4, 8, 16):
        t = t ^ (t << sh)
    par = (t >> 31) & 1
    cum = torch.cumsum(par, dim=1, dtype=WORD_DTYPE) & 1
    fill = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    t = t ^ -fill  # 0 or all ones
    return t[:, :-1]


def _concat_ranges(starts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Concatenated ``arange(starts[i], starts[i] + counts[i])`` (int64)."""
    total = int(counts.sum().item())
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=starts.device)
    cum0 = torch.cumsum(counts, 0) - counts
    return torch.repeat_interleave(starts - cum0, counts) + torch.arange(
        total, device=starts.device
    )


# ---------------------------------------------------------------------------
# event stage (torch ops)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EventStage:
    """Plan arrays of the event stage, on the store's device.

    * ``keys`` int64[e]: toggle sort keys ``row * (tw * 32 + 2) + pos``,
      sorted ascending on the host;
    * ``mask`` int32[e]: per-toggle wire bit ``1 << wire``, in key order;
    * ``gid_row`` int64[n_rows]: event-group ordinal per event row;
    * ``lut`` uint8[G * k_max * mm]: ``lut[(g * k_max + j) * mm + combo]``
      = output j of group g on input combination ``combo`` (entry 0 is the
      background, all inputs zero);
    * ``out_src`` / ``out_dst`` int64: row ``j * n_rows + row`` of the
      stage's ``[k_max * n_rows, tw]`` words, for every (output, event row)
      the row's group has, and the row of the flat ``[k * n_sel, tw]``
      buffer it goes to.
    """

    keys: torch.Tensor
    mask: torch.Tensor
    gid_row: torch.Tensor
    lut: torch.Tensor
    out_src: torch.Tensor
    out_dst: torch.Tensor
    k_max: int
    mm: int
    n_wires: int
    tw: int
    #: the reference's toggle count for this stage: its padded toggle array
    counted_toggles: int = 0


def event_runner(buf: torch.Tensor, st: EventStage) -> None:
    """Run the event stage into ``buf`` (int32[k, n_sel, tw], in place):
    every output of every event row at once, about thirty torch ops."""
    if _OBS.enabled:
        _LAUNCH_EVENT.inc(1)
        _EVENT_TOGGLES_B.inc(st.counted_toggles)
    tw, mm, k_max = st.tw, st.mm, st.k_max
    stride = tw * 32 + 2
    keys, mask, lut, gid_row = st.keys, st.mask, st.lut, st.gid_row
    dev = keys.device
    e = keys.numel()
    n_rows = gid_row.numel()
    # XOR scan of one-hot wire masks: bit w of the running XOR is the parity
    # of wire w's toggles so far
    wires = torch.arange(st.n_wires, dtype=WORD_DTYPE, device=dev)
    par = torch.cumsum((mask[:, None] >> wires) & 1, 0, dtype=WORD_DTYPE) & 1
    xacc = (par << wires).sum(1, dtype=WORD_DTYPE)
    rows_s = keys // stride
    pos_s = keys % stride
    iota = torch.arange(e, device=dev)
    prev_key = torch.cat([torch.full((1,), -1, dtype=keys.dtype, device=dev), keys[:-1]])
    starts = rows_s != torch.div(prev_key, stride, rounding_mode="floor")
    firsts = keys != prev_key
    lasts = torch.cat([keys[1:] != keys[:-1], torch.ones(1, dtype=torch.bool, device=dev)])
    pxa = torch.cat([torch.zeros(1, dtype=xacc.dtype, device=dev), xacc[:-1]])
    sidx = torch.cummax(torch.where(starts, iota, -1), 0).values
    # combo of the segment each event closes = running XOR minus the carry-in
    # from before this row (forward-filled row-start lookup)
    combo = ((xacc ^ pxa[sidx]) & (mm - 1)).to(torch.int64)
    fidx = torch.cummax(torch.where(firsts, iota, -1), 0).values
    outs = torch.arange(k_max, device=dev)[:, None]  # one row of work per output
    lb = (gid_row[rows_s][None, :] * k_max + outs) * mm  # [k_max, e]
    vals = lut[lb + combo]
    pv = torch.cat([torch.zeros((k_max, 1), dtype=lut.dtype, device=dev), vals[:, :-1]], dim=1)
    pv = torch.where(starts, lut[lb], pv)  # row start -> background
    # duplicate toggles at one position cancel: only the LAST event of a
    # (row, pos) run may toggle, and only if the value changed relative to
    # before the run
    tog = lasts & (vals != pv[:, fidx])
    t_size = n_rows * (tw + 1)
    tidx = torch.where(tog, outs * t_size + rows_s * (tw + 1) + pos_s // 32, k_max * t_size)
    tval = torch.where(tog, _bit(pos_s), 0)
    t = torch.zeros(k_max * t_size + 1, dtype=WORD_DTYPE, device=dev)
    t.index_add_(0, tidx.view(-1), tval.view(-1))
    words = _prefix_xor_words(t[:-1].view(k_max * n_rows, tw + 1))
    bg = lut[(gid_row[None, :] * k_max + outs) * mm].bool().view(-1, 1)
    words = torch.where(bg, ~words, words)
    buf.view(-1, tw)[st.out_dst] = words[st.out_src]


# ---------------------------------------------------------------------------
# block stage: the kernel's plain version and its wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockStage:
    """Plan arrays of the block stage, on the store's device.

    * ``gids`` int32[nb]: residual group of each block;
    * ``cells`` int32[nb, m_max, B, 3]: ``(kind, a, b)`` per residual input
      cell (``CELL_*``); wires at or past a group's ``m`` are not read;
    * ``dst`` int32[nb, k_max, B]: row of the flat ``[k * n_sel, tw]``
      output buffer each (output, tile) goes to, -1 for none;
    * ``table``: the program table, host numpy; ``prog`` / ``groups`` /
      ``outs`` are its tensors on the device;
    * ``packs``: the store's ``device_packs()``.
    """

    gids: torch.Tensor
    cells: torch.Tensor
    dst: torch.Tensor
    table: ProgramTable
    prog: torch.Tensor
    groups: torch.Tensor
    outs: torch.Tensor
    packs: tuple
    B: int
    tw: int
    #: the reference's decode-word count (:func:`reference_decode_words`)
    counted_decode_words: int = 0

    @property
    def n_blocks(self) -> int:
        return int(self.gids.shape[0])

    @property
    def m_max(self) -> int:
        return int(self.cells.shape[1])

    @property
    def k_max(self) -> int:
        return self.table.k_max


def make_block_stage(table: ProgramTable, gids: np.ndarray, cells: np.ndarray,
                     dst: np.ndarray, packs: tuple, B: int, tw: int,
                     counted_decode_words: int = 0) -> BlockStage:
    """A :class:`BlockStage` from host plan arrays, uploaded to the packs'
    device as contiguous int32."""
    dev = packs[0].device
    for name, a in (("cells", cells), ("dst", dst)):
        if a.size and (int(a.max()) >= 2**31 or int(a.min()) < -1):
            raise ValueError(f"tiled block plan: {name} exceeds int32 indexing")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    return BlockStage(
        gids=up(gids), cells=up(cells), dst=up(dst), table=table,
        prog=up(table.prog), groups=up(table.groups), outs=up(table.outs),
        packs=tuple(packs), B=int(B), tw=int(tw),
        counted_decode_words=int(counted_decode_words),
    )


def _decode_plain(st: BlockStage) -> torch.Tensor:
    """Decode every residual input cell: int32[nb, m_max, B * tw]."""
    dense1, sparse1, run1 = st.packs
    tw = st.tw
    cells = st.cells.view(-1, 3).to(torch.int64)
    kind, a, b = cells[:, 0], cells[:, 1], cells[:, 2]
    zero_row = dense1.shape[0] - 2
    x = dense1[torch.where(kind <= CELL_DENSE, a, zero_row)]  # [cells, tw]
    sp = torch.nonzero(kind == CELL_SPARSE).squeeze(1)
    if sp.numel():
        cnt = b[sp] - a[sp]
        pos = sparse1.to(torch.int64)[_concat_ranges(a[sp], cnt)]
        cell = torch.repeat_interleave(sp, cnt)
        # positions are distinct per cell: adding distinct bits is OR
        x.view(-1).index_add_(0, cell * tw + pos // 32, _bit(pos))
    rn = torch.nonzero(kind == CELL_RUN).squeeze(1)
    if rn.numel():
        cnt = b[rn] - a[rn]
        iv = run1.to(torch.int64)[_concat_ranges(a[rn], cnt)]
        row = torch.repeat_interleave(torch.arange(rn.numel(), device=x.device), cnt)
        t = torch.zeros(rn.numel() * (tw + 1), dtype=WORD_DTYPE, device=x.device)
        # maximal intervals: every endpoint of a cell is distinct
        t.index_add_(0, row * (tw + 1) + iv[:, 0] // 32, _bit(iv[:, 0]))
        t.index_add_(0, row * (tw + 1) + iv[:, 1] // 32, _bit(iv[:, 1]))
        x[rn] = _prefix_xor_words(t.view(-1, tw + 1))
    return x.view(st.n_blocks, st.m_max, st.B * tw)


def block_plain(buf: torch.Tensor, st: BlockStage) -> None:
    """The block kernel's plain version: decode, evaluate each block's group
    program with the plain interpreter, store to ``dst`` -- into ``buf``
    (int32[k, n_sel, tw], in place) on whatever device it lies."""
    from repro_torch.kernels.threshold_ssum import _run_program_plain

    tw, bw = st.tw, st.B * st.tw
    x = _decode_plain(st)
    ys = torch.zeros((st.n_blocks, st.k_max, bw), dtype=WORD_DTYPE, device=buf.device)
    gids = st.gids.to(torch.int64)
    for g in range(len(st.table.groups)):
        blocks = torch.nonzero(gids == g).squeeze(1)
        if not blocks.numel():
            continue
        prog, outs, n_regs, m = st.table.program(g)
        xs = x[blocks, :m].transpose(0, 1).reshape(m, -1)
        y = _run_program_plain(xs, prog, outs, n_regs, preloaded=True)
        ys[blocks] = y.view(st.k_max, blocks.numel(), bw).transpose(0, 1)
    d = st.dst.view(-1).to(torch.int64)
    valid = d >= 0
    buf.view(-1, tw)[d[valid]] = ys.view(-1, tw)[valid]


_LIB = None
_MAX_SHARED: dict[int, int] = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load_library("tiled_block")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tiled_block_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                           i, i, i, i, i, i, i, i, i, vp]
        lib.tiled_block_launch.restype = i
        lib.tiled_block_max_shared.argtypes = [i]
        lib.tiled_block_max_shared.restype = i
        lib.tiled_block_shared_bytes.argtypes = [i, i, i, i, i]
        lib.tiled_block_shared_bytes.restype = ll
        lib.tiled_block_error_string.argtypes = [i]
        lib.tiled_block_error_string.restype = ctypes.c_char_p
        for shape in ((1, 1, 1, 1, 0), (4, 64, 64, 64, 137), (32, 8, 5, 3, 300)):
            if lib.tiled_block_shared_bytes(shape[3], shape[0], shape[1], shape[2],
                                            shape[4]) != block_shared_bytes(*shape):
                raise RuntimeError("the kernel's shared-memory layout differs from "
                                   "tiled_scan.block_shared_bytes")
        _LIB = lib
    return _LIB


def _max_shared(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    got = _MAX_SHARED.get(idx)
    if got is None:
        got = _lib().tiled_block_max_shared(idx)
        if got <= 0:
            raise RuntimeError(f"cannot read the shared-memory limit of cuda:{idx}")
        _MAX_SHARED[idx] = got
    return got


def launch_shape(block_words: int) -> tuple:
    """(threads per block, words per thread) covering a block's row of
    ``block_words`` words: one word a thread (measured faster than two on an
    H100, see PERF.md), two where a row is wider than 1,024 threads (tiles
    of more than 1,024 words, one a block)."""
    vec = 1 if block_words <= 1024 else 2
    threads = -(-block_words // (32 * vec)) * 32
    if threads > 1024:
        raise ValueError(f"a block row of {block_words} words exceeds 2,048 words")
    return threads, vec


def _tiled_block_cuda(buf: torch.Tensor, st: BlockStage) -> None:
    """Launch the block kernel on ``buf``'s device and current stream."""
    if not buf.is_cuda or buf.dtype != WORD_DTYPE or not buf.is_contiguous():
        raise ValueError("the block kernel writes a contiguous int32 CUDA buffer")
    dense1, sparse1, run1 = st.packs
    arrays = (st.gids, st.cells, st.dst, st.prog, st.groups, st.outs, dense1, sparse1, run1)
    for t in arrays:
        if t.device != buf.device or not t.is_contiguous():
            raise ValueError("every plan array must be contiguous on the buffer's device")
    if dense1.dtype != WORD_DTYPE or sparse1.dtype != torch.uint16 or run1.dtype != torch.uint16:
        raise TypeError("packs must be int32 (dense) and uint16 (sparse, run)")
    lib = _lib()
    dev = buf.device
    n_regs, m_max = st.table.n_registers, st.m_max
    n_rows = int(st.table.groups[:, 1].max()) if len(st.table.groups) else 0
    threads, vec = launch_shape(st.B * st.tw)
    smem = block_shared_bytes(st.B, st.tw, n_regs, m_max, n_rows)
    if smem > _max_shared(dev):
        raise ValueError(
            f"block of {st.B} tiles x {st.tw} words with n_registers={n_regs}, m_max={m_max} "
            f"and {n_rows} program rows needs {smem} bytes of shared memory; cuda:{dev.index} "
            f"allows {_max_shared(dev)}"
        )
    with torch.cuda.device(dev):
        code = lib.tiled_block_launch(
            buf.data_ptr(), st.gids.data_ptr(), st.cells.data_ptr(), st.dst.data_ptr(),
            st.prog.data_ptr(), st.groups.data_ptr(), st.outs.data_ptr(),
            dense1.data_ptr(), sparse1.data_ptr(), run1.data_ptr(),
            st.n_blocks, m_max, st.B, st.tw, st.k_max, n_regs, n_rows, threads, vec,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"tiled_block launch failed: {lib.tiled_block_error_string(code).decode()} "
            f"(blocks={st.n_blocks}, B={st.B}, tw={st.tw}, n_registers={n_regs}, "
            f"threads={threads}, words_per_thread={vec}, shared={smem})"
        )
    launch_counts["tiled_block"] += 1


def block_runner(buf: torch.Tensor, st: BlockStage) -> None:
    """The block stage where ``buf`` lies: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if _OBS.enabled:
        _LAUNCH_BLOCK.inc(1)
        _DECODE_WORDS_B.inc(st.counted_decode_words)
    if buf.is_cuda:
        _tiled_block_cuda(buf, st)
    else:
        block_plain(buf, st)
