"""Per-device accounting of one step (the port of ``repro.launch.hlo_analysis``).

Two ways to the same dict (``dot_flops``, ``collective_bytes``,
``collective_total``, ``collective_counts``, ``hbm_traffic_proxy``,
``n_computations``), all per device:

* :func:`analyze_hlo` / :class:`HloModule` -- the reference's loop-aware
  reading of post-optimisation HLO text, copied unchanged.  XLA's
  ``compiled.cost_analysis()`` counts a while-loop body ONCE, so it builds
  the computation call graph (while bodies with static trip counts taken
  from their condition computations, fusions, calls) and accumulates with
  loop multipliers:

  * dot FLOPs: 2 x |output| x contraction size per ``dot`` op
  * collective bytes by kind (all-reduce / all-gather / reduce-scatter /
    all-to-all / collective-permute), output-shape sized
  * an HBM-traffic proxy: sum of output bytes x 2 over non-trivial ops

  Elementwise FLOPs are not counted.  The numbers are per device because
  the module is partitioned.

* :class:`OpAccounting` -- the port emits no HLO: a ``TorchDispatchMode``
  watches one eager step and counts the ops each rank runs.  Under DTensor
  it lets the DTensor dispatch first (as ``CommDebugMode`` does), so it
  sees the local ops on the local shapes and the collectives a
  redistribute sends, never the global op.  Rules:

  * dot FLOPs: 2 x |output| x K for every ``mm`` / ``bmm`` / ``addmm`` /
    ``baddbmm`` / ``mv`` / ``dot`` (``matmul`` and ``einsum`` reach the
    dispatcher as these);
  * collective bytes, output-shape sized: ``all_reduce`` (functional, and
    ``c10d.allreduce_`` from ``dist.context.psum``) as all-reduce,
    ``all_gather_into_tensor`` as all-gather, ``reduce_scatter_tensor`` as
    reduce-scatter, ``all_to_all_single`` as all-to-all, a point-to-point
    receive (``dist.context.ring_shift``) as collective-permute;
  * the traffic proxy: 2 x the output bytes of every op that is not a view
    (eager torch fuses nothing, so it counts what XLA keeps in fusions);
  * ``n_computations``: the number of ops seen.

  No loop multipliers: the port runs its layers one by one, so every layer
  is counted where it runs.  It also follows the bytes of the storages the
  step makes (``peak_bytes``: the largest sum alive at once; a storage is
  alive until the last tensor on it is freed, saved activations included),
  which the dry run reads as its temporary memory.
"""
from __future__ import annotations

import functools
import re
import threading
import weakref
from collections import Counter, defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s4": 1, "u4": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "token": 0, "f8e4m3fn": 1, "f8e5m2": 1,
}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_TRIVIAL = ("parameter", "constant", "get-tuple-element", "tuple", "bitcast",
            "after-all", "iota")

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\(?[^=]*?\)?)\s*([\w\-]+)\(")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->")


def _split_params(params: str) -> list[str]:
    """Split a parameter list on top-level commas (tuple types nest parens)."""
    out, depth, cur = [], 0, []
    for ch in params:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _shape_info(sig: str):
    """All (dtype, dims) in a type signature; returns list and total bytes."""
    shapes = []
    for dt, dims in _SHAPE_RE.findall(sig):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        shapes.append((dt, dims, n))
    byts = sum(n * _DTYPE_BYTES[dt] for dt, _, n in shapes)
    return shapes, byts


class HloModule:
    def __init__(self, text: str):
        self.comps: dict[str, list[str]] = {}
        self.entry: str | None = None
        cur, buf = None, []
        for line in text.splitlines():
            m = _COMP_RE.match(line.strip())
            if m and line.rstrip().endswith("{"):
                cur = m.group(1)
                self.comps[cur] = buf = [line]
                if line.strip().startswith("ENTRY"):
                    self.entry = cur
            elif cur is not None:
                buf.append(line)
                if line.strip() == "}":
                    cur = None
        if self.entry is None and self.comps:
            # entry is typically the last computation in the dump
            self.entry = list(self.comps)[-1]
        self._shapes_cache: dict[str, dict[str, str]] = {}

    # -- per-computation symbol table -----------------------------------
    def shapes(self, comp: str) -> dict[str, str]:
        if comp in self._shapes_cache:
            return self._shapes_cache[comp]
        table: dict[str, str] = {}
        lines = self.comps[comp]
        # parameters from the signature
        m = _COMP_RE.match(lines[0].strip().removeprefix("ENTRY "))
        if m:
            for part in _split_params(m.group(2)):
                part = part.strip()
                if ":" in part:
                    nm, ty = part.split(":", 1)
                    table[nm.strip().lstrip("%")] = ty.strip()
        for line in lines[1:]:
            om = _OP_RE.match(line)
            if om:
                table[om.group(1)] = om.group(2)
        self._shapes_cache[comp] = table
        return table

    def _trip_count(self, cond_comp: str) -> int:
        """Largest s32 constant in the condition computation (+fusions)."""
        best = 1
        seen = {cond_comp}
        stack = [cond_comp]
        while stack:
            c = stack.pop()
            for line in self.comps.get(c, []):
                for m in re.finditer(r"constant\((\d+)\)", line):
                    best = max(best, int(m.group(1)))
                cm = re.search(r"calls=%?([\w.\-]+)", line)
                if cm and cm.group(1) not in seen:
                    seen.add(cm.group(1))
                    stack.append(cm.group(1))
        return best

    # -- accounting -------------------------------------------------------
    def _edges(self) -> list[tuple[str, str, int]]:
        """(caller, callee, factor) edges of the computation call graph."""
        edges = []
        self.fusion_bodies: set[str] = set()
        for comp, lines in self.comps.items():
            for line in lines:
                om = _OP_RE.match(line)
                if om and om.group(3) in ("fusion", "reduce", "map", "sort",
                                          "reduce-window", "scatter", "select-and-scatter"):
                    fm = re.search(r"(?:calls|to_apply)=%?([\w.\-]+)", line)
                    if fm:
                        self.fusion_bodies.add(fm.group(1))
                wm = re.search(r"while\(.*condition=%?([\w.\-]+), body=%?([\w.\-]+)",
                               line)
                if wm:
                    cond, body = wm.groups()
                    trips = self._trip_count(cond)
                    edges.append((comp, body, trips))
                    edges.append((comp, cond, trips + 1))
                    continue
                for pat in (r"calls=%?([\w.\-]+)", r"to_apply=%?([\w.\-]+)",
                            r"true_computation=%?([\w.\-]+)",
                            r"false_computation=%?([\w.\-]+)",
                            r"branch_computations=\{%?([\w.\-]+)"):
                    for cm in re.finditer(pat, line):
                        edges.append((comp, cm.group(1), 1))
        return edges

    def analyze(self) -> dict:
        edges = self._edges()
        mult: dict[str, float] = defaultdict(float)
        mult[self.entry] = 1.0
        # fixpoint relaxation over the DAG (converges in <= depth passes)
        for _ in range(64):
            new: dict[str, float] = defaultdict(float)
            new[self.entry] = 1.0
            for caller, callee, f in edges:
                new[callee] += mult.get(caller, 0.0) * f
            if dict(new) == dict(mult):
                break
            mult = new

        flops = 0.0
        coll = {k: 0.0 for k in _COLLECTIVES}
        coll_counts = {k: 0.0 for k in _COLLECTIVES}
        traffic = 0.0
        for comp, m in mult.items():
            if m <= 0 or comp not in self.comps:
                continue
            table = self.shapes(comp)
            for line in self.comps[comp]:
                om = _OP_RE.match(line)
                if not om:
                    continue
                name, sig, op = om.groups()
                shapes, byts = _shape_info(sig)
                # fusion bodies execute in registers/VMEM: only the fusion
                # op's own output (counted in the caller) touches HBM
                if op not in _TRIVIAL and byts and comp not in self.fusion_bodies:
                    traffic += 2.0 * byts * m
                if op == "dot":
                    args = re.search(r"dot\(([^)]*)\)", line)
                    argstr = args.group(1) if args else ""
                    # modern XLA prints typed operands inline
                    # (dot(f32[64,64]{1,0} %x, ...)): first shape = lhs
                    lhs_shapes, _ = _shape_info(argstr)
                    if not lhs_shapes:  # bare %name operands: symbol table
                        lhs = argstr.split(",")[0].strip().lstrip("%")
                        lhs_shapes, _ = _shape_info(table.get(lhs, ""))
                    cdims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line)
                    k = 1
                    if lhs_shapes and cdims:
                        dims = [int(x) for x in lhs_shapes[0][1].split(",") if x]
                        for ci in cdims.group(1).split(","):
                            if ci and int(ci) < len(dims):
                                k *= dims[int(ci)]
                    out_elems = sum(n for _, _, n in shapes)
                    flops += 2.0 * out_elems * k * m
                elif op.rstrip("-start") in _COLLECTIVES or op in _COLLECTIVES:
                    kind = op[:-6] if op.endswith("-start") else op
                    if kind in _COLLECTIVES:
                        coll[kind] += byts * m
                        coll_counts[kind] += m
        return {
            "dot_flops": flops,
            "collective_bytes": coll,
            "collective_total": sum(coll.values()),
            "collective_counts": coll_counts,
            "hbm_traffic_proxy": traffic,
            "n_computations": len(self.comps),
        }


def analyze_hlo(text: str) -> dict:
    return HloModule(text).analyze()


# ---------------------------------------------------------------------------
# the port's own accounting: one eager step under a dispatch mode
# ---------------------------------------------------------------------------

_DOT_OPS = {
    "aten::mm": 0, "aten::bmm": 0, "aten::addmm": 1, "aten::baddbmm": 1, "aten::mv": 0,
    "aten::dot": 0,
}  # op -> index of the left operand, whose last dimension is contracted
_COLLECTIVE_OPS = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "c10d::allreduce_": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::recv_": "collective-permute",
}


# DTensor derives an op's global output shape by running the op on fake
# tensors of the global shapes (``ShardingPropagator._propagate_tensor_meta_non_cached``,
# on a cache miss); those runs compute nothing of the step and are not counted
_SHADOW = threading.local()
_PATCHES = {"depth": 0, "original": None}
_PATCH_LOCK = threading.Lock()


def _in_shadow(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        depth = getattr(_SHADOW, "depth", 0)
        _SHADOW.depth = depth + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _SHADOW.depth = depth

    return run


def _hold_shadow() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    with _PATCH_LOCK:
        if _PATCHES["depth"] == 0:
            _PATCHES["original"] = ShardingPropagator._propagate_tensor_meta_non_cached
            ShardingPropagator._propagate_tensor_meta_non_cached = _in_shadow(
                _PATCHES["original"])
        _PATCHES["depth"] += 1


def _release_shadow() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    with _PATCH_LOCK:
        _PATCHES["depth"] -= 1
        if _PATCHES["depth"] == 0:
            ShardingPropagator._propagate_tensor_meta_non_cached = _PATCHES["original"]


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class OpAccounting(TorchDispatchMode):
    """A ``TorchDispatchMode`` that counts the ops one rank runs (use it as
    a context manager around a step); :meth:`result` is the dict of
    :func:`analyze_hlo`.  ``peak_bytes`` is the most bytes that the
    storages made inside it held at once (an op writing in place, or a
    view, makes none); ``dots`` counts the products by ``(op, output
    elements, K)``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.traffic = 0
        self.n_ops = 0
        self.dots = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()
        self._lock = threading.Lock()  # the backward pass may run on another thread

    def __enter__(self):
        _hold_shadow()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _release_shadow()

    def _freed(self, n: int) -> None:
        with self._lock:
            self.live_bytes -= n

    def _track(self, outs, args) -> None:
        inputs = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in outs:
            st = t.untyped_storage()
            with self._lock:
                if st._cdata in inputs or st in self._seen:
                    continue
                self._seen.add(st)
                n = st.nbytes()
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches: its local ops come back here
        out = func(*args, **kwargs)
        name = func._schema.name
        if getattr(_SHADOW, "depth", 0) or name.startswith("prim::"):
            return out  # DTensor's shape propagation, or a query of metadata
        outs = _tensors(out)
        self.n_ops += 1
        if name in _DOT_OPS:
            k = args[_DOT_OPS[name]].shape[-1]
            self.flops += 2 * outs[0].numel() * k
            self.dots[(name, outs[0].numel(), k)] += 1
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            # a c10d op works on the tensors of its first argument (its outputs)
            moved = _tensors(args[0]) if name.startswith("c10d::") else outs
            self.coll[kind] += _nbytes(moved)
            self.coll_counts[kind] += 1
        if not func.is_view:
            self.traffic += 2 * _nbytes(outs)
            self._track(outs, (args, kwargs))
        return out

    def result(self) -> dict:
        return {
            "dot_flops": float(self.flops),
            "collective_bytes": {k: float(v) for k, v in self.coll.items()},
            "collective_total": float(sum(self.coll.values())),
            "collective_counts": {k: float(v) for k, v in self.coll_counts.items()},
            "hbm_traffic_proxy": float(self.traffic),
            "n_computations": self.n_ops,
        }
