"""Logical-axis sharding context (the port of ``repro.dist.context``).

Model code calls ``constrain(x, "batch", None, "heads", None)`` with
*logical* axis names; the active :class:`ShardingRules` (installed with
``use_rules``) maps them to the axes of a ``DeviceMesh`` and redistributes
a ``DTensor`` to those placements -- the counterpart of the reference's
``with_sharding_constraint``.  With no rules installed, or on a plain
tensor, every call is the identity, so the same code runs unsharded in
unit tests and sharded under a mesh.

DTensor takes the part of GSPMD: model parameters placed by
``launch.sharding`` are DTensors, every op propagates their placements,
and ``constrain`` pins an activation's placements where the reference
pins its sharding.  ``use_rules`` also enters DTensor's
``implicit_replication``, so the plain tensors a model makes on the fly
(positions, masks, the step counter's arithmetic) count as replicated.

Assignments that do not divide the dimension fall back to replicated, as
the reference's: DTensor would shard them unevenly, the reference does
not, so the port replicates wherever the reference replicates.

``psum`` is the reference's ``jax.lax.psum`` inside ``shard_map``, with
the gradient ``shard_map`` gives it (see ``models/layers.py``'s ``_local``
and ``_global``): the gradient of a psum is again a psum.  ``ring_shift``
is its ``ppermute`` over a ring.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from contextlib import contextmanager

import torch

__all__ = ["ShardingRules", "use_rules", "get_rules", "bound_to_rules", "constrain", "axis_size",
           "mesh_sizes", "spec_placements", "psum", "ring_shift"]


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``, such as ``launch.mesh.AbstractMesh``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axes.

    ``batch`` spreads over ``batch_axes`` (data-parallel, possibly multi-axis
    e.g. ``("pod", "data")``) unless ``batch_shardable`` is off (uneven
    global batch); ``heads`` / ``ff`` / ``vocab`` / ``model`` over the
    tensor-parallel ``model_axis``; ``seq`` / ``kv_seq`` over ``seq_axis``
    (defaulting to the model axis) when ``seq_sharded`` is enabled.
    """

    mesh: object  # a torch.distributed.device_mesh.DeviceMesh with mesh_dim_names
    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    seq_axis: str | None = None
    batch_shardable: bool = True
    seq_sharded: bool = False

    def physical(self, logical: str | None):
        if logical is None:
            return None
        names = set(self.mesh.mesh_dim_names)
        if logical == "batch":
            if not self.batch_shardable:
                return None
            axes = tuple(a for a in self.batch_axes if a in names)
            return axes if axes else None
        if logical in ("heads", "ff", "vocab", "model", "feature"):
            return self.model_axis if self.model_axis in names else None
        if logical in ("seq", "kv_seq"):
            if not self.seq_sharded:
                return None
            axis = self.seq_axis or self.model_axis
            return axis if axis in names else None
        return None


_STATE = threading.local()


def get_rules() -> ShardingRules | None:
    return getattr(_STATE, "rules", None)


@contextmanager
def use_rules(rules: ShardingRules):
    """Install ``rules`` for this thread, under DTensor's implicit
    replication (plain tensors mixed with DTensors count as replicated).
    Both are put back as they were on the way out, so the context nests
    (torch's own ``implicit_replication`` turns the switch off when it
    leaves, whoever had turned it on)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev, prev_implicit = get_rules(), dispatcher._allow_implicit_replication
    _STATE.rules = rules
    dispatcher._allow_implicit_replication = True
    try:
        yield rules
    finally:
        dispatcher._allow_implicit_replication = prev_implicit
        _STATE.rules = prev


def bound_to_rules(fn):
    """``fn`` run under the rules active now, from whichever thread calls
    it.  A checkpointed body is recomputed in the backward pass, which on a
    CUDA device runs on the autograd engine's own thread: the engine
    carries the caller's dispatch state there (DTensor's implicit
    replication with it), not Python's thread-locals, so the rules of the
    thread that built the graph are not installed."""
    rules = get_rules()
    if rules is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with use_rules(rules):
            return fn(*args, **kwargs)

    return run


def axis_size(axis: str) -> int:
    """Size of a mesh axis under the active rules (1 when unsharded)."""
    rules = get_rules()
    if rules is None:
        return 1
    return mesh_sizes(rules.mesh).get(axis, 1)


def _axes_size(mesh, axes) -> int:
    """Ranks over ``axes``: an axis name, a tuple of them, or ``None`` (1)."""
    sizes = mesh_sizes(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes.get(axes, 1)
    return int(math.prod(sizes.get(a, 1) for a in axes))


def spec_placements(mesh, spec) -> list:
    """DTensor placements of a ``PartitionSpec``-like tuple of entries (one
    a tensor dimension: ``None``, an axis name or a tuple of axis names):
    ``Shard(d)`` on every mesh axis that names dimension ``d``,
    ``Replicate()`` on the others.  A dimension split over several axes is
    split over them in the mesh's order, major first, as in JAX.  An axis
    of one rank splits nothing: it is ``Replicate()`` whatever the spec
    (torch 2.11's DTensor refuses to merge dimensions with a ``Shard`` on
    it, even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                placements[i] = Shard(dim)
    return placements


def _constraint_spec(rules: ShardingRules, shape, logical_axes) -> tuple:
    """The spec entries ``constrain`` applies: each logical axis's mesh
    axes, or ``None`` where it has none or they do not divide the dimension."""
    entries = []
    for dim, logical in zip(shape, logical_axes):
        phys = rules.physical(logical)
        if phys is None or dim % _axes_size(rules.mesh, phys) != 0:
            entries.append(None)
        else:
            entries.append(phys)
    return tuple(entries)


def constrain(x, *logical_axes):
    """Apply a sharding constraint expressed with logical axis names.

    Identity when no rules are installed or ``x`` is a plain tensor.
    Entries that do not divide their dimension are dropped (replicated)
    rather than erroring.
    """
    rules = get_rules()
    if rules is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axis names for rank-{x.ndim} array")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = spec_placements(rules.mesh, _constraint_spec(rules, x.shape, logical_axes))
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(rules.mesh, placements)


class _PSum(torch.autograd.Function):
    """All-reduce (sum) forward and backward: JAX's transpose of ``psum``
    inside ``shard_map``, where a replicated output's gradient reaches each
    rank divided by the ranks that share it."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum of a rank-local tensor over one axis of the active rules' mesh."""
    rules = get_rules()
    if rules is None:
        raise RuntimeError(f"psum over {axis!r} needs sharding rules (use_rules)")
    return _PSum.apply(x, rules.mesh.get_group(axis))


def ring_shift(tensors: list, group=None) -> list:
    """Each rank of ``group`` sends ``tensors`` to the next rank and
    receives the previous rank's (the reference's ``ppermute`` with the
    ring permutation ``i -> i + 1 mod n``), in one ``batch_isend_irecv``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n) if group is not None else (me + 1) % n
    prv = dist.get_global_rank(group, (me - 1) % n) if group is not None else (me - 1) % n
    out = [torch.empty((t.numel(),), dtype=t.dtype, device=t.device) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):  # flat: a 0-d tensor travels as one element
        ops.append(dist.P2POp(dist.isend, t.reshape(-1).contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.reshape(t.shape) for t, r in zip(tensors, out)]
