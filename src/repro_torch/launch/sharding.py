"""Sharding rules: params (FSDP x TP), optimizer state, inputs, caches (the
port of ``repro.launch.sharding``).

Conventions (the reference's):
  * TP ('model' axis): attention q/kv projections and ffn on the feature
    dim; vocab on the embedding/lm-head when divisible.
  * FSDP (('pod','data') axes): the other matrix dim of every large param
    (ZeRO-3; optimizer state inherits the param spec).
  * Any dim that does not divide its assigned axes falls back to
    replicated -- rules are *best effort by construction* so every arch in
    the zoo shards without per-arch tables.

Specs are :class:`P` tuples (JAX's ``PartitionSpec``), computed entry for
entry as the reference computes them; :class:`NamedSharding` pairs one
with a mesh and turns it into DTensor placements.  The reference stacks a
layer group's blocks (``[reps, ...]``); the port holds one module a block,
so a block's leaf takes the spec of its stacked reference leaf with the
stack dimension dropped (``convert._reference_layout`` names the leaf).
Where the reference shards that stack dimension itself (``lambda`` and
``conv_b``: ``[reps, W]`` gets one entry, which lands on ``reps``), the
port's per-block leaf is replicated.

:func:`place` is ``jax.device_put`` with shardings: every rank holds the
same full tensors (the same seed, the same checkpoint) and keeps its
shards, with no communication.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import _axes_size, spec_placements

__all__ = ["FSDP", "TP", "P", "NamedSharding", "param_shardings", "state_shardings",
           "batch_shardings", "cache_shardings", "place", "state_bytes"]

FSDP = ("pod", "data")
TP = "model"


class P(tuple):
    """A partition spec: one entry a tensor dimension (``None``, an axis
    name, or a tuple of axis names); missing trailing entries are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return spec_placements(self.mesh, self.spec)

    def place(self, tensor: torch.Tensor):
        """``tensor`` (the same full value on every rank) as a DTensor with
        these placements, on the mesh's device."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh, self.placements, src_data_rank=None)


def _fit(mesh, spec_entries, shape) -> P:
    """Drop assignments that do not divide; prune absent mesh axes."""
    names = set(mesh.mesh_dim_names)
    out = []
    for dim, entry in zip(shape, spec_entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in names)
        if not axes or dim % _axes_size(mesh, axes) != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


def _param_spec(path: str, shape, mesh) -> P:
    nd = len(shape)
    fsdp = FSDP

    def fit(*entries):
        return _fit(mesh, entries, shape)

    if "embed" == path.split("//")[-1]:
        spec = _fit(mesh, (TP, fsdp), shape)
        if spec[0] is None:  # vocab not divisible: spread d_model over all axes
            return _fit(mesh, (None, ("pod", "data", "model")), shape)
        return spec
    if path.endswith("lm_head"):
        spec = _fit(mesh, (fsdp, TP), shape)
        if spec[1] is None:
            return _fit(mesh, (("pod", "data", "model"), None), shape)
        return spec
    last = path.split("//")[-1]
    # stacked block params have a leading layer dim -> prepend None
    lead = (None,) * (nd - 2)
    if last in ("wq", "wk", "wv", "w_gate", "w_up", "w_x", "w_y", "w_a", "w_i", "ck",
                "wr", "wg", "mix_A", "w_A"):
        return fit(*lead, fsdp, TP)
    if last in ("wo", "w_down", "w_o", "cv", "cr", "mix_B", "w_B"):
        return fit(*lead, TP, fsdp)
    if last == "router":
        return fit(*lead, fsdp, None)
    if last in ("conv_w",):
        return fit(*lead, None, TP)
    if last in ("lambda", "conv_b"):
        return fit(*lead, TP)
    if last == "frontend_proj":
        return fit(None, fsdp)
    if nd >= 1 and shape[-1] > 1024:  # misc vectors (norm scales etc.)
        return fit(*(None,) * (nd - 1), fsdp)
    return P(*(None,) * nd)


def _moe_param_spec(path: str, shape, mesh) -> P | None:
    """MoE expert weights: [.., E, D, F] / [.., E, F, D]."""
    last = path.split("//")[-1]
    nd = len(shape)
    lead = (None,) * (nd - 3)
    if last in ("w_gate", "w_up") and nd >= 3:
        return _fit(mesh, (*lead, None, FSDP, TP), shape)
    if last == "w_down" and nd >= 3:
        return _fit(mesh, (*lead, None, TP, FSDP), shape)
    return None


def _full(spec, nd: int) -> tuple:
    """A spec's entries padded with ``None`` to ``nd``."""
    return tuple(spec) + (None,) * (nd - len(spec))


def param_shardings(params: nn.Module, mesh, cfg: ModelConfig) -> dict:
    """``{parameter name: NamedSharding}`` for the port's model: each
    leaf's reference spec (of the stacked leaf, for a block's) without the
    stack dimension."""
    from repro_torch.convert import _reference_layout

    reps = [r for _, r in cfg.layer_groups()]
    layout = _reference_layout(cfg)
    out = {}
    for name, p in params.named_parameters():
        path, row = layout[name]
        key = "//".join(map(str, path))
        shape = tuple(p.shape) if row is None else (reps[path[1]],) + tuple(p.shape)
        spec = None
        if cfg.moe and ("ffn" in key) and len(shape) >= 3:
            spec = _moe_param_spec(key, shape, mesh)
        if spec is None:
            spec = _param_spec(key, shape, mesh)
        entries = _full(spec, len(shape))
        out[name] = NamedSharding(mesh, P(*(entries if row is None else entries[1:])))
    return out


def state_shardings(state: dict, mesh, cfg: ModelConfig) -> dict:
    ps = param_shardings(state["params"], mesh, cfg)
    return {
        "params": ps,
        "opt": {
            "m": ps,
            "v": ps,
            "step": NamedSharding(mesh, P()),
        },
    }


def _batch_axes(mesh, batch: int):
    dp = _axes_size(mesh, tuple(a for a in FSDP if a in mesh.mesh_dim_names))
    baxes = tuple(a for a in FSDP if a in mesh.mesh_dim_names)
    return baxes if (baxes and batch % dp == 0) else None


def batch_shardings(batch: dict, mesh, global_batch: int) -> dict:
    b = _batch_axes(mesh, global_batch)
    return {k: NamedSharding(mesh, P(b, *([None] * (v.ndim - 1)))) for k, v in batch.items()}


def cache_shardings(cache: list, mesh, cfg: ModelConfig, batch: int) -> list:
    """Decode caches: batch over data when divisible; KV sequence over TP
    (sequence-parallel decode -- this is how GQA kv_heads < TP stays legal).
    The port's caches are one tuple a block; each leaf takes the rule of
    its stacked reference leaf (one dimension more), stack entry dropped."""
    b = _batch_axes(mesh, batch)
    tp = _axes_size(mesh, TP)

    def spec(leaf):
        nd = leaf.ndim + 1  # the reference's leading dim is the stacked-layer dim
        if nd == 5:  # kv cache [R, B, Sc, H, hd] or rwkv [R,B,H,dk,dv]
            sc = leaf.shape[1]
            third = TP if sc % tp == 0 and sc > 1024 else None
            return P(b, third, None, None)
        if nd == 4:  # conv state [R, B, cw-1, W]
            return P(b, None, None)
        if nd == 3:  # cpos [R, B, Sc] or states [R, B, W/D]
            sc = leaf.shape[1]
            third = TP if sc % tp == 0 and sc > 1024 else None
            return P(b, third)
        return P(*([None] * leaf.ndim))

    return [tuple(NamedSharding(mesh, spec(leaf)) for leaf in entry) for entry in cache]


def place(tree, shardings):
    """``tree`` with every tensor placed by the sharding at the same spot
    of ``shardings`` (``jax.device_put``).  A model (an ``nn.Module``) has
    its parameters replaced by DTensor parameters, in place, keyed by
    ``named_parameters()`` name; ``requires_grad`` is kept."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            mod_name, _, attr = name.rpartition(".")
            mod = tree.get_submodule(mod_name)
            mod._parameters[attr] = nn.Parameter(shardings[name].place(p.detach()),
                                                 requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    return shardings.place(torch.as_tensor(tree))


def state_bytes(state: dict) -> dict:
    """Bytes of params, ``m`` and ``v`` this rank holds (its shards)
    beside the bytes of the whole state."""
    from torch.distributed.tensor import DTensor

    local = whole = 0
    tensors = list(state["params"].parameters()) + list(state["opt"]["m"].values()) \
        + list(state["opt"]["v"].values())
    for t in tensors:
        whole += t.numel() * t.element_size()
        loc = t.to_local() if isinstance(t, DTensor) else t
        local += loc.numel() * loc.element_size()
    return {"local": local, "whole": whole}
