"""State carried across from the reference package, as numpy arrays.

For the bitmap index, data takes the place of weights: both packages are
given the same bits.  For the LM, the reference's params pytree (as numpy,
``jax.tree.map(np.asarray, params)``) is loaded into the port's modules,
and a train state (params, AdamW moments, step) crosses both ways: the
checkpoints of the two packages hold the same keys.
Nothing of the reference is imported; the caller reads the arrays off a
reference object and hands them over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, to_numpy_u32
from repro_torch.query.index import BitmapIndex

__all__ = ["index_from_reference_arrays", "words_to_numpy", "lm_params_from_reference",
           "train_state_from_reference", "train_state_to_reference",
           "lm_cache_to_reference_layout"]


def index_from_reference_arrays(columns_u32: np.ndarray, names, r: int, *,
                                tile_words: int = 64, containers: bool = True,
                                device=None) -> BitmapIndex:
    """A :class:`BitmapIndex` over the reference's packed ``uint32[N, n_words]``
    columns, names and universe size, on ``device`` (default: the CUDA card)."""
    cols = np.ascontiguousarray(np.asarray(columns_u32, dtype=np.uint32))
    return BitmapIndex(cols, tuple(names), r=int(r), tile_words=tile_words,
                       containers=containers, device=device)


def words_to_numpy(result) -> np.ndarray:
    """A packed result (int32 tensor, or a list of them) as numpy ``uint32``."""
    if isinstance(result, (list, tuple)):
        return np.stack([to_numpy_u32(x) for x in result])
    return to_numpy_u32(result)


#: reference param keys that are not Python identifiers, and their port names
_PARAM_NAMES = {"lambda": "lam"}
_REFERENCE_NAMES = {port: ref for ref, port in _PARAM_NAMES.items()}


def _reference_layout(cfg) -> dict:
    """For every parameter of the port's model (by its ``named_parameters()``
    name): its path in the reference's params pytree and, for a block's
    leaf, its row in the group's ``[reps, ...]`` stack (else ``None``).
    Blocks run group by group, repeat by repeat, pattern entry by entry."""
    from repro_torch.models.model import init_params

    rows = [(gi, f"b{i}", r) for gi, (pattern, reps) in enumerate(cfg.layer_groups())
            for r in range(reps) for i in range(len(pattern))]
    layout = {}
    for name, _ in init_params(cfg, device="meta").named_parameters():
        parts = [_REFERENCE_NAMES.get(x, x) for x in name.split(".")]
        if parts[0] == "blocks":
            gi, b, r = rows[int(parts[1])]
            layout[name] = (("groups", gi, b, *parts[2:]), r)
        else:
            layout[name] = (tuple(parts), None)
    return layout


def _leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_leaf_count(v) for v in tree)
    return 1


def _load_named(named: dict, tree, layout: dict, what: str) -> None:
    """Copy each tensor of ``named`` from its place in the reference
    pytree ``tree`` (numpy arrays); every leaf of ``tree`` must be used."""
    paths = set()
    with torch.no_grad():
        for name, dst in named.items():
            path, row = layout[name]
            node = tree
            try:
                for key in path:
                    node = node[key]
            except (KeyError, IndexError, TypeError):
                raise ValueError(f"{what}: {'/'.join(map(str, path))} (the port's {name}) "
                                 "is not in the reference pytree") from None
            arr = np.asarray(node) if row is None else np.asarray(node)[row]
            src = torch.tensor(arr)  # a copy: never aliases the caller's array
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{what}: {name}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)
            paths.add(path)
    if _leaf_count(tree) != len(paths):
        raise ValueError(f"{what}: the reference pytree has {_leaf_count(tree)} leaves, "
                         f"the port's model {len(paths)}")


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a host numpy array (bfloat16, which numpy
    lacks, as float32); never a view of a CPU tensor's memory.  A DTensor
    is gathered first (``full_tensor``: a collective, every rank of its
    mesh must call it)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_reference(named: dict, cfg, layout: dict) -> dict:
    """Tensors keyed by port parameter name as the reference's pytree of
    numpy arrays, each group's leaves stacked over its repeats."""
    tree: dict = {"groups": [{} for _ in cfg.layer_groups()]}
    by_path: dict = {}
    for name, t in named.items():
        path, row = layout[name]
        by_path.setdefault(path, []).append((row, t))
    for path, rows in by_path.items():
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(node, list) else node.setdefault(key, {})
        if rows[0][0] is None:
            node[path[-1]] = _host(rows[0][1])
            continue
        first = _host(rows[0][1])
        out = np.empty((len(rows),) + first.shape, first.dtype)
        for row, t in rows:  # one row on the host at a time, not a copy of the stack
            out[row] = _host(t)
        node[path[-1]] = out
    return tree


def lm_params_from_reference(np_params: dict, cfg, device=None, dtype=torch.float32):
    """The reference's params pytree, as numpy arrays, loaded into the
    port's :class:`repro_torch.models.LM` (weights in ``dtype``) on
    ``device`` (default: the CUDA card).  Each group's stacked
    ``[reps, ...]`` leaves are unstacked into the blocks of that group, in
    execution order.  Every parameter of the model is loaded exactly once
    and every leaf of the pytree is used, or this raises."""
    from repro_torch.models.model import init_params

    dev = resolve_device(device)
    model = init_params(cfg, dtype=dtype, device="meta").to_empty(device=dev)
    _load_named(dict(model.named_parameters()), np_params, _reference_layout(cfg), "params")
    return model


def train_state_from_reference(np_state: dict, cfg, device=None, dtype=torch.float32,
                               shardings=None) -> dict:
    """The reference's train state (``{"params", "opt": {"m", "v", "step"}}``
    as numpy arrays) as the port's: the model with gradients on, ``m`` and
    ``v`` float32 keyed by parameter name, ``step`` a 0-d int32 tensor, all
    on ``device`` (default: the CUDA card).  With ``shardings`` (the port's
    ``launch.sharding.state_shardings``) the full arrays are staged on the
    host and every rank keeps its shards, as DTensors on the shardings'
    mesh; ``device`` is not used."""
    if shardings is not None:
        from repro_torch.launch.sharding import place

        return place(train_state_from_reference(np_state, cfg, "cpu", dtype), shardings)
    dev = resolve_device(device)
    model = lm_params_from_reference(np_state["params"], cfg, dev, dtype)
    model.requires_grad_(True)
    layout = _reference_layout(cfg)
    opt: dict = {}
    for key in ("m", "v"):
        opt[key] = {name: torch.empty(p.shape, dtype=torch.float32, device=dev)
                    for name, p in model.named_parameters()}
        _load_named(opt[key], np_state["opt"][key], layout, f"opt/{key}")
    opt["step"] = torch.tensor(np.asarray(np_state["opt"]["step"], dtype=np.int32)).to(dev)
    return {"params": model, "opt": opt}


def train_state_to_reference(state: dict, cfg) -> dict:
    """The port's train state in the reference's pytree layout, as numpy
    arrays (``step`` a 0-d int32 array).  A sharded state is gathered to
    its full arrays (on every rank: each leaf's gather is a collective)."""
    layout = _reference_layout(cfg)
    opt = state["opt"]
    return {
        "params": _to_reference(dict(state["params"].named_parameters()), cfg, layout),
        "opt": {"m": _to_reference(opt["m"], cfg, layout),
                "v": _to_reference(opt["v"], cfg, layout),
                "step": np.asarray(_host(opt["step"]), dtype=np.int32)},
    }


def lm_cache_to_reference_layout(caches, cfg) -> list:
    """The port's per-block decode caches in the reference's layout: one
    dict per layer group, ``{"b{i}": tuple of numpy arrays stacked over the
    group's repeats}``."""
    out = []
    j = 0
    for pattern, reps in cfg.layer_groups():
        per = {f"b{i}": [] for i in range(len(pattern))}
        for _ in range(reps):
            for i in range(len(pattern)):
                per[f"b{i}"].append(caches[j])
                j += 1
        out.append({
            name: tuple(
                np.stack([c[t].detach().cpu().float().numpy() if c[t].is_floating_point()
                          else c[t].detach().cpu().numpy() for c in entries])
                for t in range(len(entries[0]))
            )
            for name, entries in per.items()
        })
    return out
