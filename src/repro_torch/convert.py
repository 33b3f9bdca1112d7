"""State carried across from the reference package, as numpy arrays.

For the bitmap index, data takes the place of weights: both packages are
given the same bits.  For the LM, the reference's params pytree (as numpy,
``jax.tree.map(np.asarray, params)``) is loaded into the port's modules.
Nothing of the reference is imported; the caller reads the arrays off a
reference object and hands them over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, to_numpy_u32
from repro_torch.query.index import BitmapIndex

__all__ = ["index_from_reference_arrays", "words_to_numpy", "lm_params_from_reference",
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


def lm_params_from_reference(np_params: dict, cfg, device=None):
    """The reference's float32 params pytree, as numpy arrays, loaded into
    the port's :class:`repro_torch.models.LM` on ``device`` (default: the
    CUDA card).  Each group's stacked ``[reps, ...]`` leaves are unstacked
    into the blocks of that group, in execution order.  Every parameter of
    the model is loaded exactly once, or this raises."""
    from repro_torch.models.model import init_params

    dev = resolve_device(device)
    model = init_params(cfg, device="meta").to_empty(device=dev)
    loaded = set()

    def load(owner, prefix, name, arr):
        name = _PARAM_NAMES.get(name, name)
        param = getattr(owner, name)
        src = torch.tensor(np.asarray(arr))  # a copy: never aliases the caller's array
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{prefix}{name}: shape {tuple(src.shape)} != {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(src)
        loaded.add(prefix + name)

    for key, arr in np_params.items():
        if key != "groups":
            load(model, "", key, arr)
    j = 0
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        group = np_params["groups"][gi]
        for r in range(reps):
            for i, _kind in enumerate(pattern):
                for sub, leaves in group[f"b{i}"].items():
                    owner = getattr(model.blocks[j], sub)
                    for name, arr in leaves.items():
                        load(owner, f"blocks.{j}.{sub}.", name, np.asarray(arr)[r])
                j += 1
    missing = {name for name, _ in model.named_parameters()} - loaded
    if missing or j != len(model.blocks):
        raise ValueError(f"parameters not in the reference pytree: {sorted(missing)}")
    return model


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
