"""Checkpointing: logical npz + manifest, atomic, resumable (the port of
``repro.ckpt.manager``, with its layout and keys).

Layout per step:
    <dir>/step_00000123.tmp/   (written)  ->  <dir>/step_00000123/  (renamed)
        arrays.npz           flattened {path: array} of the state pytree
        manifest.json        {step, time, paths, extra}

The keys are the reference's paths (``SEP``-joined): a train state
(``{"params": LM, "opt": {"m", "v", "step"}}``) is written in the
reference's pytree layout (``repro_torch.convert.train_state_to_reference``:
``params//groups//0//b0//attn//wq``, each group's leaves stacked over its
repeats, ``lambda`` for the RG-LRU's ``lam``), so a checkpoint of either
package restores in the other.  Any other state is a nested dict / list /
tuple of tensors or arrays.  The host copy is taken in the caller's thread
(``Tensor.cpu()`` waits for the card); the files are written on a
background thread when ``async_save`` (``wait()`` joins it before the next
save).  Retention keeps the newest ``keep``.

Elastic: a state sharded over a mesh (DTensors) is gathered to its full
arrays on every rank, synchronously in ``save`` (each leaf's gather is a
collective); only rank 0 writes, the same ``.npz`` an unsharded save of
that state writes, and ``wait()`` then holds every rank at a barrier until
the files are published.  ``restore(..., shardings=)`` loads the full
arrays and places them on the *current* mesh, whatever mesh wrote them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.convert import _host, train_state_from_reference, train_state_to_reference
from repro_torch.device import resolve_device
from repro_torch.models import LM

__all__ = ["SEP", "CheckpointManager"]

SEP = "//"


def _is_train_state(state) -> bool:
    return isinstance(state, dict) and isinstance(state.get("params"), LM)


def _flatten(tree, prefix: tuple = ()) -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        arr = _host(tree) if isinstance(tree, torch.Tensor) else np.array(tree)  # copies
        return {SEP.join(map(str, prefix)): arr}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, prefix + (key,)))
    return flat


def _nest(flat: dict):
    """Flattened keys back into nested dicts; a dict keyed 0..n-1 is a list
    (the reference's ``groups``)."""
    root: dict = {}
    for key, arr in flat.items():
        node = root
        parts = key.split(SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def _has_dtensor(tree) -> bool:
    if isinstance(tree, torch.nn.Module):
        return any(isinstance(p, DTensor) for p in tree.parameters())
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return isinstance(tree, DTensor)


def _rebuild(template, flat: dict, dev, prefix: tuple = ()):
    """``template``'s structure with every leaf read from ``flat`` onto ``dev``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, dev, prefix + (k,)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, flat, dev, prefix + (i,))
                              for i, v in enumerate(template))
    arr = flat[SEP.join(map(str, prefix))]
    out = torch.from_numpy(np.array(arr))
    if isinstance(template, torch.Tensor):
        out = out.to(template.dtype)
    return out.to(dev)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._collective = False  # the last save gathered a sharded state
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------
    def save(self, step: int, state, extra: dict | None = None):
        self.wait()
        self._collective = _has_dtensor(state)
        tree = train_state_to_reference(state, state["params"].cfg) if _is_train_state(state) \
            else state
        host = _flatten(tree)
        if self._collective and dist.get_rank() != 0:
            return  # rank 0 writes the gathered arrays

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {
                "step": step,
                "time": time.time(),
                "paths": sorted(host),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective:
            self._collective = False
            dist.barrier()  # every rank waits for rank 0's files

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template, shardings=None, device=None):
        """A new state shaped like ``template`` on ``device`` (default: the
        CUDA card).  For a train state the template gives the model's
        config and dtype only (it may live on the meta device).  With
        ``shardings`` (shaped like the state, e.g. ``state_shardings`` of
        the current mesh) every rank reads the full arrays and keeps its
        shards, as DTensors on that mesh; ``device`` is not used."""
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        if _is_train_state(template):
            model = template["params"]
            if shardings is not None:
                return train_state_from_reference(_nest(flat), model.cfg,
                                                  dtype=model.embed.dtype, shardings=shardings)
            return train_state_from_reference(_nest(flat), model.cfg, resolve_device(device),
                                              model.embed.dtype)
        if shardings is not None:
            from repro_torch.launch.sharding import place

            return place(_rebuild(template, flat, torch.device("cpu")), shardings)
        return _rebuild(template, flat, resolve_device(device))

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)
