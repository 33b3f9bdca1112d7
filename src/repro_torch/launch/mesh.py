"""Meshes (the port of ``repro.launch.mesh``): ``DeviceMesh``es over the
ranks of a ``torch.distributed`` process group, one rank a device.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; ``pod`` is an outer
data-parallel axis by default (gradients reduce over pod x data) and can
alternatively run as 2 pipeline stages (``dist/pipeline.py``).

``device=None`` is the CUDA card, and raises without one; ``device="cpu"``
is the CPU.  Defined as functions, so importing this module touches no
device and starts no process group.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.dist.context import mesh_sizes

__all__ = ["AbstractMesh", "make_production_mesh", "make_host_mesh", "mesh_axis_sizes"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names with no ranks behind them (JAX's
    ``AbstractMesh``): enough for ``launch.sharding``'s specs, e.g. of the
    production meshes on a machine that does not have 256 devices."""

    shape: tuple
    mesh_dim_names: tuple


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: tuple, axes: tuple, device):
    """A ``DeviceMesh`` of ``shape`` over the process group's ranks.

    When no process group exists and this process is the only rank
    (``WORLD_SIZE`` unset or 1), it starts that one-rank group itself,
    over an in-process ``HashStore``: for the card NCCL for CUDA tensors
    and ``gloo`` for host ones (a CPU mesh of the same rank then works
    too), for the CPU ``gloo``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    n = math.prod(shape)
    if _world_size() != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} over axes {tuple(axes)} needs "
                         f"{n} ranks; the process group has {_world_size()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) != 1:
            raise RuntimeError("WORLD_SIZE is set above 1 but no process group is "
                               "initialised: call torch.distributed.init_process_group first")
        dist.init_process_group("cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int | None = None, model: int = 1, device=None):
    """Small mesh over the ranks that exist (tests, one card): ``data``
    defaults to the world size over ``model``.  With no process group and
    one process it is the 1 x 1 mesh over a one-rank group it starts."""
    n = _world_size()
    if data is None:
        data = n // model
    return _mesh((data, model), ("data", "model"), device)


def mesh_axis_sizes(mesh) -> dict:
    return mesh_sizes(mesh)
