"""Microbatch pipeline parallelism over one mesh axis (GPipe schedule; the
port of ``repro.dist.pipeline``).

Stage ``s`` lives on rank ``s`` of ``axis_name``; microbatches are injected
at rank 0 and streamed one hop per step (a send to the next rank and a
receive from the previous, the reference's ``ppermute``), so ``M``
microbatches through ``S`` stages take ``M + S - 1`` steps.  Stages must be
shape-preserving (activation in == activation out), which is the usual
transformer-block contract.

When the mesh axis does not match the stage count (e.g. a 1 x 1 mesh) the
schedule degenerates to a sequential run over stages -- same numerics, no
overlap.
"""
from __future__ import annotations

import torch

from repro_torch.dist.context import mesh_sizes, ring_shift

__all__ = ["pipeline_forward"]


def _stage(stage_params: dict, s: int) -> dict:
    return {k: v[s] for k, v in stage_params.items()}


def _sequential(stage_fn, x, stage_params, n_stages: int):
    out = x
    for s in range(n_stages):
        p_s = _stage(stage_params, s)
        out = torch.stack([stage_fn(p_s, mb) for mb in out])
    return out


def pipeline_forward(stage_fn, x, stage_params: dict, mesh, axis_name: str = "pod"):
    """Run ``x: [M, ...]`` microbatches through ``S`` stacked stages.

    ``stage_params`` is a dict of tensors with leading dim ``S``;
    ``stage_fn(params, mb)`` applies one stage to one microbatch.  ``x`` and
    ``stage_params`` are the same on every rank; each rank of ``axis_name``
    runs its own stage, and every rank returns the ``[M, ...]`` outputs
    (the last stage broadcasts them).
    """
    import torch.distributed as dist

    n_stages = next(iter(stage_params.values())).shape[0]
    if mesh_sizes(mesh).get(axis_name, 1) != n_stages:
        return _sequential(stage_fn, x, stage_params, n_stages)

    m = x.shape[0]
    group = mesh.get_group(axis_name)
    idx = mesh.get_local_rank(axis_name)
    w = _stage(stage_params, idx)  # this rank's stage
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m + n_stages - 1):
        x_in = x[min(t, m - 1)] if idx == 0 else buf
        y = stage_fn(w, x_in)
        if idx == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        (buf,) = ring_shift([y], group)
    dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return outs
