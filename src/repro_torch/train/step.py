"""Train-step builder: loss, grads, microbatch accumulation, AdamW update
(the port of ``repro.train.step``).

The train state is ``{"params": LM, "opt": {"m", "v", "step"}}``.  The
returned step takes ``(state, batch)`` and returns ``(state, metrics)``
like the reference's; it updates the state's tensors in place (see
``optimizer.py``) and runs eagerly on the parameters' device.  Metrics are
0-d tensors on that device: reading one waits for the step.

A state placed on a mesh (``launch.sharding.place`` with
``state_shardings``: parameters, ``m`` and ``v`` are DTensors) takes the
same step, run under ``dist.context.use_rules``: DTensor propagates the
placements through the forward and backward passes, each gradient is
reduced to its parameter's placements (a reduce-scatter or all-reduce over
the batch axes), the update runs shard by shard, and the metrics come back
as plain float32 tensors.  Each rank holds only its shards.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import chunked_ce_loss, forward, init_params

from .optimizer import OptConfig, apply_updates, init_opt_state

__all__ = ["TrainConfig", "init_train_state", "make_loss_fn", "make_train_step",
           "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    remat: bool = False
    remat_policy: str = "full"  # full | dots (the outputs of matrix products are kept)
    microbatches: int = 1
    aux_coeff: float = 0.01
    loss_chunk: int = 1024


def init_train_state(model_cfg: ModelConfig, seed: int = 0, param_dtype=torch.float32,
                     device=None) -> dict:
    """A randomly initialised model (``init_params``: ``device=None`` is the
    CUDA card) with gradients on for every parameter, and a zero optimizer
    state beside it."""
    params = init_params(model_cfg, seed, param_dtype, device)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(dict(params.named_parameters()))}


def make_loss_fn(model_cfg: ModelConfig, train_cfg: TrainConfig):
    def loss_fn(params, batch):
        h, _, aux = forward(
            params, model_cfg, batch, mode="train", remat=train_cfg.remat,
            remat_policy=train_cfg.remat_policy,
        )
        loss = chunked_ce_loss(
            params, model_cfg, h, batch["labels"], batch.get("mask"), chunk=train_cfg.loss_chunk
        )
        total = loss + train_cfg.aux_coeff * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def _plain(v: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's full value)."""
    return v.full_tensor() if isinstance(v, DTensor) else v


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    loss_fn = make_loss_fn(model_cfg, train_cfg)

    def grads_of(params, batch):
        """Gradients (float32, keyed by parameter name; zeros for a
        parameter the loss does not reach, as ``jax.grad`` gives) and the
        batch's metrics, detached."""
        params.zero_grad(set_to_none=True)
        total, metrics = loss_fn(params, batch)
        total.backward()
        grads = {}
        for name, p in params.named_parameters():
            g = p.grad
            if g is None:
                g = torch.zeros_like(p, dtype=torch.float32)
            elif isinstance(g, DTensor) and g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)  # reduce over the batch axes
            grads[name] = g.float()
            p.grad = None
        return grads, {**{k: v.detach() for k, v in metrics.items()},
                       "total_loss": total.detach()}

    def accumulate(params, batch):
        """Split the batch into ``microbatches`` pieces along dim 0, sum
        their float32 gradients and metrics, and scale both by 1/m (the
        reference's ``lax.scan`` over microbatches)."""
        m = train_cfg.microbatches
        for k, x in batch.items():
            if x.shape[0] % m:
                raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a multiple of "
                                 f"{m} microbatches")
        pieces = {k: x.chunk(m) for k, x in batch.items()}
        grads = mets = None
        for i in range(m):
            g, met = grads_of(params, {k: v[i] for k, v in pieces.items()})
            if grads is None:
                grads, mets = g, met
            else:
                for k in grads:
                    grads[k].add_(g[k])
                mets = {k: mets[k] + met[k] for k in mets}
        inv = 1.0 / m
        for g in grads.values():
            g.mul_(inv)
        return grads, {k: v * inv for k, v in mets.items()}

    def train_step(state, batch):
        if train_cfg.microbatches > 1:
            grads, metrics = accumulate(state["params"], batch)
        else:
            grads, metrics = grads_of(state["params"], batch)
        model = state["params"]
        _, opt, om = apply_updates(dict(model.named_parameters()), grads, state["opt"],
                                   train_cfg.opt)
        return {"params": model, "opt": opt}, {k: _plain(v) for k, v in {**metrics, **om}.items()}

    return train_step


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    loss_fn = make_loss_fn(model_cfg, train_cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return {k: _plain(v) for k, v in metrics.items()}

    return eval_step
