"""AdamW + cosine schedule + global-norm clipping (the port of
``repro.train.optimizer``; no external optimizer).

The optimizer state holds ``m`` and ``v`` (float32, keyed by parameter
name, as the model's ``named_parameters()``) and a 0-d int32 ``step``.
The update is the reference's arithmetic in plain tensor code, not
``torch.optim.AdamW`` (which decays the weights in a separate multiply and
rounds otherwise): decay on every leaf, norms and embeddings included.
It runs on the parameters' device with no host round trip, and writes
parameters, ``m`` and ``v`` IN PLACE (the reference returns new trees): at
qwen3-1.7b a copy of each would add 20.6 GB.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["OptConfig", "schedule", "init_opt_state", "global_norm", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine down to ``min_lr_ratio``
    of it; ``step`` (an int or an int tensor) is taken in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: dict) -> dict:
    """Zero moments for ``params`` (name -> tensor, as a model's
    ``dict(named_parameters())``) and step 0, on the parameters' device."""
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device),
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32.

    Of DTensors (a sharded state's gradients, each on its parameter's
    placements) every rank takes the norms of its local pieces; a leaf
    split over mesh axes of more than one rank has its squared norm summed
    over them.  A leaf no axis splits needs no collective, so on a 1 x 1
    mesh the result is bit for bit the unsharded one."""
    from torch.distributed.tensor import DTensor

    tensors = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    local = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
    norms = list(torch._foreach_norm([t.float() for t in local]))
    for i, t in enumerate(tensors):
        if not isinstance(t, DTensor):
            continue
        mesh = t.device_mesh
        split = [d for d, p in enumerate(t.placements) if p.is_shard() and mesh.size(d) > 1]
        if split:
            import torch.distributed as dist

            sq = norms[i].square()
            for d in split:
                dist.all_reduce(sq, group=mesh.get_group(d))
            norms[i] = sq.sqrt()
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, opt_state: dict, cfg: OptConfig):
    """One AdamW step; returns (params, new_opt_state, metrics).

    ``params`` (name -> tensor), ``m`` and ``v`` are updated in place;
    ``grads`` is keyed like them."""
    step = opt_state["step"] + 1
    gnorm = global_norm([grads[k] for k in params])
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    m_state, v_state = opt_state["m"], opt_state["v"]
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = m_state[k], v_state[k]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g) * (1 - cfg.b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": m_state, "v": v_state, "step": step}, metrics
