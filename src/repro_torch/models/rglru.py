"""RecurrentGemma / Griffin recurrent block: RG-LRU + causal temporal conv.

    h_t = a_t . h_{t-1} + sqrt(1 - a_t^2) . (i_t . xi_t)
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a xi_t))        (c = 8)

The port of ``repro.models.rglru``.  The reference evaluates the diagonal
linear recurrence with ``jax.lax.associative_scan``; here it is a
log-depth (Hillis-Steele) scan in torch ops, ``ceil(log2 S)`` rounds of
elementwise work.  It sums in another order than the reference's tree, so
parity is ``allclose``.  Decode carries (h, conv window) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import constrain

from .layers import Init, _mm, rms_norm

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, w = cfg.d_model, cfg.rnn_width
        self.ln = init.full((d,), 1.0)
        self.w_x = init.dense(d, (d, w))
        self.w_y = init.dense(d, (d, w))
        self.conv_w = init.dense(cfg.conv_width, (cfg.conv_width, w))
        self.conv_b = init.full((w,), 0.0)
        self.w_a = init.dense(w, (w, w))
        self.w_i = init.dense(w, (w, w))
        # Lambda init so a^c in (0.9, 0.999) at sigmoid ~ 0.5 (Griffin appendix);
        # kept float32 whatever the model's dtype, as in the reference.  The
        # reference's key is "lambda", a Python keyword: here it is ``lam``.
        u = init.uniform((w,), 0.9**2, 0.999**2)
        self.lam = nn.Parameter(torch.log(torch.expm1(-torch.log(u) / _C)),
                                requires_grad=False)
        self.w_o = init.dense(w, (w, d))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, width cw.  state: [B, cw-1, W] trailing inputs."""
    cw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[-1]))
    xp = torch.cat([state, x], dim=1)  # promotes like jnp.concatenate
    out = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1) :, :]
    return out + b, new_state


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0, along axis 1, in
    ``ceil(log2 S)`` rounds (each round composes every element with the
    one ``shift`` before it)."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru_block(x, p: RGLRU, cfg: ModelConfig, state=None):
    """x: [B,S,D] -> (out [B,S,D], (h, conv) state)."""
    b, s, d = x.shape
    h_state, conv_state = state if state is not None else (None, None)
    xin = rms_norm(x, p.ln, cfg.norm_eps)
    branch = _mm(xin, p.w_x)
    gate = F.gelu(_mm(xin, p.w_y), approximate="tanh")  # jax.nn.gelu's default
    xi, conv_state = _causal_conv(branch, p.conv_w, p.conv_b, conv_state)
    xi = constrain(xi, "batch", None, "ff")

    r = torch.sigmoid(_mm(xi, p.w_a).float())
    ig = torch.sigmoid(_mm(xi, p.w_i).float())
    # jax.nn.softplus is logaddexp(x, 0)
    log_a = -_C * torch.logaddexp(p.lam, torch.zeros_like(p.lam)) * r  # [B,S,W], < 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        ig * xi.float()
    )

    if h_state is None:
        h_state = torch.zeros((b, xi.shape[-1]), dtype=torch.float32, device=x.device)
    if s == 1:  # decode step
        h = a[:, 0] * h_state + gated[:, 0]
        hidden = h[:, None, :]
        new_h = h
    else:
        # the carry enters as position 0's contribution: h_0 = a_0 h_prev + b_0
        gated = torch.cat([(gated[:, 0] + a[:, 0] * h_state)[:, None], gated[:, 1:]], dim=1)
        hidden = linear_scan(a, gated)
        new_h = hidden[:, -1, :]

    out = _mm(hidden.to(x.dtype) * gate, p.w_o)
    return constrain(out, "batch", "seq", None), (new_h, conv_state)
