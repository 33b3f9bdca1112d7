"""RWKV6 ("Finch") block: data-dependent-decay linear attention.

Math (per head, k-dim i, v-dim j):
    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T ,   w_t = exp(-exp(d_t))  in (0,1)

The port of ``repro.models.rwkv6``, with its two evaluation paths:
  * ``wkv_scan``    -- the exact per-token recurrence (decode step);
  * ``wkv_chunked`` -- the chunk-parallel matmul form (prefill, chunk 32).
    Every decay factor is exp(a difference of log-decay cumsums) <= 1, so
    it is stable for any decay; the [L, L, hd] decay tensor is built per
    chunk and the work stays linear in the sequence.
The reference's ``lax.scan`` loops are Python loops here (over tokens,
and over chunks).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import constrain, get_rules

from . import layers as L
from .layers import (
    Init,
    _einsum,
    _mm,
    _pin_grad,
    _split_heads,
    _whole_unless_divides,
    rms_norm,
)

LORA_DIM = 32


class RWKV(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        h, hd = cfg.n_heads, cfg.head_dim
        self.ln_t = init.full((d,), 1.0)
        self.mu_x = init.full((5, d), 0.0)  # per-(w,k,v,r,g) static interpolation
        self.mix_A = init.dense(d, (d, 5 * LORA_DIM))
        self.mix_B = init.dense(LORA_DIM, (5, LORA_DIM, d))
        self.w_bias = init.full((d,), -1.0)
        self.w_A = init.dense(d, (d, LORA_DIM * 2))
        self.w_B = init.dense(LORA_DIM * 2, (LORA_DIM * 2, d))
        self.wr = init.dense(d, (d, d))
        self.wk = init.dense(d, (d, d))
        self.wv = init.dense(d, (d, d))
        self.wg = init.dense(d, (d, d))
        self.wo = init.dense(d, (d, d))
        self.u = init.full((h, hd), 0.0)
        self.ln_x = init.full((d,), 1.0)
        # channel mix
        self.ln_c = init.full((d,), 1.0)
        self.mu_ck = init.full((d,), 0.0)
        self.mu_cr = init.full((d,), 0.0)
        self.ck = init.dense(d, (d, f))
        self.cv = init.dense(f, (f, d))
        self.cr = init.dense(d, (d, d))


def _token_shift(x, prev):
    """shift(x)_t = x_{t-1}; position 0 takes ``prev`` (decode carry)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def wkv_scan(r, k, v, logw, u, state):
    """Exact recurrence. r/k/v/logw: [B,S,H,hd]; u: [H,hd]; state: [B,H,hd,hd]."""
    s = state
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]  # [B,H,hd]
        kv = kt[..., :, None] * vt[..., None, :]  # [B,H,hd_k,hd_v]
        outs.append(_einsum("bhi,bhij->bhj", rt, s + u[None, :, :, None] * kv))
        s = torch.exp(lwt)[..., :, None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s  # [B,S,H,hd_v]


def wkv_chunked(r, k, v, logw, u, state, chunk: int = 32):
    """Chunk-parallel form; matches ``wkv_scan``."""
    b, s, h, hd = r.shape
    pad = (-s) % chunk
    if pad:  # pad the sequence axis (dim 1) with zeros
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    n = r.shape[1] // chunk

    def resh(a):  # [B, n*L, H, hd] -> [n, B, H, L, hd]
        return a.reshape(b, n, chunk, h, hd).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(logw)
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    eye = torch.eye(chunk, dtype=torch.float32, device=r.device)
    s0 = state.float()  # [B,H,hd,hd]
    outs = []
    for c in range(n):
        rt, kt, vt, lw = rc[c], kc[c], vc[c], lwc[c]
        cs = torch.cumsum(lw, dim=-2)  # [B,H,L,hd], inclusive
        cs_prev = cs - lw  # cs_{t-1}
        # inter-chunk: r_t exp(cs_{t-1}) @ S0
        o_inter = torch.einsum("bhti,bhij->bhtj", rt * torch.exp(cs_prev), s0)
        # intra-chunk: decay exp(cs_{t-1} - cs_s) for s <= t-1 (else 0); the
        # mask goes on BEFORE exp: above-diagonal diffs are positive
        diff = cs_prev[..., :, None, :] - cs[..., None, :, :]  # [B,H,t,s,hd]
        dec = torch.exp(torch.where(tri[None, None, :, :, None], diff, -torch.inf))
        scores = torch.einsum("bhti,bhsi,bhtsi->bhts", rt, kt, dec)
        diag = torch.einsum("bhti,bhti,hi->bht", rt, kt, uf)
        scores = scores + eye[None, None] * diag[..., None]
        o_intra = torch.einsum("bhts,bhsj->bhtj", scores, vt)
        # state to the next chunk: exp(cs_L) S0 + sum_s exp(cs_L - cs_s) k_s v_s^T
        cs_last = cs[..., -1:, :]
        k_dec = kt * torch.exp(cs_last - cs)
        s0 = torch.exp(cs_last[..., 0, :])[..., :, None] * s0 + torch.einsum(
            "bhsi,bhsj->bhij", k_dec, vt
        )
        outs.append(o_inter + o_intra)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, hd)
    return out[:, :s].to(r.dtype), s0


def _wkv_per_rank(fn, r, k, v, logw, u, state):
    """``fn`` (``wkv_chunked`` / ``wkv_scan``); under sharding rules on each
    rank's batch rows and heads, as the attention's (each head's
    recurrence reads only its own r, k, v, decay and state), since
    DTensor's own propagation through its einsums fails once heads are
    split (they merge the split heads into the batch of a product)."""
    rules = get_rules()
    if rules is None:
        return fn(r, k, v, logw, u, state)
    mesh = rules.mesh
    bspec = L._batch_spec(rules, r.shape[0])
    hspec = L._tp_spec(rules, r.shape[2])
    seq, st = (bspec, None, hspec, None), (bspec, hspec, None, None)
    out, state = fn(*(L._local(t, mesh, seq) for t in (r, k, v, logw)),
                    L._local(u, mesh, (hspec, None)), L._local(state, mesh, st))
    return L._global(out, mesh, seq), L._global(state, mesh, st)


def _group_norm(x, scale, eps):
    """Per-head normalisation of the wkv output (RWKV's GroupNorm)."""
    b, s, h, hd = x.shape
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    # the gradient comes back as the merged value is placed (a later op may
    # split the merged dim where the heads do not divide)
    return (_pin_grad(out.reshape(b, s, h * hd)) * scale.float()).to(x.dtype)


def time_mix(x, p: RWKV, cfg: ModelConfig, state=None, shift_prev=None, chunked=True):
    """RWKV6 time mixing. state: [B,H,hd,hd] fp32; shift_prev: [B,D]."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xin = rms_norm(x, p.ln_t, cfg.norm_eps)
    if shift_prev is None:
        shift_prev = xin.new_zeros((b, d))
    xx = _token_shift(xin, shift_prev) - xin
    xxx = xin + xx * p.mu_x.to(xin.dtype).sum(0) / 5.0
    m = _whole_unless_divides(torch.tanh(_mm(xxx, p.mix_A)), 2, 5)
    m = _pin_grad(m.reshape(b, s, 5, LORA_DIM))
    deltas = _einsum("bsli,lid->bsld", m, p.mix_B.to(xin.dtype))
    xw, xk, xv, xr, xg = (
        xin + xx * (p.mu_x[i].to(xin.dtype) + deltas[:, :, i, :]) for i in range(5)
    )
    dlog = p.w_bias.float() + _mm(torch.tanh(_mm(xw, p.w_A)), p.w_B).float()
    logw = -torch.exp(dlog)  # log decay, < 0
    r = _split_heads(_mm(xr, p.wr), h, hd)
    k = _split_heads(_mm(xk, p.wk), h, hd)
    v = _split_heads(_mm(xv, p.wv), h, hd)
    g = F.silu(_mm(xg, p.wg))
    logw = _split_heads(logw, h, hd)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    fn = wkv_chunked if (chunked and s > 1) else wkv_scan
    out, state = _wkv_per_rank(fn, r, k, v, logw, p.u, state)
    out = _group_norm(out, p.ln_x, cfg.norm_eps).to(xin.dtype)
    out = _mm(out * g, p.wo)
    return constrain(out, "batch", "seq", None), state, xin[:, -1, :]


def channel_mix(x, p: RWKV, cfg: ModelConfig, shift_prev=None):
    b, s, d = x.shape
    xin = rms_norm(x, p.ln_c, cfg.norm_eps)
    if shift_prev is None:
        shift_prev = xin.new_zeros((b, d))
    xx = _token_shift(xin, shift_prev) - xin
    xk = xin + xx * p.mu_ck.to(xin.dtype)
    xr = xin + xx * p.mu_cr.to(xin.dtype)
    kk = torch.square(torch.relu(_mm(xk, p.ck)))
    out = torch.sigmoid(_mm(xr, p.cr)) * _mm(kk, p.cv)
    return constrain(out, "batch", "seq", None), xin[:, -1, :]
