"""Shared neural layers of the port: norms, RoPE, GQA attention (full /
windowed / bidirectional, logit softcap, qk-norm), gated MLP, and MoE with
local sort-based dispatch.

The port of ``repro.models.layers``.  Each function takes the block's
``nn.Module`` where the reference takes its params dict; the modules'
parameters carry the reference's key names (``p.wq`` is ``p["wq"]``), so
the code reads like the reference's.  Sharding is expressed through
``repro_torch.dist.context.constrain`` with logical axis names, as in the
reference.  Under sharding rules four branches run per rank, as the
reference's ``shard_map`` does: the vocab-parallel ``embedding_lookup``,
the MoE dispatch (tokens local to their rank, expert weights TP-sharded on
the ff dim, partial down-projections summed over TP), the head-repeat of
``attention`` when the KV heads do not divide the TP degree, and the
attention itself (``_attend``: each rank its batch rows and heads; decode
writes the new entry into the rank's block of the cache and, where the
cache's sequence is split, combines the blocks' softmax over the ranks).
Each takes the DTensors' local shards (``_local``), computes on plain
tensors with ``dist.context.psum`` for the reference's ``psum``, and wraps
its result back into a DTensor (``_global``).  The reference leaves the
attention to GSPMD; DTensor's sharding propagation cannot place its score
``einsum`` once heads are split (it asks a tensor's value, which fails
under ``FakeTensorMode`` and, on torch 2.11, with real ranks).

Matrix products are ``torch.matmul`` / ``einsum`` (the reference leaves
them to XLA; no Pallas here).  Where ``jnp`` promotes mixed float32 /
bfloat16 operands, ``_mm`` and ``_einsum`` cast explicitly: torch refuses
mixed dtypes in a product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import (
    axis_size,
    bound_to_rules,
    constrain,
    get_rules,
    mesh_sizes,
    psum,
    spec_placements,
)

__all__ = [
    "NEG_INF", "BLOCKED_ATTN_THRESHOLD", "Init", "Attention", "MLP", "MoE",
    "rms_norm", "softcap", "act_fn", "rope", "attention", "embedding_lookup",
    "mlp", "moe_route", "moe_dispatch_local", "moe",
]


# ---------------------------------------------------------------------------
# per-rank blocks (the reference's shard_map)
# ---------------------------------------------------------------------------


# Gradients follow ``shard_map``'s transpose: an output replicated over
# mesh axes passes each rank its gradient divided by their size; an input
# replicated over an axis gets the sum of the ranks' gradients (Partial);
# a psum's gradient is a psum.  Ranks that compute alike (tokens replicated
# over 'model') then add up to the gradient once, ranks that compute apart
# (their own tokens, their own ff slice) to the sum of their parts.


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _local(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (the ``in_specs`` of a
    ``shard_map``): a DTensor is redistributed to the spec's placements; a
    plain tensor is taken as replicated.  Its gradient is partial over the
    axes the spec replicates it on."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    placements = spec_placements(mesh, spec)
    grads = [Partial() if p.is_replicate() else p for p in placements]
    return x.redistribute(mesh, placements).to_local(grad_placements=grads)


def _global(x: torch.Tensor, mesh, spec):
    """A rank's block as the DTensor it is a block of (``out_specs``)."""
    placements = spec_placements(mesh, spec)
    shared = math.prod(mesh.size(i) for i, p in enumerate(placements) if p.is_replicate())
    return DTensor.from_local(_ScaleGrad.apply(x, 1.0 / shared), mesh, placements,
                              run_check=False)


def _batch_spec(rules, b: int):
    """The batch axes that shard a leading dimension of ``b``, or ``None``."""
    sizes = mesh_sizes(rules.mesh)
    batch_axes = tuple(a for a in rules.batch_axes if a in sizes)
    dp = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
    return batch_axes if (batch_axes and b % dp == 0) else None


NEG_INF = -1e30

# use online-softmax blocked attention from this sequence length up: the
# dense [B,H,G,S,S] fp32 score transient is the dominant memory term
BLOCKED_ATTN_THRESHOLD = 4096


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


class Init:
    """Draws a model's initial weights, in construction order, from one
    explicit ``torch.Generator`` on ``device``.  On the meta device it
    allocates nothing and draws nothing (shapes only)."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def _param(self, x: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(x, requires_grad=False)

    def _empty(self, shape, dtype) -> nn.Parameter:
        return self._param(torch.empty(shape, dtype=dtype, device=self.device))

    def dense(self, fan_in: int, shape, dtype=None) -> nn.Parameter:
        """N(0, 1/fan_in), drawn in float32 and cast (the reference's ``_dense_init``)."""
        return self.normal(shape, 1.0 / math.sqrt(fan_in), dtype)

    def normal(self, shape, std: float, dtype=None) -> nn.Parameter:
        dtype = dtype or self.dtype
        if self.gen is None:
            return self._empty(shape, dtype)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return self._param((x * std).to(dtype))

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        """float32 U(lo, hi), not a parameter (the caller transforms it)."""
        if self.gen is None:
            return torch.empty(shape, dtype=torch.float32, device=self.device)
        u = torch.rand(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return u * (hi - lo) + lo

    def full(self, shape, value: float, dtype=None) -> nn.Parameter:
        dtype = dtype or self.dtype
        if self.gen is None:
            return self._empty(shape, dtype)
        return self._param(torch.full(shape, value, dtype=dtype, device=self.device))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d = cfg.d_model
        self.ln = init.full((d,), 1.0)
        self.wq = init.dense(d, (d, cfg.q_dim))
        self.wk = init.dense(d, (d, cfg.kv_dim))
        self.wv = init.dense(d, (d, cfg.kv_dim))
        self.wo = init.dense(cfg.q_dim, (cfg.q_dim, d))
        if cfg.qk_norm:
            self.q_norm = init.full((cfg.head_dim,), 1.0)
            self.k_norm = init.full((cfg.head_dim,), 1.0)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.ln = init.full((d,), 1.0)
        self.w_gate = init.dense(d, (d, f))
        self.w_up = init.dense(d, (d, f))
        self.w_down = init.dense(f, (f, d))


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.ln = init.full((d,), 1.0)
        self.router = init.dense(d, (d, e), torch.float32)  # router kept fp32
        self.w_gate = init.dense(d, (e, d, f))
        self.w_up = init.dense(d, (e, d, f))
        self.w_down = init.dense(f, (e, f, d))


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``jnp``'s promotion of mixed float dtypes.

    Of DTensors, Megatron's column- and row-parallel products under ZeRO-3:
    the activation ``a`` keeps no middle dim split and, off the
    tensor-parallel axis, only its batch rows (:func:`_rows_only`); the
    weight ``b`` is gathered on the other axes and keeps its
    tensor-parallel split (:func:`_product_operands`); the output's
    gradient comes back placed as the output was (:class:`_PinGrad`).  Left
    to itself DTensor merges a split sequence into the product's rows
    (torch 2.11 refuses; torch 2.13 makes a strided split), and splits dims
    over an axis a value is replicated on in an order whose merge makes a
    strided split; a strided split's placement asks a tensor's value,
    which fails under ``FakeTensorMode``."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    if isinstance(a, DTensor):
        a = _rows_only(a)
    if isinstance(b, DTensor) and b.ndim == 2:
        a, b = _product_operands(a, b)
    return _pin_grad(a @ b)


def _rows_only(x):
    """An activation DTensor placed as a product takes it: its rows (dim 0,
    the batch) split over the rules' batch axes and whole on every other
    axis but the tensor-parallel one, where it keeps its split unless that
    is a middle dim (a split sequence is gathered).  Left to themselves,
    DTensor's elementwise ops split other dims over an axis a value is
    replicated on (the feature dim over ``pod``, or over ``data`` instead
    of the rows), and a later merge of those dims makes a strided split."""
    rules = get_rules()
    if rules is None:
        return x
    mesh = x.device_mesh
    rows = spec_placements(mesh, (_batch_spec(rules, x.shape[0]),) + (None,) * (x.ndim - 1))
    placements = []
    for name, p, want in zip(mesh.mesh_dim_names, x.placements, rows):
        if name != rules.model_axis:
            placements.append(want)
        else:
            placements.append(Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p)
    if placements == list(x.placements):
        return x
    return x.redistribute(mesh, placements)


def _pin_grad(x):
    """``x``; a DTensor's gradient redistributed to ``x``'s placements."""
    return _PinGrad.apply(x) if isinstance(x, DTensor) else x


class _PinGrad(torch.autograd.Function):
    """The identity, whose gradient is redistributed to the placements the
    forward value had (a partial sum's gradient: replicated).  On a
    product's output it keeps DTensor's backward from splitting the
    gradient over an axis the value was replicated on, in an order whose
    merge into the product's rows makes a strided split."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and list(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def _product_operands(a, b):
    """``a`` and the weight ``b`` of ``a @ b`` placed for a ZeRO-3 product.
    On the tensor-parallel axis ``b`` keeps its split: its columns
    (column-parallel; gathered if ``a`` is split there too), or its rows,
    ``a``'s last dim then split to match (row-parallel, a partial sum).  On
    every other axis (FSDP: the batch axes, and ``pod`` when the batch is
    not split over it) ``b`` is gathered."""
    rules = get_rules()
    tp = rules.model_axis if rules is not None else None
    mesh = b.device_mesh
    a_pl = a.placements if isinstance(a, DTensor) else [Replicate()] * mesh.ndim
    keep, slice_a = [], []
    for name, pa, pb in zip(mesh.mesh_dim_names, a_pl, b.placements):
        if tp is not None and name != tp:
            keep.append(Replicate() if pb.is_shard() else pb)
            slice_a.append(pa)
            continue
        row_parallel = pb.is_shard(0) and pa.is_shard(a.ndim - 1)
        if pa.is_shard() and (pb.is_shard(1) or (pb.is_shard(0) and not row_parallel)):
            keep.append(Replicate())
        else:
            keep.append(pb)
        slice_a.append(Shard(a.ndim - 1) if pa.is_replicate() and pb.is_shard(0) else pa)
    if keep != list(b.placements):
        b = b.redistribute(mesh, keep)
    if isinstance(a, DTensor) and slice_a != list(a_pl):
        a = a.redistribute(mesh, slice_a)
    return a, b


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``jnp``'s promotion of mixed float dtypes (a
    DTensor result's gradient pinned as :func:`_mm`'s)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    if any(isinstance(o, DTensor) for o in ops):
        # the first operand is the activation (its batch rows stay split),
        # the others are weights, gathered whole
        ops = [_rows_only(ops[0]) if isinstance(ops[0], DTensor) else ops[0]] + [
            o.redistribute(o.device_mesh, [Replicate()] * o.device_mesh.ndim)
            if isinstance(o, DTensor) else o for o in ops[1:]]
    return _pin_grad(torch.einsum(eq, *(o.to(dt) for o in ops)))


def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def act_fn(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's to the erf form
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def rope(x, positions, theta: float):
    """Rotary embedding; x: [B, S, H, hd], positions: [B, S] int."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_mask(pos_q, pos_kv, kind: str, window: int):
    """[B, Sq, Skv] boolean mask. pos_kv < 0 marks invalid cache slots."""
    valid = (pos_kv >= 0)[:, None, :]
    if kind == "bidir":
        return valid
    causal = pos_q[:, :, None] >= pos_kv[:, None, :]
    if kind == "local" and window:
        causal = causal & (pos_q[:, :, None] - pos_kv[:, None, :] < window)
    return causal & valid


def _sdpa(q, k, v, mask, cap: float):
    """q: [B,Sq,Hkv,G,hd]; k/v: [B,Skv,Hkv,hd]; mask: [B,Sq,Skv]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # scores in float32 (the reference's preferred_element_type)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    scores = softcap(scores * scale, cap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def _sdpa_blocked(q, k, v, pos_q, pos_kv, kind, window, cap: float, kv_block: int = 1024):
    """Online-softmax attention over KV blocks (long-sequence path).

    Bounds the transient score tensor to [B,H,G,Sq,kv_block].  Like the
    reference, which reshapes the KV axis by ``skv // kv_block``, it takes
    only a KV length that is a multiple of ``kv_block``.
    """
    b, sq, hkv, g, hd = q.shape
    skv = k.shape[1]
    if skv == 0 or skv % kv_block:
        raise ValueError(
            f"blocked attention needs the KV length ({skv}) to be a positive "
            f"multiple of kv_block ({kv_block})"
        )
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    for lo in range(0, skv, kv_block):
        kb, vb = k[:, lo:lo + kv_block], v[:, lo:lo + kv_block]
        pb = pos_kv[:, lo:lo + kv_block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float())
        s = softcap(s * scale, cap)
        mask = _attn_mask(pos_q, pb, kind, window)
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb
        ).float()
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)  # [B,Sq,Hkv,G,hd]


def _whole_unless_divides(x, dim: int, n: int):
    """``x``, or a DTensor gathered along ``dim`` when that dim is split
    over more ranks than divide ``n`` (the count of the leading factor it
    is about to be split into): DTensor refuses to split heads unevenly,
    where GSPMD reshards."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        ranks = math.prod(mesh.size(i) for i, p in enumerate(x.placements) if p.is_shard(dim))
        if n % ranks:
            x = x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                      for p in x.placements])
    return x


def _split_heads(x, n: int, hd: int):
    """``x [B, S, n * hd]`` as ``[B, S, n, hd]``."""
    x = _whole_unless_divides(x, 2, n)
    return x.reshape(x.shape[0], x.shape[1], n, hd)


def attention(x, p: Attention, cfg: ModelConfig, kind: str, positions, kv_cache=None,
              cache_pos=None):
    """Self-attention sub-block.  Returns (out, new_kv) where new_kv is the
    (k, v, positions) to cache: full for train/prefill, the updated cache
    for decode.

    Decode writes the new entry into ``kv_cache`` IN PLACE (the reference
    returns an updated copy) and returns the same tensors: the cache is
    the largest state of a serving engine, and a copy a step would double
    its traffic.  ``cache_pos`` is an ``int`` (one position for the whole
    batch: the reference's dynamic-update-slice) or an int tensor ``[B]``
    (per-slot positions: its scatter)."""
    b, s, d = x.shape
    h = rms_norm(x, p.ln, cfg.norm_eps)
    q = _split_heads(_mm(h, p.wq), cfg.n_heads, cfg.head_dim)
    k = _split_heads(_mm(h, p.wk), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(_mm(h, p.wv), cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    g = cfg.n_heads // cfg.n_kv_heads
    # Head sharding for GQA: when kv_heads < TP degree but q_heads divide it,
    # repeat K/V to full heads for the *compute* (same FLOPs) so the score
    # tensor shards over 'model' on the head dim
    k_cacheable, v_cacheable = k, v  # pre-repeat (cache stores true kv heads)
    tp = axis_size("model")
    if (
        kv_cache is None
        and g > 1
        and cfg.n_kv_heads % tp != 0
        and cfg.n_heads % tp == 0
    ):
        k = constrain(torch.repeat_interleave(k, g, dim=2), "batch", None, "heads", None)
        v = constrain(torch.repeat_interleave(v, g, dim=2), "batch", None, "heads", None)
        qg = q.reshape(b, s, cfg.n_heads, 1, cfg.head_dim)
    else:
        qg = _whole_unless_divides(q, 2, cfg.n_kv_heads).reshape(b, s, cfg.n_kv_heads, g,
                                                                cfg.head_dim)
    qg = constrain(qg, "batch", None, "heads", None, None)

    rules = get_rules()
    if kv_cache is not None:  # decode: append then attend against the cache
        if rules is not None:
            out = _decode_per_rank(qg, k, v, positions, kv_cache, cache_pos, kind, cfg, rules)
        else:
            _write_cache(kv_cache, k, v, positions, cache_pos, kv_cache[0].shape[1])
            ck, cv, cpos = kv_cache
            mask = _attn_mask(positions, cpos, kind, cfg.window)
            out = _sdpa(qg, ck, cv, mask, cfg.attn_softcap).reshape(b, s, cfg.q_dim)
        new_cache = kv_cache
    else:
        if rules is not None:
            out = _attend_per_rank(qg, k, v, positions, kind, cfg, rules)
        else:
            out = _attend(qg, k, v, positions, kind, cfg).reshape(b, s, cfg.q_dim)
        new_cache = (k_cacheable, v_cacheable, positions)
    return constrain(_mm(out, p.wo), "batch", "seq", None), new_cache


def _attend(qg, k, v, positions, kind: str, cfg: ModelConfig):
    """Train / prefill attention of plain tensors: blocked from
    ``BLOCKED_ATTN_THRESHOLD`` tokens up, dense below."""
    if qg.shape[1] >= BLOCKED_ATTN_THRESHOLD:
        return _sdpa_blocked(qg, k, v, positions, positions, kind, cfg.window, cfg.attn_softcap)
    mask = _attn_mask(positions, positions, kind, cfg.window)
    return _sdpa(qg, k, v, mask, cfg.attn_softcap)


def _tp_spec(rules, size: int):
    """The model axis when it splits a dim of ``size`` (heads, vocab)
    evenly over 2 or more ranks, else ``None``."""
    tp = rules.model_axis
    n = mesh_sizes(rules.mesh).get(tp, 1)
    return tp if n > 1 and size % n == 0 else None


def _attend_per_rank(qg, k, v, positions, kind: str, cfg: ModelConfig, rules):
    """:func:`_attend` on each rank's batch rows and heads (each head's
    attention reads only its own q, k and v), as ``[B, S, q_dim]`` with the
    features split as the heads are."""
    mesh = rules.mesh
    b, s = qg.shape[:2]
    bspec = _batch_spec(rules, b)
    hspec = _tp_spec(rules, qg.shape[2])
    q_l = _local(qg, mesh, (bspec, None, hspec, None, None))
    k_l = _local(k, mesh, (bspec, None, hspec, None))
    v_l = _local(v, mesh, (bspec, None, hspec, None))
    pos_l = _local(positions, mesh, (bspec, None))
    out = _attend(q_l, k_l, v_l, pos_l, kind, cfg)
    # heads are the major part of q_dim: a rank's heads are a contiguous block
    return _global(out.reshape(out.shape[0], s, -1), mesh, (bspec, None, hspec))


def _write_cache(kv_cache, k, v, positions, cache_pos, total: int, offset: int = 0):
    """Write the new entry (``k`` / ``v`` ``[B, 1, Hkv, hd]``, ``positions``
    ``[B, 1]``) into ``kv_cache``'s tensors IN PLACE, at slot ``cache_pos %
    total`` (a ring buffer: bounded for local layers).  The tensors hold
    the slots ``offset`` to ``offset + len`` of a cache of ``total`` slots
    (one rank's block of a cache whose sequence is split); a slot outside
    them is left to the rank that holds it."""
    ck, cv, cpos = kv_cache  # [B, n, Hkv, hd] x2, [B, n] positions (-1 empty)
    n = ck.shape[1]
    entries = ((ck, k[:, 0]), (cv, v[:, 0]), (cpos, positions[:, 0]))
    if isinstance(cache_pos, int):
        lo = cache_pos % total - offset
        if 0 <= lo < n:
            for dst, new in entries:
                dst[:, lo] = new.to(dst.dtype)
        return
    rows = torch.arange(ck.shape[0], device=ck.device)
    lo = cache_pos.long() % total - offset
    if n == total:
        for dst, new in entries:
            dst[rows, lo] = new.to(dst.dtype)
        return
    own = (lo >= 0) & (lo < n)
    lo = lo.clamp(0, n - 1)
    for dst, new in entries:
        keep = own.reshape(-1, *([1] * (new.ndim - 1)))
        dst[rows, lo] = torch.where(keep, new.to(dst.dtype), dst[rows, lo])


def _block_spec(t, mesh) -> tuple:
    """The spec of a DTensor's placements (a plain tensor: replicated)."""
    spec = [None] * t.ndim
    if isinstance(t, DTensor):
        for name, p in zip(mesh.mesh_dim_names, t.placements):
            if p.is_shard():
                prev = spec[p.dim]
                spec[p.dim] = name if prev is None else (*(prev if isinstance(prev, tuple)
                                                           else (prev,)), name)
    return tuple(spec)


def _block_offset(mesh, axes, block: int) -> int:
    """This rank's first index along a dimension split over ``axes`` (in
    the mesh's order, major first) in blocks of ``block``."""
    if axes is None:
        return 0
    idx = 0
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx * block


def _decode_per_rank(qg, k, v, positions, kv_cache, cache_pos, kind: str, cfg: ModelConfig,
                     rules):
    """Decode attention on each rank's block of the cache, as ``[B, 1,
    q_dim]``.  The cache keeps its placements (``launch.sharding.
    cache_shardings``: batch over the batch axes, the sequence over
    ``model`` when long): the new entry is written IN PLACE into the block
    of the rank that holds its slot.  With the sequence split, every rank
    takes all heads over its block of slots and the softmax is combined
    over the ranks (a max, then sums of the weights and of the weighted
    values); otherwise each rank takes its heads over all slots."""
    mesh = rules.mesh
    ck, cv, cpos = kv_cache
    b = qg.shape[0]
    spec = _block_spec(ck, mesh)
    if spec[2:] != (None, None) or _block_spec(cpos, mesh) != spec[:2]:
        raise ValueError(f"decode takes a cache split on batch and sequence only, not {spec}")
    bspec, sspec = spec[:2]
    local = tuple(t.to_local() if isinstance(t, DTensor) else t for t in kv_cache)
    n = local[0].shape[1]
    total = ck.shape[1]
    pos_l = _local(positions, mesh, (bspec, None))
    step_pos = cache_pos if isinstance(cache_pos, int) else _local(cache_pos, mesh, (bspec,))
    _write_cache(local, _local(k, mesh, (bspec, None, None, None)),
                 _local(v, mesh, (bspec, None, None, None)), pos_l, step_pos, total,
                 _block_offset(mesh, sspec, n))
    ck_l, cv_l, cpos_l = local
    mask = _attn_mask(pos_l, cpos_l, kind, cfg.window)
    if sspec is None:
        hspec = _tp_spec(rules, qg.shape[2])
        q_l = _local(qg, mesh, (bspec, None, hspec, None, None))
        h = q_l.shape[2]
        first = _block_offset(mesh, hspec, h)
        out = _sdpa(q_l, ck_l.narrow(2, first, h), cv_l.narrow(2, first, h), mask,
                    cfg.attn_softcap)
        return _global(out.reshape(out.shape[0], 1, -1), mesh, (bspec, None, hspec))
    q_l = _local(qg, mesh, (bspec, None, None, None, None))
    out = _sdpa_split(q_l, ck_l, cv_l, mask, cfg.attn_softcap, mesh, sspec)
    return _global(out.reshape(out.shape[0], 1, -1), mesh, (bspec, None, None))


def _sdpa_split(q, k, v, mask, cap: float, mesh, axes):
    """:func:`_sdpa` of this rank's block of the KV sequence, combined
    with the other blocks over ``mesh``'s ``axes``: the global max of the scores
    (``all_reduce`` MAX; no gradient flows through it, the softmax does not
    depend on it), then the sums of the weights and of the weighted values."""
    import torch.distributed as dist

    axes = axes if isinstance(axes, tuple) else (axes,)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    scores = softcap(scores * scale, cap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    m = scores.detach().amax(dim=-1, keepdim=True)
    for a in axes:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    e = torch.exp(scores - m)
    den = e.sum(dim=-1, keepdim=True)
    for a in axes:
        den = psum(den, a)
    out = torch.einsum("bhgqk,bkhd->bqhgd", (e / den).to(v.dtype), v)
    for a in axes:
        out = psum(out, a)
    return out


def embedding_lookup(table, tokens):
    """Vocab-parallel embedding gather.

    With the table vocab-sharded over 'model', each model shard gathers its
    local rows (out-of-range tokens masked to zero) and the partial outputs
    sum over 'model' -- the classic Megatron vocab-parallel embedding.  A
    plain row gather when no rules are active or the vocab does not divide
    the TP degree.
    """
    rules = get_rules()
    v = table.shape[0]
    if rules is None:
        return table[tokens]
    mesh = rules.mesh
    tp = rules.model_axis
    tp_size = mesh_sizes(mesh).get(tp, 1)
    if tp_size == 1 or v % tp_size != 0:
        return table[tokens]
    bspec = _batch_spec(rules, tokens.shape[0])
    rows = v // tp_size
    tbl = _local(table, mesh, (tp, None))
    tok = _local(tokens, mesh, (bspec, None))
    off = mesh.get_local_rank(tp) * rows
    idx = tok - off
    ok = (idx >= 0) & (idx < rows)
    local_rows = tbl[idx.clamp(0, rows - 1)]
    out = torch.where(ok[..., None], local_rows, torch.zeros_like(local_rows))
    return _global(psum(out, tp), mesh, (bspec, None, None))


# ---------------------------------------------------------------------------
# dense MLP and MoE
# ---------------------------------------------------------------------------


def mlp(x, p: MLP, cfg: ModelConfig):
    h = rms_norm(x, p.ln, cfg.norm_eps)
    gate = act_fn(_mm(h, p.w_gate), cfg.act)
    up = _mm(h, p.w_up)
    hidden = constrain(gate * up, "batch", None, "ff")
    return constrain(_mm(hidden, p.w_down), "batch", "seq", None)


def moe_route(tokens, router, cfg: ModelConfig):
    """Top-k routing with capacity.  Returns (cap, slot [T, k], top_p,
    top_ids, probs): ``slot`` is each (token, choice) pair's row in the
    [E*cap] capacity buffer, or the sentinel ``E*cap`` when dropped.  A
    pair's rank within its expert comes from a stable argsort over expert
    ids, so an expert keeps its first ``cap`` pairs in token order."""
    t = tokens.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = min(int(math.ceil(cfg.capacity_factor * t * k / e)), t)
    # router matmul in the compute dtype, softmax in f32 (as the reference)
    router_logits = (tokens @ router.to(tokens.dtype)).float()
    probs = torch.softmax(router_logits, dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)  # [T, k], descending
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    flat_ids = top_ids.reshape(-1)  # [T*k], slot-major per token
    order = torch.argsort(flat_ids, stable=True)
    sorted_expert = flat_ids[order]
    # rank within expert: position among all (token, slot) pairs of that expert
    same = torch.cumsum(F.one_hot(sorted_expert, e), dim=0)
    rank_sorted = same.gather(1, sorted_expert[:, None])[:, 0] - 1
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    slot = torch.where(rank < cap, flat_ids * cap + rank, e * cap).reshape(t, k)
    return cap, slot, top_p, top_ids, probs


def moe_dispatch_local(tokens, router, w_gate, w_up, w_down, cfg: ModelConfig, tp_axis=None):
    """Sort-based top-k dispatch with capacity, entirely rank-local.

    tokens: [T, D].  Routes each token to its top_k experts
    (:func:`moe_route`), packs tokens into [E, C, D] capacity buffers
    (pairs past capacity are dropped, Switch-style), runs the expert GEMMs
    (the ff dim TP-sharded under the mesh branch of :func:`moe`;
    ``tp_axis`` names the axis to sum the partial down-projections over),
    and combines with the router weights.  Returns (out [T, D], the
    load-balancing aux loss).
    """
    t, d = tokens.shape
    e, k = cfg.n_experts, cfg.top_k
    cap, slot, top_p, top_ids, probs = moe_route(tokens, router, cfg)

    # fill the [E, C, D] buffer by gather: scatter the token index per slot
    # (dropped pairs all land on the sentinel e*cap, which is cut off), then
    # gather rows once; the sentinel row of tok_pad is zeros
    inv = torch.full((e * cap + 1,), t, dtype=torch.long, device=tokens.device)
    inv[slot.reshape(-1)] = torch.arange(t * k, device=tokens.device) // k
    tok_pad = torch.cat([tokens, tokens.new_zeros((1, d))], dim=0)
    buf = tok_pad[inv[: e * cap]].reshape(e, cap, d)

    gate = act_fn(torch.bmm(buf, w_gate.to(buf.dtype)), cfg.act)
    up = torch.bmm(buf, w_up.to(buf.dtype))
    expert_out = torch.bmm(gate * up, w_down.to(buf.dtype))
    if tp_axis is not None:  # partial sums over the TP-sharded ff dim
        expert_out = psum(expert_out, tp_axis)

    flat_out = torch.cat([expert_out.reshape(e * cap, d), expert_out.new_zeros((1, d))], dim=0)
    gathered = flat_out[slot.reshape(-1)].reshape(t, k, d)
    out = torch.einsum("tkd,tk->td", gathered, top_p.to(expert_out.dtype))
    # load-balancing auxiliary loss (Switch-style)
    frac_tokens = F.one_hot(top_ids[:, 0], e).float().mean(0)
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    return out, aux


def moe(x, p: MoE, cfg: ModelConfig):
    """MoE ffn: pre-norm, then the dispatch.

    With no rules: the local dispatch over all B*S tokens.  Under rules
    (the reference's ``shard_map`` branch, taken on any mesh, 1 x 1
    included): tokens stay rank-local for the sort/dispatch, expert ffn
    weights are TP-sharded on the ff dim with a psum of the partial
    down-projections (Megatron-style TP within each expert), or replicated
    when that would leave under 128 ff columns a rank -- then the sequence
    is sharded over 'model' instead.  ``moe_token_chunk`` > 1 runs the
    dispatch chunk by chunk, each checkpointed, with capacity per chunk.
    The aux loss is averaged over the batch and sequence axes.
    """
    b, s, d = x.shape
    x = rms_norm(x, p.ln, cfg.norm_eps)  # pre-norm (as in the dense mlp)
    rules = get_rules()
    if rules is None:
        out, aux = moe_dispatch_local(
            x.reshape(b * s, d), p.router, p.w_gate, p.w_up, p.w_down, cfg
        )
        return out.reshape(b, s, d), aux

    mesh = rules.mesh
    tp = rules.model_axis
    sizes = mesh_sizes(mesh)
    tp_size = sizes.get(tp, 1)
    # tiny experts: TP-sharding moe_d_ff below 128 columns a rank only buys
    # a psum -- replicate the expert weights instead (they are small)
    replicate_experts = cfg.moe_d_ff // max(tp_size, 1) < 128
    batch_spec = _batch_spec(rules, b)
    # expert-data-parallel: with replicated experts, also shard the sequence
    # over 'model' so each TP rank routes its own token slice (replicated
    # tokens when the sequence does not divide, e.g. decode)
    seq_spec = tp if (replicate_experts and s % max(tp_size, 1) == 0) else None
    ff = None if replicate_experts else tp
    xl = _local(x, mesh, (batch_spec, seq_spec, None))
    router = _local(p.router, mesh, (None, None))
    wg = _local(p.w_gate, mesh, (None, None, ff))
    wu = _local(p.w_up, mesh, (None, None, ff))
    wd = _local(p.w_down, mesh, (None, ff, None))

    bl, sl, _ = xl.shape
    tokens = xl.reshape(bl * sl, d)
    nc = cfg.moe_token_chunk
    if nc > 1 and (bl * sl) % nc == 0:
        # chunk by chunk: peak dispatch buffers shrink by nc (capacity is
        # enforced per chunk, as with expert parallelism)
        def body(tc):
            return moe_dispatch_local(tc, router, wg, wu, wd, cfg, tp_axis=ff)

        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        outs = []
        for tc in tokens.reshape(nc, (bl * sl) // nc, d):
            oc, ac = checkpoint(bound_to_rules(body), tc, use_reentrant=False)
            aux = aux + ac
            outs.append(oc)
        out = torch.stack(outs).reshape(bl * sl, d)
        aux = aux / nc
    else:
        out, aux = moe_dispatch_local(tokens, router, wg, wu, wd, cfg, tp_axis=ff)
    axes = (batch_spec or ()) + ((seq_spec,) if seq_spec else ())
    for a in axes:  # pmean, one axis at a time (equal-sized groups)
        aux = psum(aux, a) / sizes[a]
    out = _global(out.reshape(bl, sl, d), mesh, (batch_spec, seq_spec, None))
    aux = _global(aux, mesh, ())
    return constrain(out, "batch", "seq", None), aux
