"""Unified multi-architecture LM (the port of ``repro.models.model``).

A model is the reference's sequence of *layer groups*, each (pattern,
repeats); the reference scans each group over stacked per-layer params,
and the port walks one ``nn.ModuleList`` of blocks in the same execution
order (group by group, repeat by repeat, pattern entry by entry).  Caches
are a list with one entry per block, in that order.  The same block code
serves train (no cache), prefill (emits caches) and decode (carries
caches).

Block kinds: attn / local / bidir (attention + dense-or-MoE ffn),
rec (RG-LRU + ffn), rwkv (time mix + channel mix).

Training takes gradients through ``forward`` (optionally rematerialised:
``remat`` / ``remat_policy``, the counterpart of the reference's
``jax.checkpoint`` on its scan body) and :func:`chunked_ce_loss`.

The functions keep the reference's names and arguments; ``params`` is the
port's :class:`LM` module in place of the params pytree.
:func:`repro_torch.convert.lm_params_from_reference` loads a reference
pytree into one.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.context import bound_to_rules, constrain, get_rules, psum

from . import layers as L
from . import rglru as RG
from . import rwkv6 as RW

__all__ = [
    "LM", "Block", "block_kinds", "init_params", "param_count_exact", "init_cache",
    "forward", "logits_from_hidden", "chunked_ce_loss", "decode_step",
]

_ATTN_KINDS = ("attn", "local", "bidir")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer; its sub-modules carry the reference's keys ("attn",
    "ffn", "rec", "rwkv")."""

    def __init__(self, kind: str, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.kind = kind
        if kind in _ATTN_KINDS:
            self.attn = L.Attention(cfg, init)
            self.ffn = L.MoE(cfg, init) if cfg.moe else L.MLP(cfg, init)
        elif kind == "rec":
            self.rec = RG.RGLRU(cfg, init)
            self.ffn = L.MLP(cfg, init)
        elif kind == "rwkv":
            self.rwkv = RW.RWKV(cfg, init)
        else:
            raise ValueError(kind)


def block_kinds(cfg: ModelConfig) -> list[str]:
    """The kind of every layer, in execution order."""
    return [kind for pattern, reps in cfg.layer_groups() for _ in range(reps) for kind in pattern]


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.cfg = cfg  # the layer groups: checkpoints restack blocks by them
        d = cfg.d_model
        self.embed = init.normal((cfg.vocab_padded, d), 0.02)
        self.final_norm = init.full((d,), 1.0)
        if not cfg.tie_embeddings:
            self.lm_head = init.dense(d, (d, cfg.vocab_padded))
        if cfg.frontend != "none":
            self.frontend_proj = init.dense(cfg.frontend_dim, (cfg.frontend_dim, d))
        self.blocks = nn.ModuleList(Block(kind, cfg, init) for kind in block_kinds(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None) -> LM:
    """A randomly initialised model on ``device`` (default: the CUDA card;
    ``"meta"`` for shapes only), its weights drawn from a
    ``torch.Generator`` seeded with ``seed``.  The draws are not the
    reference's (``jax.random`` differs); the distributions are.  Weights
    take no gradients (serving); ``repro_torch.train.init_train_state``
    turns them on."""
    dev = resolve_device(device)
    return LM(cfg, L.Init(seed, dev, dtype))


def param_count_exact(cfg: ModelConfig) -> int:
    """Parameters of the real init, built on the meta device (no memory)."""
    return int(sum(p.numel() for p in init_params(cfg, device="meta").parameters()))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _cache_len(kind: str, cfg: ModelConfig, max_seq: int) -> int:
    if kind == "local" and cfg.window:
        return min(cfg.window, max_seq)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device=None):
    """Decode caches, one tuple a block in execution order."""
    dev = resolve_device(device)
    caches = []
    for kind in block_kinds(cfg):
        if kind in _ATTN_KINDS:
            sc = _cache_len(kind, cfg, max_seq)
            shape = (batch, sc, cfg.n_kv_heads, cfg.head_dim)
            caches.append((
                torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev),
                torch.full((batch, sc), -1, dtype=torch.int32, device=dev),
            ))
        elif kind == "rec":
            caches.append((
                torch.zeros((batch, cfg.rnn_width), dtype=torch.float32, device=dev),
                torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width), dtype=dtype, device=dev),
            ))
        elif kind == "rwkv":
            caches.append((
                torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                            dtype=torch.float32, device=dev),
                torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev),
                torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev),
            ))
    return caches


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _apply_block(x, bp: Block, kind, cfg, positions, cache=None, cache_pos=None, aux=0.0):
    if kind in _ATTN_KINDS:
        a_out, kv = L.attention(
            x, bp.attn, cfg, kind, positions, kv_cache=cache, cache_pos=cache_pos
        )
        x = x + a_out
        if cfg.moe:
            f_out, a = L.moe(x, bp.ffn, cfg)
            aux = aux + a
        else:
            f_out = L.mlp(x, bp.ffn, cfg)
        return x + f_out, kv, aux
    if kind == "rec":
        r_out, st = RG.rglru_block(x, bp.rec, cfg, state=cache)
        x = x + r_out
        return x + L.mlp(x, bp.ffn, cfg), st, aux
    if kind == "rwkv":
        p = bp.rwkv
        wkv_state, shift_t, shift_c = cache if cache is not None else (None, None, None)
        t_out, wkv_state, shift_t = RW.time_mix(
            x, p, cfg, state=wkv_state, shift_prev=shift_t, chunked=x.shape[1] > 1
        )
        x = x + t_out
        c_out, shift_c = RW.channel_mix(x, p, cfg, shift_prev=shift_c)
        return x + c_out, (wkv_state, shift_t, shift_c), aux
    raise ValueError(kind)


def _roll_seq(x, shift: int):
    """``torch.roll`` along dim 1.  A DTensor rolls each block with dim 1
    whole (gathered first where it is split): torch 2.11's DTensor has no
    placement rule for ``roll``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return torch.roll(x, shift, dims=1)
    mesh = x.device_mesh
    placements = [Replicate() if p.is_shard(1) else p for p in x.placements]
    x = x.redistribute(mesh, placements)
    return DTensor.from_local(torch.roll(x.to_local(), shift, dims=1), mesh, placements,
                              run_check=False)


def _prep_train_cache(kind, cfg, kv, max_seq):
    """Convert full-sequence block state into a decode cache slice (prefill)."""
    if kind in _ATTN_KINDS:
        k, v, pos = kv
        sc = _cache_len(kind, cfg, max_seq)
        s = k.shape[1]
        pos = pos.expand(k.shape[:2])
        if s >= sc:
            # keep the last sc entries, rolled so that the entry for position
            # p sits at index p % sc -- decode's ring indexing then lines up
            shift = s % sc
            return tuple(_roll_seq(t[:, -sc:], shift) for t in (k, v, pos))
        pad = sc - s
        return (
            nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            nn.functional.pad(v, (0, 0, 0, 0, 0, pad)),
            nn.functional.pad(pos, (0, pad), value=-1),
        )
    return kv


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _embed_inputs(params: LM, cfg: ModelConfig, batch: dict, dtype):
    """tokens (+ stub frontend features) -> initial hidden states [B,S,D]."""
    if cfg.frontend == "audio":
        return L._mm(batch["features"].to(dtype), params.frontend_proj)
    parts = []
    if cfg.frontend == "vision":
        parts.append(L._mm(batch["patches"].to(dtype), params.frontend_proj))
    tok = L.embedding_lookup(params.embed, batch["tokens"])
    if cfg.scale_embed:
        tok = tok * math.sqrt(cfg.d_model)
    parts.append(tok)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


# the outputs the "dots" policy keeps (``jax.checkpoint_policies.checkpoint_dots``
# saves every dot_general's): matrix products; everything else is recomputed
_DOT_OPS = frozenset({torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm})


def _save_dots(ctx, op, *args, **kwargs):
    if op.overloadpacket in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, policy: str):
    """``body`` under activation checkpointing: ``"full"`` keeps only its
    inputs, ``"dots"`` also the outputs of its matrix products."""
    body = bound_to_rules(body)  # recomputed on the backward pass's thread
    if policy == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat_policy must be 'full' or 'dots', not {policy!r}")


def forward(params: LM, cfg: ModelConfig, batch: dict, *, mode: str = "train",
            remat: bool = False, remat_policy: str = "full",
            compute_dtype=None, max_seq: int | None = None):
    """Full-sequence pass.  Returns (hidden [B,S,D], caches-or-None, aux).

    ``batch`` holds tensors on the model's device: ``tokens`` [B, S] int
    (plus ``patches`` / ``features`` for the stub front-ends, and
    optionally ``positions`` [B, S]).  With ``remat`` each repetition of a
    layer group's pattern (the reference's scan body) is one checkpointed
    region, recomputed in the backward pass (``remat_policy``: ``"full"``
    or ``"dots"``)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', not {mode!r}")
    x = _embed_inputs(params, cfg, batch, compute_dtype or params.embed.dtype)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = constrain(x, "batch", "seq", None)
    max_seq = max_seq or s

    def body(x, aux, blocks):
        caches = []
        for bp in blocks:
            x, kv, aux = _apply_block(x, bp, bp.kind, cfg, positions, aux=aux)
            if mode == "prefill":
                caches.append(_prep_train_cache(bp.kind, cfg, kv, max_seq))
        return x, aux, caches

    if remat:
        body = _remat(body, remat_policy)
    caches = [] if mode == "prefill" else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    j = 0
    for pattern, reps in cfg.layer_groups():
        for _ in range(reps):
            x, aux_total, cs = body(x, aux_total, params.blocks[j:j + len(pattern)])
            j += len(pattern)
            if mode == "prefill":
                caches.extend(cs)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, caches, aux_total


def _mask_pad_vocab(logits, cfg: ModelConfig):
    if cfg.vocab_padded == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < cfg.vocab, logits, L.NEG_INF)


def logits_from_hidden(params: LM, cfg: ModelConfig, h):
    """Logits over the padded vocab; padded columns are masked to -1e30
    (argmax/softmax then never select them).  Width = cfg.vocab_padded."""
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = L._mm(h, w).float()
    logits = L.softcap(logits, cfg.logit_softcap)
    return constrain(_mask_pad_vocab(logits, cfg), "batch", None, "vocab")


def _token_nll(logits, labels):
    """Per-token ``logsumexp(logits) - logits[label]`` ``[B, S]`` in float32.

    Under sharding rules it runs per rank (Megatron's vocab-parallel
    cross-entropy): each rank its batch rows and its block of the vocab, the
    log-sum-exp from a global max (an ``all_reduce`` MAX, no gradient: the
    result does not depend on it) and a sum over 'model', the label's logit
    from the rank whose block holds it.  No rank ever holds a row of the
    whole vocab: DTensor's own gather along a split vocab gathers the
    logits whole (the whole vocab, float32, for every token of a chunk), and
    its backward makes zeros of the global shape on every rank."""
    rules = get_rules()
    if rules is None:
        logz = torch.logsumexp(logits, dim=-1)
        return logz - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    import torch.distributed as dist

    mesh = rules.mesh
    tp = rules.model_axis
    bspec = L._batch_spec(rules, logits.shape[0])
    vspec = L._tp_spec(rules, logits.shape[-1])  # the model axis when it splits the vocab
    lg = L._local(logits, mesh, (bspec, None, vspec))
    lb = L._local(labels, mesh, (bspec, None)).long()
    if vspec is None:
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, lb[..., None])[..., 0]
    else:
        n = lg.shape[-1]
        m = lg.detach().amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(tp))
        logz = torch.log(psum(torch.exp(lg - m).sum(dim=-1), tp)) + m[..., 0]
        idx = lb - mesh.get_local_rank(tp) * n
        mine = (idx >= 0) & (idx < n)
        ll = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        ll = psum(torch.where(mine, ll, torch.zeros_like(ll)), tp)
    return L._global(logz - ll, mesh, (bspec, None))


def chunked_ce_loss(params: LM, cfg: ModelConfig, h, labels, mask=None, chunk: int = 1024):
    """Cross-entropy over the vocab without materialising [B,S,V] at once.

    The sequence is cut into ``min(chunk, S)``-long pieces (each over the
    whole batch), then the remainder, as in the reference.  Every full
    piece is checkpointed: only its inputs are kept for the backward pass,
    not its float32 logits (the dominant memory term of the loss); the
    remainder is not, as the reference's is not."""
    b, s, d = h.shape
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    chunk = min(chunk, s)
    n = s // chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)

    def chunk_loss(hc, lc, mc):
        logits = L.softcap(L._mm(hc, w).float(), cfg.logit_softcap)
        logits = constrain(_mask_pad_vocab(logits, cfg), "batch", None, "vocab")
        return torch.sum(_token_nll(logits, lc) * mc), torch.sum(mc)

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, n * chunk, chunk):
        piece = slice(lo, lo + chunk)
        l, c = checkpoint(bound_to_rules(chunk_loss), h[:, piece], labels[:, piece],
                          mask[:, piece], use_reentrant=False)
        tot, cnt = tot + l, cnt + c
    if s > n * chunk:
        l, c = chunk_loss(h[:, n * chunk:], labels[:, n * chunk:], mask[:, n * chunk:])
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def decode_step(params: LM, cfg: ModelConfig, caches, tokens, pos):
    """One decode step.  tokens: [B, 1]; pos: an int (or 0-d tensor) for the
    whole batch, or per-slot positions, an int tensor [B].

    Returns (logits [B, 1, V], caches).  Attention caches are updated in
    place (see :func:`repro_torch.models.layers.attention`); recurrent
    states come back as new tensors."""
    x = L.embedding_lookup(params.embed, tokens)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    b = tokens.shape[0]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(x.device)
        positions = pos.to(torch.int32)[:, None]
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    x = constrain(x, "batch", None, None)
    new_caches = []
    for bp, cache in zip(params.blocks, caches):
        x, st, _ = _apply_block(x, bp, bp.kind, cfg, positions, cache=cache, cache_pos=pos)
        new_caches.append(st)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), new_caches
