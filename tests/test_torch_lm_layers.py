"""The port's neural layers (``repro_torch.models.layers``, ``rglru``,
``rwkv6``) against the reference's.

Each case builds the reference's params for one block (perturbed with
numpy noise, so norms and mixes are not all ones and zeros), loads the
same numbers into the port's module, feeds both the same numpy-seeded
inputs, and holds the outputs and returned states ``allclose`` in float32
on the CPU.  Tolerances: 1e-5 (absolute and relative) for single
elementwise / normalisation ops, 1e-4 for anything behind a matrix
product or a softmax (sums taken in another order), 1e-4 for the RWKV
recurrences whose states grow over the sequence.  Masks and MoE routing
are compared exactly.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro.models.rglru as RG
import repro.models.rwkv6 as RW
import repro_torch.models.layers as TL
import repro_torch.models.rglru as TG
import repro_torch.models.rwkv6 as TW
from _torch_lm import close, module_from, np_tree, perturb, t
from repro.configs import get_config as r_config
from repro_torch.configs import get_config

KEY = jax.random.PRNGKey(7)
TIGHT = dict(atol=1e-5, rtol=1e-5)
MATMUL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, **kw):
    """The reduced config in both packages (the same numbers)."""
    rc, tc = r_config(arch, reduced=True), get_config(arch, reduced=True)
    return dataclasses.replace(rc, **kw), dataclasses.replace(tc, **kw)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = _normal(rng, 2, 5, 64, scale=3.0), _normal(rng, 64)
    close(TL.rms_norm(t(x), t(scale), 1e-5), RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
          **TIGHT)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 9, 4, 16)
    pos = rng.integers(0, 512, (2, 9)).astype(np.int32)
    close(TL.rope(t(x), t(pos), theta), RL.rope(jnp.asarray(x), jnp.asarray(pos), theta), **TIGHT)


@pytest.mark.parametrize("kind,window", [("attn", 0), ("local", 4), ("local", 0), ("bidir", 0)])
def test_attn_mask(kind, window):
    rng = np.random.default_rng(2)
    pos_q = rng.integers(0, 20, (2, 6)).astype(np.int32)
    pos_kv = rng.integers(-1, 20, (2, 11)).astype(np.int32)  # -1: empty cache slots
    got = TL._attn_mask(t(pos_q), t(pos_kv), kind, window).numpy()
    want = np.asarray(RL._attn_mask(jnp.asarray(pos_q), jnp.asarray(pos_kv), kind, window))
    assert np.array_equal(got, want)


def _qkv(rng, b=2, s=24, hkv=2, g=2, hd=16):
    return _normal(rng, b, s, hkv, g, hd), _normal(rng, b, s, hkv, hd), _normal(rng, b, s, hkv, hd)


@pytest.mark.parametrize("kind,window,cap", [("attn", 0, 0.0), ("local", 8, 0.0),
                                             ("attn", 0, 5.0), ("bidir", 0, 0.0)])
def test_sdpa(kind, window, cap):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    pos[1, -3:] = -1
    mask_r = RL._attn_mask(jnp.asarray(pos), jnp.asarray(pos), kind, window)
    mask_t = TL._attn_mask(t(pos), t(pos), kind, window)
    close(TL._sdpa(t(q), t(k), t(v), mask_t, cap),
          RL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_r, cap), **MATMUL)


@pytest.mark.parametrize("kind,window,cap", [("attn", 0, 0.0), ("local", 64, 0.0),
                                             ("attn", 0, 30.0)])
def test_sdpa_blocked(kind, window, cap):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, b=1, s=256)
    pos = np.arange(256, dtype=np.int32)[None, :]
    want = RL._sdpa_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(pos), kind, window, cap, kv_block=64)
    got = TL._sdpa_blocked(t(q), t(k), t(v), t(pos), t(pos), kind, window, cap, kv_block=64)
    close(got, want, **MATMUL)
    plain = TL._sdpa(t(q), t(k), t(v), TL._attn_mask(t(pos), t(pos), kind, window), cap)
    close(got, plain.numpy(), **MATMUL)


def test_sdpa_blocked_refuses_a_ragged_kv_length():
    """The reference reshapes the KV axis by ``skv // kv_block`` and fails on
    a length that is not a multiple; the port raises there too, no padding."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, b=1, s=100)
    pos = np.arange(100, dtype=np.int32)[None, :]
    with pytest.raises(TypeError):
        RL._sdpa_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                         jnp.asarray(pos), "attn", 0, 0.0, kv_block=64)
    with pytest.raises(ValueError, match="multiple of kv_block"):
        TL._sdpa_blocked(t(q), t(k), t(v), t(pos), t(pos), "attn", 0, 0.0, kv_block=64)


# ---------------------------------------------------------------------------
# attention sub-block
# ---------------------------------------------------------------------------

# (arch, kind): qk-norm + GQA; sliding window + attention softcap; bidirectional
ATTN_CASES = [("qwen3-1.7b", "attn"), ("gemma2-27b", "local"), ("hubert-xlarge", "bidir")]


def _attention_pair(arch, seed):
    rcfg, tcfg = _cfgs(arch)
    p = perturb(np_tree(RL.init_attention(jax.random.fold_in(KEY, seed), rcfg, jnp.float32)), seed)
    return rcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()}, module_from(TL.Attention, tcfg, p)


@pytest.mark.parametrize("arch,kind", ATTN_CASES)
def test_attention_train_prefill(arch, kind):
    rcfg, tcfg, rp, tp = _attention_pair(arch, 10)
    rng = np.random.default_rng(10)
    x = _normal(rng, 2, 20, rcfg.d_model)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    out_r, (k_r, v_r, p_r) = RL.attention(jnp.asarray(x), rp, rcfg, kind, jnp.asarray(pos))
    out_t, (k_t, v_t, p_t) = TL.attention(t(x), tp, tcfg, kind, t(pos))
    close(out_t, out_r, **MATMUL)
    close(k_t, k_r, **MATMUL)
    close(v_t, v_r, **MATMUL)
    assert np.array_equal(p_t.numpy(), np.asarray(p_r))


def _decode_inputs(rcfg, rng, b=3, sc=16):
    x = _normal(rng, b, 1, rcfg.d_model)
    ck = _normal(rng, b, sc, rcfg.n_kv_heads, rcfg.head_dim)
    cv = _normal(rng, b, sc, rcfg.n_kv_heads, rcfg.head_dim)
    cpos = np.full((b, sc), -1, np.int32)
    cpos[:, :11] = np.arange(11)  # 11 entries written, the rest empty
    return x, ck, cv, cpos


@pytest.mark.parametrize("arch,kind", ATTN_CASES[:2])
@pytest.mark.parametrize("form", ["scalar", "per_slot"])
def test_attention_decode(arch, kind, form):
    """Both decode forms: one position for the batch (the reference's
    dynamic-update-slice) and per-slot positions (its scatter); a local
    layer's ring buffer wraps (position 21 of a 16-entry cache)."""
    rcfg, tcfg, rp, tp = _attention_pair(arch, 11)
    rng = np.random.default_rng(11)
    x, ck, cv, cpos = _decode_inputs(rcfg, rng)
    if form == "scalar":
        pos_r, pos_t = jnp.int32(11), 11
        positions = np.full((3, 1), 11, np.int32)
    else:
        per = np.array([11, 21, 4], np.int32)
        pos_r, pos_t = jnp.asarray(per), t(per)
        positions = per[:, None]
    cache_r = (jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cpos))
    out_r, (k_r, v_r, p_r) = RL.attention(jnp.asarray(x), rp, rcfg, kind, jnp.asarray(positions),
                                          kv_cache=cache_r, cache_pos=pos_r)
    cache_t = (t(ck), t(cv), t(cpos))
    out_t, (k_t, v_t, p_t) = TL.attention(t(x), tp, tcfg, kind, t(positions),
                                          kv_cache=cache_t, cache_pos=pos_t)
    close(out_t, out_r, **MATMUL)
    close(k_t, k_r, **MATMUL)
    close(v_t, v_r, **MATMUL)
    assert np.array_equal(p_t.numpy(), np.asarray(p_r))
    assert k_t is cache_t[0], "decode writes the cache in place"


# ---------------------------------------------------------------------------
# MLP and MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b"])  # silu, gelu (tanh form)
def test_mlp(arch):
    rcfg, tcfg = _cfgs(arch)
    p = perturb(np_tree(RL.init_mlp(KEY, rcfg, jnp.float32)), 12)
    rng = np.random.default_rng(12)
    x = _normal(rng, 2, 7, rcfg.d_model)
    want = RL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rcfg)
    close(TL.mlp(t(x), module_from(TL.MLP, tcfg, p), tcfg), want, **MATMUL)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    close(TL.act_fn(t(x), "gelu"), jax.nn.gelu(jnp.asarray(x)), **TIGHT)


def _kept_oracle(top_ids: np.ndarray, e: int, cap: int) -> np.ndarray:
    """Each expert keeps its first ``cap`` (token, choice) pairs in token-major order."""
    seen = np.zeros(e, np.int64)
    keep = np.zeros(top_ids.size, bool)
    for j, ex in enumerate(top_ids.reshape(-1)):
        keep[j] = seen[ex] < cap
        seen[ex] += 1
    return keep.reshape(top_ids.shape)


@pytest.mark.parametrize("arch,capacity", [("mixtral-8x22b", 1.25), ("granite-moe-1b-a400m", 0.5),
                                           ("granite-moe-1b-a400m", 8.0)])
def test_moe_dispatch_local(arch, capacity):
    """Outputs and aux loss allclose; the kept (token, expert) pairs equal
    the capacity rule's, token for token.  Capacity 0.5 is the drop case of
    ``tests/test_models.py::test_moe_capacity_drops_tokens``."""
    rcfg, tcfg = _cfgs(arch, capacity_factor=capacity)
    p = perturb(np_tree(RL.init_moe(KEY, rcfg, jnp.float32)), 13)
    rng = np.random.default_rng(13)
    tokens = _normal(rng, 32, rcfg.d_model)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    out_r, aux_r = RL.moe_dispatch_local(jnp.asarray(tokens), rp["router"], rp["w_gate"],
                                         rp["w_up"], rp["w_down"], rcfg)
    tp = module_from(TL.MoE, tcfg, p)
    out_t, aux_t = TL.moe_dispatch_local(t(tokens), tp.router, tp.w_gate, tp.w_up, tp.w_down, tcfg)
    close(out_t, out_r, **MATMUL)
    close(aux_t, aux_r, **MATMUL)

    cap, slot, _, top_ids, _ = TL.moe_route(t(tokens), tp.router, tcfg)
    probs_r = jax.nn.softmax(jnp.asarray(tokens) @ rp["router"], axis=-1)
    assert np.array_equal(top_ids.numpy(), np.asarray(jax.lax.top_k(probs_r, rcfg.top_k)[1]))
    kept = (slot < tcfg.n_experts * cap).numpy()
    assert np.array_equal(kept, _kept_oracle(top_ids.numpy(), tcfg.n_experts, cap))
    if capacity == 0.5:
        assert not kept.all(), "capacity 0.5 must drop pairs"
        gone = ~kept.any(1)  # tokens with every choice dropped contribute nothing
        assert gone.any() and np.all(np.asarray(out_r)[gone] == 0)
        assert np.all(out_t.numpy()[gone] == 0)
    if capacity == 8.0:
        assert kept.all()


def test_moe_block():
    rcfg, tcfg = _cfgs("mixtral-8x22b")
    p = perturb(np_tree(RL.init_moe(KEY, rcfg, jnp.float32)), 14)
    rng = np.random.default_rng(14)
    x = _normal(rng, 2, 9, rcfg.d_model)
    out_r, aux_r = RL.moe(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rcfg)
    out_t, aux_t = TL.moe(t(x), module_from(TL.MoE, tcfg, p), tcfg)
    close(out_t, out_r, **MATMUL)
    close(aux_t, aux_r, **MATMUL)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_rglru_block_prefill_then_decode():
    rcfg, tcfg = _cfgs("recurrentgemma-2b")
    p = perturb(np_tree(RG.init_rglru(KEY, rcfg, jnp.float32)), 15, scale=0.05)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = module_from(TG.RGLRU, tcfg, p)
    rng = np.random.default_rng(15)
    x = _normal(rng, 2, 17, rcfg.d_model)
    out_r, st_r = RG.rglru_block(jnp.asarray(x), rp, rcfg)
    out_t, st_t = TG.rglru_block(t(x), tp, tcfg)
    close(out_t, out_r, **MATMUL)
    for a, b in zip(st_t, st_r):
        close(a, b, **MATMUL)
    # a second prefill chunk carries the state in; then one decode step
    x2 = _normal(rng, 2, 5, rcfg.d_model)
    out_r, st_r = RG.rglru_block(jnp.asarray(x2), rp, rcfg, state=st_r)
    out_t, st_t = TG.rglru_block(t(x2), tp, tcfg, state=st_t)
    close(out_t, out_r, **MATMUL)
    x3 = _normal(rng, 2, 1, rcfg.d_model)
    out_r, st_r = RG.rglru_block(jnp.asarray(x3), rp, rcfg, state=st_r)
    out_t, st_t = TG.rglru_block(t(x3), tp, tcfg, state=st_t)
    close(out_t, out_r, **MATMUL)
    for a, b in zip(st_t, st_r):
        close(a, b, **MATMUL)


def test_linear_scan_matches_loop():
    rng = np.random.default_rng(16)
    a = rng.uniform(0.5, 0.99, (2, 37, 8)).astype(np.float32)
    b = _normal(rng, 2, 37, 8)
    h, want = np.zeros((2, 8), np.float32), []
    for s in range(37):
        h = a[:, s] * h + b[:, s]
        want.append(h)
    close(TG.linear_scan(t(a), t(b)), np.stack(want, 1), **TIGHT)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, b=2, s=70, h=3, hd=8):
    rng = np.random.default_rng(seed)
    r, k, v = (_normal(rng, b, s, h, hd) for _ in range(3))
    logw = -np.exp(_normal(rng, b, s, h, hd))
    u, s0 = _normal(rng, h, hd), _normal(rng, b, h, hd, hd)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("fn", ["wkv_scan", "wkv_chunked"])
def test_wkv(fn):
    """S = 70 with chunks of 32: the chunked form pads its last chunk."""
    args = _wkv_inputs(17)
    out_r, st_r = getattr(RW, fn)(*(jnp.asarray(a) for a in args))
    out_t, st_t = getattr(TW, fn)(*(t(a) for a in args))
    close(out_t, out_r, **MATMUL)
    close(st_t, st_r, **MATMUL)
    # and the port's two forms agree with each other
    other = TW.wkv_scan if fn == "wkv_chunked" else TW.wkv_chunked
    out_o, st_o = other(*(t(a) for a in args))
    close(out_t, out_o.numpy(), atol=1e-3, rtol=1e-3)


def _rwkv_pair(seed):
    rcfg, tcfg = _cfgs("rwkv6-3b")
    p = perturb(np_tree(RW.init_rwkv(KEY, rcfg, jnp.float32)), seed, scale=0.05)
    return rcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()}, module_from(TW.RWKV, tcfg, p)


def test_time_mix_prefill_then_decode():
    rcfg, tcfg, rp, tp = _rwkv_pair(18)
    rng = np.random.default_rng(18)
    x = _normal(rng, 2, 40, rcfg.d_model)
    out_r, st_r, sh_r = RW.time_mix(jnp.asarray(x), rp, rcfg)  # chunked
    out_t, st_t, sh_t = TW.time_mix(t(x), tp, tcfg)
    close(out_t, out_r, **MATMUL)
    close(st_t, st_r, **MATMUL)
    close(sh_t, sh_r, **TIGHT)
    x1 = _normal(rng, 2, 1, rcfg.d_model)
    out_r, st_r, sh_r = RW.time_mix(jnp.asarray(x1), rp, rcfg, state=st_r, shift_prev=sh_r)
    out_t, st_t, sh_t = TW.time_mix(t(x1), tp, tcfg, state=st_t, shift_prev=sh_t)
    close(out_t, out_r, **MATMUL)
    close(st_t, st_r, **MATMUL)


def test_time_mix_scan_form():
    rcfg, tcfg, rp, tp = _rwkv_pair(19)
    x = _normal(np.random.default_rng(19), 2, 6, rcfg.d_model)
    out_r, st_r, _ = RW.time_mix(jnp.asarray(x), rp, rcfg, chunked=False)
    out_t, st_t, _ = TW.time_mix(t(x), tp, tcfg, chunked=False)
    close(out_t, out_r, **MATMUL)
    close(st_t, st_r, **MATMUL)


def test_channel_mix():
    rcfg, tcfg, rp, tp = _rwkv_pair(20)
    rng = np.random.default_rng(20)
    x, prev = _normal(rng, 2, 9, rcfg.d_model), _normal(rng, 2, rcfg.d_model)
    out_r, sh_r = RW.channel_mix(jnp.asarray(x), rp, rcfg, shift_prev=jnp.asarray(prev))
    out_t, sh_t = TW.channel_mix(t(x), tp, tcfg, shift_prev=t(prev))
    close(out_t, out_r, **MATMUL)
    close(sh_t, sh_r, **TIGHT)
