"""The port's model zoo (``repro_torch.models``) against the reference's,
for each of the ten architectures at its reduced size.

The reference's ``init_params`` draws the weights (perturbed with numpy
noise, so norms and mixes are not all ones and zeros); the port gets the
same numbers through ``repro_torch.convert.lm_params_from_reference``.
Inputs are numpy-seeded.  In float32 on the CPU, both packages run
``forward`` (prefill for decoder archs, train for the encoder), three
``decode_step`` calls (each feeding back the reference's argmax), and
``logits_from_hidden``.  Tolerances: hidden states, caches and logits
``allclose`` at 2e-4 absolute / 1e-4 relative (two to three orders of
magnitude above the differences seen, about 1e-5: sums over the model's
layers in another order); positions and argmax tokens exactly.  The
reference is run once per architecture (a module-scoped cache).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
import repro_torch.models as TM
from _torch_lm import close, np_tree, perturb, t
from repro.configs import ARCHS
from repro.configs import get_config as r_config
from repro.models.model import logits_from_hidden as r_logits
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_to_reference_layout, lm_params_from_reference
from repro_torch.models.model import logits_from_hidden as t_logits

TOL = dict(atol=2e-4, rtol=1e-4)
B, S, MAX_SEQ = 2, 20, 32
DECODERS = [a for a in ARCHS if not r_config(a).encoder_only]
_RUNS: dict = {}


def _cfgs(arch):
    rc, tc = r_config(arch, reduced=True), get_config(arch, reduced=True)
    if rc.moe:  # no capacity drops, as tests/test_models.py decodes MoE archs
        rc = dataclasses.replace(rc, capacity_factor=float(rc.n_experts))
        tc = dataclasses.replace(tc, capacity_factor=float(tc.n_experts))
    return rc, tc


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _to_torch(batch):
    return {k: t(v, torch.long) if v.dtype == np.int32 else t(v) for k, v in batch.items()}


def run(arch):
    """Both packages on the same weights and inputs; cached per arch."""
    if arch in _RUNS:
        return _RUNS[arch]
    rcfg, tcfg = _cfgs(arch)
    params = perturb(np_tree(RM.init_params(rcfg, jax.random.PRNGKey(1))), 2, scale=0.05)
    rp = jax.tree.map(jnp.asarray, params)
    tp = lm_params_from_reference(params, tcfg, device="cpu")
    batch = _batch(rcfg, 3)
    mode = "train" if rcfg.encoder_only else "prefill"
    out = {"rcfg": rcfg, "tcfg": tcfg, "rp": rp, "tp": tp}
    out["ref"] = RM.forward(rp, rcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                            mode=mode, max_seq=MAX_SEQ)
    out["port"] = TM.forward(tp, tcfg, _to_torch(batch), mode=mode, max_seq=MAX_SEQ)
    if not rcfg.encoder_only:
        # the prefill caches, copied out before decode writes into them
        out["port_caches"] = lm_cache_to_reference_layout(out["port"][1], tcfg)
        # three decode steps from the prefill caches, each feeding back the
        # reference's argmax (so a near-tie cannot fork the two runs)
        rc, tc = out["ref"][1], out["port"][1]
        tok = batch["tokens"][:, -1:]
        s0 = out["ref"][0].shape[1]
        steps = []
        for i in range(3):
            lr, rc = RM.decode_step(rp, rcfg, rc, jnp.asarray(tok), jnp.int32(s0 + i))
            lt, tc = TM.decode_step(tp, tcfg, tc, t(tok, torch.long), s0 + i)
            steps.append((np.asarray(lr), lt.numpy(), lt.argmax(-1).numpy()))
            tok = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
        out["steps"] = steps
    _RUNS[arch] = out
    return out


def test_registry_matches():
    assert T_ARCHS == ARCHS
    for arch in ARCHS:
        for reduced in (False, True):
            assert dataclasses.asdict(get_config(arch, reduced)) == \
                dataclasses.asdict(r_config(arch, reduced))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_exact(arch):
    """The full config's count, the port's built on the meta device."""
    from repro.models import param_count_exact as r_count

    cfg = get_config(arch)
    assert TM.param_count_exact(cfg) == r_count(r_config(arch))
    p = TM.init_params(cfg, device="meta")
    assert all(x.device.type == "meta" for x in p.parameters())


def test_param_count_of_qwen3_and_active_params():
    assert get_config("qwen3-1.7b").param_count() == 1_720_574_976
    assert get_config("mixtral-8x22b").active_param_count() == \
        r_config("mixtral-8x22b").active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden(arch):
    r = run(arch)
    (h_r, _, aux_r), (h_t, _, aux_t) = r["ref"], r["port"]
    assert tuple(h_t.shape) == h_r.shape
    close(h_t, h_r, **TOL)
    close(aux_t, aux_r, **TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_caches(arch):
    """Prefill caches in the reference's layout: k / v / states allclose,
    positions (-1 past the prompt, rolled for a local ring) equal."""
    r = run(arch)
    want = jax.tree.leaves(r["ref"][1])
    got = jax.tree.leaves(r["port_caches"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            assert np.array_equal(g, np.asarray(w))
        else:
            close(g, w, **TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps(arch):
    for lr, lt, tok_t in run(arch)["steps"]:
        assert lt.shape == lr.shape
        close(lt, lr, **TOL)
        assert np.array_equal(tok_t, lr.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_from_hidden(arch):
    """Padded-vocab columns masked to -1e30, logit softcap applied."""
    r = run(arch)
    cfg = r["tcfg"]
    want = np.asarray(r_logits(r["rp"], r["rcfg"], r["ref"][0]))
    got = t_logits(r["tp"], cfg, r["port"][0])
    assert got.shape[-1] == cfg.vocab_padded
    close(got, want, **TOL)
    if cfg.logit_softcap:
        assert np.abs(got.numpy()).max() <= cfg.logit_softcap


def test_logits_mask_padded_vocab():
    """hubert's reduced vocab (64) pads to 128: the padding is masked."""
    r = run("hubert-xlarge")
    cfg = r["tcfg"]
    assert cfg.vocab_padded > cfg.vocab
    got = t_logits(r["tp"], cfg, r["port"][0]).numpy()
    assert np.all(got[..., cfg.vocab:] == -1e30)
    assert np.all(got[..., :cfg.vocab] > -1e29)


def test_per_slot_decode_equals_scalar():
    """decode_step with per-slot positions all equal to p gives the scalar
    form's logits (the engine's form against the unbatched one)."""
    r = run("gemma2-27b")
    tp, cfg = r["tp"], r["tcfg"]
    batch = _to_torch(_batch(r["rcfg"], 4))
    _, c1, _ = TM.forward(tp, cfg, batch, mode="prefill", max_seq=MAX_SEQ)
    _, c2, _ = TM.forward(tp, cfg, batch, mode="prefill", max_seq=MAX_SEQ)
    tok = batch["tokens"][:, -1:]
    la, _ = TM.decode_step(tp, cfg, c1, tok, S)
    lb, _ = TM.decode_step(tp, cfg, c2, tok, torch.full((B,), S, dtype=torch.int32))
    close(la, lb.numpy(), atol=1e-6, rtol=1e-6)


def test_init_params_draws_from_the_seed():
    cfg = get_config("qwen3-1.7b", reduced=True)
    a, b = TM.init_params(cfg, 5, device="cpu"), TM.init_params(cfg, 5, device="cpu")
    c = TM.init_params(cfg, 6, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert sum(p.numel() for p in a.parameters()) == TM.param_count_exact(cfg)
