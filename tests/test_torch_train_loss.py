"""The training loss: ``chunked_ce_loss`` against the reference's (a
remainder chunk, a mask, gemma2's softcap, hubert's padded vocab), what its
checkpointed chunks keep for the backward pass, the eval step, and the
reference's "loss falls" recipe.

All float32 on the CPU, inputs and weights numpy-seeded.  Tolerances for
``chunked_ce_loss`` and its gradients (hidden states and the output
matrix): 1e-5 relative on the loss; gradients 1e-4 of the largest element,
absolute, plus 1e-3 relative (summation orders of two libraries).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
from _torch_lm import np_tree, perturb
from repro.configs import get_config as r_config
from repro.models.model import chunked_ce_loss as r_chunked_ce_loss
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import DataConfig, arch_batch, lm_batch
from repro_torch.models import chunked_ce_loss
from repro_torch.train import (
    OptConfig,
    TrainConfig,
    init_train_state,
    make_loss_fn,
    make_train_step,
)


def _ref_params(rcfg, seed=1):
    return perturb(np_tree(RM.init_params(rcfg, jax.random.PRNGKey(seed))), seed + 1, scale=0.05)


@pytest.mark.parametrize("arch,s,chunk,masked", [
    ("qwen3-1.7b", 24, 10, False),      # two full chunks and a remainder of 4
    ("gemma2-27b", 24, 8, True),        # logit softcap, a 0/1 mask, no remainder
    ("hubert-xlarge", 21, 7, False),    # vocab 64 padded to 128, untied head
    ("internvl2-26b", 20, 16, True),    # the vision mask's shape, a remainder
    ("qwen3-1.7b", 12, 1024, False),    # chunk longer than the sequence
])
def test_chunked_ce_loss_matches_reference(arch, s, chunk, masked):
    rcfg, tcfg = r_config(arch, reduced=True), get_config(arch, reduced=True)
    params = _ref_params(rcfg)
    rng = np.random.default_rng(s + chunk)
    b, d = 3, tcfg.d_model
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None
    wkey = "embed" if rcfg.tie_embeddings else "lm_head"

    def ref_loss(w, hh):
        return r_chunked_ce_loss({**jax.tree.map(jnp.asarray, params), wkey: w}, rcfg, hh,
                                 jnp.asarray(labels), None if mask is None else jnp.asarray(mask),
                                 chunk=chunk)

    r_loss, (r_gw, r_gh) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(params[wkey]), jnp.asarray(h))
    model = lm_params_from_reference(params, tcfg, device="cpu").requires_grad_(True)
    th = torch.tensor(h, requires_grad=True)
    loss = chunked_ce_loss(model, tcfg, th, torch.tensor(labels),
                           None if mask is None else torch.tensor(mask), chunk=chunk)
    gw, gh = torch.autograd.grad(loss, [getattr(model, wkey), th])
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-5)
    for got, want in ((gw, r_gw), (gh, r_gh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=1e-3)
    if tcfg.vocab_padded > tcfg.vocab:  # padded columns take no probability
        pad = gw[tcfg.vocab:] if tcfg.tie_embeddings else gw[:, tcfg.vocab:]
        assert pad.numel() and not pad.any()


def test_full_chunks_keep_no_logits_for_backward():
    """Only the remainder chunk's [B, rest, V] logits are saved for the
    backward pass; a full chunk saves its inputs and recomputes."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    model = init_train_state(cfg, 0, device="cpu")["params"]
    b, v = 2, cfg.vocab_padded

    def saved_logit_shapes(s, chunk):
        shapes = []

        def pack(t):
            if t.dim() == 3 and t.shape[0] == b and t.shape[-1] == v:
                shapes.append(tuple(t.shape))
            return t

        h = torch.randn(b, s, cfg.d_model, requires_grad=True)
        labels = torch.randint(0, cfg.vocab, (b, s))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = chunked_ce_loss(model, cfg, h, labels, chunk=chunk)
        loss.backward()
        return shapes

    assert saved_logit_shapes(16, 8) == []
    assert saved_logit_shapes(19, 8) and all(s[1] == 3 for s in saved_logit_shapes(19, 8))


def test_loss_decreases():
    """The reference's recipe: qwen3 reduced, peak 3e-3, warmup 5, 15 steps."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    tc = TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=100))
    state = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, tc)
    dc = DataConfig(vocab=cfg.vocab, batch=8, seq=64)
    losses = []
    for i in range(15):
        state, m = step(state, lm_batch(dc, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_eval_step_matches_loss_fn():
    from repro_torch.train import make_eval_step

    cfg = get_config("gemma2-27b", reduced=True)
    model = init_train_state(cfg, 4, device="cpu")["params"]
    batch = arch_batch(cfg, 2, 16, "train", seed=2, device="cpu")
    met = make_eval_step(cfg, TrainConfig())(model, batch)
    _, want = make_loss_fn(cfg, TrainConfig())(model, batch)
    assert not met["loss"].requires_grad
    assert float(met["loss"]) == float(want["loss"].detach())
