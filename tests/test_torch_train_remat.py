"""Rematerialisation (``forward(remat=, remat_policy=)``) against none, and
microbatch accumulation against one batch and against the reference's
``lax.scan`` over microbatches.

All float32 on the CPU, inputs and weights numpy-seeded.  Tolerances:

* remat against none: equal to 1e-6 absolute (the same float32 ops run
  again; on the CPU the recomputation is bit-identical);
* microbatches: the reference's own test bounds, loss 1e-3 and parameters
  5e-3 between 4 microbatches and 1; port against reference at 4
  microbatches as ``tests/test_torch_train_step.py`` holds one (loss
  1e-5 relative, parameters half a step).
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.utils.flop_counter import FlopCounterMode

import repro.models as RM
from _torch_lm import np_tree, perturb
from repro.configs import get_config as r_config
from repro.data import DataConfig as RDataConfig
from repro.data import lm_batch as r_lm_batch
from repro.train import OptConfig as ROptConfig
from repro.train import TrainConfig as RTrainConfig
from repro.train import init_opt_state as r_init_opt_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_reference, train_state_to_reference
from repro_torch.data import DataConfig, arch_batch, lm_batch
from repro_torch.models import forward
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

LR = 1e-3


def _ref_params(rcfg, seed=1):
    return perturb(np_tree(RM.init_params(rcfg, jax.random.PRNGKey(seed))), seed + 1, scale=0.05)


REMAT_ARCHS = ("qwen3-1.7b", "recurrentgemma-2b", "rwkv6-3b", "mixtral-8x22b",
               "internvl2-26b")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_full_and_dots_match_none(arch):
    cfg = get_config(arch, reduced=True)
    state = init_train_state(cfg, 2, device="cpu")
    batch = arch_batch(cfg, 4, 24, "train", seed=5, device="cpu")
    runs = {}
    for name, tc in (("none", TrainConfig()), ("full", TrainConfig(remat=True)),
                     ("dots", TrainConfig(remat=True, remat_policy="dots"))):
        s, m = make_train_step(cfg, tc)(copy.deepcopy(state), batch)
        runs[name] = (m, [p.detach() for p in s["params"].parameters()])
    for name in ("full", "dots"):
        m, ps = runs[name]
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(runs["none"][0][key]), atol=1e-6)
        for a, b in zip(ps, runs["none"][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_remat_policies_recompute_what_they_should():
    """Matrix-product FLOPs of one forward + backward: "full" recomputes
    every product of the blocks, "dots" keeps their outputs and recomputes
    none, as ``checkpoint_dots`` does."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    model = init_train_state(cfg, 0, device="cpu")["params"]
    batch = arch_batch(cfg, 2, 16, "train", seed=1, device="cpu")
    flops = {}
    for name, kw in (("none", {}), ("full", {"remat": True}),
                     ("dots", {"remat": True, "remat_policy": "dots"})):
        counter = FlopCounterMode(display=False)
        with counter:
            h, _, _ = forward(model, cfg, batch, **kw)
            h.sum().backward()
        model.zero_grad(set_to_none=True)
        flops[name] = counter.get_total_flops()
    assert flops["dots"] == flops["none"] < flops["full"]
    with pytest.raises(ValueError, match="remat_policy"):
        forward(model, cfg, batch, remat=True, remat_policy="offload")


def test_microbatches_four_against_one():
    cfg = get_config("qwen3-1.7b", reduced=True)
    batch = lm_batch(DataConfig(vocab=cfg.vocab, batch=8, seq=32), 0, device="cpu")
    state = init_train_state(cfg, 1, device="cpu")
    out = {}
    for m in (1, 4):
        tc = TrainConfig(opt=OptConfig(peak_lr=LR), microbatches=m)
        s, met = make_train_step(cfg, tc)(copy.deepcopy(state), batch)
        out[m] = (met, [p.detach() for p in s["params"].parameters()])
    assert abs(float(out[1][0]["loss"]) - float(out[4][0]["loss"])) < 1e-3
    assert max(float((a - b).abs().max()) for a, b in zip(out[1][1], out[4][1])) < 5e-3
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, TrainConfig(microbatches=3))(copy.deepcopy(state), batch)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b"])
def test_microbatches_match_reference(arch):
    """Four microbatches in both packages (MoE capacity is per microbatch
    in both, so mixtral routes the same)."""
    rcfg, tcfg = r_config(arch, reduced=True), get_config(arch, reduced=True)
    params = _ref_params(rcfg, 3)
    state = {"params": params, "opt": np_tree(r_init_opt_state(params))}
    opt = dict(peak_lr=LR, warmup_steps=0, total_steps=100)
    rbatch = r_lm_batch(RDataConfig(vocab=rcfg.vocab, batch=8, seq=16), 0)
    r_state, r_met = jax.jit(r_make_train_step(rcfg, RTrainConfig(opt=ROptConfig(**opt),
                                                                  microbatches=4)))(
        jax.tree.map(jnp.asarray, state), rbatch)
    st = train_state_from_reference(state, tcfg, device="cpu")
    batch = lm_batch(DataConfig(vocab=tcfg.vocab, batch=8, seq=16), 0, device="cpu")
    st, met = make_train_step(tcfg, TrainConfig(opt=OptConfig(**opt), microbatches=4))(st, batch)
    for key in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(float(met[key]), float(r_met[key]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(met["grad_norm"]), float(r_met["grad_norm"]), rtol=1e-4)
    got = train_state_to_reference(st, tcfg)["params"]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(np_tree(r_state["params"]))):
        np.testing.assert_allclose(g, w, atol=0.5 * LR, rtol=0)
