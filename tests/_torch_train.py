"""Shared run of ``tests/test_torch_train_step*.py``: one train step of the
port (``repro_torch.train``) against the reference's (``repro.train``) at
an architecture's reduced size.

The reference's ``init_params`` draws the weights (perturbed with numpy
noise); both packages get the same train state through
``repro_torch.convert.train_state_from_reference`` and the same
numpy-seeded ``arch_batch`` (the vision mask and the audio features
included).  The reference's step is ``jax.value_and_grad`` of its loss,
then its ``apply_updates`` (what ``make_train_step`` composes at one
microbatch); the port's is ``make_train_step``, and its gradients come from
``make_loss_fn`` through ``torch.autograd.grad``.  Everything is float32 on
the CPU.  Tolerances (the differences seen are summation orders: two
frameworks' matrix products and scans):

* loss, aux and total loss: 1e-5 relative (seen: under 3e-7);
* every gradient leaf: 1e-4 of the model's largest gradient, absolute, plus
  1e-3 relative (seen: up to 1.6e-5 of it, rwkv6's wkv chunks);
* ``m`` and ``v`` after the update: the same rule on their own scale;
* the parameters after the update: half a step, ``0.5 * peak_lr``.  Adam's
  first step moves a weight by ``lr * g / (|g| + eps)``, about ``+-lr``
  whatever ``|g|``: where a gradient is within rounding of zero the two
  packages move it by different fractions of a step (seen: up to 0.13).

The reference is run once per architecture (a module-level cache).
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
from repro.data import arch_batch as r_arch_batch
from repro.train import OptConfig as ROptConfig
from repro.train import TrainConfig as RTrainConfig
from repro.train import apply_updates as r_apply_updates
from repro.train import init_opt_state as r_init_opt_state
from repro.train import make_loss_fn as r_make_loss_fn
from repro_torch.configs import get_config
from repro_torch.convert import (
    _reference_layout,
    _to_reference,
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.data import arch_batch
from repro_torch.train import OptConfig, TrainConfig, make_loss_fn, make_train_step

B, S, LR = 2, 24, 1e-3
LOSS_RTOL = 1e-5
_RUNS: dict = {}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def run(arch):
    """Both packages from the same state on the same batch; cached per arch."""
    if arch in _RUNS:
        return _RUNS[arch]
    rcfg, tcfg = r_config(arch, reduced=True), get_config(arch, reduced=True)
    params = perturb(np_tree(RM.init_params(rcfg, jax.random.PRNGKey(1))), 2, scale=0.05)
    state = {"params": params, "opt": np_tree(r_init_opt_state(params))}
    opt = dict(peak_lr=LR, warmup_steps=0, total_steps=100)
    rtc = RTrainConfig(opt=ROptConfig(**opt))
    rb = r_arch_batch(rcfg, B, S, "train", seed=3)
    (r_total, r_met), r_grads = jax.jit(
        jax.value_and_grad(r_make_loss_fn(rcfg, rtc), has_aux=True))(
        jax.tree.map(jnp.asarray, params), rb)
    r_new_p, r_new_opt, r_om = jax.jit(lambda p, g, o: r_apply_updates(p, g, o, rtc.opt))(
        jax.tree.map(jnp.asarray, params), r_grads, jax.tree.map(jnp.asarray, state["opt"]))

    tc = TrainConfig(opt=OptConfig(**opt))
    st = train_state_from_reference(state, tcfg, device="cpu")
    tb = arch_batch(tcfg, B, S, "train", seed=3, device="cpu")
    total, met = make_loss_fn(tcfg, tc)(st["params"], tb)
    named = list(st["params"].named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
    # a parameter the loss never reaches has a zero gradient (jax.grad's)
    port_grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)}
    new_st, metrics = make_train_step(tcfg, tc)(st, tb)
    out = {
        "ref_metrics": {"loss": r_met["loss"], "aux_loss": r_met["aux_loss"],
                        "total_loss": r_total, **r_om},
        "port_metrics": metrics,
        "port_total_from_loss_fn": total.detach(),
        "ref_grads": np_tree(r_grads),
        "port_grads": _to_reference(port_grads, tcfg, _reference_layout(tcfg)),
        "ref_state": {"params": np_tree(r_new_p), "opt": np_tree(r_new_opt)},
        "port_state": train_state_to_reference(new_st, tcfg),
    }
    _RUNS[arch] = out
    return out


def check_loss_aux_and_metrics(arch):
    r = run(arch)
    want, got = r["ref_metrics"], r["port_metrics"]
    for key in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(float(r["port_total_from_loss_fn"]), float(want["total_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
    assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)
    if r_config(arch).moe:
        assert float(got["aux_loss"]) > 0.0


def check_every_gradient_leaf(arch):
    r = run(arch)
    want = dict(_leaves(r["ref_grads"]))
    got = dict(_leaves(r["port_grads"]))
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, atol=1e-4 * scale, rtol=1e-3, err_msg=key)


def check_state_after_the_update(arch):
    r = run(arch)
    want, got = r["ref_state"], r["port_state"]
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    assert got["opt"]["step"].dtype == np.int32
    for part in ("m", "v"):
        w_leaves, g_leaves = dict(_leaves(want["opt"][part])), dict(_leaves(got["opt"][part]))
        assert g_leaves.keys() == w_leaves.keys()
        scale = max(float(np.abs(w).max()) for w in w_leaves.values())
        for key, w in w_leaves.items():
            np.testing.assert_allclose(g_leaves[key], w, atol=1e-4 * scale, rtol=1e-3,
                                       err_msg=f"{part}{key}")
    w_leaves, g_leaves = dict(_leaves(want["params"])), dict(_leaves(got["params"]))
    assert g_leaves.keys() == w_leaves.keys()
    for key, w in w_leaves.items():
        np.testing.assert_allclose(g_leaves[key], w, atol=0.5 * LR, rtol=0, err_msg=key)
