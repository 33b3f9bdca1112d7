"""The port's AdamW, schedule and clipping (``repro_torch.train.optimizer``)
against the reference's (``repro.train.optimizer``).

Inputs are numpy-seeded trees handed to both packages; the reference gets a
dict pytree, the port the same dict of tensors.  Tolerances: the learning
rate 1e-6 relative (float32 cos on two libraries); the global norm 1e-6
relative (sums in another order); parameters, ``m`` and ``v`` after one
to three updates 1e-6 absolute plus 1e-5 relative, gradients of O(1)
scaled so that no element is within rounding of zero (the update's
``g / (|g| + eps)`` would amplify that).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import OptConfig as ROptConfig
from repro.train import apply_updates as r_apply_updates
from repro.train.optimizer import global_norm as r_global_norm
from repro.train import init_opt_state as r_init_opt_state
from repro.train import schedule as r_schedule
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batch
from repro_torch.train import (
    OptConfig,
    TrainConfig,
    apply_updates,
    init_opt_state,
    init_train_state,
    make_train_step,
    schedule,
)
from repro_torch.train.optimizer import global_norm

SHAPES = {"embed": (40, 8), "norm": (8,), "w": (8, 12), "stack": (3, 8, 4), "scalar": ()}


def _tree(rng, scale: float = 1.0) -> dict:
    out = {}
    for k, shape in SHAPES.items():
        x = rng.normal(size=shape).astype(np.float32)
        # away from zero: |x| >= 0.1
        out[k] = (np.sign(x) * (np.abs(x) + 0.1) * scale).astype(np.float32)
    return out


def _t(tree: dict) -> dict:
    return {k: torch.tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(peak_lr=3e-3, warmup_steps=5, total_steps=100),
    dict(peak_lr=1e-3, warmup_steps=0, total_steps=10),
])
def test_schedule_matches_reference(kw):
    for step in (0, 5, 10, 50, 100):
        want = float(r_schedule(ROptConfig(**kw), jnp.int32(step)))
        got = schedule(OptConfig(**kw), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step
        assert float(schedule(OptConfig(**kw), step)) == float(got)


def test_schedule_shape():
    oc = OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(schedule(oc, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 5e-4) < 1e-9  # linear warmup
    assert abs(lrs[2] - 1e-3) < 1e-9  # peak
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 1e-4) < 1e-6  # min ratio


def test_init_opt_state_and_global_norm():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    opt = init_opt_state(_t(tree))
    ref = r_init_opt_state(tree)
    assert opt["step"].dtype == torch.int32 and opt["step"].ndim == 0 and int(opt["step"]) == 0
    for part in ("m", "v"):
        assert opt[part].keys() == tree.keys()
        for k, v in opt[part].items():
            assert v.dtype == torch.float32 and v.shape == ref[part][k].shape
            assert not v.any()
    assert float(global_norm(_t(tree))) == pytest.approx(float(r_global_norm(tree)), rel=1e-6)


@pytest.mark.parametrize("clip_norm,grad_scale", [(1.0, 1.0), (1e3, 1.0), (1.0, 30.0)])
def test_apply_updates_matches_reference(clip_norm, grad_scale):
    """Three updates from one start on random trees: clipping active at
    clip 1 (the gradient norm is about 20 or 600), inactive at 1e3."""
    rng = np.random.default_rng(int(clip_norm + grad_scale))
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm)
    start = _tree(rng)
    params, r_params = _t(start), {k: jnp.asarray(v) for k, v in start.items()}
    opt, r_opt = init_opt_state(params), r_init_opt_state(r_params)
    for i in range(3):
        g = _tree(rng, grad_scale)
        r_params, r_opt, r_m = r_apply_updates(r_params, g, r_opt, ROptConfig(**kw))
        params, opt, m = apply_updates(params, _t(g), opt, OptConfig(**kw))
        assert float(m["grad_norm"]) == pytest.approx(float(r_m["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(r_m["lr"]), rel=1e-6)
        assert int(opt["step"]) == int(r_opt["step"]) == i + 1
        for k in SHAPES:
            for got, want in ((params[k], r_params[k]), (opt["m"][k], r_opt["m"][k]),
                              (opt["v"][k], r_opt["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5,
                                           err_msg=f"step {i + 1} {k}")


def test_apply_updates_writes_in_place():
    params = _t(_tree(np.random.default_rng(3)))
    before = {k: v.clone() for k, v in params.items()}
    opt = init_opt_state(params)
    m_ids = {k: id(v) for k, v in opt["m"].items()}
    out, new_opt, _ = apply_updates(params, _t(_tree(np.random.default_rng(4))), opt, OptConfig())
    assert out is params and all(id(new_opt["m"][k]) == m_ids[k] for k in m_ids)
    assert all(not torch.equal(params[k], before[k]) for k in ("embed", "w"))


def test_grad_clipping_bounds_update():
    """The reference's test on the port: raw gradients are not tiny, but a
    clip of 1e-6 keeps one step of lr 1 under 2."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    oc = OptConfig(peak_lr=1.0, warmup_steps=0, total_steps=10, clip_norm=1e-6, weight_decay=0.0)
    s = init_train_state(cfg, 3, device="cpu")
    before = [p.detach().clone() for p in s["params"].parameters()]
    s, m = make_train_step(cfg, TrainConfig(opt=oc))(
        s, lm_batch(DataConfig(vocab=cfg.vocab, batch=4, seq=32), 0, device="cpu"))
    assert float(m["grad_norm"]) > 1e-3
    d = max(float((a.detach() - b).abs().max()) for a, b in zip(s["params"].parameters(), before))
    assert d < 2.0
