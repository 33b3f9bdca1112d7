"""The sharded train step on a (data=4, model=2) mesh of 8 gloo ranks:
qwen3-1.7b reduced, batch 8 x 32, ``peak_lr=1e-3`` -- the recipe of the
reference's ``tests/test_dist.py::test_sharded_train_step_matches_single_device``.

Both packages start from the reference's ``init_train_state(PRNGKey(0))``.
The ranks place it with ``state_shardings`` (params, ``m`` and ``v`` as
DTensors), place the batch with ``batch_shardings`` and take one step of
``make_train_step`` under ``use_rules``; the state is gathered back to the
reference's layout.  Held against:

* the reference's single-device step, with its own bounds: the loss within
  1e-3, every parameter within 5e-3;
* the port's unsharded step from the same state: the loss within 1e-5
  relative (the grad norm 1e-4), ``m``, ``v`` and the parameters within
  the tolerances of ``tests/_torch_train.py::check_state_after_the_update``.

Each rank's bytes of params, ``m`` and ``v`` are those of its shards.
"""
from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Shard

import _torch_dist as TD
from _torch_lm import np_tree
from _torch_train import _leaves
from repro.configs import get_config as r_config
from repro.data import DataConfig as RDataConfig
from repro.data import lm_batch as r_lm_batch
from repro.train import OptConfig as ROptConfig
from repro.train import TrainConfig as RTrainConfig
from repro.train import init_train_state as r_init_train_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_reference, train_state_to_reference
from repro_torch.data import DataConfig, lm_batch
from repro_torch.dist.context import mesh_sizes
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import param_shardings
from repro_torch.models import init_params
from repro_torch.train import OptConfig, TrainConfig, make_train_step

LR = TD.TRAIN_LR


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    rcfg = r_config(TD.TRAIN_ARCH, reduced=True)
    s0 = r_init_train_state(rcfg, jax.random.PRNGKey(0))
    s0_np = np_tree(s0)
    TD.save_tree(d / "state0.npz", s0_np)

    rbatch = r_lm_batch(RDataConfig(vocab=rcfg.vocab, batch=TD.TRAIN_BATCH, seq=TD.TRAIN_SEQ), 0)
    s_ref, m_ref = jax.jit(r_make_train_step(rcfg, RTrainConfig(opt=ROptConfig(peak_lr=LR))))(
        s0, rbatch)

    cfg = get_config(TD.TRAIN_ARCH, reduced=True)
    st = train_state_from_reference(s0_np, cfg, device="cpu")
    batch = lm_batch(DataConfig(vocab=cfg.vocab, batch=TD.TRAIN_BATCH, seq=TD.TRAIN_SEQ), 0,
                     "cpu")
    st, m_port = make_train_step(cfg, TrainConfig(opt=OptConfig(peak_lr=LR)))(st, batch)

    TD.spawn(TD.train_step_worker, 8, d)
    with open(d / "metrics.json") as f:
        sharded = json.load(f)
    ranks = []
    for r in range(8):
        with open(d / f"bytes_{r}.json") as f:
            ranks.append(json.load(f))
    return {
        "ref_metrics": {k: float(v) for k, v in m_ref.items()},
        "ref_state": np_tree(s_ref),
        "port_metrics": {k: float(v) for k, v in m_port.items()},
        "port_state": train_state_to_reference(st, cfg),
        "sharded": sharded,
        "sharded_state": TD.load_tree(d / "sharded_state.npz"),
        "bytes": ranks,
    }


def test_sharded_loss_matches_reference_single_device(run):
    got, want = run["sharded"]["metrics"]["loss"], run["ref_metrics"]["loss"]
    assert abs(got - want) < 1e-3, (got, want)


def test_sharded_params_match_reference_single_device(run):
    want = dict(_leaves(run["ref_state"]["params"]))
    got = dict(_leaves(run["sharded_state"]["params"]))
    assert got.keys() == want.keys()
    worst = max(float(np.abs(got[k] - w).max()) for k, w in want.items())
    assert worst < 5e-3, worst


def test_sharded_metrics_match_port_unsharded(run):
    got, want = run["sharded"]["metrics"], run["port_metrics"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["total_loss"], want["total_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    # metrics come back as plain tensors, not DTensors
    assert run["sharded"]["types"] == ["Tensor"]


def test_sharded_state_matches_port_unsharded(run):
    """The tolerances of ``_torch_train.check_state_after_the_update``."""
    want, got = run["port_state"], run["sharded_state"]
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
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


def test_params_are_placed_by_state_shardings(run):
    cfg = get_config(TD.TRAIN_ARCH, reduced=True)
    mesh = AbstractMesh((4, 2), ("data", "model"))
    want = {name: [str(p) for p in sh.placements]
            for name, sh in param_shardings(init_params(cfg, device="meta"), mesh, cfg).items()}
    assert run["sharded"]["placements"] == want
    # the 2-D weights are split over both axes
    assert want["blocks.0.attn.wq"] == [str(Shard(0)), str(Shard(1))]


def test_each_rank_holds_only_its_shards(run):
    """Params, m and v: every leaf's bytes over the ranks its spec splits it
    across, on every rank: no rank holds the whole state."""
    cfg = get_config(TD.TRAIN_ARCH, reduced=True)
    mesh = AbstractMesh((4, 2), ("data", "model"))
    sizes = mesh_sizes(mesh)
    model = init_params(cfg, device="meta")
    local = whole = 0
    for name, sh in param_shardings(model, mesh, cfg).items():
        numel = model.get_parameter(name).numel()
        split = math.prod(sizes[a] for e in sh.spec if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
        local += 3 * numel * 4 // split
        whole += 3 * numel * 4
    for r, b in enumerate(run["bytes"]):
        assert b == {"local": local, "whole": whole}, (r, b)
    assert local < whole / 4
