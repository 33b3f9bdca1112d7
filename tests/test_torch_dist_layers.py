"""The per-rank branches of ``models/layers.py`` on a (data=4, model=2)
mesh of 8 gloo ranks, against the port's unsharded code and the reference.

* MoE (the reference's ``shard_map`` branch), granite-moe reduced with
  ``capacity_factor=8.0`` (no token is dropped, so a rank's capacity does
  not change the result): its experts are replicated (64 ff columns) and
  the sequence is split over 'model'.  ``h`` against the reference's local
  forward within the reference's own bounds (``atol=3e-3, rtol=1e-2``,
  ``tests/test_dist.py::test_moe_shard_map_matches_local``), against the
  port's local forward within 1e-5, and ``h`` and ``aux`` against the
  reference's sharded forward (8 XLA host devices in a subprocess, as
  ``tests/test_dist.py`` runs it) within the LM layer tolerances
  (2e-4 / 1e-4).  The gradients of ``sum(h * w)`` against the port's local
  forward's, and of ``sum(h * w) + aux`` against ``jax.grad`` of the
  reference's sharded forward.
* The same with 256 ff columns an expert: TP-sharded experts, the partial
  down-projections summed over 'model' (``moe_dispatch_local(tp_axis=)``).
* The vocab-parallel ``embedding_lookup`` (and its gradient) against a
  plain row gather.
* The GQA head-repeat (6 query, 3 KV heads on model=2) against the
  unsharded forward.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist as TD
from _torch_lm import np_tree
from _torch_train import _leaves
from repro.configs import get_config as r_config
from repro.data import arch_batch as r_arch_batch
from repro.models import forward as r_forward
from repro.models import init_params as r_init_params
from repro_torch.convert import _reference_layout, _to_reference, lm_params_from_reference
from repro_torch.data import arch_batch
from repro_torch.models import forward, init_params

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
       "PYTHONPATH": SRC}

# the reference's MoE forward under 4 x 2 rules on 8 host devices, and the
# gradient of sum(h * w) + aux (w as _torch_dist.loss_weights(h.shape, 5))
REF_SHARDED = """
import dataclasses, sys
import jax, numpy as np
from repro.configs import get_config
from repro.data import arch_batch
from repro.dist.context import ShardingRules, use_rules
from repro.launch.mesh import make_host_mesh
from repro.models import forward, init_params

cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", reduced=True), capacity_factor=8.0)
params = init_params(cfg, jax.random.PRNGKey(0))
batch = arch_batch(cfg, 4, 32, "train", seed=0)
mesh = make_host_mesh(data=4, model=2)
w = np.random.default_rng(5).normal(size=(4, 32, cfg.d_model)).astype(np.float32)

def loss(p, b):
    h, _, aux = forward(p, cfg, b)
    return (h * w).sum() + aux, (h, aux)

with use_rules(ShardingRules(mesh, batch_axes=("data",))), mesh:
    grads, (h, aux) = jax.jit(jax.grad(loss, has_aux=True))(params, batch)
flat = {"//".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(g)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
np.savez(sys.argv[1], **{"h": np.asarray(h), "aux": np.asarray(aux)},
         **{"grads//" + k: v for k, v in flat.items()})
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_layers")
    ref_out = str(d / "ref_sharded.npz")
    proc = subprocess.Popen([sys.executable, "-c", REF_SHARDED, ref_out], env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg = TD.moe_config()
        rcfg = dataclasses.replace(r_config(TD.MOE_ARCH, reduced=True), capacity_factor=8.0)
        params = np_tree(r_init_params(rcfg, jax.random.PRNGKey(0)))
        TD.save_tree(d / "moe_params.npz", params)
        h_ref, _, _ = r_forward(params, rcfg, r_arch_batch(rcfg, TD.MOE_BATCH, TD.MOE_SEQ,
                                                           "train", seed=0))
        batch = arch_batch(cfg, TD.MOE_BATCH, TD.MOE_SEQ, "train", seed=0, device="cpu")
        model = lm_params_from_reference(params, cfg, "cpu")
        model.requires_grad_(True)
        local = TD._forward_and_grads(model, cfg, batch)
        tcfg = TD.moe_tp_config()
        tmodel = init_params(tcfg, 2, device="cpu")
        tmodel.requires_grad_(True)
        local_tp = TD._forward_and_grads(tmodel, tcfg, batch)
        gcfg = TD.gqa_config()
        gh, _, _ = forward(init_params(gcfg, 3, device="cpu"), gcfg,
                           arch_batch(gcfg, 8, 16, "train", seed=1, device="cpu"))

        TD.spawn(TD.layers_worker, 8, d)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return {
        "ref_local_h": np.asarray(h_ref),
        "ref_sharded": TD.load_tree(ref_out),
        "local": local, "local_tp": local_tp, "gqa_local": gh.detach().numpy(),
        "mesh": TD.load_tree(d / "layers.npz"),
    }


def _close_grads(got: dict, want: dict, rel: float):
    """Every leaf within ``rel`` of the largest gradient, absolute, plus
    ``10 * rel`` relative."""
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=rel * scale, rtol=10 * rel, err_msg=name)


def test_moe_mesh_branch_matches_reference_local(run):
    np.testing.assert_allclose(run["mesh"]["moe"]["h"], run["ref_local_h"], atol=3e-3, rtol=1e-2)


def test_moe_mesh_branch_matches_port_local(run):
    np.testing.assert_allclose(run["mesh"]["moe"]["h"], run["local"][0], atol=1e-5, rtol=1e-5)


def test_moe_mesh_branch_matches_reference_sharded(run):
    ref = run["ref_sharded"]
    np.testing.assert_allclose(run["mesh"]["moe"]["h"], ref["h"], atol=2e-4, rtol=1e-4)
    # aux is averaged over the ranks' own token slices, as the reference's
    np.testing.assert_allclose(float(run["mesh"]["moe"]["aux"]), float(ref["aux"]), rtol=1e-5)


def test_moe_mesh_branch_gradients_match_port_local(run):
    """The gradient of sum(h * w): the same function on both sides (the
    aux loss is not: the mesh averages the ranks' own Switch losses)."""
    _close_grads(run["mesh"]["moe"]["g_h"], run["local"][2], 1e-5)


def test_moe_mesh_branch_gradients_match_reference_sharded(run):
    """The gradient of sum(h * w) + aux against ``jax.grad`` of the
    reference's sharded forward, leaf by leaf in the reference's layout."""
    cfg = TD.moe_config()
    mesh = run["mesh"]["moe"]
    named = {k: torch.from_numpy(mesh["g_h"][k] + mesh["g_aux"][k]) for k in mesh["g_h"]}
    got = dict(_leaves(_to_reference(named, cfg, _reference_layout(cfg))))
    want = dict(_leaves(run["ref_sharded"]["grads"]))
    _close_grads(got, want, 1e-4)


def test_moe_tp_sharded_experts_match_port_local(run):
    np.testing.assert_allclose(run["mesh"]["moe_tp"]["h"], run["local_tp"][0], atol=1e-5,
                               rtol=1e-5)
    _close_grads(run["mesh"]["moe_tp"]["g_h"], run["local_tp"][2], 1e-5)


def test_vocab_parallel_embedding_matches_row_gather(run):
    table = TD.loss_weights((512, 64), 7).requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (8, 16)))
    out = table[tokens]
    (out * TD.loss_weights((8, 16, 64), 9)).sum().backward()
    np.testing.assert_array_equal(run["mesh"]["embed"]["out"], out.detach().numpy())
    np.testing.assert_allclose(run["mesh"]["embed"]["grad"], table.grad.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_gqa_head_repeat_matches_unsharded(run):
    gcfg = TD.gqa_config()
    assert int(run["mesh"]["gqa"]["repeats"]) == 2 * gcfg.n_layers  # K and V, every layer
    np.testing.assert_allclose(run["mesh"]["gqa"]["h"], run["gqa_local"], atol=1e-5, rtol=1e-5)
