"""Attention computed per rank (``models/layers.py``: ``_attend_per_rank``,
``_decode_per_rank``): each rank its batch rows and heads, and in decode
its block of the cache.

* On a fake process group under ``FakeTensorMode`` (the dry run's setup):
  the head-sharded step of qwen3-1.7b reduced traces on a (data=4,
  model=2) mesh, where DTensor's own propagation of the score ``einsum``
  failed (``aten._local_scalar_dense``), with the sequence split or not,
  and on the 16 x 16 production mesh with 16 heads split over 'model',
  train step and decode.
* On 8 gloo ranks (4 x 2, ``seq_sharded`` as the dry run): qwen3-1.7b
  reduced from the reference's weights; the forward and the gradients of
  ``sum(h * w)`` against ``jax.grad`` of the reference's sharded forward
  (8 XLA host devices in a subprocess) within the tolerances of
  ``tests/test_torch_dist_layers.py`` (2e-4 / 1e-4, gradients 1e-4 of the
  largest) and against the port's unsharded forward within 1e-5; decode
  on a cache of 2,048 slots split over 'model' (``cache_shardings``):
  six steps across the blocks' boundary, one position for the batch and
  then per-slot positions; the logits and the caches against the
  reference's sharded decode (2e-4 / 1e-4, positions equal) and the
  port's unsharded decode (1e-5); rwkv6-3b reduced with its recurrence per
  rank (remat), ``h`` and gradients against the port's unsharded ones
  (2e-4 / 1e-4).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as TD
from _torch_lm import np_tree
from _torch_train import _leaves
from repro.configs import get_config as r_config
from repro.models import init_params as r_init_params
from repro_torch.configs import get_config
from repro_torch.convert import (
    _reference_layout,
    _to_reference,
    lm_cache_to_reference_layout,
    lm_params_from_reference,
)
from repro_torch.data import arch_batch
from repro_torch.models import init_cache, init_params

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
       "PYTHONPATH": SRC}

# the reference under the same 4 x 2 rules on 8 host devices: h and the
# gradient of sum(h * w), then decode_step over attention_decode_inputs()
REF_SHARDED = """
import sys
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import _torch_dist as TD
from repro.configs import get_config
from repro.data import arch_batch
from repro.dist.context import ShardingRules, use_rules
from repro.launch.mesh import make_host_mesh
from repro.launch.sharding import cache_shardings, param_shardings
from repro.models import decode_step, forward, init_cache, init_params

cfg = get_config(TD.ATTN_ARCH, reduced=True)
params = init_params(cfg, jax.random.PRNGKey(0))
batch = arch_batch(cfg, TD.ATTN_BATCH, TD.ATTN_SEQ, "train", seed=0)
mesh = make_host_mesh(data=4, model=2)
w = np.random.default_rng(5).normal(size=(TD.ATTN_BATCH, TD.ATTN_SEQ, cfg.d_model)).astype(np.float32)

def loss(p, b):
    h, _, _ = forward(p, cfg, b)
    return (h * w).sum(), h

out = {}
with use_rules(ShardingRules(mesh, batch_axes=("data",), seq_sharded=True)), mesh:
    grads, h = jax.jit(jax.grad(loss, has_aux=True))(params, batch)
    cache = init_cache(cfg, TD.ATTN_BATCH, TD.ATTN_CACHE, jnp.float32)
    rep = NamedSharding(mesh, P())
    step = jax.jit(lambda p, c, t, pos: decode_step(p, cfg, c, t, pos),
                   in_shardings=(param_shardings(params, mesh, cfg),
                                 cache_shardings(cache, mesh, cfg, TD.ATTN_BATCH), rep, rep))
    logits = []
    for tokens, pos in TD.attention_decode_inputs():
        lg, cache = step(params, cache, tokens, jnp.asarray(pos, jnp.int32))
        logits.append(np.asarray(lg))
flat = {"//".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(g)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
cflat = {"//".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(c)
         for path, c in jax.tree_util.tree_flatten_with_path(cache)[0]}
np.savez(sys.argv[1], h=np.asarray(h), logits=np.stack(logits),
         **{"grads//" + k: v for k, v in flat.items()},
         **{"cache//" + k: v for k, v in cflat.items()})
"""


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of ``world`` placeholder ranks in this process,
    destroyed on the way out (a group left behind breaks later tests)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 -- registers "fake"

    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_step(cfg, mesh, rules, batch: int, seq: int):
    """One train step and one decode step of ``cfg`` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.context import use_rules
    from repro_torch.launch.sharding import (
        batch_shardings,
        cache_shardings,
        place,
        state_shardings,
    )
    from repro_torch.models import decode_step
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    with FakeTensorMode(allow_non_fake_inputs=True), use_rules(rules):
        state = init_train_state(cfg, param_dtype=torch.bfloat16, device="cpu")
        state = place(state, state_shardings(state, mesh, cfg))
        data = {k: torch.zeros((batch, seq), dtype=torch.int32) for k in ("tokens", "labels")}
        data = place(data, batch_shardings(data, mesh, batch))
        state, metrics = make_train_step(cfg, TrainConfig(opt=OptConfig(), remat=True))(
            state, data)
        assert metrics["loss"].shape == () and metrics["grad_norm"].shape == ()
        params = state["params"]
        caches = init_cache(cfg, batch, 2048, torch.bfloat16, "cpu")
        caches = place(caches, cache_shardings(caches, mesh, cfg, batch))
        with torch.no_grad():
            logits, _ = decode_step(params, cfg, caches, torch.zeros((batch, 1), dtype=torch.int32),
                                    2047)
        assert tuple(logits.shape) == (batch, 1, cfg.vocab_padded)


@pytest.mark.parametrize("seq_sharded", [False, True])
def test_head_sharded_step_traces_on_fake_4x2(seq_sharded):
    from repro_torch.dist.context import ShardingRules
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config(TD.ATTN_ARCH, reduced=True)
    assert cfg.n_heads % 2 == 0 and cfg.n_kv_heads % 2 == 0  # both split over model=2
    with fake_group(8):
        mesh = make_host_mesh(data=4, model=2, device="cpu")
        _fake_step(cfg, mesh, ShardingRules(mesh, seq_sharded=seq_sharded), 16, 128)
    assert not dist.is_initialized()


def test_head_sharded_step_traces_on_fake_production_mesh():
    """16 query heads over model=16 (8 KV heads: the head-repeat branch)."""
    from repro_torch.dist.context import ShardingRules
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dataclasses.replace(get_config(TD.ATTN_ARCH, reduced=True), n_heads=16,
                              n_kv_heads=8, head_dim=8)
    with fake_group(256):
        mesh = make_production_mesh(device="cpu")
        _fake_step(cfg, mesh, ShardingRules(mesh, seq_sharded=True), 16, 64)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_attention")
    ref_out = str(d / "ref_sharded.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SHARDED, ref_out, os.path.dirname(os.path.abspath(__file__))],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        rcfg = r_config(TD.ATTN_ARCH, reduced=True)
        params = np_tree(r_init_params(rcfg, jax.random.PRNGKey(0)))
        TD.save_tree(d / "attn_params.npz", params)
        cfg = get_config(TD.ATTN_ARCH, reduced=True)
        model = lm_params_from_reference(params, cfg, "cpu")
        model.requires_grad_(True)
        batch = arch_batch(cfg, TD.ATTN_BATCH, TD.ATTN_SEQ, "train", seed=0, device="cpu")
        local = TD.h_and_grads(model, cfg, batch)
        local_decode = TD.run_decode(
            model, cfg, init_cache(cfg, TD.ATTN_BATCH, TD.ATTN_CACHE, torch.float32, "cpu"))
        rcfg = get_config(TD.RWKV_ARCH, reduced=True)
        rmodel = init_params(rcfg, TD.RWKV_SEED, device="cpu")
        rmodel.requires_grad_(True)
        rwkv_local = TD.h_and_grads(rmodel, rcfg, arch_batch(rcfg, TD.ATTN_BATCH, TD.ATTN_SEQ,
                                                              "train", seed=3, device="cpu"))

        TD.spawn(TD.attention_worker, 8, d)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(d / "attention.json") as f:
        meta = json.load(f)
    return {"ref": TD.load_tree(ref_out), "local": local, "local_decode": local_decode,
            "rwkv_local": rwkv_local, "mesh": TD.load_tree(d / "attention.npz"), "meta": meta}


def _close_grads(got: dict, want: dict, rel: float):
    """Every leaf within ``rel`` of the largest gradient, absolute, plus
    ``10 * rel`` relative (``tests/test_torch_dist_layers.py``'s rule)."""
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=rel * scale, rtol=10 * rel, err_msg=name)


def _mesh_caches(run) -> list:
    return [tuple(torch.from_numpy(c[k]) for k in ("k", "v", "pos"))
            for c in run["mesh"]["decode"]["cache"]]  # load_tree: blocks "0".."n-1" -> a list


def test_forward_matches_reference_sharded(run):
    np.testing.assert_allclose(run["mesh"]["train"]["h"], run["ref"]["h"], atol=2e-4, rtol=1e-4)


def test_forward_matches_port_unsharded(run):
    np.testing.assert_allclose(run["mesh"]["train"]["h"], run["local"][0], atol=1e-5, rtol=1e-5)


def test_gradients_match_reference_sharded(run):
    cfg = get_config(TD.ATTN_ARCH, reduced=True)
    named = {k: torch.from_numpy(v) for k, v in run["mesh"]["train"]["g_h"].items()}
    got = dict(_leaves(_to_reference(named, cfg, _reference_layout(cfg))))
    want = dict(_leaves(run["ref"]["grads"]))
    _close_grads(got, want, 1e-4)


def test_gradients_match_port_unsharded(run):
    _close_grads(run["mesh"]["train"]["g_h"], run["local"][1], 1e-5)


def test_decode_cache_is_split_over_batch_and_sequence(run):
    # the mesh's (data, model) axes split the cache's batch and its slots
    assert run["meta"]["cache_split_dims"] == [0, 1]


def test_decode_logits_match_reference_sharded(run):
    np.testing.assert_allclose(run["mesh"]["decode"]["logits"], run["ref"]["logits"],
                               atol=2e-4, rtol=1e-4)


def test_decode_logits_match_port_unsharded(run):
    np.testing.assert_allclose(run["mesh"]["decode"]["logits"], run["local_decode"][0],
                               atol=1e-5, rtol=1e-5)


def test_decode_cache_matches_reference_sharded(run):
    cfg = get_config(TD.ATTN_ARCH, reduced=True)
    got = dict(_leaves(lm_cache_to_reference_layout(_mesh_caches(run), cfg)))
    want = dict(_leaves(run["ref"]["cache"]))
    assert got.keys() == want.keys()
    for key, w in want.items():
        if w.dtype.kind == "i":  # the positions written, slot by slot
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, atol=2e-4, rtol=1e-4, err_msg=key)


def test_decode_cache_matches_port_unsharded(run):
    for got, want in zip(_mesh_caches(run), run["local_decode"][1]):
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        for t in (0, 1):
            np.testing.assert_allclose(got[t].numpy(), want[t], atol=1e-5, rtol=1e-5)


def test_rwkv_per_rank_matches_port_unsharded(run):
    """rwkv6-3b reduced (4 heads over model=2, remat): ``h`` and the
    gradients of ``sum(h * w)`` against the port's unsharded forward, within
    the LM layer tolerances (2e-4 / 1e-4; gradients 1e-4 of the largest):
    the row-parallel products add their partial sums over 'model' in
    another order, and the recurrence's decays (exponentials of cumulative
    sums) carry that rounding further than attention does."""
    np.testing.assert_allclose(run["mesh"]["rwkv"]["h"], run["rwkv_local"][0], atol=2e-4,
                               rtol=1e-4)
    _close_grads(run["mesh"]["rwkv"]["g_h"], run["rwkv_local"][1], 1e-4)
