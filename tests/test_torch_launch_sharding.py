"""``repro_torch.launch.sharding`` against ``repro.launch.sharding``, in
process: for all ten architectures at full size, the port's
``state_shardings``, ``batch_shardings`` and ``cache_shardings`` equal the
reference's leaf for leaf on meshes 8 x 1, 4 x 2, 2 x 4, 1 x 8, (16, 16)
and (2, 16, 16).

Nothing is allocated: the reference's shapes come from ``jax.eval_shape``,
the port's from the meta device.  The reference gets a stand-in mesh (axis
names and a ``devices`` array) and its ``NamedSharding`` is replaced by the
spec itself; the port gets an ``AbstractMesh``.  The port holds one module
a block where the reference stacks a layer group's blocks, so a block's
leaf is compared (through ``convert._reference_layout``) with its stacked
reference leaf's spec, stack entry dropped.
"""
from __future__ import annotations

import pickle
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.launch.sharding as RS
from repro.configs import get_config as r_config
from repro.data import arch_batch as r_arch_batch
from repro.models import init_cache as r_init_cache
from repro.train import init_train_state as r_init_train_state
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import _reference_layout
from repro_torch.data import arch_batch
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
from repro_torch.launch.sharding import (
    P,
    batch_shardings,
    cache_shardings,
    place,
    state_bytes,
    state_shardings,
)
from repro_torch.models import init_cache
from repro_torch.train import init_train_state

MESHES = [((8, 1), ("data", "model")), ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((1, 8), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_BATCH, CACHE_SEQ = 16, 2048


def _norm(spec, nd: int) -> tuple:
    """A spec's entries padded to ``nd``, one-axis tuples written as the axis."""
    entries = tuple(spec) + (None,) * (nd - len(tuple(spec)))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _node(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.fixture
def ref_specs(monkeypatch):
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: spec)

    def meshed(shape, names):
        return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))

    return meshed


@pytest.mark.parametrize("arch", ARCHS)
def test_state_shardings_match_reference(arch, ref_specs):
    rcfg, cfg = r_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: r_init_train_state(rcfg, jax.random.PRNGKey(0)))
    template = init_train_state(cfg, device="meta")
    layout = _reference_layout(cfg)
    params = dict(template["params"].named_parameters())
    for shape, names in MESHES:
        want = RS.state_shardings(shapes, ref_specs(shape, names), rcfg)
        got = state_shardings(template, AbstractMesh(shape, names), cfg)
        assert _norm(got["opt"]["step"].spec, 0) == _norm(want["opt"]["step"], 0) == ()
        for part in ("params", "m", "v"):
            ref_tree = want["params"] if part == "params" else want["opt"][part]
            port = got["params"] if part == "params" else got["opt"][part]
            assert port.keys() == params.keys()
            for name, p in params.items():
                path, row = layout[name]
                ref = _norm(_node(ref_tree, path), p.ndim + (row is not None))
                ref = ref if row is None else ref[1:]
                assert _norm(port[name].spec, p.ndim) == ref, (shape, part, name)


@pytest.mark.parametrize("global_batch", [16, 6, 512])
def test_batch_shardings_match_reference(global_batch, ref_specs):
    for arch in ARCHS:
        rcfg, cfg = r_config(arch, reduced=True), get_config(arch, reduced=True)
        rb = r_arch_batch(rcfg, 2, 8, "train", seed=0)
        tb = arch_batch(cfg, 2, 8, "train", seed=0, device="cpu")
        assert rb.keys() == tb.keys()
        for shape, names in MESHES:
            want = RS.batch_shardings(rb, ref_specs(shape, names), global_batch)
            got = batch_shardings(tb, AbstractMesh(shape, names), global_batch)
            for k, v in tb.items():
                assert _norm(got[k].spec, v.ndim) == _norm(want[k], v.ndim), (arch, shape, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch, ref_specs):
    rcfg, cfg = r_config(arch), get_config(arch)
    rcache = jax.eval_shape(lambda: r_init_cache(rcfg, CACHE_BATCH, CACHE_SEQ))
    cache = init_cache(cfg, CACHE_BATCH, CACHE_SEQ, device="meta")
    blocks = [(gi, f"b{i}") for gi, (pattern, reps) in enumerate(cfg.layer_groups())
              for _ in range(reps) for i in range(len(pattern))]
    for shape, names in MESHES:
        want = RS.cache_shardings(rcache, ref_specs(shape, names), rcfg, CACHE_BATCH)
        got = cache_shardings(cache, AbstractMesh(shape, names), cfg, CACHE_BATCH)
        assert len(got) == len(cache) == len(blocks)
        for (gi, b), entry, leaves in zip(blocks, got, cache):
            ref = want[gi][b]
            assert len(entry) == len(ref) == len(leaves)
            for sh, r, leaf in zip(entry, ref, leaves):
                assert _norm(sh.spec, leaf.ndim) == _norm(r, leaf.ndim + 1)[1:], (shape, gi, b)


def test_a_sharded_kv_cache_sequence():
    """Above 1,024 positions a divisible KV sequence splits over model."""
    cfg = get_config("qwen3-1.7b")
    got = cache_shardings(init_cache(cfg, 16, 2048, device="meta"),
                          AbstractMesh((4, 2), ("data", "model")), cfg, 16)
    assert tuple(got[0][0].spec) == (("data",), "model", None, None)
    assert tuple(got[0][2].spec) == (("data",), "model")


def test_partition_spec_and_named_sharding():
    spec = P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(spec)) == spec and type(pickle.loads(pickle.dumps(spec))) is P
    assert repr(P("data", None)) == "P('data', None)"
    ns = state_shardings(init_train_state(get_config("qwen3-1.7b", reduced=True), device="meta"),
                         AbstractMesh((2, 2, 2), ("pod", "data", "model")),
                         get_config("qwen3-1.7b", reduced=True))
    # wq [64, 64]: rows over pod x data (FSDP), columns over model (TP)
    assert tuple(ns["params"]["blocks.0.attn.wq"].spec) == (("pod", "data"), "model")
    assert ns["params"]["blocks.0.attn.wq"].placements == [Shard(0), Shard(0), Shard(1)]


def test_place_on_a_one_rank_mesh():
    assert not dist.is_initialized()
    try:
        cfg = get_config("qwen3-1.7b", reduced=True)
        mesh = make_host_mesh(device="cpu")
        state = init_train_state(cfg, 0, device="cpu")
        want = {k: v.detach().clone() for k, v in state["params"].named_parameters()}
        state = place(state, state_shardings(state, mesh, cfg))
        for name, p in state["params"].named_parameters():
            assert isinstance(p, DTensor) and p.requires_grad, name
            torch.testing.assert_close(p.full_tensor(), want[name], rtol=0, atol=0)
        assert isinstance(state["opt"]["m"]["embed"], DTensor)
        assert tuple(state["opt"]["step"].placements) == (Replicate(), Replicate())
        b = state_bytes(state)
        assert b["local"] == b["whole"] > 0  # one rank holds everything
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_train_state_round_trip_through_a_sharded_state():
    """``convert.train_state_from_reference(..., shardings=)`` then
    ``train_state_to_reference``: the same arrays back, bit for bit."""
    import jax

    from _torch_lm import np_tree, perturb
    from _torch_train import _leaves
    from repro_torch.convert import train_state_from_reference, train_state_to_reference

    rcfg, cfg = r_config("recurrentgemma-2b", reduced=True), get_config("recurrentgemma-2b",
                                                                        reduced=True)
    want = np_tree(r_init_train_state(rcfg, jax.random.PRNGKey(0)))
    want["opt"]["m"] = perturb(want["opt"]["m"], 1)
    want["opt"]["step"] = np.asarray(7, np.int32)
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        sh = state_shardings(init_train_state(cfg, device="meta"), mesh, cfg)
        state = train_state_from_reference(want, cfg, shardings=sh)
        assert all(isinstance(p, DTensor) for p in state["params"].parameters())
        got = train_state_to_reference(state, cfg)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    w, g = dict(_leaves(want)), dict(_leaves(got))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
