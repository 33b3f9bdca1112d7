"""``repro_torch.dist.context`` against ``repro.dist.context``, in process.

* ``ShardingRules.physical`` on every logical name, and ``constrain``'s
  drop rule (an axis that does not divide its dimension is replicated), on
  meshes 8 x 1, 4 x 2, 2 x 4, 1 x 8, (16, 16) and (2, 16, 16) under several
  rule settings.  Neither side needs devices for this: the reference gets
  a stand-in mesh (axis names and a ``devices`` array) and its
  ``with_sharding_constraint`` is replaced by a recorder, the port an
  ``AbstractMesh``.
* ``constrain`` / ``axis_size`` with no rules, on plain tensors, and on a
  DTensor of a 1 x 1 mesh over a one-rank gloo group.
* mixtral reduced (``moe_token_chunk=2``) under 1 x 1 rules -- the MoE mesh
  branch with capacity per token chunk -- against the reference under its
  own 1 x 1 host mesh and rules, within the LM layer tolerances
  (2e-4 / 1e-4); and both without rules.
"""
from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

import repro.dist.context as RC
from _torch_lm import np_tree
from repro.configs import get_config as r_config
from repro.data import arch_batch as r_arch_batch
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro.models import forward as r_forward
from repro.models import init_params as r_init_params
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import arch_batch
from repro_torch.dist import context as C
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
from repro_torch.launch.sharding import batch_shardings, param_shardings, place
from repro_torch.models import forward

MESHES = [((8, 1), ("data", "model")), ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((1, 8), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RULES = [{}, {"batch_axes": ("pod", "data")}, {"batch_shardable": False},
         {"seq_sharded": True}, {"seq_sharded": True, "seq_axis": "data"},
         {"model_axis": "data"}, {"batch_axes": ("model",), "seq_axis": "pod", "seq_sharded": True}]
LOGICAL = [None, "batch", "heads", "ff", "vocab", "model", "feature", "seq", "kv_seq", "other"]


def _pair(shape, names, kw):
    ref_mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    return RC.ShardingRules(ref_mesh, **kw), C.ShardingRules(AbstractMesh(shape, names), **kw)


def _norm(spec) -> tuple:
    """JAX's ``PartitionSpec`` writes a one-axis tuple entry as the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.fixture
def one_rank():
    """A one-rank gloo group the test starts (``make_host_mesh``); gone after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape,names", MESHES)
def test_physical_matches_reference(shape, names):
    for kw in RULES:
        ref, port = _pair(shape, names, kw)
        for logical in LOGICAL:
            assert port.physical(logical) == ref.physical(logical), (kw, logical)


@pytest.mark.parametrize("shape,names", MESHES)
def test_constrain_drop_rule_matches_reference(shape, names, monkeypatch):
    monkeypatch.setattr(RC, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    cases = [((8, 128, 64), ("batch", "seq", None)), ((6, 7, 16), ("batch", None, "vocab")),
             ((32, 1, 48, 16), ("batch", None, "heads", None)),
             ((2, 4096, 3, 16), ("batch", "kv_seq", None, None)),
             ((16, 256, 512), ("batch", None, "ff")), ((512, 16, 16, 2, 8),
                                                       ("batch", None, "heads", None, None))]
    for kw in RULES:
        ref, port = _pair(shape, names, kw)
        for dims, axes in cases:
            with RC.use_rules(ref):
                want = tuple(RC.constrain(np.zeros(dims, np.int8), *axes))
            assert _norm(C._constraint_spec(port, dims, axes)) == _norm(want), (kw, dims, axes)


def test_axis_size_and_identity_without_rules():
    x = torch.zeros(2, 3)
    assert C.get_rules() is None and C.axis_size("model") == 1
    assert C.constrain(x, "batch", None) is x
    rules = C.ShardingRules(AbstractMesh((4, 2), ("data", "model")))
    with C.use_rules(rules):
        assert C.get_rules() is rules
        assert C.axis_size("model") == 2 and C.axis_size("data") == 4 and C.axis_size("pod") == 1
        assert C.constrain(x, "batch", None) is x  # a plain tensor: nothing to place
        with pytest.raises(ValueError, match="2 axis names for rank-3"):
            C.constrain(torch.zeros(2, 3, 4), "batch", None)
    assert C.get_rules() is None


def test_psum_needs_rules():
    with pytest.raises(RuntimeError, match="use_rules"):
        C.psum(torch.ones(2), "model")


def test_spec_placements():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert C.spec_placements(mesh, (("pod", "data"), "model")) == [Shard(0), Shard(0), Shard(1)]
    assert C.spec_placements(mesh, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        C.spec_placements(mesh, (("data", "pod"),))


def test_constrain_on_a_one_rank_mesh(one_rank):
    """Over axes of one rank a spec splits nothing: the placements stay
    replicated and the values whole."""
    mesh = make_host_mesh(device="cpu")
    assert C.mesh_sizes(mesh) == {"data": 1, "model": 1}
    assert C.spec_placements(mesh, ("data", None, "model")) == [Replicate(), Replicate()]
    x = distribute_tensor(torch.arange(24.0).reshape(2, 3, 4), mesh, [Replicate(), Replicate()])
    with C.use_rules(C.ShardingRules(mesh)):
        y = C.constrain(x, "batch", None, "vocab")
        assert isinstance(y, DTensor) and tuple(y.placements) == (Replicate(), Replicate())
        np.testing.assert_array_equal(y.full_tensor().numpy(), np.arange(24.0).reshape(2, 3, 4))


def test_spec_placements_replicate_axes_of_one_rank():
    mesh = AbstractMesh((4, 1), ("data", "model"))
    assert C.spec_placements(mesh, ("data", "model")) == [Shard(0), Replicate()]


_MIXTRAL: dict = {}


def _mixtral_reference():
    """mixtral reduced, the reference's forward with and without 1 x 1 rules."""
    if not _MIXTRAL:
        rcfg = r_config("mixtral-8x22b", reduced=True)
        params = np_tree(r_init_params(rcfg, jax.random.PRNGKey(0)))
        batch = r_arch_batch(rcfg, 4, 32, "train", seed=0)
        h0, _, a0 = r_forward(params, rcfg, batch)
        mesh = r_make_host_mesh()
        with RC.use_rules(RC.ShardingRules(mesh)), mesh:
            h1, _, a1 = jax.jit(lambda p, b: r_forward(p, rcfg, b))(params, batch)
        _MIXTRAL.update(params=params, plain=(np.asarray(h0), float(a0)),
                        rules=(np.asarray(h1), float(a1)))
    return _MIXTRAL


def test_mixtral_token_chunks_under_1x1_rules_match_reference(one_rank):
    ref = _mixtral_reference()
    cfg = get_config("mixtral-8x22b", reduced=True)
    assert cfg.moe_token_chunk == 2
    mesh = make_host_mesh(device="cpu")
    model = lm_params_from_reference(ref["params"], cfg, "cpu")
    batch = arch_batch(cfg, 4, 32, "train", seed=0, device="cpu")
    with C.use_rules(C.ShardingRules(mesh)):
        place(model, param_shardings(model, mesh, cfg))
        h, _, aux = forward(model, cfg, place(batch, batch_shardings(batch, mesh, 4)))
        assert isinstance(h, DTensor)
        h, aux = h.full_tensor().numpy(), float(aux.full_tensor())
    np.testing.assert_allclose(h, ref["rules"][0], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(aux, ref["rules"][1], atol=2e-4, rtol=1e-4)


def test_mixtral_without_rules_matches_reference():
    ref = _mixtral_reference()
    cfg = get_config("mixtral-8x22b", reduced=True)
    model = lm_params_from_reference(ref["params"], cfg, "cpu")
    h, _, aux = forward(model, cfg, arch_batch(cfg, 4, 32, "train", seed=0, device="cpu"))
    np.testing.assert_allclose(h.numpy(), ref["plain"][0], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), ref["plain"][1], atol=2e-4, rtol=1e-4)


def _backward_on_another_thread(loss) -> None:
    """``loss.backward()`` run by a second thread, as the autograd engine
    runs a CUDA graph's backward pass on its own device thread: that
    thread gets the caller's dispatch state (DTensor's implicit
    replication on), not its Python thread-locals (the rules)."""
    import threading

    errors = []

    def run():
        try:
            DTensor._op_dispatcher._allow_implicit_replication = True
            loss.backward()
        except BaseException as e:  # noqa: BLE001 -- re-raised in the test's thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors


def test_bound_to_rules_reaches_a_recompute_on_another_thread():
    """A checkpointed body is recomputed in the backward pass: bound to the
    rules, it sees them there whichever thread runs it; unbound it does not."""
    from torch.utils.checkpoint import checkpoint

    rules = C.ShardingRules(AbstractMesh((1, 1), ("data", "model")))
    for bind, want in ((True, [rules, rules]), (False, [rules, None])):
        seen = []

        def body(x):
            seen.append(C.get_rules())
            return torch.tanh(x) * 2.0

        x = torch.ones(4, requires_grad=True)
        with C.use_rules(rules):
            y = checkpoint(C.bound_to_rules(body) if bind else body, x, use_reentrant=False)
        _backward_on_another_thread(y.sum())
        assert seen == want
    assert C.bound_to_rules(body) is body  # no rules, nothing to carry


def test_use_rules_nests_with_implicit_replication():
    rules = C.ShardingRules(AbstractMesh((1, 1), ("data", "model")))
    dispatcher = DTensor._op_dispatcher
    assert not dispatcher._allow_implicit_replication
    with C.use_rules(rules):
        with C.use_rules(rules):
            assert dispatcher._allow_implicit_replication
        assert dispatcher._allow_implicit_replication and C.get_rules() is rules
    assert not dispatcher._allow_implicit_replication and C.get_rules() is None


def test_remat_recompute_runs_per_rank_branches_on_another_thread(one_rank, monkeypatch):
    """qwen3 reduced under 1 x 1 rules with remat: the backward pass, run
    by another thread, recomputes each layer through the per-rank
    attention as the forward did, and the gradients equal those of a
    backward pass on the test's thread."""
    from repro_torch.models import layers as L

    cfg = get_config("qwen3-1.7b", reduced=True)
    mesh = make_host_mesh(device="cpu")
    calls = []
    real = L._attend_per_rank

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(L, "_attend_per_rank", counted)
    grads = []
    for other_thread in (False, True):
        calls.clear()
        model = init_params_seeded(cfg)
        place(model, param_shardings(model, mesh, cfg))
        batch = place(arch_batch(cfg, 2, 16, "train", seed=0, device="cpu"),
                      batch_shardings(arch_batch(cfg, 2, 16, "train", seed=0, device="cpu"),
                                      mesh, 2))
        with C.use_rules(C.ShardingRules(mesh)):
            h, _, _ = forward(model, cfg, batch, remat=True)
            loss = h.sum()
            if not other_thread:
                loss.backward()
        if other_thread:
            _backward_on_another_thread(loss)
        assert len(calls) == 2 * cfg.n_layers  # the forward, then the recompute
        grads.append({n: p.grad.full_tensor() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


def init_params_seeded(cfg):
    from repro_torch.models import init_params

    model = init_params(cfg, 0, device="cpu")
    model.requires_grad_(True)
    return model
