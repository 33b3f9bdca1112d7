"""Ranks of a ``torch.distributed`` group on the CPU (``gloo``) for the
tests/test_torch_dist_*.py files, and the per-rank work they run.

``spawn`` starts ``world`` processes (the ``spawn`` start method), joins
them within a timeout (a hang fails the test instead of eating the
suite's time) and re-raises a rank's exception.  The group meets over a
``FileStore`` under the test's ``tmp_path``, so files running at once on
several pytest workers never share a port.  Each rank uses one thread.

This module imports torch and the port only (never jax): every rank
imports it.  The workers read their inputs from, and write their results
to, the directory they are given; rank 0 writes what the test compares.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 300.0


def spawn(fn, world: int, directory, *args, timeout: float = JOIN_TIMEOUT_S) -> None:
    """Run ``fn(rank, world, directory, *args)`` on ``world`` gloo ranks."""
    store = os.path.join(str(directory), "filestore")
    ctx = mp.start_processes(_entry, args=(fn, world, store, str(directory), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5.0)


def _entry(rank, fn, world, store, directory, args):
    torch.set_num_threads(1)  # ranks share the CPUs with the other test workers
    logging.disable(logging.WARNING)  # DTensor's planner notes, once a rank
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        fn(rank, world, directory, *args)
    finally:
        dist.destroy_process_group()


def save_tree(path, tree) -> None:
    """A nested dict / list of arrays as one flat ``.npz`` ("//" keys)."""
    from repro_torch.ckpt.manager import _flatten

    np.savez(path, **_flatten(tree))


def load_tree(path):
    from repro_torch.ckpt.manager import _nest

    with np.load(path) as z:
        return _nest({k: z[k] for k in z.files})


def _write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


# ---------------------------------------------------------------------------
# the sharded train step (4 x 2)
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = "qwen3-1.7b", 8, 32, 1e-3


def train_step_worker(rank, world, d):
    """One step of qwen3-1.7b reduced on a (data=4, model=2) mesh from the
    reference's initial state (``state0.npz``), the recipe of the
    reference's ``test_sharded_train_step_matches_single_device``."""
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_reference, train_state_to_reference
    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.dist.context import ShardingRules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import batch_shardings, place, state_bytes, state_shardings
    from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH, reduced=True)
    tc = TrainConfig(opt=OptConfig(peak_lr=TRAIN_LR))
    batch = lm_batch(DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ), 0, "cpu")
    mesh = make_host_mesh(data=4, model=2, device="cpu")
    with use_rules(ShardingRules(mesh, batch_axes=("data",))):
        sh = state_shardings(init_train_state(cfg, device="meta"), mesh, cfg)
        state = train_state_from_reference(load_tree(os.path.join(d, "state0.npz")), cfg,
                                           shardings=sh)
        batch = place(batch, batch_shardings(batch, mesh, TRAIN_BATCH))
        state, metrics = make_train_step(cfg, tc)(state, batch)
        placed = {name: [str(p) for p in t.placements]
                  for name, t in state["params"].named_parameters()}
        nbytes = state_bytes(state)
        out = train_state_to_reference(state, cfg)  # gathers: every rank
    _write_json(os.path.join(d, f"bytes_{rank}.json"), nbytes)
    if rank == 0:
        save_tree(os.path.join(d, "sharded_state.npz"), out)
        _write_json(os.path.join(d, "metrics.json"),
                    {"metrics": {k: float(v) for k, v in metrics.items()},
                     "types": sorted({type(v).__name__ for v in metrics.values()}),
                     "placements": placed})


# ---------------------------------------------------------------------------
# the per-rank branches of models/layers.py (4 x 2)
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_BATCH, MOE_SEQ = "granite-moe-1b-a400m", 4, 32


def moe_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH, reduced=True), capacity_factor=8.0)


def moe_tp_config():
    """granite-moe reduced with 256 ff columns an expert: 128 a rank on
    model=2, so the experts are TP-sharded and the down-projections psum."""
    return dataclasses.replace(moe_config(), moe_d_ff=256)


def gqa_config():
    """qwen3 reduced with 6 query and 3 KV heads: 3 does not divide
    model=2, 6 does, so attention repeats K/V to the query heads."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH, reduced=True), n_heads=6, n_kv_heads=3)


def loss_weights(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _forward_and_grads(model, cfg, batch):
    """Hidden states, aux, and two sets of gradients, of ``sum(h * w)``
    and of ``aux`` (``w`` from ``loss_weights``), each leaf as a full numpy
    array keyed by parameter name (zeros where the function does not
    reach)."""
    from repro_torch.models import forward
    from repro_torch.train.step import _plain

    h, _, aux = forward(model, cfg, batch)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    w = loss_weights(tuple(h.shape), 5)
    out = []
    for i, f in enumerate(((h * w).sum(), aux)):
        grads = torch.autograd.grad(f, params, retain_graph=i == 0, allow_unused=True)
        out.append({})
        for (name, p), g in zip(named, grads):
            if g is None:
                g = torch.zeros_like(p)
            if hasattr(g, "full_tensor"):
                g = g.redistribute(p.device_mesh, p.placements).full_tensor()
            out[-1][name] = g.detach().numpy()
    return _plain(h).detach().numpy(), float(_plain(aux).detach()), out[0], out[1]


def layers_worker(rank, world, d):
    """Under 4 x 2 rules: granite-moe's forward (the MoE ``shard_map``
    branch) from the reference's weights, and its gradients; the
    vocab-parallel embedding and its gradient; the GQA head-repeat."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.convert import lm_params_from_reference
    from repro_torch.data import arch_batch
    from repro_torch.dist.context import ShardingRules, spec_placements, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import batch_shardings, param_shardings, place
    from repro_torch.models import forward, init_params
    from repro_torch.models.layers import embedding_lookup
    from repro_torch.train.step import _plain

    mesh = make_host_mesh(data=4, model=2, device="cpu")
    out = {}
    with use_rules(ShardingRules(mesh, batch_axes=("data",))):
        cfg = moe_config()
        model = lm_params_from_reference(load_tree(os.path.join(d, "moe_params.npz")), cfg,
                                         "cpu")
        model.requires_grad_(True)
        place(model, param_shardings(model, mesh, cfg))
        batch = arch_batch(cfg, MOE_BATCH, MOE_SEQ, "train", seed=0, device="cpu")
        batch = place(batch, batch_shardings(batch, mesh, MOE_BATCH))
        h, aux, g_h, g_aux = _forward_and_grads(model, cfg, batch)
        out["moe"] = {"h": h, "aux": np.float32(aux), "g_h": g_h, "g_aux": g_aux}

        tcfg = moe_tp_config()
        tmodel = init_params(tcfg, 2, device="cpu")
        tmodel.requires_grad_(True)
        place(tmodel, param_shardings(tmodel, mesh, tcfg))
        h, aux, g_h, _ = _forward_and_grads(tmodel, tcfg, batch)
        out["moe_tp"] = {"h": h, "aux": np.float32(aux), "g_h": g_h}

        # vocab-parallel embedding: the table (vocab over model, d_model
        # over data, the reference's embed spec) and tokens over data
        table = loss_weights((512, 64), 7)
        tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (8, 16)))
        tdt = distribute_tensor(table.detach(), mesh,
                                spec_placements(mesh, ("model", "data")),
                                src_data_rank=None).requires_grad_(True)
        kdt = distribute_tensor(tokens, mesh, spec_placements(mesh, ("data", None)),
                                src_data_rank=None)
        e = embedding_lookup(tdt, kdt)
        (e * loss_weights((8, 16, 64), 9)).sum().backward()
        out["embed"] = {"out": _plain(e).detach().numpy(),
                        "grad": tdt.grad.redistribute(mesh, tdt.placements).full_tensor().numpy()}

        # GQA head-repeat: count repeat_interleave calls (the branch's K/V)
        gcfg = gqa_config()
        gmodel = init_params(gcfg, 3, device="cpu")
        place(gmodel, param_shardings(gmodel, mesh, gcfg))
        gbatch = arch_batch(gcfg, 8, 16, "train", seed=1, device="cpu")
        gbatch = place(gbatch, batch_shardings(gbatch, mesh, 8))
        calls = []
        real = torch.repeat_interleave

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)

        torch.repeat_interleave = counted
        try:
            gh, _, _ = forward(gmodel, gcfg, gbatch)
        finally:
            torch.repeat_interleave = real
        out["gqa"] = {"h": _plain(gh).detach().numpy(), "repeats": np.int64(len(calls))}
    if rank == 0:
        save_tree(os.path.join(d, "layers.npz"), out)


# ---------------------------------------------------------------------------
# int8 ring, pipeline, elastic restore (8 ranks)
# ---------------------------------------------------------------------------


def ring_inputs() -> np.ndarray:
    return np.random.default_rng(0).normal(size=(8, 257)).astype(np.float32)


def ring_worker(rank, world, d):
    """Rank r holds row r of ``ring_inputs()``; every rank's result of the
    int8 ring is gathered to rank 0."""
    from repro_torch.dist.compression import _ring_allreduce_int8

    x = torch.from_numpy(ring_inputs()[rank:rank + 1])
    out = _ring_allreduce_int8(x, None, world)
    every = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(every, out)
    if rank == 0:
        np.save(os.path.join(d, "ring.npy"), torch.stack(every).numpy())


def pipeline_inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(8, 16, 16)).astype(np.float32) / 4)
    x = rng.normal(size=(4, 2, 16)).astype(np.float32)
    return w, x


def stage_fn(p, x):
    return torch.tanh(x @ p["w"])


def pipeline_worker(rank, world, d):
    """GPipe over a ``pod`` axis of 8 ranks, S = 8 stages, M = 4
    microbatches; every rank's output is gathered to rank 0."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.pipeline import pipeline_forward

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    w, x = pipeline_inputs()
    out = pipeline_forward(stage_fn, torch.from_numpy(x), {"w": torch.from_numpy(w)}, mesh,
                           axis_name="pod")
    every = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(every, out)
    if rank == 0:
        np.save(os.path.join(d, "pipeline.npy"), torch.stack(every).numpy())


def elastic_worker(rank, world, d):
    """qwen3-1.7b reduced's initial state placed on 8 x 1, saved, restored
    on 2 x 4 through ``restore(shardings=)``; rank 0 also saves the
    unsharded state to ``plain/``."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import place, state_shardings
    from repro_torch.train import init_train_state

    cfg = get_config(TRAIN_ARCH, reduced=True)
    mesh_a = make_host_mesh(data=8, model=1, device="cpu")
    state_a = init_train_state(cfg, 0, device="cpu")
    state_a = place(state_a, state_shardings(state_a, mesh_a, cfg))
    mgr = CheckpointManager(os.path.join(d, "sharded"), async_save=True)
    mgr.save(1, state_a)
    mgr.wait()
    if rank == 0:
        plain = CheckpointManager(os.path.join(d, "plain"), async_save=False)
        plain.save(1, init_train_state(cfg, 0, device="cpu"))
    mesh_b = make_host_mesh(data=2, model=4, device="cpu")
    template = init_train_state(cfg, device="meta")
    sh_b = state_shardings(template, mesh_b, cfg)
    state_b = mgr.restore(1, template, sh_b)
    want = init_train_state(cfg, 0, device="cpu")
    report = {"placements_b": {}, "equal": {}}
    for (name, p), q in zip(state_b["params"].named_parameters(), want["params"].parameters()):
        report["placements_b"][name] = [str(x) for x in p.placements]
        report["equal"][f"params/{name}"] = bool(torch.equal(p.full_tensor(), q.detach()))
    for part in ("m", "v"):
        for name, t in state_b["opt"][part].items():
            report["equal"][f"{part}/{name}"] = bool(torch.equal(
                t.full_tensor(), want["opt"][part][name]))
    report["equal"]["step"] = bool(torch.equal(state_b["opt"]["step"].full_tensor(),
                                               want["opt"]["step"]))
    report["requires_grad"] = all(p.requires_grad for p in state_b["params"].parameters())
    if rank == 0:
        _write_json(os.path.join(d, "elastic.json"), report)


# ---------------------------------------------------------------------------
# launch.train on 8 ranks
# ---------------------------------------------------------------------------


def launch_worker(rank, world, d, argv):
    """``repro_torch.launch.train.main(argv)`` on every rank (its host mesh
    is then 8 x 1); each rank's printed lines go to ``launch_<rank>.txt``."""
    import contextlib
    import io

    from repro_torch.launch import train as launch_train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(argv)
    with open(os.path.join(d, f"launch_{rank}.txt"), "w") as f:
        f.write(buf.getvalue())


# ---------------------------------------------------------------------------
# attention per rank (4 x 2): forward, gradients, decode on a split cache
# ---------------------------------------------------------------------------

ATTN_ARCH, ATTN_BATCH, ATTN_SEQ, ATTN_CACHE = "qwen3-1.7b", 8, 32, 2048
RWKV_ARCH, RWKV_SEED = "rwkv6-3b", 4


def attention_decode_inputs() -> list:
    """Decode steps as (tokens [B, 1] int32, pos): one position for the
    batch (an int) across the boundary of the cache's two blocks of 1,024
    slots over 'model', then per-slot positions on both sides of it."""
    rng = np.random.default_rng(11)
    per_slot = np.array([1030, 1020, 1040, 1010, 1050, 1000, 1060, 990], np.int32)
    steps = [1022, 1023, 1024, 1025, per_slot, per_slot + 1]
    return [(rng.integers(0, 512, (ATTN_BATCH, 1)).astype(np.int32), p) for p in steps]


def h_and_grads(model, cfg, batch, remat: bool = False):
    """Hidden states and the gradient of ``sum(h * w)`` (``w`` from
    ``loss_weights``) as full numpy arrays keyed by parameter name."""
    from repro_torch.models import forward
    from repro_torch.train.step import _plain

    h, _, _ = forward(model, cfg, batch, remat=remat)
    named = list(model.named_parameters())
    f = (h * loss_weights(tuple(h.shape), 5)).sum()
    grads = torch.autograd.grad(f, [p for _, p in named], allow_unused=True)
    out = {}
    for (name, p), g in zip(named, grads):
        if g is None:
            g = torch.zeros_like(p)
        if hasattr(g, "full_tensor"):
            g = g.redistribute(p.device_mesh, p.placements).full_tensor()
        out[name] = g.detach().numpy()
    return _plain(h).detach().numpy(), out


def run_decode(model, cfg, caches):
    """``attention_decode_inputs()`` through ``decode_step``: the logits of
    every step and the final caches (full arrays, one tuple a block)."""
    from repro_torch.models import decode_step
    from repro_torch.train.step import _plain

    logits = []
    with torch.no_grad():
        for tokens, pos in attention_decode_inputs():
            pos = pos if isinstance(pos, int) else torch.from_numpy(pos)
            lg, caches = decode_step(model, cfg, caches, torch.from_numpy(tokens), pos)
            logits.append(_plain(lg).numpy())
    full = [tuple(_plain(t).numpy() for t in c) for c in caches]
    return np.stack(logits), full


def attention_worker(rank, world, d):
    """qwen3-1.7b reduced from the reference's weights under 4 x 2 rules
    with the sequence split (``seq_sharded``, as the dry run): the forward
    and its gradients (4 heads, 2 KV heads: both split over 'model'), and
    decode on a cache placed by ``cache_shardings`` (batch over 'data', its
    2,048 slots over 'model'); rwkv6-3b reduced's forward (remat) and
    gradients, its recurrence per rank."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.data import arch_batch
    from repro_torch.dist.context import ShardingRules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (
        batch_shardings,
        cache_shardings,
        param_shardings,
        place,
    )
    from repro_torch.models import init_cache, init_params

    cfg = get_config(ATTN_ARCH, reduced=True)
    mesh = make_host_mesh(data=4, model=2, device="cpu")
    out = {}
    with use_rules(ShardingRules(mesh, batch_axes=("data",), seq_sharded=True)):
        model = lm_params_from_reference(load_tree(os.path.join(d, "attn_params.npz")), cfg,
                                         "cpu")
        model.requires_grad_(True)
        place(model, param_shardings(model, mesh, cfg))
        batch = arch_batch(cfg, ATTN_BATCH, ATTN_SEQ, "train", seed=0, device="cpu")
        batch = place(batch, batch_shardings(batch, mesh, ATTN_BATCH))
        h, g_h = h_and_grads(model, cfg, batch)
        out["train"] = {"h": h, "g_h": g_h}
        caches = init_cache(cfg, ATTN_BATCH, ATTN_CACHE, torch.float32, "cpu")
        caches = place(caches, cache_shardings(caches, mesh, cfg, ATTN_BATCH))
        split_dims = [p.dim if p.is_shard() else None for p in caches[0][0].placements]
        logits, full = run_decode(model, cfg, caches)
        out["decode"] = {"logits": logits,
                         "cache": {str(i): {"k": c[0], "v": c[1], "pos": c[2]}
                                   for i, c in enumerate(full)}}
        # RWKV's recurrence per rank (its heads split over 'model' as well)
        rcfg = get_config(RWKV_ARCH, reduced=True)
        rmodel = init_params(rcfg, RWKV_SEED, device="cpu")
        rmodel.requires_grad_(True)
        place(rmodel, param_shardings(rmodel, mesh, rcfg))
        rbatch = arch_batch(rcfg, ATTN_BATCH, ATTN_SEQ, "train", seed=3, device="cpu")
        rbatch = place(rbatch, batch_shardings(rbatch, mesh, ATTN_BATCH))
        h, g_h = h_and_grads(rmodel, rcfg, rbatch, remat=True)
        out["rwkv"] = {"h": h, "g_h": g_h}
    if rank == 0:
        save_tree(os.path.join(d, "attention.npz"), out)
        _write_json(os.path.join(d, "attention.json"), {"cache_split_dims": split_dims})
