"""Multi-pod dry run: trace every (arch x shape x mesh) cell on placeholder
ranks (the port of ``repro.launch.dryrun``).

For each cell this proves, with no device memory, that the distribution
config is coherent: the shardings are accepted, every op of the step finds
a placement, the collective schedule is built, and the bytes a rank holds
show whether the cell fits.  The placeholders are a fake process group of
the production size (256 ranks single, 512 multi: every collective returns
at once, nothing is sent) and fake tensors (``FakeTensorMode``: shapes,
dtypes and devices, no storage) on the run's device.  One rank's eager step
runs under :class:`~repro_torch.launch.hlo_analysis.OpAccounting`, which
counts the local ops that rank would run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b \
        --shape train_4k --mesh single --out artifacts/pt_dryrun [--device cpu]

(no flags = every runnable cell on both meshes; skips cells whose JSON
already exists unless --force).  ``device=None`` is the CUDA card, and
raises without one; ``--device cpu`` traces on the CPU.  The environment
variables of the reference apply: ``DRYRUN_SEQ_SHARDED`` (default 1),
``DRYRUN_REMAT_POLICY`` (``full``), ``DRYRUN_LOSS_CHUNK`` (512).

A record keeps the reference's keys.  Where XLA compiles, the port traces:
``lower_s`` is the build and trace seconds and ``compile_s`` is null.
``memory_analysis`` counts one rank's local bytes: the step's arguments,
its outputs, the donated state they alias (the port updates it in place),
and as ``temp_size_in_bytes`` the most bytes the storages made during the
step held at once (activations, gradients, and the outputs it makes).
``cost_analysis`` and ``loop_aware`` hold the per-rank dot FLOPs, the
traffic proxy and the collectives of :class:`OpAccounting`.

What a record does not prove: nothing ran on a device, so it says nothing
of time, of numerics or of a collective's real cost; the byte counts are
those of tensors, not of an allocator (no fragmentation, no workspaces).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback
from functools import partial

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, cell_is_runnable, get_config, shape_cells
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.context import ShardingRules, use_rules
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models.model import logits_from_hidden
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

from .hlo_analysis import OpAccounting
from .mesh import make_production_mesh, mesh_axis_sizes
from .sharding import (
    P,
    NamedSharding,
    batch_shardings,
    cache_shardings,
    param_shardings,
    place,
    state_shardings,
)

__all__ = ["PARAM_DTYPE", "batch_specs", "input_specs", "build_cell", "collective_bytes",
           "run_cell", "main"]

PARAM_DTYPE = torch.bfloat16

#: ranks of the fake process group each mesh runs on
MESH_RANKS = {"single": 256, "multi": 512}

# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, batch: int, seq: int, with_labels: bool) -> dict:
    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict = {}
    if cfg.frontend == "audio":
        out["features"] = sds((batch, seq, cfg.frontend_dim), torch.bfloat16)
        if with_labels:
            out["labels"] = sds((batch, seq), torch.int32)
        return out
    s_text = seq - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    if cfg.frontend == "vision":
        out["patches"] = sds((batch, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16)
    out["tokens"] = sds((batch, s_text), torch.int32)
    if with_labels:
        out["labels"] = sds((batch, seq), torch.int32)
        if cfg.frontend == "vision":
            out["mask"] = sds((batch, seq), torch.float32)
    return out


def input_specs(arch: str, shape: str) -> dict:
    """Public entry: meta tensors for every model input of a cell."""
    cfg = get_config(arch)
    cell = shape_cells()[shape]
    return batch_specs(cfg, cell["global_batch"], cell["seq_len"], cell["kind"] == "train")


def _materialise(specs: dict, device) -> dict:
    """Tensors of the specs' shapes and dtypes on ``device`` (fake tensors
    under ``FakeTensorMode``): zeros, and a mask of ones."""
    return {k: (torch.ones if k == "mask" else torch.zeros)(v.shape, dtype=v.dtype,
                                                            device=device)
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# step builders per cell kind
# ---------------------------------------------------------------------------


def _prefill_step(params, batch, *, cfg: ModelConfig):
    h, caches, _ = forward(params, cfg, batch, mode="prefill")
    if cfg.encoder_only:
        return logits_from_hidden(params, cfg, h), caches
    return logits_from_hidden(params, cfg, h[:, -1:]), caches


def build_cell(arch: str, shape: str, mesh, device=None):
    """Returns ``(fn, args, donate, rules)``: the cell's step, its inputs
    placed on ``mesh`` by ``launch.sharding``, the indices of the arguments
    it updates in place (the reference's donated ones), and the rules to
    run it under.  The inputs are made on ``device`` under the caller's
    mode: call it inside a ``FakeTensorMode`` for a dry run (at full width
    they would not fit anywhere)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    cell = shape_cells()[shape]
    b, s, kind = cell["global_batch"], cell["seq_len"], cell["kind"]
    rules = ShardingRules(
        mesh, seq_sharded=os.environ.get("DRYRUN_SEQ_SHARDED", "1") == "1"
    )

    if kind == "train":
        tc = TrainConfig(
            opt=OptConfig(),
            remat=True,
            remat_policy=os.environ.get("DRYRUN_REMAT_POLICY", "full"),
            loss_chunk=int(os.environ.get("DRYRUN_LOSS_CHUNK", "512")),
        )
        state = init_train_state(cfg, param_dtype=PARAM_DTYPE, device=dev)
        state = place(state, state_shardings(state, mesh, cfg))
        batch = _materialise(batch_specs(cfg, b, s, True), dev)
        batch = place(batch, batch_shardings(batch, mesh, b))
        return make_train_step(cfg, tc), (state, batch), (0,), rules

    params = init_params(cfg, 0, PARAM_DTYPE, dev)
    params = place(params, param_shardings(params, mesh, cfg))
    if kind == "prefill":
        batch = _materialise(batch_specs(cfg, b, s, False), dev)
        batch = place(batch, batch_shardings(batch, mesh, b))
        return partial(_prefill_step, cfg=cfg), (params, batch), (), rules

    # decode: one new token against a cache of seq_len, at its last slot
    caches = init_cache(cfg, b, s, PARAM_DTYPE, dev)
    caches = place(caches, cache_shardings(caches, mesh, cfg, b))
    tokens = NamedSharding(mesh, P(None, None)).place(
        torch.zeros((b, 1), dtype=torch.int32, device=dev))

    def step(params, caches, tokens, pos):
        return decode_step(params, cfg, caches, tokens, pos)

    return step, (params, caches, tokens, s - 1), (1,), rules


def _local_bytes(tree) -> int:
    """One rank's bytes of the tensors in ``tree`` (a DTensor's local
    shard; a model's parameters; a Python int is the reference's int32
    scalar argument)."""
    from torch.distributed.tensor import DTensor
    from torch.nn import Module

    if isinstance(tree, Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, int):
        return 4
    return 0


# ---------------------------------------------------------------------------
# HLO collective accounting (the reference's reading of HLO text)
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}
_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shapes_bytes(sig: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(sig):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes moved by each collective kind (output-shape sizes)."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"%?[\w.\-]+\s*=\s*(\(?[^=]*?\)?)\s*(all-reduce|all-gather|"
                     r"reduce-scatter|all-to-all|collective-permute)(-start|-done)?\(", line)
        if not m:
            continue
        if m.group(3) == "-done":
            continue  # counted at -start
        sig, kind = m.group(1), m.group(2)
        out[kind] += _shapes_bytes(sig)
        counts[kind] += 1
    return {"bytes": out, "counts": counts, "total_bytes": sum(out.values())}


# ---------------------------------------------------------------------------
# running the cells
# ---------------------------------------------------------------------------


def _start_fake_group(world: int) -> None:
    """A process group of ``world`` placeholder ranks; this process is rank 0."""
    # torch names the "fake" backend; importing this module registers its maker
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str, force: bool = False,
             device=None):
    tag = f"{arch}__{shape}__{mesh_kind}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        print(f"[skip-cached] {tag}")
        with open(path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    ok, why = cell_is_runnable(arch, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "SKIP", "reason": why}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {tag}: {why}")
        return rec

    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = resolve_device(device)
    world = MESH_RANKS[mesh_kind]
    started = not dist.is_initialized()
    if not started and dist.get_world_size() != world:
        raise ValueError(f"the {mesh_kind} mesh needs {world} ranks; the process group "
                         f"has {dist.get_world_size()}")
    if started:
        _start_fake_group(world)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=dev)
        t0 = time.time()
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args, donate, rules = build_cell(arch, shape, mesh, dev)
                with use_rules(rules), OpAccounting() as acc:
                    out = fn(*args)
                t_lower = time.time() - t0
                mem_rec = {
                    "temp_size_in_bytes": int(acc.peak_bytes),
                    "argument_size_in_bytes": _local_bytes(args),
                    "output_size_in_bytes": _local_bytes(out),
                    "alias_size_in_bytes": sum(_local_bytes(args[i]) for i in donate),
                    "generated_code_size_in_bytes": 0,
                }
                del out, args, fn
            loop_aware = acc.result()
            coll = {
                "bytes": loop_aware["collective_bytes"],
                "counts": loop_aware["collective_counts"],
                "total_bytes": loop_aware["collective_total"],
            }
            cost_rec = {"flops": loop_aware["dot_flops"],
                        "bytes accessed": loop_aware["hbm_traffic_proxy"]}
            rec = {
                "arch": arch,
                "shape": shape,
                "mesh": mesh_kind,
                "status": "OK",
                "mesh_shape": dict(mesh_axis_sizes(mesh)),
                "n_devices": int(mesh.size()),
                "lower_s": round(t_lower, 1),
                "compile_s": None,
                "memory_analysis": mem_rec,
                "cost_analysis": cost_rec,
                "collectives": coll,
                "loop_aware": loop_aware,
            }
            print(
                f"[ok] {tag}: trace {t_lower:.0f}s, "
                f"flops/dev {cost_rec['flops']:.3e}, "
                f"coll_bytes/dev {coll['total_bytes']:.3e}, "
                f"temp/dev {mem_rec['temp_size_in_bytes'] / 2**30:.2f} GiB"
            )
        except Exception as e:  # noqa: BLE001 -- a sweep records a cell's failure
            rec = {
                "arch": arch,
                "shape": shape,
                "mesh": mesh_kind,
                "status": "FAIL",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}")
    finally:
        if started:
            dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=list(shape_cells()) + [None])
    ap.add_argument("--mesh", default=None, choices=["single", "multi", None])
    # not the reference's artifacts/dryrun: a cached record is never the other package's
    ap.add_argument("--out", default="artifacts/pt_dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: the CUDA card)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(shape_cells())
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, args.out, args.force, args.device)
                n_fail += rec.get("status") == "FAIL"
    print(f"done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
