"""Production training launcher: sharded, checkpointed, fault-tolerant (the
port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

It runs on the CUDA card (NCCL) unless ``--device`` names another device
(``cpu``: ``gloo``).  Run as one process it is the reference's single-host
run: ``make_host_mesh()`` is the 1 x 1 mesh over a one-rank group, and the
state and batches are DTensors on it.  Launched as several ranks (a
process group initialised first), the host mesh spans them.
Exercised end to end:
  * mesh + FSDP/TP shardings from launch/sharding.py
  * auto-resume from the newest checkpoint (crash recovery)
  * deterministic data stream keyed by (seed, step) -- restart replays
  * async checkpointing every --ckpt-every steps, atomic publish
  * preemption handling (SIGTERM -> final sync checkpoint)
  * straggler monitor on step wall-times
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batch
from repro_torch.dist.context import ShardingRules, use_rules
from repro_torch.ft import PreemptionHandler, StragglerMonitor
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

from .mesh import make_host_mesh, make_production_mesh
from .sharding import batch_shardings, place, state_shardings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    owns_group = not dist.is_initialized()  # a one-rank group the mesh starts is ours
    mesh = (make_production_mesh(device=args.device) if args.production_mesh
            else make_host_mesh(device=args.device))
    try:
        _train(args, cfg, mesh)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    print("[done]")


def _train(args, cfg, mesh):
    rules = ShardingRules(mesh, batch_shardable=args.batch % mesh.size() == 0)
    dtype = getattr(torch, args.param_dtype)
    tc = TrainConfig(
        opt=OptConfig(peak_lr=args.lr, warmup_steps=10, total_steps=args.steps),
        remat=args.remat,
        microbatches=args.microbatches,
    )
    dc = DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    with use_rules(rules):
        # the shardings need shapes only: a template on the meta device
        st_sh = state_shardings(init_train_state(cfg, args.seed, dtype, "meta"), mesh, cfg)
        start = 0
        if mgr and mgr.latest_step() is not None:
            start = mgr.latest_step()
            # the template only names the config and dtype: it holds no memory
            state = mgr.restore(start, init_train_state(cfg, args.seed, dtype, "meta"), st_sh)
            print(f"[resume] restored step {start} from {args.ckpt_dir}")
        else:
            # every rank draws the same full state from the seed, keeps its shards
            state = place(init_train_state(cfg, args.seed, dtype, "cpu"), st_sh)
        b_sh = batch_shardings(lm_batch(dc, 0, "cpu"), mesh, args.batch)

        step_fn = make_train_step(cfg, tc)
        monitor = StragglerMonitor()
        preempt = PreemptionHandler()
        preempt.install()

        for step in range(start, args.steps):
            t0 = time.time()
            batch = place(lm_batch(dc, step, "cpu"), b_sh)
            state, metrics = step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            ev = monitor.record(step, dt)
            if ev:
                print(f"[straggler] step {ev.step}: {ev.ratio:.1f}x EWMA -> mitigation hook")
            if step % 10 == 0 or step == args.steps - 1:
                print(
                    f"step {step:5d} loss {metrics['loss']:.4f} "
                    f"gnorm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e} {dt * 1e3:.0f} ms"
                )
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state)
            if preempt.should_stop:
                print(f"[preempt] signal received; checkpointing at step {step + 1}")
                if mgr:
                    mgr.wait()
                    mgr.save(step + 1, state)
                    mgr.wait()
                break
        if mgr:
            mgr.wait()
            if (args.steps % args.ckpt_every) and not preempt.should_stop:
                mgr.save(args.steps, state)
                mgr.wait()


if __name__ == "__main__":
    main()
