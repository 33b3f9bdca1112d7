"""End-to-end training example (the PyTorch port): train an LM for a few
hundred steps through the full stack -- the train step, checkpointing,
straggler monitor, deterministic data stream.

    PYTHONPATH=src python examples/pt_train_lm.py                 # a CPU-sized model
    PYTHONPATH=src python examples/pt_train_lm.py --width 768 --layers 12  # ~100M

The port's counterpart of ``examples/train_lm.py``, on the CUDA card unless
``--device`` names another device.  The default is a small qwen3-family
model; --width/--layers scale the same config up to the ~100M class (the
code path is identical -- this just trades wall-clock).  Loss on the
synthetic copy-structure stream drops from ~7 to <2 within a few hundred
steps.  The weights are the port's own seeded ``init_train_state`` (seed
0).  Checkpoints go to a directory of the port's own (``--ckpt-dir``,
default ``repro_torch_train_lm`` in the temporary directory): both packages
write one checkpoint format, so sharing the reference's directory would
mix their runs.
"""
import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.ft import StragglerMonitor
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

#: the port's own checkpoint directory (the reference's example writes /tmp/repro_train_lm)
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = get_config("qwen3-1.7b", reduced=True)
    cfg = dataclasses.replace(
        base,
        name=f"qwen3-example-{args.width}x{args.layers}",
        d_model=args.width,
        n_layers=args.layers,
        n_heads=max(4, args.width // 32),
        n_kv_heads=max(2, args.width // 64),
        head_dim=32,
        d_ff=args.width * 3,
        vocab=args.vocab,
    )
    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params")

    tc = TrainConfig(
        opt=OptConfig(peak_lr=3e-3, warmup_steps=20, total_steps=args.steps)
    )
    dc = DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
    state = init_train_state(cfg, 0, device=dev)
    step_fn = make_train_step(cfg, tc)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    monitor = StragglerMonitor()

    first_loss = None
    t_start = time.time()
    for step in range(args.steps):
        t0 = time.time()
        state, metrics = step_fn(state, lm_batch(dc, step, dev))
        loss = float(metrics["loss"])  # a host read: the step's device work is done
        if first_loss is None:
            first_loss = loss
        monitor.record(step, time.time() - t0)
        if step % 25 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / max(time.time() - t0, 1e-9)
            print(f"step {step:4d}  loss {loss:.3f}  lr {float(metrics['lr']):.2e}  "
                  f"{tok_s / 1e3:.1f}k tok/s")
        if (step + 1) % 100 == 0:
            mgr.save(step + 1, state)
    mgr.wait()
    mgr.save(args.steps, state)
    mgr.wait()
    dt = time.time() - t_start
    print(f"trained {args.steps} steps in {dt:.0f}s; "
          f"loss {first_loss:.2f} -> {loss:.2f}; "
          f"checkpoints at {args.ckpt_dir} (latest step {mgr.latest_step()})")
    assert loss < first_loss - 1.0, "loss did not improve"
    print("OK")


if __name__ == "__main__":
    main()
