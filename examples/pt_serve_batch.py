"""Batched serving with continuous batching and bitmap slot tracking (the
PyTorch port).

    PYTHONPATH=src python examples/pt_serve_batch.py [--arch recurrentgemma-2b] [--device cpu]

The port's counterpart of ``examples/serve_batch.py``, on the CUDA card
unless ``--device`` names another device.  Feeds a stream of
variable-length prompts through the slot-pool engine; slot occupancy is
tracked with packed bitmaps (the paper's machinery in the serving layer:
slot queries run through the circuit kernel).  Prints per-request outputs
and throughput.  The weights are the port's own seeded ``init_params``
(seed 0), not the reference's draw from ``jax.random.PRNGKey(0)``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = init_params(cfg, 0, device=dev)
    engine = ServeEngine(cfg, params, batch_slots=args.slots, max_seq=128, device=dev)
    rng = np.random.default_rng(0)
    pending = [
        Request(rid=i, prompt=rng.integers(1, cfg.vocab, rng.integers(3, 12)).tolist(),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    print(f"{args.requests} requests -> {args.slots} slots ({args.arch} reduced)")
    t0 = time.time()
    done = engine.run_until_drained(list(pending))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    for r in sorted(done, key=lambda r: r.rid)[:6]:
        print(f"  rid {r.rid:2d}: prompt[{len(r.prompt)}] -> {r.out}")
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {toks} tokens, {engine.step_count} engine steps, "
          f"{toks / dt:.1f} tok/s")
    assert len(done) == args.requests
    print("OK")


if __name__ == "__main__":
    main()
