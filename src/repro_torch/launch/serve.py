"""Serving entry point: batched continuous-batching engine over the slot pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \
        --requests 16 --slots 4 --max-new 8 [--device cpu]

The model is randomly initialised from ``--seed`` (no checkpoint is
loaded, as in the reference).  It runs on the CUDA card unless
``--device`` names another device.
"""
from __future__ import annotations

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
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    dev = resolve_device(args.device)
    params = init_params(cfg, args.seed, device=dev)
    engine = ServeEngine(cfg, params, batch_slots=args.slots, max_seq=args.max_seq, device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(2, 9)).tolist(),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = engine.run_until_drained(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(
        f"served {len(done)} requests / {total_tokens} tokens in {dt:.2f}s "
        f"({total_tokens / max(dt, 1e-9):.1f} tok/s, {engine.step_count} engine steps)"
    )
    for r in done[:4]:
        print(f"  rid={r.rid} prompt={r.prompt[:4]}... out={r.out}")


if __name__ == "__main__":
    main()
