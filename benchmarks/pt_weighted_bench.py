"""Weighted thresholds: the paper's replication (2.3) vs our binary
decomposition -- gate counts and equivalence across weight magnitudes.

The port's counterpart of ``benchmarks/weighted_bench.py``: the gate counts
come from ``repro_torch.core.weighted`` on the host; the decomposed circuit
runs on ``device`` (default: the CUDA card, where it is one launch of the
circuit kernel) and its unpacked bits are asserted against numpy.

    PYTHONPATH=src:. python benchmarks/pt_weighted_bench.py [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bitmaps import pack, unpack
from repro_torch.core.weighted import (
    decomposed_gate_cost,
    replication_gate_cost,
    weighted_threshold_decomposed,
)
from repro_torch.device import resolve_device


def run(device=None):
    dev = resolve_device(device)
    out = []
    rng = np.random.default_rng(0)
    for n, wmax in [(16, 7), (16, 100), (32, 1000)]:
        weights = [int(x) for x in rng.integers(1, wmax + 1, n)]
        t = sum(weights) // 2
        rep = replication_gate_cost(weights, t)
        dec = decomposed_gate_cost(weights, t)
        out.append(
            (f"weighted_N{n}_wmax{wmax}_replication_gates", rep, "paper 2.3 approach")
        )
        out.append(
            (f"weighted_N{n}_wmax{wmax}_decomposed_gates", dec,
             f"ours; {rep / dec:.1f}x smaller")
        )
        bits = rng.random((n, 500)) < 0.3
        got = weighted_threshold_decomposed(pack(bits, dev), tuple(weights), t, device=dev)
        expect = (bits * np.array(weights)[:, None]).sum(0) >= t

        assert (unpack(got, 500).cpu().numpy() == expect).all()
    return out


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    for name, val, extra in run(device=parse_args().device):
        print(f"{name},{val},{extra}")
