"""Figures 3/4: scaling of the threshold algorithms with N and with T.

Fig 3: time vs N at T = N/2 (normalised to N=32, as in the paper).
Fig 4: time vs T at N = 64 on one bitmap set.

The port's counterpart of ``benchmarks/fig3_scaling.py``, on ``device``
(default: the CUDA card).  The reference's times are of jitted XLA calls;
here only ``fused`` is one kernel launch (the circuit kernel), the other
algorithms are chains of eager torch ops, so on the card their times hold
the launches of those chains: ``ops=N``, the device ops one call
dispatches (``pt_common.ops_per_call``), stands beside each time.  Every call ends in a synchronise of the
device, and every algorithm's words are held against SCANCOUNT on the CPU
over the same bits.

    PYTHONPATH=src:. python benchmarks/pt_fig3_scaling.py [--device cpu]
"""
from __future__ import annotations

from benchmarks.pt_common import check_words, ops_per_call, time_call, with_ops
from repro_torch.core.threshold import threshold
from repro_torch.data.paper_datasets import synthetic_dataset
from repro_torch.device import resolve_device, to_numpy_u32, to_words

ALGOS = ("scancount", "looped", "ssum", "treeadd", "csvckt", "fused")


def scancount_on_cpu(cpu):
    """``expect(n, t)``: SCANCOUNT's words on the CPU over the first ``n``
    rows of ``cpu`` (numpy ``uint32``)."""
    return lambda n, t: to_numpy_u32(threshold(cpu[:n], t, "scancount"))


def sweep(full, cases, dev, expect, reps=3):
    """Time every algorithm of ``ALGOS`` at each ``(n, t)`` of ``cases`` over
    the first ``n`` rows of ``full``, each held against ``expect(n, t)``.
    Yields ``(alg, n, t, seconds, ops a call)``."""
    for n, t in cases:
        bm = full[:n]
        want = expect(n, t)
        for alg in ALGOS:
            if alg == "looped" and n * t > 4000:
                continue  # LOOPED is an O(NT)-op small-T algorithm (paper 4.5)

            def call(alg=alg):
                return threshold(bm, t, alg)

            dt, got = time_call(call, dev, reps)
            check_words(got, want, f"{alg} N={n} T={t}")
            yield alg, n, t, dt, ops_per_call(call)


def run(card=4000, device=None):
    dev = resolve_device(device)
    out = []
    packed, r, _ = synthetic_dataset("clustered", "dense", n_bitmaps=128, card=card,
                                     seed=1111, device=dev)
    full, expect = to_words(packed, dev), scancount_on_cpu(to_words(packed, "cpu"))
    # Fig 3: N scaling at T=N/2
    for alg, n, t, dt, k in sweep(full, [(n, n // 2) for n in (8, 16, 32, 64, 128)], dev,
                                  expect):
        out.append((f"fig3_{alg}_N{n}_us", dt * 1e6, with_ops(f"T={t}", k)))
    # Fig 4: T scaling at N=64
    for alg, n, t, dt, k in sweep(full, [(64, t) for t in (2, 3, 8, 16, 32, 48, 61, 63)], dev,
                                  expect):
        out.append((f"fig4_{alg}_T{t}_us", dt * 1e6, with_ops("N=64", k)))
    return out


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    for name, val, extra in run(device=parse_args().device):
        print(f"{name},{val:.1f},{extra}")
