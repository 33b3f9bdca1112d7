"""Paper 5.4/5.8: SMALL-COMPETITIONS heatmap + Appendix C suboptimality.

Runs the paper's competition protocol: for each (N, T) pair of the
SMALL-COMPETITIONS schedule, race the algorithms on similarity queries and
rank them.  Produces (a) per-algorithm win / within-50% / terrible
percentages (the paper's heat-map aggregates) and (b) mean suboptimality
(Appendix C).  The *relative* conclusions are what the paper reports
(RBMRG/adders robust, LOOPED wins small T, pruning wins T ~ N on sparse
data).

The port's counterpart of ``benchmarks/heatmap_competitions.py``, on
``device`` (default: the CUDA card).  Device calls end in a synchronise of
the device; DSK and W2CTI run on the host clock.  On the card the eager
torch-op algorithms race one launch of the circuit kernel (``fused``), so
their ranks hold launch overhead the reference's jitted XLA programs do not
pay; the device ops a call of each algorithm dispatches (its mean over the
pairs, ``ops=N``) stand beside its row.  Every bitmap result is held against SCANCOUNT on the
CPU over the same bits, and the list algorithms' ids against its set bits.

    PYTHONPATH=src:. python benchmarks/pt_heatmap_competitions.py [--device cpu]
"""
from __future__ import annotations

import numpy as np

from benchmarks.pt_common import check_ids, check_words, ops_per_call, time_call
from repro_torch.core import listalgos as LA
from repro_torch.core.threshold import threshold
from repro_torch.data.paper_datasets import similarity_query, synthetic_dataset
from repro_torch.device import resolve_device, to_numpy_u32, to_words
from repro_torch.storage import TileStore, rbmrg_block_threshold


def small_competitions():
    """The paper's (N, T) schedule: doubling N; T' and N+2-T' ladders."""
    pairs = []
    for n in (4, 8, 16, 32):
        ts = set()
        tp = 3
        while tp <= n // 2 + 1:
            ts.add(tp)
            ts.add(n + 2 - tp)
            tp = (3 * tp) // 2
        for t in sorted(x for x in ts if 2 <= x <= n - 1):
            pairs.append((n, t))
    return pairs


def run(card=3000, device=None):
    dev = resolve_device(device)
    packed, r, lists = synthetic_dataset("clustered", "dense", n_bitmaps=64,
                                         card=card, seed=1111, device=dev)
    stats_cache = {}
    wins: dict[str, int] = {}
    ok50: dict[str, int] = {}
    terrible: dict[str, int] = {}
    subopt: dict[str, list] = {}
    ops: dict[str, int] = {}
    n_comp = 0
    for n, t in small_competitions():
        sel, rid = similarity_query(lists, n, seed=n * 131 + t)
        bm = to_words(packed[sel], dev)
        sel_lists = [lists[i] for i in sel]
        key = tuple(sel)
        if key not in stats_cache:
            stats_cache[key] = TileStore.from_packed(bm, device=dev).block_stats()
        stats = stats_cache[key]
        expect = to_numpy_u32(threshold(to_words(packed[sel], "cpu"), t, "scancount"))
        what = f"N={n} T={t}"
        times = {}
        calls = {a: (lambda a=a: threshold(bm, t, a)) for a in ("scancount", "ssum", "csvckt",
                                                                  "fused")}
        if n * t <= 4000:
            calls["looped"] = lambda: threshold(bm, t, "looped")
        for alg, call in calls.items():
            times[alg], got = time_call(call, dev, 2)
            check_words(got, expect, f"{what} {alg}")

        def rbmrg():
            return rbmrg_block_threshold(bm, t, stats=stats)[0]

        calls["rbmrg_block"] = rbmrg
        times["rbmrg_block"], got = time_call(rbmrg, dev, 2)
        check_words(got, expect, f"{what} rbmrg_block")
        for alg, call in calls.items():
            ops[alg] = ops.get(alg, 0) + ops_per_call(call)
        for name, fn in (("dsk", LA.dsk), ("w2cti", LA.w2cti)):
            times[name], ids = time_call(lambda fn=fn: fn(sel_lists, t, r), None, 2)
            check_ids(ids, expect, f"{what} {name}")
        best = min(times.values())
        n_comp += 1
        for alg, dt in times.items():
            wins[alg] = wins.get(alg, 0) + (dt == best)
            ok50[alg] = ok50.get(alg, 0) + (dt <= 1.5 * best)
            terrible[alg] = terrible.get(alg, 0) + (dt >= 10 * best)
            subopt.setdefault(alg, []).append(dt / best - 1.0)
    out = []
    for alg in sorted(subopt, key=lambda a: float(np.mean(subopt[a]))):
        extra = (f"wins={100 * wins[alg] / n_comp:.0f}% within50={100 * ok50[alg] / n_comp:.0f}% "
                 f"terrible={100 * terrible[alg] / n_comp:.0f}%")
        if alg in ops:
            extra += f" ops={ops[alg] / len(subopt[alg]):.1f}"
        out.append((f"heatmap_{alg}_mean_subopt", float(np.mean(subopt[alg])), extra))
    out.append(("heatmap_competitions", n_comp, "SMALL-COMPETITIONS pairs"))
    return out


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    for name, val, extra in run(device=parse_args().device):
        print(f"{name},{val},{extra}")
