"""Table 10 / Figs 62-64: workload comparison across algorithm families.

A workload of similarity queries over the 5.3 synthetic datasets (uniform /
clustered x dense / moderate), run through: the bitmap circuit algorithms
(torch ops + the fused kernel), SCANCOUNT, the block-RLE RBMRG adaptation,
and the host-side integer-list competitors (WHEAP / MGOPT / WMGSK / DSK /
W2CTI / WSORT).  Reports total normalised time per algorithm (paper 5.9:
each dataset's fastest algorithm = 1.0) plus RBMRG's pruned work fraction.

The port's counterpart of ``benchmarks/table10_workload.py``, on ``device``
(default: the CUDA card).  Device calls end in a synchronise of the device
and carry ``ops=N``, the device ops a call dispatches (``fused`` is one
launch of the circuit kernel; the others are chains of eager torch ops,
where the reference's are jitted XLA programs); the list algorithms are timed on the host clock.
Every bitmap result is held against SCANCOUNT on the CPU over the same
bits, and every list algorithm's ids against that result's set bits.

    PYTHONPATH=src:. python benchmarks/pt_table10_workload.py [--device cpu]
"""
from __future__ import annotations

from benchmarks.pt_common import check_ids, check_words, ops_per_call, time_call, with_ops
from repro_torch.core import listalgos as LA
from repro_torch.core.threshold import threshold
from repro_torch.data.paper_datasets import similarity_query, synthetic_dataset
from repro_torch.device import resolve_device, to_numpy_u32, to_words
from repro_torch.storage import TileStore, rbmrg_block_threshold

DATASETS = [
    ("uniform", "dense"),
    ("clustered", "dense"),
    ("uniform", "moderate"),
    ("clustered", "moderate"),
]
N, T = 32, 16
LIST_ALGOS = [
    ("wheap", LA.wheap), ("mgopt", LA.mgopt), ("wmgsk", LA.wmgsk),
    ("dsk", LA.dsk), ("w2cti", LA.w2cti), ("wsort", LA.wsort),
]


def run(card=3000, device=None):
    dev = resolve_device(device)
    out = []
    totals: dict[str, float] = {}
    for kind, dens in DATASETS:
        packed, r, lists = synthetic_dataset(kind, dens, n_bitmaps=64, card=card, seed=1111,
                                             device=dev)
        sel, rid = similarity_query(lists, N, seed=7)
        bm = to_words(packed[sel], dev)
        sel_lists = [lists[i] for i in sel]
        stats = TileStore.from_packed(bm, device=dev).block_stats()
        tag = f"{kind[:4]}_{dens[:3]}"
        expect = to_numpy_u32(threshold(to_words(packed[sel], "cpu"), T, "scancount"))
        times, ops = {}, {}
        for alg in ("scancount", "looped", "ssum", "csvckt", "fused"):
            def call(alg=alg):
                return threshold(bm, T, alg)

            times[alg], got = time_call(call, dev, 3)
            check_words(got, expect, f"{tag} {alg}")
            ops[alg] = ops_per_call(call)

        def rbmrg():
            return rbmrg_block_threshold(bm, T, stats=stats)

        times["rbmrg_block"], (got, info) = time_call(rbmrg, dev, 3)
        check_words(got, expect, f"{tag} rbmrg_block")
        ops["rbmrg_block"] = ops_per_call(rbmrg)
        for name, fn in LIST_ALGOS:
            times[name], ids = time_call(lambda fn=fn: fn(sel_lists, T, r), None, 3)
            check_ids(ids, expect, f"{tag} {name}")
        best = min(times.values())
        for alg, dt in sorted(times.items(), key=lambda kv: kv[1]):
            norm = dt / best
            totals[alg] = totals.get(alg, 0.0) + norm
            derived = f"norm={norm:.2f}"
            out.append((f"table10_{tag}_{alg}", dt * 1e6,
                        with_ops(derived, ops[alg]) if alg in ops else derived))
        out.append(
            (f"table10_{tag}_rbmrg_work_fraction", info["work_fraction"] * 100, "% of words")
        )
    for alg, tot in sorted(totals.items(), key=lambda kv: kv[1]):
        out.append((f"table10_total_norm_{alg}", tot, f"ideal={len(DATASETS)}"))
    return out


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    for name, val, extra in run(device=parse_args().device):
        print(f"{name},{val:.2f},{extra}")
