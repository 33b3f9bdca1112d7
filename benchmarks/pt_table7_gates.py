"""Tables 6/7/8: circuit gate counts vs the paper's published numbers.

This is the paper-faithfulness check: the sideways-sum construction must
reproduce the 'S. Sum' column of Table 8 EXACTLY; the tree adder matches
c(2^k) = 7N - 5 log2 N - 7 exactly at powers of two and is within 1% (our
constant propagation is slightly stronger) elsewhere; the Batcher sorter is
within ~10% (the paper prunes a hand-built merge network).

The port's counterpart of ``benchmarks/table7_gates.py``: the circuits are
built by ``repro_torch.core.circuits`` on the host, so every row equals the
reference's.  ``device`` follows the port's rule (default: the CUDA card)
although no row touches it.

    PYTHONPATH=src:. python benchmarks/pt_table7_gates.py [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import circuits as C
from repro_torch.device import resolve_device

TABLE8 = [
    # (N, T, tree_paper, ssum_paper, sorter_paper)
    (43, 30, 272, 192, 480),
    (85, 12, 562, 398, 1216),
    (120, 105, 806, 580, 1907),
    (323, 14, 2226, 1586, 7518),
    (329, 138, 2272, 1620, 9052),
    (330, 324, 2275, 1623, 7549),
    (786, 481, 5467, 3905, 28945),
    (786, 776, 5461, 3899, 24233),
]


def run(device=None):
    resolve_device(device)  # the port's rule: the card unless the caller names another
    out = []
    ssum_exact = 0
    for n, t, tree_p, ssum_p, sort_p in TABLE8:
        tree = C.build_threshold_circuit(n, t, "treeadd").gate_count()
        ssum = C.build_threshold_circuit(n, t, "ssum").gate_count()
        srt = C.build_threshold_circuit(n, t, "srtckt").gate_count()
        ssum_exact += ssum == ssum_p
        out.append(
            (f"table8_N{n}_T{t}_ssum_gates", ssum, f"paper={ssum_p} exact={ssum == ssum_p}")
        )
        out.append((f"table8_N{n}_T{t}_tree_gates", tree, f"paper={tree_p}"))
        out.append((f"table8_N{n}_T{t}_sorter_gates", srt, f"paper={sort_p}"))
    out.append(("table8_ssum_exact_rows", ssum_exact, f"of {len(TABLE8)}"))
    for npow in (2, 4, 8, 16, 32):
        w = C.build_weight_circuit(npow, "treeadd").gate_count()
        out.append(
            (f"tree_c{npow}", w, f"formula={C.paper_tree_adder_gates(npow)}")
        )
    for npow, s_paper in [(2, 2), (4, 9), (8, 26), (16, 63), (32, 140)]:
        out.append(
            (f"ssum_s{npow}", C.build_weight_circuit(npow, "ssum").gate_count(),
             f"paper={s_paper}")
        )
    # Table 7 spot checks + LOOPED op-count formula
    for (n, t), e in {(4, 2): 9, (4, 3): 11, (5, 2): 12, (5, 3): 14}.items():
        out.append(
            (f"table7_N{n}_T{t}_ssum", C.build_threshold_circuit(n, t, "ssum").gate_count(),
             f"paper={e}")
        )
    for n, t in [(4, 3), (5, 2), (5, 4)]:
        out.append((f"looped_ops_N{n}_T{t}", C.looped_op_count(n, t), "formula"))
    return out


if __name__ == "__main__":
    from benchmarks.pt_common import parse_args

    for name, val, extra in run(device=parse_args().device):
        print(f"{name},{val},{extra}")
