"""The port's roofline (``benchmarks/pt_roofline.py``) against the
reference's (``benchmarks/roofline.py``).

``model_flops`` is held equal for every architecture and shape cell at 256
and 512 ranks.  On synthetic dry-run records (with and without
``loop_aware``) both take the same FLOPs, bytes and collective bytes, and
each term is those counts over the module's own peaks (one H100's in the
port), rounded to the microsecond as the reference rounds; ``run`` over a
directory keeps OK records only.  The port names no TPU peak.
"""
import json
import os
import re
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)  # the benchmarks package, as PYTHONPATH=src:. gives

import benchmarks.pt_roofline as TR  # noqa: E402
import benchmarks.roofline as RR  # noqa: E402
from repro_torch.configs import ARCHS, shape_cells  # noqa: E402

TERMS = (("compute_s", "hlo_flops", "PEAK_FLOPS"), ("memory_s", "hlo_bytes", "HBM_BW"),
         ("collective_s", "coll_bytes", "LINK_BW"))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    for shape in shape_cells():
        for n in (256, 512):
            assert TR.model_flops(arch, shape, n) == RR.model_flops(arch, shape, n), (shape, n)


def _record(arch="qwen3-1.7b", shape="train_4k", mesh="single", status="OK", loop_aware=True):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
           "n_devices": 256 if mesh == "single" else 512,
           "cost_analysis": {"flops": 3.1e14, "bytes accessed": 7.7e11},
           "collectives": {"total_bytes": 2.9e10}}
    if loop_aware:
        rec["loop_aware"] = {"dot_flops": 4.2e14, "hbm_traffic_proxy": 9.1e11,
                             "collective_total": 3.3e10}
    return rec


@pytest.mark.parametrize("loop_aware", [True, False])
@pytest.mark.parametrize("arch,shape,mesh", [("qwen3-1.7b", "train_4k", "single"),
                                             ("mixtral-8x22b", "prefill_32k", "multi"),
                                             ("qwen3-1.7b", "decode_32k", "single")])
def test_analyze_takes_the_reference_counts_over_the_h100_peaks(arch, shape, mesh, loop_aware):
    rec = _record(arch, shape, mesh, loop_aware=loop_aware)
    got, want = TR.analyze(rec), RR.analyze(rec)
    for key in ("arch", "shape", "mesh", "hlo_flops", "hlo_bytes", "coll_bytes",
                "model_flops_per_dev", "useful_flops_ratio"):
        assert got[key] == want[key], key
    for term, count, peak in TERMS:
        assert got[term] == round(got[count] / getattr(TR, peak) * 1e3, 3)
        # each term times its module's peak is the same count, to the rounding
        assert abs(got[term] * getattr(TR, peak) - want[term] * getattr(RR, peak)) <= \
            5e-4 * (getattr(TR, peak) + getattr(RR, peak))
    assert got["dominant"] == max(TERMS, key=lambda t: got[t[0]])[0][:-2]


def test_analyze_skips_records_that_are_not_ok():
    assert TR.analyze(_record(status="SKIP")) is None
    assert TR.analyze(_record(status="FAIL")) is None


def test_run_keeps_ok_records_only(tmp_path):
    for i, status in enumerate(("OK", "SKIP", "FAIL")):
        (tmp_path / f"cell{i}.json").write_text(json.dumps(_record(status=status)))
    out, rows = TR.run(str(tmp_path))
    assert [name for name, _, _ in out] == ["roofline_qwen3-1.7b_train_4k_single"]
    assert len(rows) == 1 and [n for n, _, _ in RR.run(str(tmp_path))[0]] == [out[0][0]]
    assert out[0][1] == max(rows[0][t] for t, _, _ in TERMS) * 1e3
    assert out[0][2].startswith(f"dom={rows[0]['dominant']} frac=")
    path = TR.write_markdown(rows, str(tmp_path / "out" / "roofline.md"))
    text = open(path).read()
    assert "H100" in text and "| qwen3-1.7b | train_4k | single |" in text


def test_run_on_an_empty_directory(tmp_path):
    assert TR.run(str(tmp_path)) == ([], [])


def test_h100_peaks_and_no_tpu_constant():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert "H100" in TR.CARD and "700 W" in TR.CARD
    assert TR.DRYRUN_DIR == "artifacts/pt_dryrun" and TR.MARKDOWN_PATH == "artifacts/pt_roofline.md"
    for name in os.listdir(os.path.join(ROOT, "benchmarks")):
        if name.startswith("pt_") and name.endswith(".py"):
            with open(os.path.join(ROOT, "benchmarks", name)) as f:
                text = f.read()
            hit = re.search(r"\b(197e12|819e9|50e9|v5e|197 TF|819 GB)", text)
            assert hit is None, (name, hit.group(0))
