"""The port's kernel and query benchmarks (``benchmarks/pt_kernel_bench.py``,
``benchmarks/pt_query_bench.py``) against the reference's at their
``--smoke`` shapes.

What does not depend on the clock is held equal: the planner's words
estimates and ``predicted_win`` of every crossover point, the launches,
``decode_words``, ``dirty_words_gathered`` and the engine of each tiled
run, the batched multi-residual launch counts, the bytes-model rows, the
words rows and planned costs of the query section, the sparsity sweep's
census and words, and the shard sweep's mode, per-shard backends and words
touched.  Timed rows are held name for name.  The port runs on
``device="cpu"`` (the kernels' plain versions).
"""
import json
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)  # the benchmarks package, as PYTHONPATH=src:. gives

import benchmarks.kernel_bench as RK  # noqa: E402
import benchmarks.pt_kernel_bench as TK  # noqa: E402
import benchmarks.pt_query_bench as TQ  # noqa: E402
import benchmarks.query_bench as RQ  # noqa: E402

CPU = "cpu"
_REF: dict = {}


def ref(name, fn):
    """The reference's run of ``name``, once per module."""
    if name not in _REF:
        _REF[name] = fn()
    return _REF[name]


CROSSOVER_KEYS = ("n", "n_tiles", "launches", "engine", "event_tiles", "dirty_words_gathered",
                  "decode_words", "est_tiled_words", "est_fused_words", "predicted_win",
                  "assert_win")


def test_crossover_points_equal_reference():
    rows = TK.tiled_crossover(smoke=True, device=CPU)  # holds tiled against fused
    want = ref("crossover", lambda: RK.tiled_crossover(smoke=True))
    assert len(rows) == len(want) == 7
    for got, exp in zip(rows, want):
        assert {k: got[k] for k in CROSSOVER_KEYS} == {k: exp[k] for k in CROSSOVER_KEYS}
        kind = "clean_fraction" if "clean_fraction" in exp else "density"
        assert got[kind] == exp[kind]
    assert sum(r["predicted_win"] for r in rows) == 5


def test_batched_launch_collapse_equals_reference():
    got = TK.batched_launch_collapse(smoke=True, device=CPU)
    assert got == RK.batched_launch_collapse(smoke=True)
    assert got["launches"] <= 2 < got["launches_per_group_path"]


def test_kernel_legacy_rows_name_the_reference_rows():
    rows = TK.run(smoke=True, device=CPU)
    want = ref("kernel", lambda: RK.run(smoke=True))
    assert [n for n, _, _ in rows] == [n for n, _, _ in want]
    ratio = {n: v for n, v, _ in rows if n.endswith("_hbm_ratio")}
    assert ratio == {n: v for n, v, _ in want if n.endswith("_hbm_ratio")} and ratio
    # the plain version's "launch shape": one pass over the row
    (words, extra), = [(v, e) for n, v, e in rows if n.endswith("_block_words")]
    assert words == 1 << 10 and extra.startswith("plain version")


def test_kernel_main_keeps_the_contract_and_writes_its_artifact(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(TK, "ARTIFACTS", tmp_path)
    doc = TK.main(smoke=True, device=CPU)
    assert doc["backend"] == "cpu" and doc["smoke"] is True
    assert json.loads((tmp_path / "BENCH_kernel.json").read_text())["crossover"] == \
        json.loads(json.dumps(doc["crossover"]))
    out = capsys.readouterr().out
    assert "batched_multi_residual,groups=8,launches=1 (per-group path: 8)" in out
    assert out.count("crossover_") == 7


def test_query_rows_equal_reference():
    rows = TQ.run(smoke=True, device=CPU)
    want = ref("query", lambda: RQ.run(smoke=True))
    assert [n for n, _, _ in rows] == [n for n, _, _ in want]
    exact = ("_words", "_planned_cost")
    got = {(n, v, e) for n, v, e in rows if n.endswith(exact)}
    assert got == {(n, v, e) for n, v, e in want if n.endswith(exact)} and len(got) == 12


def test_clean_fraction_sweep_equals_reference():
    rows = TQ.clean_fraction_sweep(smoke=True, device=CPU)
    want = ref("cf", lambda: RQ.clean_fraction_sweep(smoke=True))
    for got, exp in zip(rows, want, strict=True):
        assert got["planned"] == exp["planned"]
        for be in ("fused", "tiled_fused"):
            g, e = dict(got["backends"][be]), dict(exp["backends"][be])
            g.pop("wall_us"), e.pop("wall_us")
            assert g == e


def test_sparsity_sweep_equals_reference():
    rows = TQ.sparsity_sweep(smoke=True, device=CPU)
    want = ref("sparsity", lambda: RQ.sparsity_sweep(smoke=True))
    for got, exp in zip(rows, want, strict=True):
        for k in ("density", "dense_words", "census", "memory_words", "memory_words_legacy",
                  "words_touched", "words_touched_legacy", "words_by_kind", "event_tiles",
                  "densified_tiles", "reduction"):
            assert got[k] == exp[k], k


def test_shard_sweep_equals_reference():
    rows = TQ.shard_sweep(smoke=True, device=CPU)
    want = ref("shards", lambda: RQ.shard_sweep(smoke=True))
    for got, exp in zip(rows, want, strict=True):
        for k in ("n_shards", "mode", "backends", "per_shard"):
            assert got[k] == exp[k], k
    # the reference's 8-device mesh point is the port's devices= point
    assert [r["mesh"] for r in rows] == [False, False, False, True]
    assert rows[-1]["backends"] == want[-1]["backends"]


def test_query_write_json(tmp_path):
    path = tmp_path / "q.json"
    doc = TQ.write_json(path, smoke=True, sweep=[], shards=[], sparsity=[], device=CPU)
    assert json.loads(path.read_text()) == doc and doc["device"] == "cpu"


@pytest.mark.parametrize("fn", [TK.tiled_crossover, TK.batched_launch_collapse,
                                TQ.clean_fraction_sweep, TQ.sparsity_sweep, TQ.shard_sweep,
                                TQ.write_json])
def test_kernel_and_query_refuse_to_run_without_a_card(fn):
    import torch

    if torch.cuda.is_available():  # decided inside the test, not at import
        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(smoke=True)
