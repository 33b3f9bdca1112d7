"""The port's paper benchmarks (``benchmarks/pt_*.py``: table5, table7,
fig3, table10, heatmap, weighted, and the ``pt_run.py`` CLI over all
fourteen sections) against the reference's (``benchmarks/*.py``).

Deterministic rows are held equal name for name and value for value
(table7, weighted, the gate counts, RBMRG's work fraction); timed rows
name for name (the port runs at a small ``card`` on ``device="cpu"``; the
reference's row names come from its ``run()`` with its threshold calls
stubbed where compiling them would take minutes).  Each algorithm's words
on a handful of (N, T) cases of every section equal the reference's
``threshold`` over the same numpy-seeded bits; the tolerance is none.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)  # the benchmarks package, as PYTHONPATH=src:. gives

import benchmarks.fig3_scaling as R3  # noqa: E402
import benchmarks.heatmap_competitions as RH  # noqa: E402
import benchmarks.pt_fig3_scaling as T3  # noqa: E402
import benchmarks.pt_heatmap_competitions as TH  # noqa: E402
import benchmarks.pt_run as TRUN  # noqa: E402
import benchmarks.pt_table5_rowscan as T5  # noqa: E402
import benchmarks.pt_table7_gates as T7  # noqa: E402
import benchmarks.pt_table10_workload as T10  # noqa: E402
import benchmarks.pt_weighted_bench as TW  # noqa: E402
import benchmarks.table5_rowscan as R5  # noqa: E402
import benchmarks.table7_gates as R7  # noqa: E402
import benchmarks.table10_workload as R10  # noqa: E402
import benchmarks.weighted_bench as RW  # noqa: E402
import repro.data.paper_datasets as RD  # noqa: E402
import repro_torch.data.paper_datasets as TD  # noqa: E402
from _torch_port import u32  # noqa: E402
from repro.core import listalgos as RLA  # noqa: E402
from repro.core.bitmaps import pack as r_pack  # noqa: E402
from repro.core.threshold import threshold as r_threshold  # noqa: E402
from repro.core.weighted import weighted_threshold_decomposed as r_weighted  # noqa: E402
from repro.storage import TileStore as RTileStore  # noqa: E402
from repro.storage import rbmrg_block_threshold as r_rbmrg  # noqa: E402
from repro_torch.core import listalgos as TLA  # noqa: E402
from repro_torch.core.bitmaps import pack  # noqa: E402
from repro_torch.core.threshold import threshold  # noqa: E402
from repro_torch.core.weighted import weighted_threshold_decomposed  # noqa: E402
from repro_torch.device import to_words  # noqa: E402
from repro_torch.storage import TileStore, rbmrg_block_threshold  # noqa: E402

CARD = 200  # the sections' card, cut for the CPU (the reference's: 4,000 / 3,000)
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))


def _small(real):
    """``synthetic_dataset`` with ``card`` cut to ``CARD``."""
    return lambda *a, **k: real(*a, **{**k, "card": CARD})


def _r_threshold_stub(bm, t, alg):
    """The reference's threshold with no work: its rows' names, no compile."""
    return jnp.zeros(bm.shape[1], jnp.uint32)


def _names(rows):
    return [name for name, _, _ in rows]


# --------------------------------------------------------------- table7 --


def test_table7_rows_equal_reference():
    assert T7.run(device="cpu") == R7.run()


def test_pt_run_table7_prints_the_reference_rows():
    port = subprocess.run([sys.executable, "benchmarks/pt_run.py", "table7", "--device", "cpu"],
                          cwd=ROOT, env=ENV, capture_output=True, text=True)
    ref = subprocess.run([sys.executable, "benchmarks/run.py", "table7"],
                         cwd=ROOT, env=ENV, capture_output=True, text=True)
    assert port.returncode == 0 and ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout
    assert "table8_ssum_exact_rows,8,of 8" in port.stdout


def test_pt_run_unknown_section_exits_1_after_the_others():
    out = subprocess.run([sys.executable, "benchmarks/pt_run.py", "nosuch", "table7",
                          "--device", "cpu"], cwd=ROOT, env=ENV, capture_output=True, text=True)
    assert out.returncode == 1
    assert "table8_ssum_exact_rows,8,of 8" in out.stdout  # the other sections still ran
    assert "ValueError: unknown section nosuch" in out.stderr


def test_pt_run_sections_in_the_reference_order():
    # benchmarks/run.py's default list, in its order
    ref_order = ["table5", "table7", "fig3", "table10", "heatmap", "kernel", "weighted", "query",
                 "stream", "persist", "serve", "obs", "search", "roofline"]
    assert list(TRUN.SECTIONS) == ref_order
    assert not hasattr(TRUN, "NOT_PORTED")
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        assert repr(ref_order).replace("'", '"') in f.read()


def test_pt_run_stream_persist_roofline_print_the_reference_rows(tmp_path):
    out = subprocess.run([sys.executable, "benchmarks/pt_run.py", "stream", "persist", "roofline",
                          "--device", "cpu"], cwd=ROOT, env=ENV, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    names = [line.split(",", 1)[0] for line in out.stdout.splitlines()
             if not line.startswith("#")]
    import benchmarks.persist_bench as RP
    import benchmarks.stream_bench as RS

    stream = {"update_vs_rebuild": RS.update_vs_rebuild(smoke=True),
              "view_refresh": RS.view_refresh(smoke=True),
              "compaction": RS.compaction_curve(smoke=True)}
    want = _names(RS.run(smoke=True, payload=stream)) + _names(RP.run(smoke=True,
                                                                      payload=RP.collect(True)))
    assert names == want
    assert out.stdout.splitlines()[0] == "# --- stream ---"
    assert "# --- roofline ---" in out.stdout


# ------------------------------------------------------------- weighted --


def test_weighted_rows_equal_reference():
    assert TW.run(device="cpu") == RW.run()


@pytest.mark.parametrize("n,wmax", [(16, 7), (16, 100), (32, 1000)])
def test_weighted_decomposed_words_equal_reference(n, wmax):
    rng = np.random.default_rng(n + wmax)
    weights = tuple(int(x) for x in rng.integers(1, wmax + 1, n))
    t = sum(weights) // 2
    bits = rng.random((n, 700)) < 0.3
    got = weighted_threshold_decomposed(pack(bits, "cpu"), weights, t, device="cpu")
    want = r_weighted(r_pack(jnp.asarray(bits)), weights, t)
    assert np.array_equal(u32(got), u32(want))


# --------------------------------------------------------------- table5 --


def test_table5_rows_name_the_reference_rows():
    rows = T5.run(reps=1, device="cpu")  # holds every query against the row scan
    assert _names(rows) == _names(R5.run(reps=1))
    assert rows[1][2].startswith("speedup=")


def test_table5_index_equals_reference():
    table = T5.build_table()
    assert np.array_equal(table, R5.build_table())
    assert np.array_equal(u32(T5.bitmap_index(table, 8, "cpu")), u32(R5.bitmap_index(table, 8)))


# ------------------------------------------------------------- datasets --


@pytest.mark.parametrize("kind,density", [d for d in T10.DATASETS])
def test_bench_datasets_and_selections_equal_reference(kind, density):
    packed, r, lists = TD.synthetic_dataset(kind, density, n_bitmaps=64, card=CARD, seed=1111,
                                            device="cpu")
    rpacked, rr, rlists = RD.synthetic_dataset(kind, density, n_bitmaps=64, card=CARD,
                                               seed=1111)
    assert r == rr and np.array_equal(packed, np.asarray(rpacked, np.uint32))
    assert all(np.array_equal(a, b) for a, b in zip(lists, rlists))
    for n, seed in [(T10.N, 7), (4, 4 * 131 + 3), (16, 16 * 131 + 9), (32, 32 * 131 + 31)]:
        assert TD.similarity_query(lists, n, seed=seed) == RD.similarity_query(rlists, n,
                                                                              seed=seed)


# ----------------------------------------------------------------- fig3 --


@pytest.mark.parametrize("n,t", [(8, 4), (32, 16), (64, 2), (64, 63)])
def test_fig3_words_equal_reference(n, t):
    packed, _, _ = TD.synthetic_dataset("clustered", "dense", n_bitmaps=128, card=CARD,
                                        seed=1111, device="cpu")
    bm, rbm = to_words(packed[:n], "cpu"), jnp.asarray(packed[:n])
    for alg in T3.ALGOS:
        if alg == "looped" and n * t > 4000:
            continue
        assert np.array_equal(u32(threshold(bm, t, alg)), u32(r_threshold(rbm, t, alg))), alg


def test_fig3_rows_name_the_reference_rows(monkeypatch):
    rows = T3.run(card=CARD, device="cpu")  # holds every call against scancount
    monkeypatch.setattr(R3, "synthetic_dataset", _small(RD.synthetic_dataset))
    monkeypatch.setattr(R3, "threshold", _r_threshold_stub)
    assert _names(rows) == _names(R3.run())
    assert rows[0][2].startswith("T=4 ops=")


@pytest.mark.parametrize("n", [8, 32])
def test_ops_per_call_counts_device_ops(n):
    from benchmarks.pt_common import ops_per_call
    from repro_torch.core.threshold import _tabulated_circuit

    packed, _, _ = TD.synthetic_dataset("clustered", "dense", n_bitmaps=n, card=CARD,
                                        seed=1111, device="cpu")
    bm = to_words(packed, "cpu")
    assert ops_per_call(lambda: bm[:2].view(-1)) == 0  # views do no device work
    gates = _tabulated_circuit(n, n // 2, "ssum").gate_count()
    ssum = ops_per_call(lambda: threshold(bm, n // 2, "ssum"))
    assert gates <= ssum <= gates + 8  # one op a gate, plus the shim's few
    assert ops_per_call(lambda: threshold(bm, n // 2, "scancount")) < 16  # N-independent


def test_fig3_sweep_raises_on_a_mismatch():
    packed, _, _ = TD.synthetic_dataset("clustered", "dense", n_bitmaps=8, card=CARD,
                                        seed=1111, device="cpu")
    full = to_words(packed, "cpu")
    wrong = lambda n, t: np.zeros(full.shape[1], np.uint32)  # noqa: E731
    with pytest.raises(AssertionError, match="mismatched words"):
        list(T3.sweep(full, [(8, 4)], torch.device("cpu"), wrong, reps=1))


# -------------------------------------------------------------- table10 --


@pytest.mark.parametrize("kind,density", [d for d in T10.DATASETS])
def test_table10_words_and_work_fraction_equal_reference(kind, density):
    packed, r, lists = TD.synthetic_dataset(kind, density, n_bitmaps=64, card=CARD, seed=1111,
                                            device="cpu")
    sel, _ = TD.similarity_query(lists, T10.N, seed=7)
    bm, rbm = to_words(packed[sel], "cpu"), jnp.asarray(packed[sel])
    for alg in ("scancount", "looped", "ssum", "csvckt", "fused"):
        assert np.array_equal(u32(threshold(bm, T10.T, alg)),
                              u32(r_threshold(rbm, T10.T, alg))), alg
    got, info = rbmrg_block_threshold(bm, T10.T,
                                      stats=TileStore.from_packed(bm, device="cpu").block_stats())
    want, rinfo = r_rbmrg(rbm, T10.T, stats=RTileStore.from_packed(rbm).block_stats())
    assert np.array_equal(u32(got), u32(want))
    assert info == rinfo
    sel_lists = [lists[i] for i in sel]
    for name, fn in T10.LIST_ALGOS:
        assert np.array_equal(fn(sel_lists, T10.T, r), getattr(RLA, name)(sel_lists, T10.T, r))


def test_table10_rows_name_the_reference_rows(monkeypatch):
    rows = T10.run(card=CARD, device="cpu")
    monkeypatch.setattr(R10, "synthetic_dataset", _small(RD.synthetic_dataset))
    ref = R10.run()
    # rows within a dataset are sorted by time: names as sets, the
    # deterministic work fractions as values
    assert sorted(_names(rows)) == sorted(_names(ref))
    frac = {n: v for n, v, _ in rows if n.endswith("_rbmrg_work_fraction")}
    assert frac == {n: v for n, v, _ in ref if n.endswith("_rbmrg_work_fraction")}
    assert len(frac) == len(T10.DATASETS)


# -------------------------------------------------------------- heatmap --


def test_small_competitions_schedule_equals_reference():
    assert TH.small_competitions() == RH.small_competitions()
    assert len(TH.small_competitions()) == 22


@pytest.mark.parametrize("n,t", [(4, 3), (8, 7), (16, 9), (32, 3), (32, 31)])
def test_heatmap_words_equal_reference(n, t):
    packed, r, lists = TD.synthetic_dataset("clustered", "dense", n_bitmaps=64, card=CARD,
                                            seed=1111, device="cpu")
    sel, _ = TD.similarity_query(lists, n, seed=n * 131 + t)
    bm, rbm = to_words(packed[sel], "cpu"), jnp.asarray(packed[sel])
    for alg in ("scancount", "ssum", "csvckt", "fused") + (("looped",) if n * t <= 4000 else ()):
        assert np.array_equal(u32(threshold(bm, t, alg)), u32(r_threshold(rbm, t, alg))), alg
    got, info = rbmrg_block_threshold(bm, t, stats=TileStore.from_packed(bm, device="cpu")
                                      .block_stats())
    want, rinfo = r_rbmrg(rbm, t, stats=RTileStore.from_packed(rbm).block_stats())
    assert np.array_equal(u32(got), u32(want)) and info == rinfo
    sel_lists = [lists[i] for i in sel]
    assert np.array_equal(TLA.dsk(sel_lists, t, r), RLA.dsk(sel_lists, t, r))
    assert np.array_equal(TLA.w2cti(sel_lists, t, r), RLA.w2cti(sel_lists, t, r))


def test_heatmap_rows_name_the_reference_rows(monkeypatch):
    rows = TH.run(card=CARD, device="cpu")
    monkeypatch.setattr(RH, "synthetic_dataset", _small(RD.synthetic_dataset))
    monkeypatch.setattr(RH, "threshold", _r_threshold_stub)
    ref = RH.run()
    assert sorted(_names(rows)) == sorted(_names(ref))  # sorted by suboptimality
    assert rows[-1] == ("heatmap_competitions", 22, "SMALL-COMPETITIONS pairs") == ref[-1]
    for _, _, extra in rows[:-1]:
        assert extra.startswith("wins=") and "terrible=" in extra


# --------------------------------------------------- the device rule --


# roofline reads the dry run's records and runs nothing on a device
@pytest.mark.parametrize("section", [s for s in TRUN.SECTIONS if s != "roofline"])
def test_sections_refuse_to_run_without_a_card(section):
    if torch.cuda.is_available():  # decided inside the test, not at import
        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        TRUN.run_section(section)
