"""The port's subsystem benchmarks (``benchmarks/pt_{stream,persist,serve,
obs,search}_bench.py``) against the reference's at their ``--smoke`` shapes.

Nothing the clock decides is compared.  What is: the stream section's
update counts, view refresh counters, delta words and compactions; the
persist section's snapshot and WAL bytes and the snapshot files byte for
byte; the serve section's query pool and request streams (canonical
keys), the oracle (every pool query served equal to the reference's
direct execution) and every request served, none shed; the obs section's
last span tree without times (the port's own spans folded out), drift
samples, Prometheus families and lint result; the search section's
candidate counts and ids, top-k relaxations and verifications, and every
window refresh's accounting.  Row names are
equal for every section.  The reference's collection functions are
called; where one writes a file its path is moved under ``tmp_path``, and
the serve / obs sections run the reference's ``run(smoke=False)`` with
``FULL`` set to the smoke shapes (its wall-time asserts are smoke-only).
The port runs on ``device="cpu"`` (the kernels' plain versions).  Each
section's ``check_contracts`` passes a payload that meets the reference's
limits and raises the reference's message for one that misses.
"""
import filecmp
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)  # the benchmarks package, as PYTHONPATH=src:. gives

import benchmarks.obs_bench as RO  # noqa: E402
import benchmarks.persist_bench as RP  # noqa: E402
import benchmarks.pt_obs_bench as TO  # noqa: E402
import benchmarks.pt_persist_bench as TP  # noqa: E402
import benchmarks.pt_search_bench as TSE  # noqa: E402
import benchmarks.pt_serve_bench as TSV  # noqa: E402
import benchmarks.pt_stream_bench as TS  # noqa: E402
import benchmarks.search_bench as RSE  # noqa: E402
import benchmarks.serve_bench as RSV  # noqa: E402
import benchmarks.stream_bench as RS  # noqa: E402
import repro.obs as robs  # noqa: E402
import repro.search.similarity as r_similarity  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.search.similarity as t_similarity  # noqa: E402
from _torch_port import PORT_ONLY_FAMILIES, reference_view, u32  # noqa: E402

CPU = "cpu"
_REF: dict = {}


def ref(name, fn):
    """The reference's run of ``name``, once per module."""
    if name not in _REF:
        _REF[name] = fn()
    return _REF[name]


def _names(rows):
    return [name for name, _, _ in rows]


# --------------------------------------------------------------- stream --


STREAM_KEYS = ("distribution", "mutation_rate", "updates", "r", "n", "view_tiles_refreshed",
               "view_words_touched", "n_tiles", "delta_words", "compactions")


def test_stream_update_vs_rebuild_counters_equal_reference():
    got = TS.update_vs_rebuild(smoke=True, device=CPU)  # holds the overlay against a rebuild
    want = ref("stream_uvr", lambda: RS.update_vs_rebuild(smoke=True))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert {k: g[k] for k in STREAM_KEYS} == {k: w[k] for k in STREAM_KEYS}
    assert got[-1]["compactions"] > 0  # the uniform smear folds the delta mid-update


def test_stream_view_refresh_counters_equal_reference():
    got = TS.view_refresh(smoke=True, device=CPU)
    want = ref("stream_view", lambda: RS.view_refresh(smoke=True))
    keys = ("update_batch", "tiles_refreshed", "words_touched", "total_words")
    assert [{k: g[k] for k in keys} for g in got] == [{k: w[k] for k in keys} for w in want]


def test_stream_compaction_delta_words_equal_reference():
    got = TS.compaction_curve(smoke=True, device=CPU)
    want = ref("stream_compact", lambda: RS.compaction_curve(smoke=True))
    keys = ("update_batches", "delta_words_at_compaction")
    assert [{k: g[k] for k in keys} for g in got] == [{k: w[k] for k in keys} for w in want]


def test_stream_rows_name_the_reference_rows():
    payload = TS.collect(smoke=True, device=CPU)
    want = {"update_vs_rebuild": ref("stream_uvr", lambda: RS.update_vs_rebuild(smoke=True)),
            "view_refresh": ref("stream_view", lambda: RS.view_refresh(smoke=True)),
            "compaction": ref("stream_compact", lambda: RS.compaction_curve(smoke=True))}
    rows = TS.run(smoke=True, payload=payload)
    assert _names(rows) == _names(RS.run(smoke=True, payload=want))
    assert payload["device"] == "cpu" and payload["n_devices"] == 1
    # the derived text holds only counts: equal too
    assert [e for _, _, e in rows if "tiles" in e] == \
        [e for _, _, e in RS.run(smoke=True, payload=want) if "tiles" in e]


def test_stream_guard_raises_on_a_wrong_rebuild(monkeypatch):
    real = TS._apply_packed
    monkeypatch.setattr(TS, "_apply_packed", lambda p, c, pos, on: real(p, c, pos, ~on))
    with pytest.raises(AssertionError, match="rebuild"):
        TS.update_vs_rebuild(smoke=True, device=CPU)


# -------------------------------------------------------------- persist --


@pytest.mark.parametrize("part", ["snapshot_size", "cold_load", "wal_replay"])
def test_persist_bytes_and_files_equal_reference(part, tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    got = getattr(TP, part)(True, str(port_dir), CPU)
    want = getattr(RP, part)(True, str(ref_dir))
    keys = {"snapshot_size": ("density", "snapshot_bytes", "dense_bytes", "ratio", "n", "r"),
            "cold_load": ("density", "target", "snapshot_bytes"),
            "wal_replay": ("wal_records", "wal_bytes")}[part]
    assert [{k: g[k] for k in keys} for g in got] == [{k: w[k] for k in keys} for w in want]
    files = sorted(os.path.relpath(os.path.join(d, f), port_dir)
                   for d, _, fs in os.walk(port_dir) for f in fs)
    assert files and files == sorted(os.path.relpath(os.path.join(d, f), ref_dir)
                                     for d, _, fs in os.walk(ref_dir) for f in fs)
    for f in files:
        if f.endswith((".bmsnap", ".bmwal")):
            assert filecmp.cmp(port_dir / f, ref_dir / f, shallow=False), f


def test_persist_rows_name_the_reference_rows():
    payload = TP.collect(smoke=True, device=CPU)
    want = ref("persist", lambda: RP.collect(smoke=True))
    rows, ref_rows = TP.run(smoke=True, payload=payload), RP.run(smoke=True, payload=want)
    assert _names(rows) == _names(ref_rows)
    assert [r for r in rows if r[0].endswith("_bytes")] == \
        [r for r in ref_rows if r[0].endswith("_bytes")]


# ---------------------------------------------------------------- serve --


@pytest.fixture(scope="module")
def serve_pair():
    cfg = TSV.SMOKE
    t_idx, t_names = TSV._build_index(cfg["n_cols"], cfg["n_words"], device=CPU)
    r_idx, r_names = RSV._build_index(cfg["n_cols"], cfg["n_words"])
    assert t_names == r_names
    return (t_idx, TSV._query_pool(t_names, cfg["pool_size"])), \
        (r_idx, RSV._query_pool(r_names, cfg["pool_size"]))


def test_serve_pool_and_request_streams_equal_reference(serve_pair):
    (_, t_pool), (_, r_pool) = serve_pair
    assert TSV.SMOKE == RSV.SMOKE and TSV.FULL == RSV.FULL
    assert [q.key() for q in t_pool] == [q.key() for q in r_pool]
    for clients in TSV.SMOKE["clients"]:
        got = TSV._request_streams(t_pool, clients, TSV.SMOKE["per_client"])
        want = RSV._request_streams(r_pool, clients, RSV.SMOKE["per_client"])
        assert [[q.key() for q in s] for s in got] == [[q.key() for q in s] for s in want]


def test_serve_oracle_equals_reference_execution(serve_pair):
    (t_idx, t_pool), (r_idx, r_pool) = serve_pair
    assert TSV._oracle_check(t_idx, t_pool)
    idx, ridx = t_idx.index(), r_idx.index()
    for q, rq in zip(t_pool, r_pool):
        assert np.array_equal(u32(idx.execute(q)), u32(ridx.execute(rq))), q


def test_serve_every_request_served_none_shed(serve_pair):
    (t_idx, t_pool), _ = serve_pair
    streams = TSV._request_streams(t_pool, 8, TSV.SMOKE["per_client"])
    qps, info = TSV._coalesced_qps(t_idx, streams, 1, window=0.001)
    n = sum(len(s) for s in streams)
    assert qps > 0 and info["served"] == info["requests"] == n
    assert info["shed"] == 0 and info["errors"] == 0 and info["latency"]["count"] == n


def test_serve_collect_and_rows_name_the_reference_rows(monkeypatch, tmp_path):
    from repro.core.calibration import get_calibration as r_get
    from repro_torch.core.calibration import get_calibration as t_get

    data = TSV.collect(smoke=True, device=CPU)  # raises if the oracle fails
    assert data["oracle_bit_identical"] and t_get() is None
    for point in data["sweep"]:
        assert point["shed"] == 0 and point["latency_s"]["count"] == point["offered"]
    monkeypatch.setattr(RSV, "FULL", RSV.SMOKE)
    monkeypatch.setattr(RSV, "OUT_PATH", tmp_path / "BENCH_serve.json")
    ref_rows = RSV.run(smoke=False)
    assert r_get() is None
    assert _names(TSV.rows(data)) + ["bench_serve_json"] == _names(ref_rows)
    monkeypatch.setattr(TSV, "OUT_PATH", tmp_path / "pt_BENCH_serve.json")
    monkeypatch.setattr(TSV, "collect", lambda smoke, device: data)
    assert _names(TSV.run(smoke=False, device=CPU)) == _names(ref_rows)
    assert json.loads((tmp_path / "pt_BENCH_serve.json").read_text())["sweep"]


def _serve_payload(speedup, p99=0.01, count=10):
    point = lambda c: {"clients": c, "speedup_vs_sequential": speedup,  # noqa: E731
                       "latency_s": {"p99_s": p99, "count": count}}
    return {"sweep": [point(c) for c in (1, 2, 4, 8, 16)]}


def test_serve_check_contracts():
    TSV.check_contracts(_serve_payload(3.0))
    with pytest.raises(AssertionError, match=r"coalesced front-end only 2\.99x sequential at "
                                             r">=8 clients \(need >= 3\.0x\)"):
        TSV.check_contracts(_serve_payload(2.99))
    with pytest.raises(AssertionError, match="p99 latency not finite at 1 clients: inf"):
        TSV.check_contracts(_serve_payload(4.0, p99=float("inf")))
    with pytest.raises(AssertionError, match="latency histogram empty"):
        TSV.check_contracts(_serve_payload(4.0, count=0))
    misses = [c for c in TSV.contracts(_serve_payload(1.5)) if not c["ok"]]
    assert [(c["contract"], c["value"], c["limit"]) for c in misses] == \
        [("speedup_vs_sequential_at_8_clients", 1.5, ">= 3.0")]


# ------------------------------------------------------------------ obs --


def _untimed(span: dict) -> tuple:
    """A span dict of the trace artifact without its time."""
    return (span["name"], span["attrs"], [_untimed(c) for c in span["children"]])


def _families(prom: str, skip=frozenset()) -> list:
    """The ``# TYPE`` lines of an export, without the families in ``skip``."""
    return sorted(line for line in prom.splitlines()
                  if line.startswith("# TYPE ") and line.split()[2] not in skip)


def _capture_prometheus(monkeypatch, module, into: list) -> None:
    real = module.export_prometheus

    def export():
        into.append(real())
        return into[-1]

    monkeypatch.setattr(module, "export_prometheus", export)


def test_obs_trace_drift_and_exports_equal_reference(monkeypatch, tmp_path):
    t_prom, r_prom = [], []
    _capture_prometheus(monkeypatch, tobs, t_prom)
    _capture_prometheus(monkeypatch, robs, r_prom)
    monkeypatch.setattr(TO, "TRACE_PATH", tmp_path / "pt_trace.jsonl")
    data = TO.collect(smoke=True, device=CPU)  # raises on drift, lint or a missing plan span
    assert not tobs.enabled()
    monkeypatch.setattr(RO, "FULL", RO.SMOKE)
    monkeypatch.setattr(RO, "OUT_PATH", tmp_path / "BENCH_obs.json")
    monkeypatch.setattr(RO, "TRACE_PATH", tmp_path / "trace.jsonl")
    ref_rows = RO.run(smoke=False)
    want = json.loads((tmp_path / "BENCH_obs.json").read_text())
    assert data["drift_samples"] == want["drift_samples"] == TO.SMOKE["n_queries"]
    assert data["prometheus_lint_problems"] == want["prometheus_lint_problems"] == []
    assert _families(t_prom[-1], PORT_ONLY_FAMILIES) == _families(r_prom[-1]) and _families(t_prom[-1])
    assert {line.split()[2] for line in _families(t_prom[-1])} >= PORT_ONLY_FAMILIES
    last = [json.loads(p.read_text().splitlines()[-1])["last_trace"]
            for p in (tmp_path / "pt_trace.jsonl", tmp_path / "trace.jsonl")]
    folded = set()  # the port-only spans of K1 (_torch_port.PORT_ONLY_SPANS)
    assert reference_view(last[0], folded) == _untimed(last[1])
    assert folded == {"program", "launch"}
    assert any(c["name"] == "plan" for c in last[0]["children"])
    assert _names(TO.rows(data)) == _names(ref_rows)


def _obs_payload(on, off):
    return {"enabled_overhead_pct": on, "implied_disabled_overhead_pct": off}


def test_obs_check_contracts():
    TO.check_contracts(_obs_payload(4.99, 1.99))
    with pytest.raises(AssertionError, match=r"metrics\+tracing cost 5\.00% \(bound 5\.0%\)"):
        TO.check_contracts(_obs_payload(5.0, 0.1))
    with pytest.raises(AssertionError,
                       match=r"disabled instrumentation implies 2\.500% \(bound 2\.0%\)"):
        TO.check_contracts(_obs_payload(1.0, 2.5))


# --------------------------------------------------------------- search --


def _recording(monkeypatch, module, into: list) -> None:
    """Record the ids of every ``SimilarityIndex.candidates`` call."""
    real = module.SimilarityIndex.candidates

    def candidates(self, s, k, **kw):
        out = real(self, s, k, **kw)
        into.append((s, k, out.t, np.asarray(out.ids).tolist()))
        return out

    monkeypatch.setattr(module.SimilarityIndex, "candidates", candidates)


def test_search_candidates_and_topk_equal_reference(monkeypatch):
    t_calls, r_calls = [], []
    _recording(monkeypatch, t_similarity, t_calls)
    _recording(monkeypatch, r_similarity, r_calls)
    rows, got = TSE.candidate_race(TSE.SMOKE, CPU)  # raises when a list algorithm disagrees
    ref_rows, want = RSE.candidate_race(RSE.SMOKE)
    assert TSE.SMOKE == RSE.SMOKE and TSE.FULL == RSE.FULL
    keys = ("query", "t", "n_lists", "list_elems", "n_candidates")
    assert [{k: p[k] for k in keys} for p in got["points"]] == \
        [{k: p[k] for k in keys} for p in want["points"]]
    assert [sorted(p["lists_s"]) for p in got["points"]] == \
        [sorted(p["lists_s"]) for p in want["points"]]
    assert t_calls == r_calls and len(t_calls) >= TSE.SMOKE["queries"]
    topk = ("k", "relaxations", "verified", "corpus", "verified_fraction")
    assert {k: got["topk"][k] for k in topk} == {k: want["topk"][k] for k in topk}
    assert _names(rows) == _names(ref_rows)


def test_search_window_refreshes_equal_reference():
    rows, got = TSE.window_sweep(TSE.SMOKE, CPU)  # raises on a words-bound miss
    ref_rows, want = RSE.window_sweep(RSE.SMOKE)
    keys = ("tiles_refreshed", "words_touched", "bound", "universe_words", "live",
            "total_rows", "count")
    assert [{k: r[k] for k in keys} for r in got["refreshes"]] == \
        [{k: r[k] for k in keys} for r in want["refreshes"]]
    assert {k: got[k] for k in ("series", "tile_words", "support")} == \
        {k: want[k] for k in ("series", "tile_words", "support")}
    assert rows == ref_rows  # counts and the words ratio only: equal values


def test_search_run_rows_and_artifact(monkeypatch, tmp_path):
    monkeypatch.setattr(TSE, "OUT_PATH", tmp_path / "BENCH_search.json")
    monkeypatch.setattr(TSE, "FULL", TSE.SMOKE)  # the shapes of smoke, not its contract
    rows = TSE.run(smoke=False, device=CPU)
    assert _names(rows) == ["search_best_speedup_vs_dsk", "search_topk_ms", "window_events",
                            "window_words_touched_vs_bound", "bench_search_json"]
    saved = json.loads((tmp_path / "BENCH_search.json").read_text())
    assert saved["config"] == json.loads(json.dumps(TSE.SMOKE)) and "rows" not in saved


def test_search_check_contracts():
    TSE.check_contracts({"candidates": {"best_speedup_vs_dsk": 1.0}})
    with pytest.raises(AssertionError, match="bitmap candidate generation never reached "
                                             r"DivideSkip: best 0\.99x"):
        TSE.check_contracts({"candidates": {"best_speedup_vs_dsk": 0.99}})


# ------------------------------------------------------- the device rule --


@pytest.mark.parametrize("mod", [TS, TP, TSV, TO, TSE], ids=lambda m: m.__name__)
def test_collect_refuses_to_run_without_a_card(mod):
    import torch

    if torch.cuda.is_available():  # decided inside the test, not at import
        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.collect(smoke=True)
