"""A configuration, a traffic mix, a per-layer metric and a cell added as new
files and entries, in a directory of their own, run without an edit to any
file the benchmark has."""
import json

import pytest

import _bench
from bench import control
from bench import run as harness

CONFIG = {"name": "tiny-clustered", "generator": "clustered", "columns": 12,
          "universe": 1 << 16, "card": 1 << 12, "universe_per_card": 16, "tile_words": 64}
TRAFFIC = {"loop": "embedded", "columns_read": [8, 12], "kinds": ["threshold", "andnot"],
           "params": {"threshold": {"t": {"8": 2, "12": 3}}, "andnot": {"t": {"8": 3, "12": 2}}},
           "clients": 1, "check_sample": 8, "trace_seconds": 0.5}
METRIC = '''"""Requests completed in the traced stretch."""


def read(run, prof):
    return len(run.traced) or None
'''


def _layout(tmp_path):
    spec = json.loads((_bench.ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-clustered", "source": "a test",
                            "file": "bench/configs/tiny-clustered.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny.two-kinds", "config": "tiny-clustered",
                              "traffic": "two-kinds", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "tiny.traced_requests", "unit": "queries",
                              "better": "higher", "source": "host_clock", "layer": "device",
                              "moves": "queries_per_s", "workloads": ["tiny.two-kinds"]})
    spec["end_to_end"].append({"name": "tiny.attempted_per_s", "unit": "queries/s",
                               "better": "higher", "bound": 0.25, "source": "host_clock",
                               "workloads": ["tiny.two-kinds"]})
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / "bench" / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "bench/configs/tiny-clustered.json").write_text(json.dumps(CONFIG))
    (tmp_path / "bench/traffic/two-kinds.json").write_text(json.dumps(TRAFFIC))
    (tmp_path / "bench/metrics/tiny.traced_requests.py").write_text(METRIC)
    (tmp_path / "bench/metrics/tiny.attempted_per_s.py").write_text(
        "def read(run, prof):\n    return run.attempted / run.seconds\n")
    return harness.Layout(tmp_path, [tmp_path / "bench"])


#: Kaser and Lemire (arXiv:1402.4073) Table 8's thresholds over N = 43 to 786
#: bitmaps, one a column count, over uniform dense columns
WIDE_CONFIG = {"name": "wide786", "generator": "uniform", "columns": 786,
               "universe": 1 << 25, "card": (1 << 25) // 3, "universe_per_card": 3,
               "tile_words": 64}
TABLE8 = {43: 30, 85: 12, 120: 105, 323: 14, 329: 138, 330: 324, 786: 481}
WIDE_TRAFFIC = {"loop": "embedded", "columns_read": list(TABLE8), "kinds": ["threshold"],
                "params": {"threshold": {"t": {str(n): t for n, t in TABLE8.items()}}},
                "clients": 1, "check_sample": 16}


def _bench_files():
    return {p: p.read_bytes() for p in (_bench.ROOT / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_of_new_files_runs(tmp_path):
    before = _bench_files()
    layout = _layout(tmp_path)
    res = harness.run_cell(layout, "tiny.two-kinds", 5, 0.5, False, device="cpu")
    assert res["correct"] is True and res["attempted"] > 0
    # query_p50_ms lists its cells, and this one is not among them
    assert set(res["metrics"]) == {"setup_s", "queries_per_s", "query_p95_ms",
                                   "tiny.attempted_per_s"}
    assert res["metrics"]["tiny.attempted_per_s"]["value"] > 0
    traced = harness.run_cell(layout, "tiny.two-kinds", 6, 1.5, True, device="cpu")
    assert traced["correct"] is True
    assert traced["metrics"]["tiny.traced_requests"]["value"] > 0
    assert {"plan.host_ms", "device.idle_share"} <= {
        m["name"] for m in layout.metrics("per_layer", "tiny.two-kinds")}
    assert _bench_files() == before


def test_a_wide_cell_of_new_files_runs_and_fails_its_control(tmp_path):
    before = _bench_files()
    spec = json.loads((_bench.ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "wide786", "source": "a test",
                            "file": "bench/configs/wide786.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "wide786.table8", "config": "wide786",
                              "traffic": "table8", "chips": 1, "why": "a test"})
    for sub in ("configs", "traffic"):
        (tmp_path / "bench" / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "bench/configs/wide786.json").write_text(json.dumps(WIDE_CONFIG))
    (tmp_path / "bench/traffic/table8.json").write_text(json.dumps(WIDE_TRAFFIC))
    layout = harness.Layout(tmp_path, [tmp_path / "bench"])
    res = _bench.tiny("wide786.table8", layout)
    assert res["correct"] is True and res["attempted"] > 0
    assert res["_notes"]["plans"] == ["fused"] * len(TABLE8)
    ctl = _bench.tiny("wide786.table8", layout, stand_in=control, seconds=4.0)
    assert ctl["attempted"] >= 16, "too few requests to reach every template"
    assert ctl["correct"] is False
    assert ctl["checks"]["mismatched_words"]["value"] > 0
    assert _bench_files() == before


@pytest.mark.parametrize("config, rows", [(c["name"], 1 << 17) for c in json.loads(
    (_bench.ROOT / "BENCHMARK.json").read_text())["configs"]] + [("wide786", 1 << 13)])
def test_a_tiny_run_sizes_its_rows_by_the_bits_they_hold(config, rows, monkeypatch):
    layout = harness.Layout(_bench.ROOT)
    layout.spec = dict(layout.spec, workloads=[{"name": "probe", "config": config}])
    if config == "wide786":
        layout.config = lambda name: WIDE_CONFIG
    seen = []
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, overrides, **kw: seen.append(overrides["universe"]))
    _bench.tiny("probe", layout)
    _bench.tiny("probe", layout, rows=1 << 15)  # an explicit count wins
    assert seen == [rows, 1 << 15]
