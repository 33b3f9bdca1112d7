"""A configuration, a traffic mix, a per-layer metric and a cell added as new
files and entries, in a directory of their own, run without an edit to any
file the benchmark has."""
import json

import _bench
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


def test_a_new_cell_of_new_files_runs(tmp_path):
    before = {p: p.read_bytes() for p in (_bench.ROOT / "bench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
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
    after = {p: p.read_bytes() for p in (_bench.ROOT / "bench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert after == before
