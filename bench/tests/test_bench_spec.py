"""BENCHMARK.json against the benchmark contract's shape rules."""
import json
import re

import pytest

import _bench

SPEC = json.loads((_bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    # a full check of 24 cells fits its time
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    sources = [c["source"] for c in SPEC["configs"]]
    assert len(set(sources)) == len(sources)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench/configs/") and (_bench.ROOT / c["file"]).exists()
        body = json.loads((_bench.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert all(body[k] != body["published"][k] for k in c["reduced"])
        for k, v in body["published"].items():
            assert k in c["reduced"] or body[k] == v


def test_workloads():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (_bench.ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()


def _reported(key, cell):
    return {m["name"] for m in SPEC[key] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("key", ["end_to_end", "per_layer"])
def test_metrics(key):
    cells = {w["name"] for w in SPEC["workloads"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    for m in SPEC[key]:
        extra = {"bound"} if key == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if key == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert _line(m["layer"])
            assert (_bench.ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
            for cell in m.get("workloads", cells):
                assert m["moves"] in _reported("end_to_end", cell)
            if m["name"].endswith("_roofline"):
                assert m["unit"] == "%"


def test_every_cell_reports_setup_another_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = _reported("end_to_end", w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _reported("per_layer", w["name"])
