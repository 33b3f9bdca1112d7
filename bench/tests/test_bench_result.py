"""Every cell runs end to end on the CPU at a tiny size and its result
object has the keys the contract reads, ``checks`` last."""
import json
import subprocess
import sys

import pytest

import _bench

CELLS = _bench.cells()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_and_has_the_contract_keys(cell, trace):
    layout = _bench.with_parked()
    res = _bench.tiny(cell, layout, trace=trace, seconds=1.0 if trace else 0.6)
    notes = res.pop("_notes")
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert notes["requests"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        listed = {m["name"] for m in layout.metrics("per_layer", cell)}
        # on the CPU nothing runs on a device: the device's readers find nothing
        assert set(res["metrics"]) <= listed
        host = {"plan.host_ms", "dispatch.host_ms", "compile.host_ms", "tiled.decode_words",
                "serve.batch_size", "serve.batch_ms", "stream.delta_words", "stream.compactions"}
        assert listed & host <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {m["name"] for m in layout.metrics("end_to_end", cell)}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_without_a_card_the_command_prints_no_result_and_fails():
    proc = subprocess.run([sys.executable, str(_bench.ROOT / "bench" / "run.py"),
                           "--workload", CELLS[0], "--seed", "3", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=120,
                          cwd=_bench.ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
