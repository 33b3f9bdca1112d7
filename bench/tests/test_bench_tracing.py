"""The device's busy and idle time on synthetic interval lists."""
import pytest

import _bench  # noqa: F401
from bench import tracing


def test_merge_busy_and_gaps():
    iv = [(5.0, 6.0), (0.5, 1.0), (0.8, 2.0), (2.0, 2.5), (9.0, 12.0)]
    assert tracing.merge(iv) == [(0.5, 2.5), (5.0, 6.0), (9.0, 12.0)]
    assert tracing.busy_seconds(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert tracing.idle_gaps(iv, 0.0, 10.0) == [(0.0, 0.5), (2.5, 5.0), (6.0, 9.0)]
    assert tracing.idle_gaps(iv, 1.0, 5.5) == [(2.5, 5.0)]


def test_idle_share_metric():
    from bench.common import load_module

    reader = load_module(_bench.ROOT / "bench" / "metrics" / "device.idle_share.py", "idle")
    prof = {"busy_s": 0.25, "window_s": 1.0, "device_intervals": 3}
    assert reader.read(None, prof) == pytest.approx(75.0)
    assert reader.read(None, dict(prof, device_intervals=0)) is None
    assert reader.read(None, None) is None


def test_gaps_are_named_by_the_innermost_open_call():
    cpu = [(0.0, 10.0, "bench.execute"), (1.0, 4.0, "aten::copy_"), (5.0, 9.0, "outer"),
           (6.0, 8.0, "inner")]
    named = tracing.TraceWindow._name_gaps([(2.0, 3.0), (6.5, 7.5), (9.5, 9.9)], cpu)
    assert dict(named) == pytest.approx({"bench.execute: aten::copy_": 1.0,
                                         "bench.execute: inner": 1.0,
                                         "bench.execute: bench.execute": 0.4})
