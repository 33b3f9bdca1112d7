"""The readers of the program's own spans (``bench/spans.py`` and the three
metrics on it) on synthetic span trees and profiler events, and a tiny
traced run of the uniform cell."""
from types import SimpleNamespace

import pytest
import torch

import _bench
from bench import spans
from bench.common import load_module
from repro_torch.obs.trace import Span

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _reader(name):
    return load_module(_bench.ROOT / "bench" / "metrics" / f"{name}.py", name)


def _span(name, t0, children=(), wall=1.0):
    sp = Span(name)
    sp.t0, sp.wall_s = t0, wall
    sp.children = list(children)
    return sp


def _request(t0, launch_at):
    """execute > plan, dispatch > program, launch (launch ``launch_at`` s in)."""
    disp = [_span("program", t0 + 3e-5)]
    if launch_at is not None:
        disp.append(_span("launch", t0 + launch_at))
    return _span("execute", t0, [_span("plan", t0 + 1e-5), _span("dispatch", t0 + 2e-5, disp)])


def _run(roots=(), prof=None, traced=1):
    return SimpleNamespace(tracer=SimpleNamespace(spans=list(roots), prof=prof),
                           traced=[{}] * traced)


def test_prelaunch_is_the_mean_first_launch_offset():
    read = _reader("execute.prelaunch_ms").read
    second = _request(20.0, 3e-4)
    second.children[1].children.append(_span("launch", 20.0 + 9e-4))  # a second launch: not read
    roots = [_request(10.0, 1e-4), second, _span("plan", 30.0), _request(40.0, None)]
    assert read(_run(roots), None) == pytest.approx(0.2)
    assert read(_run([_request(1.0, None)]), None) is None  # no launch span: nothing to read
    assert read(_run([]), None) is None


def _event(name, start, end, device=CPU, parent=None, kernels=(), annotation=False):
    return SimpleNamespace(name=name, device_type=device, cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[SimpleNamespace(duration=d) for d in kernels],
                           is_user_annotation=annotation)


def _events(k2_linked=True):
    """Two requests: events > aten ops with kernels, block > a K2 launch."""
    out = []
    for t in (0.0, 1000.0):
        execute = _event("repro.execute", t, t + 900)
        dispatch = _event("repro.dispatch", t + 10, t + 890, parent=execute)
        ev = _event("repro.events", t + 20, t + 500, parent=dispatch)
        cumsum = _event("aten::cumsum", t + 30, t + 200, parent=ev, kernels=(300.0,))
        inner = _event("aten::copy_", t + 40, t + 50, parent=cumsum, kernels=(5.0,))
        block = _event("repro.block", t + 510, t + 600, parent=dispatch,
                       kernels=(7.0,) if k2_linked else ())
        base = _event("aten::clone", t + 12, t + 15, parent=dispatch, kernels=(2.0,))
        out += [execute, dispatch, ev, cumsum, inner, block, base,
                _event("cumsum_kernel", t + 31, t + 331, device=CUDA),
                _event("copy_kernel", t + 41, t + 46, device=CUDA),
                _event("tiled_block", t + 511, t + 518, device=CUDA),
                _event("repro.block", t + 511, t + 519, device=CUDA, annotation=True)]
    return out


def test_device_time_of_a_range_follows_the_launching_op():
    assert spans.range_device_us(_events(), "events") == pytest.approx(2 * 305.0)
    assert spans.range_device_us(_events(), "block") == pytest.approx(2 * 7.0)
    # K2 not linked by correlation: the range's device-side annotation stands in
    assert spans.range_device_us(_events(k2_linked=False), "block") == pytest.approx(2 * 8.0)
    assert spans.range_device_us(_events(), "launch") is None  # no such range
    host_only = [e for e in _events() if e.device_type == CPU]
    assert spans.range_device_us(host_only, "events") is None  # no device: nothing to read


@pytest.mark.parametrize("name,stage,want", [("tiled.events_device_ms", "events", 0.305),
                                             ("tiled.block_device_ms", "block", 0.007)])
def test_device_readers_per_traced_request(name, stage, want):
    read = _reader(name).read
    prof = SimpleNamespace(events=_events)
    assert read(_run(prof=prof, traced=2), None) == pytest.approx(want)
    assert read(_run(prof=None, traced=2), None) is None  # the CPU: no profiler session
    assert read(_run(prof=prof, traced=0), None) is None
    assert spans.device_ms_per_query(_run(prof=prof, traced=4), stage) == pytest.approx(want / 2)


def test_a_tiny_traced_uniform_run_reports_the_prelaunch_time():
    cell = "uniform64.embedded-recurring"
    res = _bench.tiny(cell, trace=True, seconds=1.0)
    assert res["correct"] is True
    got = res["metrics"]["execute.prelaunch_ms"]
    assert got["unit"] == "ms" and 0.0 < got["value"] < 1e3
    assert "execute.prelaunch_ms" in {m["name"] for m in _bench.with_parked().metrics(
        "per_layer", cell)}
    # no profiler session on the CPU, and the cell lists neither device reader
    assert not {"tiled.events_device_ms", "tiled.block_device_ms"} & set(res["metrics"])
