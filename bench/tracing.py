"""The traced part of a ``--trace 1`` run: ``torch.profiler`` and the
program's spans over one steady stretch of the window.

The harness marks its own calls into the program with ``record_function``
ranges named ``bench.<call>``; an idle gap of the device is named after the
range and the innermost host operation open at its middle.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

from bench import program


def merge(intervals):
    """Sorted, disjoint union of (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def idle_gaps(intervals, lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for a, b in merge(intervals):
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


class TraceWindow:
    """Starts the profiler and the program's spans at ``start`` (host
    clock) and stops them at ``stop``; the loop's thread calls
    :meth:`poll` as it goes.  With ``enabled`` false it does nothing."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.start = self.stop = self.span = None
        self.state = "idle"
        self.spans: list = []
        self.prof = None
        self.host = None  # (t_on, t_off) host clock
        self.hooks_on: list = []
        self.hooks_off: list = []

    def schedule(self, start: float, span: float) -> None:
        """Trace ``span`` seconds from ``start`` on, or from whenever the
        profiler is up, if that is later."""
        self.start, self.span = start, span

    def prime(self) -> None:
        """One throwaway profiler session in set-up, so the profiler's own
        start-up (CUPTI) stays out of the window."""
        if not self.enabled or self.device.type != "cuda":
            return
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(8, device=self.device).sum().item()

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def annotate(self, name: str):
        if self.enabled and self.state == "on":
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def poll(self, now: float | None = None) -> None:
        if not self.enabled or self.start is None:
            return
        now = time.perf_counter() if now is None else now
        if self.state == "idle" and now >= self.start:
            self._on()
        elif self.state == "on" and now >= self.stop:
            self._off()

    def finish(self) -> None:
        if self.enabled and self.state == "on":
            self._off()

    def _on(self) -> None:
        """Spans and counters on; the profiler too where there is a device
        to trace (on the CPU nothing runs on a device)."""
        for fn in self.hooks_on:
            fn()
        program.enable_spans(self.spans)
        if self.device.type == "cuda":
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.__enter__()
        self.state = "on"
        self.host = [time.perf_counter(), None]
        self.stop = self.host[0] + self.span
        with torch.profiler.record_function("bench.window_open"):
            pass

    def _off(self) -> None:
        with torch.profiler.record_function("bench.window_close"):
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.host[1] = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
        program.disable_spans()
        for fn in self.hooks_off:
            fn()
        self.state = "done"

    # -- reading ------------------------------------------------------------
    def read(self) -> dict | None:
        """busy / window seconds, device intervals, and the breakdown."""
        if self.host is None or self.host[1] is None:
            return None
        if self.prof is None:
            window = self.host[1] - self.host[0]
            return {"window_s": window, "busy_s": 0.0, "device_intervals": 0, "device_ops": [],
                    "idle_gaps": [], "host_window_s": window}
        dev, cpu = [], []
        marks = {}
        for e in self.prof.events():
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the device-side shadow of a record_function range is no work
                if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                    dev.append((a, b, e.name))
            else:
                if e.name in ("bench.window_open", "bench.window_close"):
                    marks[e.name] = a
                cpu.append((a, b, e.name))
        lo = marks.get("bench.window_open", min([a for a, _, _ in cpu], default=0.0))
        hi = marks.get("bench.window_close", max([b for _, b, _ in cpu], default=lo))
        ivals = [(a, b) for a, b, _ in dev if b > lo and a < hi]
        busy = busy_seconds(ivals, lo, hi)
        by_name = defaultdict(float)
        for a, b, name in dev:
            if b > lo and a < hi:
                by_name[name] += min(b, hi) - max(a, lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": hi - lo,
            "busy_s": busy,
            "device_intervals": len(ivals),
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": self._name_gaps(idle_gaps(ivals, lo, hi), cpu) if ivals else [],
            "host_window_s": self.host[1] - self.host[0],
        }

    @staticmethod
    def _name_gaps(gaps, cpu, top: int = 10, scan: int = 400):
        if not gaps or not cpu:
            return []
        starts = np.array([a for a, _, _ in cpu])
        ends = np.array([b for _, b, _ in cpu])
        names = [n for _, _, n in cpu]
        total = defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:scan]:
            mid = 0.5 * (a + b)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if hit.size == 0:
                label = "host: outside any traced call"
            else:
                bench = [names[i] for i in hit if names[i].startswith("bench.")]
                inner = min(hit, key=lambda i: ends[i] - starts[i])
                label = f"{bench[0] if bench else 'host'}: {names[inner]}"
            total[label] += b - a
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def spans_named(roots, name: str) -> list:
    """Every span called ``name`` in the program's span trees."""
    return [s for root in roots for s in root.iter() if s.name == name]


def host_ms_per_query(run, name: str):
    """Wall milliseconds of the ``name`` spans, over the traced requests."""
    if not run.tracer.spans or not run.traced:
        return None
    return 1e3 * sum(s.wall_s for s in spans_named(run.tracer.spans, name)) / len(run.traced)
