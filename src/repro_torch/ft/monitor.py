"""Fault tolerance: straggler detection, preemption handling, restart logic.

A copy of ``repro.ft.monitor`` (host code: it imports neither JAX nor torch).

At 1000+ nodes the failure modes are (a) slow hosts (stragglers), (b)
preemptions, (c) hard crashes.  The framework's contract:

  * crashes    -> the train loop is a pure function of (checkpoint, data
                  stream position); launch/train.py auto-resumes from the
                  newest checkpoint and the data pipeline is deterministic
                  per (seed, step), so a restart replays identically.
  * preemption -> SIGTERM/SIGINT triggers a final synchronous checkpoint
                  before exit (PreemptionHandler).
  * stragglers -> per-step wall-times feed an EWMA; a step slower than
                  ``threshold x`` the EWMA raises a mitigation event.  On a
                  real fleet the event handler re-slices the data shards
                  away from the slow host (elastic rescale via the
                  checkpoint reshard path) -- here the decision logic is
                  real and unit-tested, the actuation is a callback.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float
    ratio: float


class StragglerMonitor:
    def __init__(self, threshold: float = 2.5, alpha: float = 0.1, warmup: int = 5):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: float | None = None
        self.count = 0
        self.events: list[StragglerEvent] = []

    def record(self, step: int, step_time: float) -> StragglerEvent | None:
        self.count += 1
        if self.ewma is None:
            self.ewma = step_time
            return None
        event = None
        if self.count > self.warmup and step_time > self.threshold * self.ewma:
            event = StragglerEvent(step, step_time, self.ewma, step_time / self.ewma)
            self.events.append(event)
            # do not fold outliers into the EWMA
            return event
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return event


class PreemptionHandler:
    """Installs SIGTERM/SIGINT hooks; the train loop polls ``should_stop``."""

    def __init__(self, on_preempt: Callable[[], None] | None = None):
        self.should_stop = False
        self._on_preempt = on_preempt
        self._installed = False

    def install(self):
        if self._installed:
            return

        def _handler(signum, frame):
            self.should_stop = True
            if self._on_preempt:
                self._on_preempt()

        try:
            signal.signal(signal.SIGTERM, _handler)
            signal.signal(signal.SIGINT, _handler)
            self._installed = True
        except ValueError:  # non-main thread (tests)
            pass


class Heartbeat:
    """Simple liveness tracking for a host set; dead hosts trigger elastic
    rescale (drop their data shards, reshard on the survivors)."""

    def __init__(self, hosts: int, timeout: float = 60.0):
        self.timeout = timeout
        self.last_seen = {h: time.time() for h in range(hosts)}

    def beat(self, host: int, now: float | None = None):
        self.last_seen[host] = now if now is not None else time.time()

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.time()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]

    def surviving_shards(self, now: float | None = None) -> list[int]:
        dead = set(self.dead_hosts(now))
        return [h for h in self.last_seen if h not in dead]
