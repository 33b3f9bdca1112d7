"""Slow-query log: threshold-gated ring buffer of completed span trees.

Any root span whose wall time crosses the threshold is recorded (plan
attributes + the full span tree as JSON-ready dicts) into a bounded
deque, so production incidents leave evidence without unbounded memory.
"""
from __future__ import annotations

import threading
import time
from collections import deque


class SlowQueryLog:
    def __init__(self, threshold_s: float = 0.050, capacity: int = 128) -> None:
        self.threshold_s = threshold_s
        self._entries: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0  # recorded past capacity (ring overwrote)

    def set_threshold(self, threshold_s: float) -> None:
        self.threshold_s = threshold_s

    def maybe_record(self, root_span) -> bool:
        if root_span.wall_s < self.threshold_s:
            return False
        plan = root_span.find("plan")
        entry = {
            "ts": time.time(),
            "name": root_span.name,
            "wall_us": root_span.wall_s * 1e6,
            "plan": dict(plan.attrs) if plan is not None else dict(root_span.attrs),
            "span": root_span.to_dict(),
        }
        with self._lock:
            if len(self._entries) == self._entries.maxlen:
                self.dropped += 1
            self._entries.append(entry)
        return True

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.dropped = 0
