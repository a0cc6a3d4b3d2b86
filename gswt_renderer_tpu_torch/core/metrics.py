"""Windowed performance metrics, matching the reference semantics.

IncrementalMA reproduces utils.rs:76-130 (O(1) windowed mean/std via running
sum & sum-of-squares); Timer reproduces utils.rs:132-184 (pausable wall clock,
milliseconds). These feed the fly-path benchmark harness (gui.rs:955-997) and
the per-frame HUD counters incl. sort/build trigger rates (state.rs:293-311).
"""

from __future__ import annotations

import math
import time
from collections import deque


def get_time_milliseconds() -> float:
    """Monotonic wall clock in ms (helper.js:1-3 / performance.now)."""
    return time.perf_counter() * 1000.0


class IncrementalMA:
    """Incremental moving average over a fixed window (utils.rs:76-130)."""

    def __init__(self, window_size: int):
        self.window_size = int(window_size)
        self._v: deque = deque()
        self._sum = 0.0
        self._sum_sq = 0.0
        self._avg = 0.0
        self._stddev = 0.0

    def add(self, value: float):
        if len(self._v) == self.window_size:
            old = self._v.popleft()
            self._sum -= old
            self._sum_sq -= old * old
        self._v.append(value)
        self._sum += value
        self._sum_sq += value * value
        n = float(len(self._v))
        avg = self._sum / n
        variance = self._sum_sq / n - avg * avg
        self._avg = avg
        self._stddev = math.sqrt(max(variance, 0.0))
        return self._avg, self._stddev

    def calc(self):
        if not self._v:
            return 0.0, 0.0
        return self._avg, self._stddev

    def clear(self):
        self._v.clear()
        self._sum = self._sum_sq = self._avg = self._stddev = 0.0

    def __len__(self):
        return len(self._v)


class Timer:
    """Pausable accumulating wall-clock timer (utils.rs:132-184)."""

    def __init__(self):
        self._start: float | None = None
        self._accumulated = 0.0
        self._paused = True

    def start(self):
        if self._paused:
            self._start = get_time_milliseconds()
            self._paused = False

    def pause(self):
        if not self._paused:
            if self._start is not None:
                self._accumulated += get_time_milliseconds() - self._start
            self._start = None
            self._paused = True

    def reset(self):
        self._start = None
        self._accumulated = 0.0
        self._paused = True

    def elapsed(self) -> float:
        if self._paused or self._start is None:
            return self._accumulated
        return self._accumulated + (get_time_milliseconds() - self._start)

    @property
    def is_paused(self) -> bool:
        return self._paused
