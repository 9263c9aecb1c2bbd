"""Latency percentiles for the batching queue's statistics."""

from __future__ import annotations

import collections
import contextlib
import threading
import time


class LatencyHistogram:
    """Sliding-window percentile tracker over the last ``cap`` samples.

    A deque of recent samples, sorted on demand, so percentiles describe
    the system's current behaviour.  Samples are recorded from the event
    loop and from executor threads, so every mutation takes the lock.
    """

    def __init__(self, cap: int = 1024):
        self._lock = threading.Lock()
        self._window: collections.deque[float] = collections.deque(maxlen=cap)

    def record(self, seconds: float) -> None:
        with self._lock:
            self._window.append(seconds)

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def percentile(self, p: float) -> float | None:
        with self._lock:
            if not self._window:
                return None
            s = sorted(self._window)
        return s[min(len(s) - 1, int(p / 100.0 * len(s)))]
