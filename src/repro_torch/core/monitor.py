"""Real-time timing / throughput monitoring (paper §4 "future developments":
real-time tracking of timing and resource usage — implemented here).

Lightweight, lock-protected counters and EWMA timers that every kernel pool
updates in place; ``report()`` renders one dict for logging / EXPERIMENTS.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional


class Timer:
    """EWMA + totals for a repeatedly-timed section."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.total = 0.0
        self.count = 0
        self.max = 0.0
        self._lock = threading.Lock()

    def add(self, dt: float):
        with self._lock:
            self.total += dt
            self.count += 1
            self.max = max(self.max, dt)
            self.ewma = dt if self.ewma is None else (
                self.alpha * dt + (1 - self.alpha) * self.ewma)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.add(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def stats(self) -> Dict[str, float]:
        return {"mean_s": self.mean, "ewma_s": self.ewma or 0.0,
                "max_s": self.max, "count": self.count,
                "total_s": self.total}


class Monitor:
    """Named timers + counters for the whole PAL run."""

    def __init__(self):
        self._timers: Dict[str, Timer] = collections.defaultdict(Timer)
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()
        self.start_time = time.time()

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers[name]

    def incr(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] += n

    def count(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    def report(self) -> Dict[str, object]:
        with self._lock:
            return {
                "uptime_s": time.time() - self.start_time,
                "timers": {k: t.stats() for k, t in self._timers.items()},
                "counters": dict(self._counters),
            }
