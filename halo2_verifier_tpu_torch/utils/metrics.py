"""Lightweight stage timing / observability (SURVEY.md §5: the reference has
no tracing at all; batch verification at target rates needs per-stage
breakdowns to steer optimization)."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field


@dataclass
class StageTimings:
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    # stages run concurrently on the stream pipeline's worker threads;
    # dict-entry += is load/add/store and can lose updates without this
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        """Add one call of `seconds` to a stage timed by its caller."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "seconds": round(self.totals[name], 4),
                "calls": self.counts[name],
            }
            for name in sorted(self.totals)
        }

    def __str__(self) -> str:
        parts = [
            f"{name}={self.totals[name]:.3f}s/{self.counts[name]}x"
            for name in sorted(self.totals, key=lambda n: -self.totals[n])
        ]
        return " ".join(parts)


def maybe_stage(timings, name: str):
    """timings.stage(name), or nothing when timings is None."""
    return nullcontext() if timings is None else timings.stage(name)
