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
    # None, or a list that keeps every stage call as (name, thread, t0, t1)
    # on the perf_counter clock
    intervals: list | None = field(default=None, repr=False, compare=False)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._record(name, t1 - t0, t0, t1)

    def add(self, name: str, seconds: float) -> None:
        """Add one call of `seconds` to a stage timed by its caller."""
        t1 = time.perf_counter()
        self._record(name, seconds, t1 - seconds, t1)

    def add_span(self, name: str, t0: float, t1: float) -> None:
        """Add one call of a stage that its caller places from t0 to t1
        on the perf_counter clock, on this thread."""
        self._record(name, t1 - t0, t0, t1)

    def _record(self, name, seconds, t0, t1) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            if self.intervals is not None:
                self.intervals.append((name, threading.get_ident(), t0, t1))

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
