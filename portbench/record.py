"""What one run leaves for the metric readers: the window, every batch it
handed over with the times of hand-over and verdict, the program's counters
over the window and, in a traced run, the host stages and device
operations as intervals on the host's clock.

The stage intervals come from `IntervalTimings`, a StageTimings that the
harness gives the verifier as its `timings`: the program's own stage names
(parallel/orchestrator.py, ops/msm_forest.py), with start, end and thread.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from halo2_verifier_tpu_torch.utils.metrics import StageTimings


@dataclass
class IntervalTimings(StageTimings):
    intervals: list = field(default_factory=list, repr=False)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.totals[name] += t1 - t0
                self.counts[name] += 1
                self.intervals.append((name, threading.get_ident(), t0, t1))

    def add(self, name: str, seconds: float) -> None:
        t1 = time.perf_counter()
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            self.intervals.append((name, threading.get_ident(),
                                   t1 - seconds, t1))


@dataclass
class BatchRecord:
    size: int
    tampered: tuple       # positions of tampered proofs
    probe: bool           # handed over after the window closed
    handed: float         # host clock when the stream took it
    verdict: float | None = None
    ok: bool | None = None
    failed: list | None = None
    num_proofs: int | None = None


@dataclass
class Run:
    workload: str
    config: str
    traffic: str
    seconds: float
    setup_s: float
    t_start: float
    t_end: float
    batches: list                      # BatchRecord, in stream order
    counters: dict                     # the program's counters, window deltas
    facts: dict                        # what the reference counted
    card: dict
    stages: list | None = None         # (name, thread, t0, t1)
    device: list | None = None         # (name, t0, t1) device operations

    def handed_in_window(self) -> list:
        return [b for b in self.batches
                if not b.probe and self.t_start <= b.handed <= self.t_end]

    def verdicts_in_window(self) -> list:
        return [b for b in self.batches
                if b.verdict is not None
                and self.t_start <= b.verdict <= self.t_end]

    def stage_seconds(self, name: str) -> float:
        """Seconds of stage `name` inside the window, over all threads."""
        return sum(max(0.0, min(t1, self.t_end) - max(t0, self.t_start))
                   for n, _tid, t0, t1 in self.stages or () if n == name)

    def device_seconds(self, keep) -> float | None:
        """Device seconds inside the window of the operations whose name
        `keep(name)` accepts; None in an untraced run or with no such
        operation."""
        if not self.device:
            return None
        s = sum(max(0.0, min(t1, self.t_end) - max(t0, self.t_start))
                for name, t0, t1 in self.device if keep(name))
        return s or None
