"""The program's stage intervals of a traced run (Run.stages: name,
thread, start, end), read per thread: the union of intervals, a stage's
self time, and what the stream's main thread spent in no stage. Shared by
the readers in metrics/ that read spans inside the program's host path.

Every reader built on these returns None in an untraced run, in a run
that handed over no batch in its window, and in a run of a program that
records no such stage.
"""

from __future__ import annotations

from .trace import busy_intervals

REPLAY = "host_replay"   # the stage that marks the stream's main thread


def union(intervals, lo: float, hi: float) -> list:
    """The union of (t0, t1) intervals clipped to [lo, hi], as sorted
    disjoint [t0, t1]."""
    return busy_intervals([(None, a, b) for a, b in intervals], lo, hi)


def covered(disjoint, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that sorted disjoint intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in disjoint)


def recorded(run, name: str) -> bool:
    """Whether the run's program recorded stage `name` at all."""
    return any(n == name for n, _tid, _t0, _t1 in run.stages or ())


def batches(run) -> int | None:
    """Batches handed over in the window; None in an untraced run or
    one that handed over none."""
    n = len(run.handed_in_window())
    return n if run.stages is not None and n else None


def stage_ms(run, name: str) -> float | None:
    """Seconds of stage `name` in the window, over all threads, per
    batch handed over in the window, in ms."""
    n = batches(run)
    if n is None or not recorded(run, name):
        return None
    return run.stage_seconds(name) / n * 1e3


def self_seconds(run, parent: str, children) -> float:
    """Seconds of stage `parent` in the window less the part of each of
    its intervals that stages `children` on the same thread cover."""
    kids = {}
    for n, tid, t0, t1 in run.stages or ():
        if n in children:
            kids.setdefault(tid, []).append((t0, t1))
    kids = {tid: union(ivs, run.t_start, run.t_end)
            for tid, ivs in kids.items()}
    total = 0.0
    for n, tid, t0, t1 in run.stages or ():
        if n != parent:
            continue
        a, b = max(t0, run.t_start), min(t1, run.t_end)
        if b > a:
            total += (b - a) - covered(kids.get(tid, ()), a, b)
    return total


def main_thread(run):
    """The thread that ran most of stage host_replay in the window: the
    one that consumes the stream; None where no replay ran in it."""
    by = {}
    for n, tid, t0, t1 in run.stages or ():
        if n == REPLAY:
            d = min(t1, run.t_end) - max(t0, run.t_start)
            if d > 0:
                by[tid] = by.get(tid, 0.0) + d
    return max(by, key=by.get) if by else None


def unstaged_seconds(run, tid) -> float:
    """Seconds of the window in which thread `tid` ran no stage."""
    spans = union([(t0, t1) for _n, t, t0, t1 in run.stages or ()
                   if t == tid], run.t_start, run.t_end)
    return (run.t_end - run.t_start) - covered(spans, run.t_start, run.t_end)
