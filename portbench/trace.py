"""The traced run's device record: torch.profiler over the window, its
device operations moved onto the host's clock, the union of their
intervals (busy time) and the breakdown the result line carries.

The profiler's timestamps share one base; a CPU-side marker recorded at a
known host time gives the offset to `time.perf_counter`.
"""

from __future__ import annotations

import time

MARK = "portbench.window_mark"


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._mark_host = None

    def start(self) -> None:
        self._prof.start()

    def mark(self) -> None:
        from torch.profiler import record_function

        self._mark_host = time.perf_counter()
        with record_function(MARK):
            pass

    def stop(self) -> list:
        """Stops the profiler; returns [(name, t0, t1)] of every device
        operation, in host-clock seconds."""
        from torch.autograd import DeviceType

        self._prof.stop()
        events = self._prof.events()
        marks = [e for e in events if e.name == MARK]
        if not marks or self._mark_host is None:
            raise RuntimeError("the profiler recorded no window mark")
        offset = self._mark_host - marks[0].time_range.start / 1e6
        return sorted(
            (e.name, e.time_range.start / 1e6 + offset,
             e.time_range.end / 1e6 + offset)
            for e in events if e.device_type == DeviceType.CUDA)


def busy_intervals(device, t_start, t_end) -> list:
    """The union of the device operations' intervals, clipped to the
    window, as sorted disjoint [t0, t1]."""
    out = []
    for _name, a, b in sorted(device, key=lambda e: e[1]):
        a, b = max(a, t_start), min(b, t_end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stage_at(stages, t) -> str:
    """The host stages running at time t: the innermost on each thread,
    joined by '|'; 'no_stage' where none runs."""
    inner = {}
    for name, tid, t0, t1 in stages or ():
        if t0 <= t <= t1 and (tid not in inner or t0 > inner[tid][0]):
            inner[tid] = (t0, name)
    return "|".join(sorted({n for _t0, n in inner.values()})) or "no_stage"


def breakdown(device, stages, t_start, t_end, top=10) -> dict:
    """The device operations that took most time in the window, by name,
    and its longest idle gaps, labelled by the host stage then running."""
    by_name = {}
    for name, a, b in device:
        d = min(b, t_end) - max(a, t_start)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(device, t_start, t_end)
    edges = [t_start] + [x for iv in busy for x in iv] + [t_end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [[stage_at(stages, (a + b) / 2), b - a] for a, b in gaps]
    return {"device_ops": [[n[:64], s] for n, s in ops],
            "idle_gaps": idle}
