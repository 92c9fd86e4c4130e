"""device_idle_pct: 100 x (1 - the union of the device's kernel and copy
intervals in the window, over the window), from torch.profiler."""

from portbench.trace import busy_intervals


def read(run):
    if not run.device:
        return None
    busy = sum(b - a for a, b in busy_intervals(run.device, run.t_start,
                                                run.t_end))
    return 100.0 * (1.0 - busy / (run.t_end - run.t_start))
