"""tampered_latency_p50_ms: the median over the batches holding a tampered
proof whose verdict arrives in the window, of the time from hand-over to
the verdict, the failing proof's position found."""

import statistics


def read(run):
    lat = [b.verdict - b.handed for b in run.verdicts_in_window()
           if b.tampered]
    return statistics.median(lat) * 1e3 if lat else None
