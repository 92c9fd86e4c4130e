"""batch_latency_p95_ms: the 95th percentile (nearest rank) over every
batch whose verdict arrives in the window, of the time from the stream
taking the batch from the generator to its verdict."""

import math


def read(run):
    lat = sorted(b.verdict - b.handed for b in run.verdicts_in_window())
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
