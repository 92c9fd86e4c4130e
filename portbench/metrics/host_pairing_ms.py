"""host_pairing_ms: seconds of the program's stage `host_pairing` inside the window, over all
threads, per batch handed over in the window, in ms."""

STAGE = "host_pairing"


def read(run):
    n = len(run.handed_in_window())
    if run.stages is None or not n:
        return None
    return run.stage_seconds(STAGE) / n * 1e3
