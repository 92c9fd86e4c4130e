"""msm_dispatch_ms: seconds of the program's stage `device_msm_dispatch` inside the window, over all
threads, per batch handed over in the window, in ms."""

STAGE = "device_msm_dispatch"


def read(run):
    n = len(run.handed_in_window())
    if run.stages is None or not n:
        return None
    return run.stage_seconds(STAGE) / n * 1e3
