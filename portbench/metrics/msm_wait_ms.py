"""msm_wait_ms: a finish worker's wait for the MSM's window totals on the
host; seconds of the program's stage `msm_wait` inside the window, over
all threads, per batch handed over in the window, in ms. None where the
program records no such stage."""

from portbench.spans import stage_ms

STAGE = "msm_wait"


def read(run):
    return stage_ms(run, STAGE)
