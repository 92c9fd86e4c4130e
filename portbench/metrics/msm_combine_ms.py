"""msm_combine_ms: the exact host fold of the MSM's window totals, on a
finish worker; seconds of the program's stage `msm_combine` inside the
window, over all threads, per batch handed over in the window, in ms.
None where the program records no such stage."""

from portbench.spans import stage_ms

STAGE = "msm_combine"


def read(run):
    return stage_ms(run, STAGE)
