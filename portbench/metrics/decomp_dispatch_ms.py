"""decomp_dispatch_ms: the sqrt pre-pass's gather, launch, D2H enqueue and
hand-off, on the main thread; seconds of the program's stage
`decomp_dispatch` inside the window, over all threads, per batch handed
over in the window, in ms. None where the program records no such stage."""

from portbench.spans import stage_ms

STAGE = "decomp_dispatch"


def read(run):
    return stage_ms(run, STAGE)
