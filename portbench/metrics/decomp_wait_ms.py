"""decomp_wait_ms: the main thread's block on the sqrt pre-pass's roots;
seconds of the program's stage `decomp_wait` inside the window, over all
threads, per batch handed over in the window, in ms. None where the
program records no such stage."""

from portbench.spans import stage_ms

STAGE = "decomp_wait"


def read(run):
    return stage_ms(run, STAGE)
